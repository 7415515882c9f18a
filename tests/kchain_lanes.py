"""A NumPy emulation of the K chain's lane schedule in the warp kernels.

``csrc/profile_hmm_row.cuh`` (npt_row_kchain) evaluates the profile-HMM
K-skip chain K[k] = op(c[k], K[k-1] + lp_kk) of one row of KP = 32 R
kmers with one warp: lane l holds kmers l R ... l R + R - 1.  The tree is
jax.lax.associative_scan's, in place: the up-sweep's levels
0 ... log2 R - 1 combine a lane's registers, its levels log2 R ... combine
the lanes' last registers at lane distance 2^l / R (``__shfl_up_sync``);
the down-sweep mirrors it.  ``lane_schedule_chain`` runs that schedule
step for step on [n, KP] float32 arrays, with the same shuffle semantics
(a lane below the distance keeps its own value), so a test can hold it to
``ops/profile_hmm.kstate_chain_max`` / ``kstate_chain_logsum`` bit for bit
before the kernel ever runs on a card.

Two generalisations cover the other rows: ``width`` runs the shuffles on
groups of W lanes (``__shfl_up_sync``'s width argument), each group a
segment of its own, as csrc/forward_indexed.cu packs 32 / W short windows
into a warp; ``lanes`` widens the warp to the 1,024 threads of the wide
row (csrc/profile_hmm_wide.cuh), whose in-place shared-memory tree follows
the same schedule with a barrier per level.
"""

from __future__ import annotations

import numpy as np

WARP = 32


def _shfl_up(x: np.ndarray, d: int, width: int = WARP) -> np.ndarray:
    """__shfl_up_sync(x, d, width) over the lane axis (axis 1) of
    x [n, lanes]: a lane takes the value d lanes below in its group of
    width lanes, and a lane below d in its group keeps its own."""
    n, lanes = x.shape
    g = x.reshape(n, lanes // width, width)
    out = g.copy()
    out[:, :, d:] = g[:, :, :-d]
    return out.reshape(n, lanes)


def lane_schedule_chain(c: np.ndarray, lp_kk: np.ndarray, R: int,
                        op, width: int = WARP,
                        lanes: int = WARP) -> np.ndarray:
    """K [n, lanes R] float32 from inputs c [n, lanes R] and lp_kk [n]
    (or [n, lanes // width], one per group), through npt_row_kchain's
    schedule on groups of ``width`` lanes, each group a segment of
    width R kmers; ``op(a, b)`` is the chain's operation on float32
    arrays (max or logaddexp)."""
    n, kp = c.shape
    assert kp == lanes * R and lanes % width == 0, (kp, R, lanes, width)
    f32 = np.float32
    v = np.asarray(c, f32).reshape(n, lanes, R).copy()    # v[:, lane, r]
    lane = np.arange(lanes)[None, :] % width              # group lane
    a = np.repeat(np.asarray(lp_kk, f32).reshape(n, -1), width,
                  axis=1)[:, :, None].copy()              # [n, lanes, 1]
    with np.errstate(invalid="ignore", over="ignore"):
        h = 1                            # up-sweep inside the lane
        while h < R:
            for r in range(2 * h - 1, R, 2 * h):
                v[:, :, r] = op(v[:, :, r - h] + a[:, :, 0], v[:, :, r])
            a = a + a
            h *= 2
        d = 1                            # up-sweep across lanes
        while d < width:
            u = _shfl_up(v[:, :, R - 1], d, width)
            sel = ((lane + 1) & (2 * d - 1)) == 0
            v[:, :, R - 1] = np.where(sel, op(u + a[:, :, 0],
                                              v[:, :, R - 1]),
                                      v[:, :, R - 1])
            a = a + a
            d *= 2
        a = a * f32(0.5)                 # the level under the root: no-op
        d = width // 4                   # down-sweep across lanes
        while d >= 1:
            a = a * f32(0.5)
            u = _shfl_up(v[:, :, R - 1], d, width)
            sel = (((lane + 1) & (2 * d - 1)) == d) & (lane + 1 >= 3 * d)
            v[:, :, R - 1] = np.where(sel, op(u + a[:, :, 0],
                                              v[:, :, R - 1]),
                                      v[:, :, R - 1])
            d //= 2
        prev = _shfl_up(v[:, :, R - 1], 1, width)   # K[l R - 1]
        first = lane > 0                 # group lane 0 keeps element 0
        h = R // 2                       # down-sweep inside the lane
        while h >= 1:
            a = a * f32(0.5)
            for r in range(h - 1, R, 2 * h):
                if r == h - 1:           # from the lane below
                    v[:, :, r] = np.where(first, op(prev + a[:, :, 0],
                                                    v[:, :, r]), v[:, :, r])
                else:
                    v[:, :, r] = op(v[:, :, r - h] + a[:, :, 0], v[:, :, r])
            h //= 2
    return v.reshape(n, kp)


def chain_inputs(rng: np.random.Generator, n: int, kp: int):
    """Inputs with exact ties and -inf runs: c on an integer grid and
    lp_kk in {-1, -2} on most rows (so c[k] == K[k-1] + lp_kk happens),
    plus a log(0.3) row, a -inf lp_kk row and an all -inf row."""
    c = rng.integers(-40, 1, (n, kp)).astype(np.float32)
    c[1] = rng.normal(-200.0, 30.0, kp).astype(np.float32)
    for row in range(n):
        start = int(rng.integers(0, kp - 8))
        c[row, start:start + int(rng.integers(1, 8))] = -np.inf
    c[:, 0::11] = -np.inf
    c[-1] = -np.inf
    lp_kk = rng.choice(np.array([-1.0, -2.0], np.float32), n)
    lp_kk[1] = np.float32(np.log(0.3))
    lp_kk[2] = -np.inf
    return c, lp_kk.astype(np.float32)
