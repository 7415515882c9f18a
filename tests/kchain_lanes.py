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

A generalisation covers the short windows: ``width`` runs the shuffles
on groups of W lanes (``__shfl_up_sync``'s width argument), each group a
segment of its own, as csrc/forward_indexed.cu packs 32 / W short windows
into a warp.

``wide_schedule_chain`` runs the wide row's schedule
(csrc/profile_hmm_wide.cuh): a cluster of C CTAs of nt threads, J kmers a
thread, the tree in tiers (in the thread, across a warp's lanes, across
the CTA's warps in warp 0, across the cluster's CTAs), each tier's first
element of a level taking the final value at the end of the tier below.
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
                        op, width: int = WARP) -> np.ndarray:
    """K [n, 32 R] float32 from inputs c [n, 32 R] and lp_kk [n]
    (or [n, 32 // width], one per group), through npt_row_kchain's
    schedule on groups of ``width`` lanes, each group a segment of
    width R kmers; ``op(a, b)`` is the chain's operation on float32
    arrays (max or logaddexp)."""
    n, kp = c.shape
    assert kp == WARP * R and WARP % width == 0, (kp, R, width)
    f32 = np.float32
    v = np.asarray(c, f32).reshape(n, WARP, R).copy()     # v[:, lane, r]
    lane = np.arange(WARP)[None, :] % width               # group lane
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


def _shift(x: np.ndarray, d: int, axis: int) -> np.ndarray:
    """__shfl_up_sync(x, d) along one axis: an index takes the value d
    below it, and an index below d keeps its own."""
    out = x.copy()
    src = [slice(None)] * x.ndim
    dst = [slice(None)] * x.ndim
    src[axis], dst[axis] = slice(0, x.shape[axis] - d), slice(d, None)
    out[tuple(dst)] = x[tuple(src)]
    return out


def wide_schedule_chain(c: np.ndarray, lp_kk: np.ndarray, J: int, nt: int,
                        C: int, op) -> np.ndarray:
    """K [n, KP] float32 (KP = C nt J) from inputs c [n, KP] and lp_kk [n]
    through npt_wide_fill's schedule, step for step: thread th of CTA cr
    holds kmers (cr nt + th) J ... + J - 1; the tiers' up-sweeps, the
    cluster's sweep on the CTAs' totals (every CTA alike), then the
    down-sweeps with the prefixes of the CTA, warp and thread below."""
    n, kp = c.shape
    NW = nt // WARP
    assert kp == C * nt * J and nt % WARP == 0, (kp, J, nt, C)
    f32 = np.float32
    neg = f32(-np.inf)
    v = np.asarray(c, f32).reshape(n, C, NW, WARP, J).copy()
    lane = np.arange(WARP)[None, None, None, :]
    wi = np.arange(NW)[None, None, :]
    ci = np.arange(C)[None, :]
    kb = (np.arange(C * nt).reshape(1, C, NW, WARP) * J)
    warp_pre = (wi > 0) | (ci[:, :, None] > 0)          # [1, C, NW]
    a = np.asarray(lp_kk, f32).reshape(n, 1, 1, 1).copy()
    with np.errstate(invalid="ignore", over="ignore"):
        h = 1                            # in the thread
        while h < J:
            for r in range(2 * h - 1, J, 2 * h):
                v[..., r] = op(v[..., r - h] + a, v[..., r])
            a = a + a
            h *= 2
        x = v[..., J - 1].copy()         # [n, C, NW, 32]
        d = 1                            # across the warp's lanes
        while d < WARP:
            u = _shift(x, d, 3)
            x = np.where(((lane + 1) & (2 * d - 1)) == 0, op(u + a, x), x)
            a = a + a
            d *= 2
        z = x[..., WARP - 1].copy()      # warp 0: [n, C, NW]
        aw = a[..., 0].copy()
        d = 1
        while d < NW:
            u = _shift(z, d, 2)
            z = np.where(((wi + 1) & (2 * d - 1)) == 0, op(u + aw, z), z)
            aw = aw + aw
            d *= 2
        cpre = np.full((n, C), neg, f32)
        if C > 1:
            y = z[..., NW - 1].copy()    # [n, C]
            ac = aw[..., 0].copy()
            d = 1
            while d < C:
                u = _shift(y, d, 1)
                y = np.where(((ci + 1) & (2 * d - 1)) == 0, op(u + ac, y), y)
                ac = ac + ac
                d *= 2
            ac = ac * f32(0.5)
            d = C // 4
            while d >= 1:
                ac = ac * f32(0.5)
                u = _shift(y, d, 1)
                sel = (((ci + 1) & (2 * d - 1)) == d) & (ci + 1 >= 3 * d)
                y = np.where(sel, op(u + ac, y), y)
                d //= 2
            cpre[:, 1:] = y[:, :-1]
            z[..., NW - 1] = y
            aw = ac[..., None]
        d = NW // 2                      # down across the warps
        while d >= 1:
            aw = aw * f32(0.5)
            u = _shift(z, d, 2)
            sel = ((wi + 1) & (2 * d - 1)) == d
            z = np.where(sel & (wi >= d), op(u + aw, z), z)
            z = np.where(sel & (wi < d) & (ci[:, :, None] > 0),
                         op(cpre[..., None] + aw, z), z)
            d //= 2
        wf = np.concatenate([cpre[..., None], z], axis=2)  # [n, C, NW + 1]
        wpre = wf[..., :NW, None]                          # [n, C, NW, 1]
        x[..., WARP - 1] = wf[..., 1:]
        d = WARP // 2                    # down across the warp's lanes
        while d >= 1:
            a = a * f32(0.5)
            u = _shift(x, d, 3)
            sel = ((lane + 1) & (2 * d - 1)) == d
            x = np.where(sel & (lane >= d), op(u + a, x), x)
            x = np.where(sel & (lane < d) & warp_pre[..., None],
                         op(wpre + a, x), x)
            d //= 2
        prev = np.where(lane > 0, _shift(x, 1, 3),
                        np.where(warp_pre[..., None], wpre, neg))
        v[..., J - 1] = x
        h = J // 2                       # down in the thread
        while h >= 1:
            a = a * f32(0.5)
            for r in range(h - 1, J, 2 * h):
                if r == h - 1:
                    v[..., r] = np.where(kb > 0, op(prev + a, v[..., r]),
                                         v[..., r])
                else:
                    v[..., r] = op(v[..., r - h] + a, v[..., r])
            h //= 2
    return v.reshape(n, kp)
