"""Profile HMM (R9) Viterbi and Forward — plain PyTorch versions.

Behavioral spec: ``profile_hmm_fill_generic_r9`` / ``profile_hmm_align_r9``
(reference: src/hmm/nanopolish_profile_hmm_r9.{h,inl,cpp}): a 3-state-per-
kmer-block profile HMM over (events x kmers) with states K=kmer-skip,
B=bad-event, M=match, soft-clip flanks, and 6 movement types.

This module is the plain version of the two CUDA kernels wrapped by
``ops/profile_hmm_viterbi.py`` (``csrc/viterbi_fill.cu``,
``csrc/viterbi_backtrack.cu``).  It produces exactly the kernels'
outputs:

  * ``viterbi_fill_plain``: one Python loop step per event row,
    vectorized over (segments x kmers).  M and B depend only on the row
    above; the K row's within-row chain K[k] = max(c[k], K[k-1] + lp_kk)
    is a (max,+) linear recurrence evaluated with the pairwise tree of
    ``jax.lax.associative_scan`` (odd/even recursion), so every K value
    carries the same rounding as the JAX scan path.  Output: one byte per
    cell, ``trM | trB << 3 | trK << 4`` (movement types below; trB is 1
    for FROM_SAME_B).
  * ``viterbi_backtrack_plain``: the traceback from (row = n_events,
    kmer = n_kmers-1, M) as a step loop vectorized over segments.  Output
    ``path[B, 1 + T + K]`` int32: column 0 holds the path length, column
    1 + i the i-th visited cell in traceback order packed as
    ``event << 12 | kmer << 2 | state``.

  * ``forward_fill_plain``: the Forward log-likelihood per segment
    (profile_hmm_score_r9, r9.cpp:35-65), the plain version of
    ``csrc/forward_fill.cu`` (wrapped by ``ops/profile_hmm_forward.py``).
    It follows the JAX scan path (``_profile_hmm_scan``, viterbi=False)
    operation for operation: the six M terms folded left to right with
    ``utils.logsum.add_logs_exact``, the K chain on the same pairwise
    tree as the Viterbi (``kstate_chain_logsum``), and the end terms
    folded into the score only on the rows the clip flags allow.
  * ``forward_indexed_plain``: the same Forward from indexed inputs (each
    segment four ids into shared event rows, per-read tables, kmer-rank
    rows and transition rows), the plain version of
    ``csrc/forward_indexed.cu`` (wrapped by ``ops/profile_hmm_indexed.py``):
    ``gather_indexed`` builds the flat inputs, then ``forward_fill_plain``.

The emission follows the scan's f32 evaluation: ``a = (x - mu) / sigma``
and ``fma(-0.5*a, a, c)`` with ``c = LOG_INV_SQRT_2PI - log(sigma)``
computed on the host.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..utils.logsum import add_logs_exact
from .emissions import LOG_INV_SQRT_2PI, fma32, log_normal_fused

# movement types (nanopolish_profile_hmm_r9.h:61-71)
HMT_FROM_SAME_M = 0
HMT_FROM_PREV_M = 1
HMT_FROM_SAME_B = 2
HMT_FROM_PREV_B = 3
HMT_FROM_PREV_K = 4
HMT_FROM_SOFT = 5

# states (nanopolish_profile_hmm_r9.h:52-59)
PSR9_KMER_SKIP = 0
PSR9_BAD_EVENT = 1
PSR9_MATCH = 2

# flags (nanopolish_profile_hmm.h:34-38)
HAF_ALLOW_PRE_CLIP = 1
HAF_ALLOW_POST_CLIP = 2

# soft clip constants (r9.inl:12-13) + background emission (-3 nats)
TRANS_CLIP_SELF = 0.9
TRANS_START_TO_CLIP = 0.5
LOG_BG = -3.0

_LOG1M_CLIP = math.log(1.0 - TRANS_START_TO_CLIP)
_CLIP_BASE = math.log(TRANS_START_TO_CLIP) + LOG_BG + \
    math.log(1.0 - TRANS_CLIP_SELF)
_CLIP_STEP = math.log(TRANS_CLIP_SELF) + LOG_BG

# columns of the [B, 8] transition table
TRANS_COLS = ("lp_mk", "lp_mb", "lp_mm_self", "lp_mm_next", "lp_bb",
              "lp_b3", "lp_kk", "lp_km")

# path cell packing (see module docstring)
PATH_EVENT_SHIFT = 12
PATH_KMER_SHIFT = 2
MAX_KMERS = 1 << (PATH_EVENT_SHIFT - PATH_KMER_SHIFT)

NEG_INF = float("-inf")

# c of a padding kmer (sigma 1): f32(LOG_INV_SQRT_2PI) - log(1)
PAD_C = float(np.float32(LOG_INV_SQRT_2PI))


def make_transitions(events_per_base, indel_bias: float = 1.0,
                     p_skip: float = 0.0025, p_bad: float = 0.001,
                     p_skip_self: float = 0.3, p_bad_self=None) -> np.ndarray:
    """Per-segment log transition probabilities (r9.inl:17-76), computed
    on the host in f64 and rounded to f32; p_bad_self defaults to p_bad.
    Returns [B, 8] float32 with the columns of TRANS_COLS (the three
    bad-event exits share lp_b3)."""
    if p_bad_self is None:
        p_bad_self = p_bad
    epb = np.maximum(1.25, np.asarray(events_per_base, np.float64).reshape(-1)
                     * indel_bias)
    p_stay = 1.0 - 1.0 / epb
    p_mm_next = 1.0 - p_stay - p_skip - p_bad
    p_b3 = (1.0 - p_bad_self) / 3.0
    cols = [np.full_like(p_stay, np.log(p_skip)),        # lp_mk
            np.full_like(p_stay, np.log(p_bad)),         # lp_mb
            np.log(p_stay),                              # lp_mm_self
            np.log(p_mm_next),                           # lp_mm_next
            np.full_like(p_stay, np.log(p_bad_self)),    # lp_bb
            np.full_like(p_stay, np.log(p_b3)),          # lp_b3 (= lp_bk)
            np.full_like(p_stay, np.log(p_skip_self)),   # lp_kk
            np.full_like(p_stay, np.log(1 - p_skip_self))]  # lp_km
    return np.stack(cols, axis=1).astype(np.float32)


def flank(i_f: torch.Tensor) -> torch.Tensor:
    """pre_flank[i] (r9.inl:200-227); post_flank[i] is the same function
    of n-1-i.  Affine because the background emission is constant."""
    base = fma32(i_f - 1.0, float(np.float32(_CLIP_STEP)),
                 float(np.float32(_CLIP_BASE)))
    return torch.where(i_f == 0, float(np.float32(_LOG1M_CLIP)), base)


def _shift_prev(x):
    """out[:, k] = x[:, k-1], -inf at k=0 (reads from the previous block)."""
    return torch.cat([torch.full_like(x[:, :1], NEG_INF), x[:, :-1]], dim=1)


def _kstate_chain(c: torch.Tensor, lp_kk: torch.Tensor, op) -> torch.Tensor:
    """K[k] = op(c[k], K[k-1] + lp_kk) along dim 1, evaluated with the
    pairwise tree of ``jax.lax.associative_scan``: combine((ax, vx),
    (ay, vy)) = (ax + ay, op(vx + ay, vy)), elements paired (0,1),
    (2,3), ... at every level.  Every element of level l carries the same
    ``a = lp_kk * 2**l`` (doubling is exact), so only v is computed.  The
    value at k depends on elements <= k only, so any padding of K gives
    the same result there."""

    def scan(v, a):
        n = v.shape[1]
        if n < 2:
            return v
        red = op(v[:, 0:-1:2] + a, v[:, 1::2])
        odd = scan(red, a + a)
        tail = odd if n % 2 else odd[:, :-1]
        even = op(tail + a, v[:, 2::2])
        out = torch.empty_like(v)
        out[:, 0] = v[:, 0]
        out[:, 2::2] = even
        out[:, 1::2] = odd
        return out

    return scan(c, lp_kk[:, None])


def kstate_chain_max(c: torch.Tensor, lp_kk: torch.Tensor) -> torch.Tensor:
    """The Viterbi K chain: K[k] = max(c[k], K[k-1] + lp_kk)."""
    return _kstate_chain(c, lp_kk, torch.maximum)


def kstate_chain_logsum(c: torch.Tensor, lp_kk: torch.Tensor) -> torch.Tensor:
    """The Forward K chain: K[k] = logaddexp(c[k], K[k-1] + lp_kk)."""
    return _kstate_chain(c, lp_kk, add_logs_exact)


def viterbi_fill_plain(levels, n_events, mu, sigma, c, n_kmers, trans,
                       clips) -> torch.Tensor:
    """Viterbi fill (r9.inl:265-433) with trace, vectorized over segments.

    Args (tensors on one device): levels [B, T] f32, n_events [B] i32,
    mu/sigma/c [B, K] f32, n_kmers [B] i32, trans [B, 8] f32 (TRANS_COLS),
    clips [B, 2] bool (pre-clip, post-clip allowed).
    Returns trace [B, T, K] uint8; rows >= n_events are unspecified.
    """
    B, T = levels.shape
    K = mu.shape[1]
    dev = levels.device
    f32 = torch.float32
    tr = trans.to(f32)
    col = {name: tr[:, i:i + 1] for i, name in enumerate(TRANS_COLS)}
    lp_kk = tr[:, 6]
    pre_clip = clips[:, 0].to(torch.bool)
    nev = n_events.to(torch.int64)
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)  # noqa: E731

    trace = torch.zeros((B, T, K), dtype=torch.uint8, device=dev)
    M = torch.full((B, K), NEG_INF, dtype=f32, device=dev)
    Bs = torch.full_like(M, NEG_INF)
    Ks = torch.full_like(M, NEG_INF)
    k0 = (torch.arange(K, device=dev) == 0)[None, :]
    t_max = int(nev.max()) if B else 0

    for t in range(1, t_max + 1):
        em = log_normal_fused(levels[:, t - 1:t], mu, sigma, c)

        soft_ok = pre_clip | (t == 1)
        pre_val = flank(torch.full((B,), float(t - 1), dtype=f32, device=dev))
        s_soft = torch.where(k0 & (soft_ok & (t <= nev))[:, None],
                             pre_val[:, None], NEG_INF)

        x0 = col["lp_mm_self"] + M           # FROM_SAME_M
        x1 = col["lp_mm_next"] + _shift_prev(M)   # FROM_PREV_M
        x2 = col["lp_b3"] + Bs               # FROM_SAME_B
        x3 = col["lp_b3"] + _shift_prev(Bs)  # FROM_PREV_B
        x4 = col["lp_km"] + _shift_prev(Ks)  # FROM_PREV_K
        x5 = s_soft                          # FROM_SOFT
        m_in = torch.maximum(torch.maximum(torch.maximum(x0, x1),
                                           torch.maximum(x2, x3)),
                             torch.maximum(x4, x5))
        # tie-break: the reference takes the LAST equal index (r9.inl:140-146)
        trM = torch.zeros((B, K), dtype=torch.uint8, device=dev)
        for idx, x in ((HMT_FROM_PREV_M, x1), (HMT_FROM_SAME_B, x2),
                       (HMT_FROM_PREV_B, x3), (HMT_FROM_PREV_K, x4),
                       (HMT_FROM_SOFT, x5)):
            trM = torch.where(x == m_in, u8(idx), trM)
        M_new = m_in + em

        b0 = col["lp_mb"] + M                # FROM_SAME_M
        b2 = col["lp_bb"] + Bs               # FROM_SAME_B
        B_new = torch.maximum(b0, b2)        # bad events emit 0
        trB = (b2 == B_new).to(torch.uint8)

        cM = col["lp_mk"] + _shift_prev(M_new)   # FROM_PREV_M (same row)
        cB = col["lp_b3"] + _shift_prev(B_new)   # FROM_PREV_B
        K_new = kstate_chain_max(torch.maximum(cM, cB), lp_kk)
        kk_prev = _shift_prev(K_new) + lp_kk[:, None]
        trK = torch.full((B, K), HMT_FROM_PREV_M, dtype=torch.uint8,
                         device=dev)
        trK = torch.where(cB == K_new, u8(HMT_FROM_PREV_B), trK)
        trK = torch.where(kk_prev == K_new, u8(HMT_FROM_PREV_K), trK)

        trace[:, t - 1, :] = trM | (trB << 3) | (trK << 4)
        M, Bs, Ks = M_new, B_new, K_new
    return trace


def forward_fill_plain(levels, n_events, mu, sigma, c, n_kmers, trans,
                       clips) -> torch.Tensor:
    """Forward fill (r9.inl:265-433 with logsum), vectorized over segments.

    Takes the inputs of ``viterbi_fill_plain``; returns the log-likelihood
    lp_end [B] f32 (-inf for a segment without events).  Rows past a
    segment's n_events and kmers past its n_kmers never reach its score.
    """
    B, T = levels.shape
    K = mu.shape[1]
    dev = levels.device
    f32 = torch.float32
    tr = trans.to(f32)
    col = {name: tr[:, i:i + 1] for i, name in enumerate(TRANS_COLS)}
    lp_kk = tr[:, 6]
    pre_clip = clips[:, 0].to(torch.bool)
    post_clip = clips[:, 1].to(torch.bool)
    nev = n_events.to(torch.int64)
    nev_f = n_events.to(f32)
    last = (n_kmers.to(torch.int64) - 1).clamp(0, K - 1)[:, None]
    add = add_logs_exact

    M = torch.full((B, K), NEG_INF, dtype=f32, device=dev)
    Bs = torch.full_like(M, NEG_INF)
    Ks = torch.full_like(M, NEG_INF)
    lp_end = torch.full((B,), NEG_INF, dtype=f32, device=dev)
    k0 = (torch.arange(K, device=dev) == 0)[None, :]
    t_max = int(nev.max()) if B else 0

    for t in range(1, t_max + 1):
        em = log_normal_fused(levels[:, t - 1:t], mu, sigma, c)

        soft_ok = pre_clip | (t == 1)
        pre_val = flank(torch.full((B,), float(t - 1), dtype=f32, device=dev))
        s_soft = torch.where(k0 & (soft_ok & (t <= nev))[:, None],
                             pre_val[:, None], NEG_INF)

        x0 = col["lp_mm_self"] + M           # FROM_SAME_M
        x1 = col["lp_mm_next"] + _shift_prev(M)   # FROM_PREV_M
        x2 = col["lp_b3"] + Bs               # FROM_SAME_B
        x3 = col["lp_b3"] + _shift_prev(Bs)  # FROM_PREV_B
        x4 = col["lp_km"] + _shift_prev(Ks)  # FROM_PREV_K
        x5 = s_soft                          # FROM_SOFT
        m_in = add(add(add(add(add(x0, x1), x2), x3), x4), x5)
        M_new = m_in + em
        B_new = add(col["lp_mb"] + M, col["lp_bb"] + Bs)   # bad events emit 0

        cM = col["lp_mk"] + _shift_prev(M_new)   # FROM_PREV_M (same row)
        cB = col["lp_b3"] + _shift_prev(B_new)   # FROM_PREV_B
        K_new = kstate_chain_logsum(add(cM, cB), lp_kk)

        # end contributions (r9.inl:385-396); lp_ms = 0
        s3 = add(add(M_new.gather(1, last)[:, 0], B_new.gather(1, last)[:, 0]),
                 K_new.gather(1, last)[:, 0])
        cand = s3 + flank(nev_f - float(t))       # post_flank[t-1]
        allowed = torch.where(post_clip, t <= nev, t == nev)
        lp_end = torch.where(allowed, add(lp_end, cand), lp_end)
        M, Bs, Ks = M_new, B_new, K_new
    return lp_end


def gather_indexed(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids):
    """The flat per-segment inputs of ``forward_fill_plain`` gathered from
    the indexed ones (``forward_indexed_plain``): levels [n, Tc],
    n_events [n], mu/sigma/c [n, Kc], n_kmers [n], trans [n, 8].  Kmers
    past a segment's n_kmers get mu 0, sigma 1 and the c of sigma 1, the
    padding of ``prepare_viterbi_inputs``."""
    ids = ids.long()
    ev, tab, rid, tid = ids[:, 0], ids[:, 1], ids[:, 2], ids[:, 3]
    S = tabs.shape[2]
    n_km = n_km_u[rid]
    kmask = torch.arange(rank_mat.shape[1], device=ids.device)[None, :] < \
        n_km[:, None].long()
    flat = tab[:, None] * S + rank_mat[rid].long()

    def take(row, pad):
        return torch.where(kmask, tabs[row].reshape(-1)[flat],
                           torch.tensor(pad, dtype=torch.float32,
                                        device=ids.device))

    return (levels_u[ev], n_ev_u[ev], take(0, 0.0), take(1, 1.0),
            take(2, PAD_C), n_km, trans_u[tid])


def forward_indexed_plain(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u,
                          ids, clips) -> torch.Tensor:
    """Forward log-likelihood [n] f32 per segment from indexed inputs: the
    plain version of ``csrc/forward_indexed.cu``.

    Args (tensors on one device): levels_u [E, Tc] f32 drift-corrected
    levels in traversal order, n_ev_u [E] i32, tabs [3, R, S] f32 per-read
    mu / sigma / c (``c = LOG_INV_SQRT_2PI - log(sigma)``, as
    ``prepare_viterbi_inputs`` computes it), rank_mat [U, Kc] i32 kmer
    ranks (padding entries must be valid ranks, e.g. 0), n_km_u [U] i32,
    trans_u [R2, 8] f32 (TRANS_COLS), ids [n, 4] i32 (event row, table
    row, rank row, transition row), clips [n, 2] (pre-clip, post-clip).
    A segment's score equals ``forward_fill_plain`` on its gathered flat
    inputs bit for bit, whatever Tc, Kc and batch it is scored in."""
    lv, nev, mu, sigma, c, nk, trans = gather_indexed(
        levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids)
    return forward_fill_plain(lv, nev, mu, sigma, c, nk, trans, clips)


def viterbi_backtrack_plain(trace, n_events, n_kmers) -> torch.Tensor:
    """Traceback (r9.cpp:73-204) from (row=n_events, kmer=n_kmers-1, M);
    K states are silent (the row does not decrement).  A walk that would
    leave the kmer axis stops there.  Returns path [B, 1 + T + K] int32
    (see module docstring)."""
    B, T, K = trace.shape
    dev = trace.device
    i64 = torch.int64
    L = T + K
    rows = torch.arange(B, device=dev)
    row = n_events.to(i64).clone()
    ki = n_kmers.to(i64) - 1
    st = torch.full((B,), PSR9_MATCH, dtype=i64, device=dev)
    done = row <= 0
    length = torch.zeros(B, dtype=i64, device=dev)
    path = torch.zeros((B, 1 + L), dtype=i64, device=dev)
    for step in range(L):
        act = ~done
        if not bool(act.any()):
            break
        cell = ((row - 1) << PATH_EVENT_SHIFT) | (ki << PATH_KMER_SHIFT) | st
        path[:, 1 + step] = torch.where(act, cell, 0)
        length = length + act.to(i64)
        byte = trace[rows, (row - 1).clamp(0, T - 1),
                     ki.clamp(0, K - 1)].to(i64)
        mv = torch.where(st == PSR9_MATCH, byte & 7,
                         torch.where(st == PSR9_BAD_EVENT,
                                     torch.where((byte >> 3) & 1 > 0,
                                                 HMT_FROM_SAME_B,
                                                 HMT_FROM_SAME_M),
                                     (byte >> 4) & 7))
        soft = act & (mv == HMT_FROM_SOFT)
        step_on = act & ~soft
        prev_k = (mv == HMT_FROM_PREV_M) | (mv == HMT_FROM_PREV_B) | \
            (mv == HMT_FROM_PREV_K)
        nxt_st = torch.where((mv == HMT_FROM_SAME_M) | (mv == HMT_FROM_PREV_M),
                             PSR9_MATCH,
                             torch.where((mv == HMT_FROM_SAME_B) |
                                         (mv == HMT_FROM_PREV_B),
                                         PSR9_BAD_EVENT, PSR9_KMER_SKIP))
        row = torch.where(step_on & (st != PSR9_KMER_SKIP), row - 1, row)
        ki = torch.where(step_on & prev_k, ki - 1, ki)
        st = torch.where(step_on, nxt_st, st)
        done = done | soft | (row <= 0) | (ki < 0)
    path[:, 0] = length
    return path.to(torch.int32)


def paths_to_segments(path: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    """Host expansion of packed traceback paths into per-segment
    (event_offsets, kmer_idxs, state_string) in forward order; the event
    offset is 0-based within the segment (row - 1)."""
    path = np.asarray(path)
    out = []
    for b in range(path.shape[0]):
        n = int(path[b, 0])
        cells = path[b, 1:1 + n][::-1].astype(np.int64)
        evs = (cells >> PATH_EVENT_SHIFT).astype(np.int32)
        kms = ((cells >> PATH_KMER_SHIFT) & (MAX_KMERS - 1)).astype(np.int32)
        chars = np.frombuffer(b"KBM", np.uint8)[cells & 3]
        out.append((evs, kms, chars.tobytes().decode("ascii")))
    return out
