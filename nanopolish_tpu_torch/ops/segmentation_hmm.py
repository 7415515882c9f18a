"""Sample-level segmentation Viterbi for poly(A)/poly(I) tail calling.

Rebuild of SegmentationHMM (reference: src/nanopolish_polya_estimator.cpp:
176-520): a 6-state HMM (START -> LEADER -> ADAPTER -> [POLYA <-> CLIFF]
-> TRANSCRIPT) decoded over RAW samples with per-read scaled Gaussian,
uniform and mixture emissions.

This module holds the plain PyTorch versions of the two CUDA kernels
wrapped by ``ops/segmentation_viterbi.py`` (``csrc/seg_viterbi_fill.cu``,
``csrc/seg_backtrack.cu``), with the same contract:

  * ``seg_viterbi_fill_plain``: samples ``[N, B]`` f32 (sample-major),
    ``n_samples [B]`` i32, per-read ``(scale, shift, var)`` ``[B, 3]`` f32
    -> backpointers ``[N, B]`` uint8, one byte per (sample, read), and the
    final scores ``[B, 6]`` f32 (after sample ``n - 1``).  The emissions of
    all samples are computed at once; only the 6-state recurrence runs in
    the step loop.  Byte layout (S always points to S): bit 0 L<-L, bit 1
    A<-A, bits 2-3 P's source (0 P, 1 A, 2 C), bit 4 C<-C, bit 5 T<-T.
    Row 0 and rows past a read's length are 0.
  * ``seg_backtrack_plain``: the labels ``[N, B]`` uint8 (T past a read's
    length) and their ``[B, 5]`` i32 summary: the last S->L, L->A, A->P,
    P->T transition index (-1 if none) and the number of CLIFF samples.

Both follow the JAX package's scan path (``_segmentation_viterbi`` and
``_backward_labels``): the first state vector is S = the emission of the
LAST sample, the rest NEG (a quirk of the reference); C's emission is
-inf outside its band; backpointers use the reference's strict-< tie
rules; labels follow ``label[t] = bptr[t][label[t + 1]]`` for
``1 <= t <= n - 2``, with ``label[n - 1] = T`` and ``label[0] = S``.
Every constant is rounded to f32 once on the host (``seg_constants``) and
each operation rounds once, so the kernel equals this version bit for bit
on the card.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

S, L, A, P, C, T = range(6)
NEG = -1.0e30

# backpointer bytes allowed in flight per launch; a batch is cut into
# launches (reads sorted by length, longest first) only as far as this
# needs
BPTR_CAP_BYTES = 256 << 20


@dataclass(frozen=True)
class SegmentationParams:
    """Emission/transition constants (polya_estimator.cpp:209-250).
    detect-polyi overrides a subset (nanopolish_detect_polyi.cpp)."""

    # transitions (dense rows: S, L, A, P, C, T)
    trans: Tuple = (
        (0.10, 0.90, 0.00, 0.00, 0.00, 0.00),
        (0.00, 0.90, 0.10, 0.00, 0.00, 0.00),
        (0.00, 0.00, 0.95, 0.05, 0.00, 0.00),
        (0.00, 0.00, 0.00, 0.89, 0.01, 0.10),
        (0.00, 0.00, 0.00, 0.99, 0.01, 0.00),
        (0.00, 0.00, 0.00, 0.00, 0.00, 1.00),
    )
    s_emission: Tuple[float, float] = (70.2737, 3.7743)
    s_prob: float = 0.00476
    s_norm_coeff: float = 0.50
    s_unif_coeff: float = 0.50
    l_emission: Tuple[float, float] = (110.973, 5.237)
    a0_emission: Tuple[float, float] = (79.347, 8.3702)
    a1_emission: Tuple[float, float] = (63.3126, 2.7464)
    a0_coeff: float = 0.874
    a1_coeff: float = 0.126
    p_emission: Tuple[float, float] = (108.883, 3.257)
    # detect-polyi models P as a two-Gaussian mixture; p1_emission=None
    # selects the single-Gaussian polya behavior
    p1_emission: Tuple[float, float] = None
    p0_coeff: float = 0.5
    p1_coeff: float = 0.5
    c_begin: float = 70.0
    c_end: float = 140.0
    c_log_prob: float = -4.2485
    t0_emission: Tuple[float, float] = (79.679, 6.966)
    t1_emission: Tuple[float, float] = (105.784, 16.022)
    t0_coeff: float = 0.346
    t1_coeff: float = 0.654


def segmentation_params_from_dict(d) -> SegmentationParams:
    """SegmentationParams from a ``dataclasses.asdict``-style mapping
    (lists become tuples, so the result stays hashable)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, (list, tuple)) else v
    names = {f.name for f in dataclasses.fields(SegmentationParams)}
    return SegmentationParams(**{k: tup(v) for k, v in d.items()
                                 if k in names})


class Segmentation(NamedTuple):
    """Final sample index of each region (polya_estimator.cpp:176-183)."""

    start: int
    leader: int
    adapter: int
    polya: int
    cliffs: int


# ---- the f32 constants both versions read (seg_constants layout) ----
N_CONSTS = 48
# Gaussians, (mean, stdv) pairs at 2*g
G_S, G_L, G_A0, G_A1, G_P, G_P1, G_T0, G_T1 = range(8)
K_S_NORM, K_S_UNIF, K_A0, K_A1, K_P0, K_P1, K_T0, K_T1 = range(16, 24)
K_C_BEGIN, K_C_END, K_C_LOG = 24, 25, 26
K_LT = 27            # 12 log transitions, in the order of _SRC
K_DPI = 39           # 1.0 when P is a two-Gaussian mixture
K_SQRT_2PI, K_HALF_LOG_2PI = 40, 41

# the twelve scored transitions: source state of each, and (from, to)
_SRC = (S, S, L, L, A, A, P, P, P, C, C, T)
_EDGES = ((S, S), (S, L), (L, L), (L, A), (A, A), (A, P), (P, P), (P, C),
          (P, T), (C, C), (C, P), (T, T))
# candidates of each new state (by index into the twelve): the state
# itself, then its other sources (repeated where there is only one)
_MAX3 = ((0, 2, 4, 6, 9, 8), (0, 1, 3, 5, 7, 11), (0, 1, 3, 10, 7, 11))
# the backpointer comparisons lhs < rhs: SL<LL, LA<AA, AP<PP, CP<PP,
# PP<AP, CP<AP, PC<CC, PT<TT
_CMP = ((1, 3, 5, 10, 6, 10, 7, 8), (2, 4, 6, 6, 5, 5, 9, 11))


def seg_constants(params: SegmentationParams) -> np.ndarray:
    """The f32 constants of the emissions and transitions, rounded once
    here: each as the JAX scan path rounds its Python float operand."""
    k = np.zeros(N_CONSTS, np.float64)
    gauss = {G_S: params.s_emission, G_L: params.l_emission,
             G_A0: params.a0_emission, G_A1: params.a1_emission,
             G_P: params.p_emission,
             G_P1: params.p1_emission if params.p1_emission is not None
             else (0.0, 1.0),
             G_T0: params.t0_emission, G_T1: params.t1_emission}
    for g, (mean, stdv) in gauss.items():
        k[2 * g], k[2 * g + 1] = mean, stdv
    k[K_S_NORM] = params.s_norm_coeff
    k[K_S_UNIF] = params.s_unif_coeff * params.s_prob
    k[K_A0], k[K_A1] = params.a0_coeff, params.a1_coeff
    k[K_P0], k[K_P1] = params.p0_coeff, params.p1_coeff
    k[K_T0], k[K_T1] = params.t0_coeff, params.t1_coeff
    k[K_C_BEGIN], k[K_C_END] = params.c_begin, params.c_end
    k[K_C_LOG] = params.c_log_prob
    for j, (a, b) in enumerate(_EDGES):
        p = params.trans[a][b]
        k[K_LT + j] = math.log(p) if p > 0 else NEG
    k[K_DPI] = 1.0 if params.p1_emission is not None else 0.0
    k[K_SQRT_2PI] = math.sqrt(2 * math.pi)
    k[K_HALF_LOG_2PI] = 0.5 * math.log(2 * math.pi)
    return k.astype(np.float32)


def _emissions(x, scal, k):
    """x [N, B] (or [B]) samples -> [..., B, 6] log emissions, in the
    kernel's per-operation f32 rounding.  scal [B, 3] = scale, shift,
    var; k the seg_constants array."""
    kf = [float(v) for v in k]
    scale, shift, var = scal[:, 0], scal[:, 1], scal[:, 2]
    xx = torch.where((x > 200.0) | (x < 40.0), 100.0, x)

    def gauss(g):
        mu = shift + scale * kf[2 * g]
        sd = var * kf[2 * g + 1]
        return mu, sd

    def norm_pdf(g):
        mu, sd = gauss(g)
        z = (xx - mu) / sd
        return torch.exp((-0.5 * z) * z) / (sd * kf[K_SQRT_2PI])

    def log_norm_pdf(g):
        mu, sd = gauss(g)
        z = (xx - mu) / sd
        return ((-0.5 * z) * z - torch.log(sd)) - kf[K_HALF_LOG_2PI]

    def mix(c0, g0, c1, g1):
        return torch.log(kf[c0] * norm_pdf(g0) + kf[c1] * norm_pdf(g1))

    e_s = torch.log(kf[K_S_NORM] * norm_pdf(G_S) + kf[K_S_UNIF])
    e_l = log_norm_pdf(G_L)
    e_a = mix(K_A0, G_A0, K_A1, G_A1)
    e_p = mix(K_P0, G_P, K_P1, G_P1) if kf[K_DPI] else log_norm_pdf(G_P)
    e_c = torch.where((xx > kf[K_C_BEGIN]) & (xx < kf[K_C_END]),
                      kf[K_C_LOG], -math.inf)
    e_t = mix(K_T0, G_T0, K_T1, G_T1)
    return torch.stack([e_s, e_l, e_a, e_p, e_c, e_t], dim=-1)


def seg_viterbi_fill_plain(samples, n_samples, scal, consts):
    """Plain version of csrc/seg_viterbi_fill.cu (see module docstring).
    Returns (bptr [N, B] uint8, final scores [B, 6] f32)."""
    N, B = samples.shape
    dev = samples.device
    f32 = torch.float32
    n = n_samples.to(torch.int64)
    em = _emissions(samples, scal, consts)                   # [N, B, 6]
    last = samples[(n - 1).clamp(min=0), torch.arange(B, device=dev)]
    v = torch.full((B, 6), NEG, dtype=f32, device=dev)
    v[:, S] = _emissions(last, scal, consts)[:, S]
    lt = torch.as_tensor(consts[K_LT:K_LT + 12], dtype=f32, device=dev)
    src = torch.tensor(_SRC, device=dev)
    max3 = torch.tensor(_MAX3, device=dev).reshape(-1)
    cmp_idx = torch.tensor(_CMP, device=dev).reshape(-1)
    cmp = torch.zeros((N, B, 8), dtype=torch.bool, device=dev)
    for t in range(1, N):
        c = v[:, src] + lt                                  # [B, 12]
        nv = c[:, max3].view(B, 3, 6).amax(dim=1) + em[t]
        pair = c[:, cmp_idx].view(B, 2, 8)
        cmp[t] = pair[:, 0] < pair[:, 1]
        v = torch.where((t < n)[:, None], nv, v)
    u8 = torch.uint8
    code_p = torch.where(cmp[..., 2] & cmp[..., 3], 0,
                         torch.where(cmp[..., 4] & cmp[..., 5], 1, 2))
    bptr = (cmp[..., 0].to(u8) | (cmp[..., 1].to(u8) << 1)
            | (code_p.to(u8) << 2) | (cmp[..., 6].to(u8) << 4)
            | (cmp[..., 7].to(u8) << 5))
    t = torch.arange(N, device=dev)[:, None]
    live = (t >= 1) & (t < n[None, :])
    return torch.where(live, bptr, 0).to(u8), v


def _decode_table(dev) -> torch.Tensor:
    """[64, 6]: the predecessor state of each state under one byte."""
    tab = np.zeros((64, 6), np.uint8)
    for byte in range(64):
        code = (byte >> 2) & 3
        tab[byte] = (S, L if byte & 1 else S, A if byte & 2 else L,
                     P if code == 0 else (A if code == 1 else C),
                     C if byte & 16 else P, T if byte & 32 else P)
    return torch.as_tensor(tab, device=dev)


def seg_summary_plain(labels, n_samples) -> torch.Tensor:
    """[B, 5] i32: last S->L, L->A, A->P, P->T transition index among
    ``[0, n - 1)`` (-1 if none) and the CLIFF count among ``[0, n)``."""
    N, B = labels.shape
    dev = labels.device
    lab = labels.to(torch.int64)
    n = n_samples.to(torch.int64)[None, :]
    i = torch.arange(N - 1, device=dev)[:, None]
    tmask = (i + 1) < n
    cur, nxt = lab[:-1], lab[1:]
    none = torch.full((1, B), -1, dtype=torch.int64, device=dev)

    def lastidx(a, b):
        hit = torch.where((cur == a) & (nxt == b) & tmask, i, -1)
        return torch.cat([none, hit]).amax(dim=0)

    vmask = torch.arange(N, device=dev)[:, None] < n
    cliffs = ((lab == C) & vmask).sum(dim=0)
    return torch.stack([lastidx(S, L), lastidx(L, A), lastidx(A, P),
                        lastidx(P, T), cliffs], dim=1).to(torch.int32)


def seg_backtrack_plain(bptr, n_samples):
    """Plain version of csrc/seg_backtrack.cu: (summary [B, 5] i32,
    labels [N, B] uint8)."""
    N, B = bptr.shape
    dev = bptr.device
    n = n_samples.to(torch.int64)
    prev_of = _decode_table(dev)[bptr.to(torch.int64) & 63]  # [N, B, 6] u8
    state = torch.full((B,), T, dtype=torch.int64, device=dev)
    labels = torch.full((N, B), T, dtype=torch.uint8, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(N - 1, -1, -1):
        prev = prev_of[t, rows, state].to(torch.int64)
        active = (t >= 1) & (t <= n - 2)
        new_state = torch.where(active, prev, state)
        last = t == n - 1
        label = torch.where(last, T, S if t == 0 else new_state)
        state = torch.where(last, T, new_state)
        labels[t] = torch.where(t < n, label, T).to(torch.uint8)
    return seg_summary_plain(labels, n_samples), labels


def _extract_segmentation(labels: np.ndarray) -> Segmentation:
    """Segmentation of one read's label array (polya_estimator.cpp:
    466-508)."""
    labels = np.asarray(labels)
    cur, nxt = labels[:-1], labels[1:]
    idx = np.arange(len(cur))

    def last(a, b):
        m = (cur == a) & (nxt == b)
        return int(idx[m][-1]) if m.any() else -1

    return segmentation_from_summary(
        (last(S, L), last(L, A), last(A, P), last(P, T),
         int((labels == C).sum())), len(labels))


def segmentation_from_summary(row, n: int) -> Segmentation:
    """One summary row (``seg_summary_plain``'s columns) of an n-sample
    read -> Segmentation, with the reference's defaulting: a missing
    transition keeps its default index (0, 1, 2, 3), and when the leader,
    adapter or poly(A) index EQUALS its default (missing or not) the three
    become n-3, n-2, n-1."""
    s_, l_, a_, p_, cliffs = (int(x) for x in row)
    start = s_ if s_ >= 0 else 0
    leader = l_ if l_ >= 0 else 1
    adapter = a_ if a_ >= 0 else 2
    polya = p_ if p_ >= 0 else 3
    if leader == 1 or adapter == 2 or polya == 3:
        leader, adapter, polya = n - 3, n - 2, n - 1
    return Segmentation(start=start, leader=leader, adapter=adapter,
                        polya=polya, cliffs=cliffs)


def plan_launches(lens_desc: np.ndarray, cap_bytes: int
                  ) -> List[Tuple[int, int, int]]:
    """Cut reads sorted by length (longest first) into launches
    ``(lo, hi, N)`` whose ``N x reads`` backpointer bytes stay within
    cap_bytes (a read longer than the cap gets a launch of its own)."""
    out = []
    lo, B = 0, len(lens_desc)
    while lo < B:
        N = max(int(lens_desc[lo]), 1)
        hi = min(B, lo + max(1, cap_bytes // N))
        out.append((lo, hi, N))
        lo = hi
    return out


def segment_reads(samples_list: List[np.ndarray], scalings_list,
                  params: SegmentationParams = None, device=None
                  ) -> List[Segmentation]:
    """Batched segmentation of raw sample arrays on ``device`` (``cuda``
    unless ``cpu`` is asked).  scalings_list: per-read (scale, shift,
    var).  Reads are sorted by length and cut into launches only as far
    as BPTR_CAP_BYTES of backpointers needs; the samples go up in one
    copy and the [B, 5] summaries come back in one."""
    from .segmentation_viterbi import seg_backtrack, seg_viterbi_fill

    dev = resolve_device(device)
    params = params if params is not None else SegmentationParams()
    B = len(samples_list)
    if B == 0:
        return []
    lens = np.array([len(s) for s in samples_list], np.int64)
    if (lens < 1).any():
        raise ValueError("segment_reads: every read needs at least one sample")
    order = np.argsort(-lens, kind="stable")
    launches = plan_launches(lens[order], BPTR_CAP_BYTES)
    # one f32 wire: [scalings B x 3 | n_samples B (i32 bits) | per launch
    # its samples [N, reads], sample-major, padded with 100.0]
    offs, off = [], 4 * B
    for lo, hi, N in launches:
        offs.append(off)
        off += N * (hi - lo)
    wire = np.empty(off, np.float32)
    wire[:3 * B] = np.asarray(scalings_list, np.float32)[order].reshape(-1)
    wire[3 * B:4 * B].view(np.int32)[:] = lens[order]
    for (lo, hi, N), o in zip(launches, offs):
        block = np.full((N, hi - lo), 100.0, np.float32)
        for j in range(lo, hi):
            s = samples_list[order[j]]
            block[:len(s), j - lo] = s
        wire[o:o + block.size] = block.reshape(-1)
    dwire = torch.from_numpy(wire).to(dev)
    scal = dwire[:3 * B].view(B, 3)
    n_dev = dwire[3 * B:4 * B].view(torch.int32)
    consts = seg_constants(params)
    summary = torch.empty((B, 5), dtype=torch.int32, device=dev)
    for (lo, hi, N), o in zip(launches, offs):
        smp = dwire[o:o + N * (hi - lo)].view(N, hi - lo)
        bptr, _ = seg_viterbi_fill(smp, n_dev[lo:hi], scal[lo:hi], consts)
        seg_backtrack(bptr, n_dev[lo:hi], out=summary[lo:hi])
    summ = summary.cpu().numpy()
    out: List[Segmentation] = [None] * B
    for j, i in enumerate(order):
        out[i] = segmentation_from_summary(summ[j], int(lens[i]))
    return out
