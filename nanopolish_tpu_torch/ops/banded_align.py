"""Adaptive banded event alignment — the per-read load-time DP, plain
PyTorch version.

Behavioral spec: ``adaptive_banded_simple_event_align``
(reference: src/nanopolish_raw_loader.cpp:77-379), a Suzuki-Kasahara-style
anti-diagonal banded Viterbi aligning raw events to the basecalled sequence
with a 100-wide adaptive band.

This module is the plain version of the two CUDA kernels in
``ops/banded_exact.py`` (``csrc/banded_fill.cu``,
``csrc/banded_backtrack.cu``): a Python loop over bands, vectorized over
reads, that produces exactly the kernels' outputs.

  * ``banded_fill_plain`` walks the (T+1)+(K+1) anti-diagonal bands.  The
    band lives on a 128-wide offset axis (offsets 100..127 are always
    -inf); each band's placement (down/right) follows Suzuki's rule on the
    two band-edge scores; scores are f32 in the reference's operation
    order with ties broken L > U > D.  Output: 2-bit moves packed four
    cells per byte, ``trace[B, n_bands, 32]`` (cell o at byte o // 4, bits
    2*(o % 4)), one placement bit per band ``moves[B, n_bands]``
    (1 = right), the lower-left event of the last band, and the best
    trailing-trim end cell of the last kmer.
  * ``banded_backtrack_plain`` replays the walk from the best end cell,
    band by band, and returns the base->event map, the summed emission
    and the walk statistics.
  * ``finish_banded`` turns those into a ``BandedAlignResult`` with the
    reference's QC.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .emissions import LOG_INV_SQRT_2PI, fma32, log_normal_fused

BANDWIDTH = 100          # ALN_BANDWIDTH (raw_loader.cpp:72)
LANES = 128              # band offsets held per band (100 used)
HALF_BANDWIDTH = BANDWIDTH // 2
TRACE_BYTES = LANES // 4  # 2-bit moves, four cells per byte

# transition/trim constants (raw_loader.cpp:98-108)
LP_SKIP = math.log(1e-10)
LP_TRIM = math.log(0.01)

# QC constants (raw_loader.cpp:90-92)
MIN_AVG_LOG_EMISSION = -5.0
MAX_GAP_THRESHOLD = 50

FROM_D, FROM_U, FROM_L = 0, 1, 2

NEG_INF = float("-inf")
INT32_MAX = 2 ** 31 - 1


class BandedAlignResult(NamedTuple):
    """Per-read outputs of the batched banded alignment (tensors)."""

    b2e_start: torch.Tensor       # [B, K] int32, first event per kmer, -1 if none
    b2e_stop: torch.Tensor        # [B, K] int32
    failed: torch.Tensor          # [B] bool (QC: emission/spanned/max-gap)
    avg_log_emission: torch.Tensor  # [B] f32
    spanned: torch.Tensor         # [B] bool
    max_gap: torch.Tensor         # [B] int32
    events_per_base: torch.Tensor  # [B] f32 ((max_ev-min_ev)/n_kmers)
    n_pairs: torch.Tensor         # [B] int32


def transition_params_f32(n_events, n_kmers):
    """lp_stay/lp_step per read (raw_loader.cpp:98-107), f64 math -> f32,
    computed on the host.  Returns two [B] float32 arrays."""
    epk = np.asarray(n_events, np.float64).reshape(-1) / np.maximum(
        np.asarray(n_kmers, np.float64).reshape(-1), 1)
    p_stay = 1.0 - 1.0 / (epk + 1.0)
    lp_stay = np.log(p_stay)
    lp_step = np.log(1.0 - math.exp(LP_SKIP) - np.exp(lp_stay))
    return lp_stay.astype(np.float32), lp_step.astype(np.float32)


def emission_constant(log_sigma) -> np.ndarray:
    """Host-side f32 ``LOG_INV_SQRT_2PI - log(sigma)`` per kmer."""
    return np.float32(LOG_INV_SQRT_2PI) - np.asarray(log_sigma, np.float32)


def n_bands_for(T: int, K: int) -> int:
    return (T + 1) + (K + 1)


def _shift_left(x, fill):
    # out[o] = x[o+1]
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shift_right(x, fill):
    # out[o] = x[o-1]
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """[B, 128] uint8 2-bit codes -> [B, 32] bytes (cell o at byte o//4,
    bits 2*(o%4))."""
    c = codes.view(codes.shape[0], TRACE_BYTES, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | \
        (c[:, :, 3] << 6)


def banded_fill_plain(event_mean, n_events, mu, sigma, c, n_kmers,
                      lp_stay, lp_step):
    """Forward band fill (raw_loader.cpp:110-300), vectorized over reads.

    Args (tensors on one device): event_mean [B, T] f32, n_events [B]
    i32, mu/sigma/c [B, K] f32 (c = LOG_INV_SQRT_2PI - log sigma),
    n_kmers [B] i32, lp_stay/lp_step [B] f32.
    Returns (trace [B, n_bands, 32] u8, moves [B, n_bands] u8,
    ll_e_last [B] i32, best_e [B] i32, best_s [B] f32).
    """
    B, T = event_mean.shape
    K = mu.shape[1]
    dev = event_mean.device
    n_bands = n_bands_for(T, K)
    f32, i64 = torch.float32, torch.int64
    offs = torch.arange(LANES, device=dev, dtype=i64)[None, :]
    lane_valid = offs < BANDWIDTH
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    lp_skip = torch.tensor(float(np.float32(LP_SKIP)), dtype=f32, device=dev)
    lp_trim = torch.tensor(float(np.float32(LP_TRIM)), dtype=f32, device=dev)
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)  # noqa: E731

    nev = n_events.to(i64)[:, None]
    nk = n_kmers.to(i64)[:, None]
    nev_f = n_events.to(f32)[:, None]
    lps = lp_stay.to(f32)[:, None]
    lpt = lp_step.to(f32)[:, None]

    trace = torch.zeros((B, n_bands, TRACE_BYTES), dtype=torch.uint8,
                        device=dev)
    moves = torch.zeros((B, n_bands), dtype=torch.uint8, device=dev)

    # band 0: score 0 at the central cell (kmer -1, offset 50)
    sp2 = torch.where(offs == HALF_BANDWIDTH, torch.zeros_like(neg), neg
                      ).expand(B, LANES).contiguous()
    # band 1 = move_down(band 0): first-event trim at offset 50
    sp = torch.where(offs == HALF_BANDWIDTH, lp_trim, neg
                     ).expand(B, LANES).contiguous()
    trace[:, 1, HALF_BANDWIDTH // 4] = FROM_U << (2 * (HALF_BANDWIDTH % 4))
    ll_e = torch.full((B,), HALF_BANDWIDTH, dtype=i64, device=dev)
    ll_k = torch.full((B,), -1 - HALF_BANDWIDTH, dtype=i64, device=dev)
    r_prev = torch.zeros((B,), dtype=i64, device=dev)
    best_s = torch.full((B,), NEG_INF, dtype=f32, device=dev)
    best_e = torch.zeros((B,), dtype=i64, device=dev)
    rows = torch.arange(B, device=dev)

    for bi in range(2, n_bands):
        # --- adaptive band placement (raw_loader.cpp:175-195) ---
        ll = sp[:, 0]
        ur = sp[:, BANDWIDTH - 1]
        both_ob = torch.isneginf(ll) & torch.isneginf(ur)
        right = torch.where(both_ob, bool(bi % 2 == 1), ll < ur)
        r = right.to(i64)
        ll_e = ll_e + (1 - r)
        ll_k = ll_k + r

        # --- neighbour bands re-indexed into this band's offsets ---
        # RIGHT: up = sp[o+1], left = sp[o]; DOWN: up = sp[o], left = sp[o-1]
        rb = right[:, None]
        up = torch.where(rb, _shift_left(sp, NEG_INF), sp)
        left = torch.where(rb, sp, _shift_right(sp, NEG_INF))
        # diag = sp2[o - 1 + r_prev + r]
        amt = (r_prev + r - 1)[:, None]
        diag = torch.where(amt == 1, _shift_left(sp2, NEG_INF),
                           torch.where(amt == 0, sp2,
                                       _shift_right(sp2, NEG_INF)))

        # --- cell coordinates + gathers ---
        ei = ll_e[:, None] - offs
        ki = ll_k[:, None] + offs
        ev = torch.gather(event_mean, 1, ei.clamp(0, T - 1))
        kidx = ki.clamp(0, K - 1)
        mu_g = torch.gather(mu, 1, kidx)
        sg_g = torch.gather(sigma, 1, kidx)
        c_g = torch.gather(c, 1, kidx)
        valid = (ei >= 0) & (ei < nev) & (ki >= 0) & (ki < nk) & lane_valid

        em = log_normal_fused(ev, mu_g, sg_g, c_g)

        score_d = (diag + lpt) + em
        score_u = (up + lps) + em
        score_l = left + lp_skip

        # 3-way max with the reference's tie-break (last winner)
        m2 = torch.maximum(score_d, score_u)
        f2 = torch.where(m2 == score_u, u8(FROM_U), u8(FROM_D))
        m3 = torch.maximum(m2, score_l)
        f3 = torch.where(m3 == score_l, u8(FROM_L), f2)

        cell = torch.where(valid, m3, neg)
        code = torch.where(valid, f3, u8(0))

        # --- trim state column (ki == -1), raw_loader.cpp:215-225 ---
        trim_mask = (ki == -1) & (ei >= 0) & (ei < nev) & lane_valid
        trim_val = lp_trim * (ei.to(f32) + 1.0)
        cell = torch.where(trim_mask, trim_val, cell)
        code = torch.where(trim_mask, u8(FROM_U), code)

        # --- best end cell: ki == n_kmers-1, plus trailing trim ---
        end_mask = valid & (ki == nk - 1)
        end_score = fma32(nev_f - ei.to(f32), lp_trim, cell)
        end_score = torch.where(end_mask, end_score, neg)
        cand, arg = torch.max(end_score, dim=1)
        cand_ev = ei[rows, arg]
        better = cand > best_s                   # strict: earliest event wins
        best_s = torch.where(better, cand, best_s)
        best_e = torch.where(better, cand_ev, best_e)

        trace[:, bi, :] = _pack_codes(code)
        moves[:, bi] = r.to(torch.uint8)
        sp2, sp, r_prev = sp, cell, r

    return (trace, moves, ll_e.to(torch.int32), best_e.to(torch.int32),
            best_s)


def band_lower_left_events(moves, ll_e_last):
    """Per-band lower-left event index [B, n_bands] from the placement
    bits: band 0 sits at event 49, band 1 at 50, each down move adds 1."""
    B, n_bands = moves.shape
    ll = torch.empty((B, n_bands), dtype=torch.int64, device=moves.device)
    ll[:, 0] = HALF_BANDWIDTH - 1
    ll[:, 1] = HALF_BANDWIDTH
    if n_bands > 2:
        downs = 1 - moves[:, 2:].to(torch.int64)
        ll[:, 2:] = HALF_BANDWIDTH + torch.cumsum(downs, dim=1)
    return ll


def banded_backtrack_plain(trace, moves, ll_e_last, best_e, event_mean,
                           mu, sigma, c, n_kmers):
    """Reverse walk over bands for all reads at once (raw_loader.cpp:302-362).

    Returns (b2e_start [B, K] i32, b2e_stop [B, K] i32 — before QC
    masking, sum_em [B] f32, stats [B, 5] i32 = n_pairs, max_gap,
    last_ki, min_ev, max_ev).
    """
    B, n_bands, _ = trace.shape
    T = event_mean.shape[1]
    K = mu.shape[1]
    dev = trace.device
    i64 = torch.int64
    ll_all = band_lower_left_events(moves, ll_e_last)
    rows = torch.arange(B, device=dev)

    ki = n_kmers.to(i64) - 1
    ei = best_e.to(i64)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    sum_em = torch.zeros(B, dtype=torch.float32, device=dev)
    n_pairs = torch.zeros(B, dtype=i64, device=dev)
    cur_gap = torch.zeros(B, dtype=i64, device=dev)
    max_gap = torch.zeros(B, dtype=i64, device=dev)
    min_ev = torch.full((B,), INT32_MAX, dtype=i64, device=dev)
    max_ev = torch.full((B,), -1, dtype=i64, device=dev)
    last_ki = torch.full((B,), -1, dtype=i64, device=dev)
    out_k = torch.full((n_bands, B), -1, dtype=i64, device=dev)
    out_e = torch.full((n_bands, B), -1, dtype=i64, device=dev)
    out_ok = torch.zeros((n_bands, B), dtype=torch.bool, device=dev)

    for bi in range(n_bands - 1, -1, -1):
        here = active & ((ei + ki + 2) == bi)
        offset = (ll_all[:, bi] - ei).clamp(0, LANES - 1)
        byte = trace[rows, bi, offset >> 2].to(i64)
        mv = (byte >> (2 * (offset & 3))) & 3

        # emission at the visited cell, for QC (raw_loader.cpp:339-342)
        ec = ei.clamp(0, T - 1)[:, None]
        kc = ki.clamp(0, K - 1)[:, None]
        lp = log_normal_fused(torch.gather(event_mean, 1, ec)[:, 0],
                              torch.gather(mu, 1, kc)[:, 0],
                              torch.gather(sigma, 1, kc)[:, 0],
                              torch.gather(c, 1, kc)[:, 0])

        sum_em = torch.where(here, sum_em + lp, sum_em)
        n_pairs = torch.where(here, n_pairs + 1, n_pairs)
        min_ev = torch.where(here, torch.minimum(min_ev, ei), min_ev)
        max_ev = torch.where(here, torch.maximum(max_ev, ei), max_ev)
        last_ki = torch.where(here, ki, last_ki)

        is_d = mv == FROM_D
        is_u = mv == FROM_U
        is_l = mv == FROM_L
        cur_gap = torch.where(here, torch.where(is_l, cur_gap + 1, 0), cur_gap)
        max_gap = torch.where(here, torch.maximum(max_gap, cur_gap), max_gap)

        # a pair enters the base->event map iff its event differs from the
        # previous (forward-order) pair's event, i.e. the move out of this
        # cell is not a kmer-skip — except for the first forward pair
        terminates = (torch.where(is_u, ki, ki - 1) < 0) | \
            (torch.where(is_l, ei, ei - 1) < 0)
        out_k[bi] = torch.where(here, ki, -1)
        out_e[bi] = torch.where(here, ei, -1)
        out_ok[bi] = here & ((~is_l) | terminates)

        ki = torch.where(here & (is_d | is_l), ki - 1, ki)
        ei = torch.where(here & (is_d | is_u), ei - 1, ei)
        active = active & ~(here & terminates)

    # scatter the (ki -> ei) pairs into the base->event map
    flat = rows[None, :] * K + out_k.clamp(0, K - 1)
    flat = torch.where(out_ok, flat, B * K).reshape(-1)      # dump slot
    evs = out_e.reshape(-1)
    starts = torch.full((B * K + 1,), INT32_MAX, dtype=i64, device=dev)
    starts = starts.scatter_reduce(0, flat, evs, reduce="amin")
    stops = torch.full((B * K + 1,), -1, dtype=i64, device=dev)
    stops = stops.scatter_reduce(0, flat, evs, reduce="amax")
    b2e_start = torch.where(starts[:-1] == INT32_MAX, -1, starts[:-1])
    stats = torch.stack([n_pairs, max_gap, last_ki, min_ev, max_ev], dim=1)
    return (b2e_start.reshape(B, K).to(torch.int32),
            stops[:-1].reshape(B, K).to(torch.int32), sum_em,
            stats.to(torch.int32))


def finish_banded(b2e_start, b2e_stop, sum_em, stats, n_kmers
                  ) -> BandedAlignResult:
    """QC verdicts and the masked base->event map (raw_loader.cpp:363-379)."""
    n_pairs, max_gap, last_ki, min_ev, max_ev = stats.to(torch.int64).unbind(1)
    avg = sum_em / torch.clamp(n_pairs, min=1).to(torch.float32)
    spanned = last_ki == 0                     # first fwd pair at kmer 0
    failed = ((avg < MIN_AVG_LOG_EMISSION) | (~spanned) |
              (max_gap > MAX_GAP_THRESHOLD) | (n_pairs == 0))
    epb = (max_ev - min_ev).to(torch.float32) / torch.clamp(
        n_kmers.to(torch.int64), min=1).to(torch.float32)
    f = failed[:, None]
    return BandedAlignResult(
        b2e_start=torch.where(f, -1, b2e_start),
        b2e_stop=torch.where(f, -1, b2e_stop),
        failed=failed,
        avg_log_emission=avg,
        spanned=spanned,
        max_gap=max_gap.to(torch.int32),
        events_per_base=epb,
        n_pairs=n_pairs.to(torch.int32),
    )


def prepare_banded_inputs(event_mean, n_events, mu, sigma, log_sigma,
                          n_kmers, lp_stay=None, lp_step=None, device=None):
    """Arrays or tensors -> the f32/i32 tensors on ``device`` (``cuda``
    unless ``cpu`` is asked) that both implementations take.  The log
    terms are host-side numpy: the emission constant
    ``LOG_INV_SQRT_2PI - log_sigma`` in f32 and the transition terms of
    ``transition_params_f32``."""
    device = resolve_device(device)
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    def on_dev(x, dt):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=dt).contiguous()
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    nev = host(n_events).reshape(-1)
    nk = host(n_kmers).reshape(-1)
    if lp_stay is None:
        lp_stay, lp_step = transition_params_f32(nev, nk)
    f32, i32 = torch.float32, torch.int32
    return dict(event_mean=on_dev(event_mean, f32), n_events=on_dev(nev, i32),
                mu=on_dev(mu, f32), sigma=on_dev(sigma, f32),
                c=on_dev(emission_constant(host(log_sigma)), f32),
                n_kmers=on_dev(nk, i32),
                lp_stay=on_dev(host(lp_stay).reshape(-1), f32),
                lp_step=on_dev(host(lp_step).reshape(-1), f32))


def banded_align_batch(event_mean, n_events, mu, sigma, log_sigma, n_kmers,
                       lp_stay=None, lp_step=None, device=None
                       ) -> BandedAlignResult:
    """Batched adaptive banded event alignment, plain PyTorch throughout,
    on ``device`` (``cuda`` unless ``cpu`` is asked).

    Args:
      event_mean: [B, T] float32 event current levels (drift-free, raw pA).
      n_events:   [B] int32 valid event counts.
      mu/sigma/log_sigma: [B, K] float32 *scaled* per-kmer gaussians
        (scale*level_mean+shift, level_stdv*var, log thereof).
      n_kmers:    [B] int32 valid kmer counts.
      lp_stay/lp_step: optional [B] overrides; defaults follow
        raw_loader.cpp:98-107 (p_stay = 1 - 1/(events_per_kmer + 1)).
    """
    x = prepare_banded_inputs(event_mean, n_events, mu, sigma, log_sigma,
                              n_kmers, lp_stay, lp_step, device=device)
    trace, moves, lle, best_e, _ = banded_fill_plain(
        x["event_mean"], x["n_events"], x["mu"], x["sigma"], x["c"],
        x["n_kmers"], x["lp_stay"], x["lp_step"])
    b2e_start, b2e_stop, sum_em, stats = banded_backtrack_plain(
        trace, moves, lle, best_e, x["event_mean"], x["mu"], x["sigma"],
        x["c"], x["n_kmers"])
    return finish_banded(b2e_start, b2e_stop, sum_em, stats, x["n_kmers"])
