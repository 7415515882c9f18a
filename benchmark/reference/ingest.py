"""A read's ingest, as nanopolish's SquiggleRead::load_from_raw does it
(src/nanopolish_squiggle_read.cpp:189-337, nanopolish_raw_loader.cpp):
events, method-of-moments scaling, the adaptive banded event alignment
(a 100-wide band, Suzuki's rule), the base-to-event map and its QC, the
'M' events and the weighted least-squares recalibration.

NumPy, one read at a time: a Python loop over the bands, each band's 100
cells as one vector.  The row sums take the program's padded width
(``Chunk``: the ingest pads every read of a batch to the longest one's
event and kmer counts, rounded up to 256), since a float32 sum's rounding
depends on how its terms are grouped.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import events as ev_mod
from .common import (F32, LP_SKIP, LP_TRIM, NEG_INF, Precision,
                     emission_constant, fma32, ordered_sum,
                     solve2)

W = 100
HALF = 50
D, U, L = 0, 1, 2
MIN_AVG_LOG_EMISSION = -5.0
MAX_GAP = 50
MIN_EVENTS_TO_RESCALE = 200
MIN_CALIBRATION_VAR = 2.5
MAX_EVENTS_PER_BASE = 5.0
QUANTUM = 256


def bucket(n: int) -> int:
    return max(QUANTUM, -(-n // QUANTUM) * QUANTUM)


@dataclass
class Events:
    mean: np.ndarray
    stdv: np.ndarray
    start_time: np.ndarray
    duration: np.ndarray


@dataclass
class IngestedRead:
    name: str
    events: Events
    b2e: np.ndarray                 # [n_kmers, 2] int
    shift: float
    scale: float
    var: float
    events_per_base: float
    ok: bool


def pa_signal(adc: np.ndarray, offset: float, rng: float, digi: float):
    return (adc.astype(np.float32) + np.float32(offset)) * (rng / digi)


def detect_read(adc, offset, rng, digi, sample_rate) -> Optional[Events]:
    raw = pa_signal(adc, offset, rng, digi)
    b = ev_mod.trim(raw)
    if b is None:
        return None
    _, length, mean, stdv = ev_mod.detect(raw[b[0]:b[1]])
    dur = (length / sample_rate).astype(np.float32)
    st = np.concatenate([[0.0], np.cumsum(dur)[:-1]]).astype(np.float32)
    return Events(mean=mean, stdv=stdv, start_time=st, duration=dur)


def _padded(x, n, fill=0.0):
    out = np.full(n, fill, np.float32)
    out[:len(x)] = x
    return out


def mom_scalings(ev_mean, lvl_mean, T, K):
    """Method-of-moments shift and scale (raw_loader.cpp:17-60)."""
    nev = np.float32(len(ev_mean))
    nkm = np.float32(len(lvl_mean))
    event_sum = ordered_sum(_padded(ev_mean, T))
    kmer_sum = ordered_sum(_padded(lvl_mean, K))
    kmer_sq = ordered_sum(_padded(lvl_mean * lvl_mean, K))
    shift = np.float32(event_sum / nev - kmer_sum / nkm)
    dev = ev_mean - shift
    ev_sq = ordered_sum(_padded(dev * dev, T))
    scale = np.float32((ev_sq / nev) / (kmer_sq / nkm))
    return shift, scale


def transition_terms(n_events, n_kmers):
    epk = n_events / max(n_kmers, 1)
    lp_stay = math.log(1.0 - 1.0 / (epk + 1.0))
    lp_step = math.log(1.0 - math.exp(LP_SKIP) - math.exp(lp_stay))
    return np.float32(lp_stay), np.float32(lp_step)


def _emission(x, mu, sigma, c, prec: Precision):
    """fma(-0.5 a, a, c) with a = (x - mu) / sigma: the product of two
    float32 values is exact in float64, so one float64 add and one
    rounding to float32 give the fused result (but where the float64 sum
    falls on a float32 midpoint, about once in 2^29)."""
    a = (x - mu) / sigma
    p = (np.float32(-0.5) * a).astype(np.float64)
    p *= a
    p += c
    return prec.q(p.astype(np.float32))


BLOCK = 128      # bands whose emissions are computed in one call


def banded_align(ev, mu, sigma, c, lp_stay, lp_step, prec: Precision):
    """The band fill and the walk back from the best end cell.  Returns
    (b2e [K, 2], sum_em, n_pairs, max_gap, last_ki, min_ev, max_ev)."""
    T, K = len(ev), len(mu)
    nb = T + K + 2
    f32 = np.float32
    lps, lpt = f32(lp_stay), f32(lp_step)
    lskip, ltrim = f32(LP_SKIP), f32(LP_TRIM)
    ninf = f32(NEG_INF)
    from_u = np.zeros((nb, W), bool)     # the move into each cell: U,
    from_l = np.zeros((nb, W), bool)     # L, else D
    ll_e_of = np.zeros(nb, np.int64)
    ll_e_of[0], ll_e_of[1] = HALF - 1, HALF
    # three band buffers, offsets 0..W-1 at 1..W and -inf at both ends,
    # so that a band's neighbours are views
    sp2, sp, cur = (np.full(W + 2, ninf, f32) for _ in range(3))
    sp2[1 + HALF] = 0.0
    sp[1 + HALF] = ltrim
    from_u[1, HALF] = True
    ll_e, ll_k, r_prev = HALF, -1 - HALF, 0
    best_s, best_e = NEG_INF, 0
    t1 = np.empty(W, f32)
    t2 = np.empty(W, f32)
    blk_end = 0
    for bi in range(2, nb):
        a, z = sp[1], sp[W]
        if a == NEG_INF and z == NEG_INF:
            r = bi % 2
        else:
            r = 1 if a < z else 0
        ll_e += 1 - r
        ll_k += r
        ll_e_of[bi] = ll_e
        if bi >= blk_end:
            # the emissions of every cell the next BLOCK bands can hold
            e_lo, k_lo = max(0, ll_e - W + 1), max(0, ll_k)
            e_hi = min(T - 1, ll_e + BLOCK - 1)
            k_hi = min(K - 1, ll_k + W - 1 + BLOCK - 1)
            kb = max(k_hi - k_lo + 1, 1)
            blk = _emission(ev[e_lo:e_hi + 1, None],
                            mu[None, k_lo:k_hi + 1],
                            sigma[None, k_lo:k_hi + 1],
                            c[None, k_lo:k_hi + 1], prec).ravel()
            blk_end = bi + BLOCK
        # valid cells: 0 <= ll_e - o < T and 0 <= ll_k + o < K
        o0 = max(0, -ll_k, ll_e - (T - 1))
        o1 = min(W - 1, ll_e, K - 1 - ll_k)
        if o0 > 0 or o1 < W - 1:
            cur.fill(ninf)
        if o0 <= o1:
            n = o1 - o0 + 1
            step = 1 - kb
            i0 = (ll_e - o0 - e_lo) * kb + (ll_k + o0 - k_lo)
            i1 = i0 + n * step
            em = blk[i0:(i1 if i1 >= 0 else None):step]
            d0 = o0 + r_prev + r             # diag = sp2[o + r_prev + r - 1]
            sd = np.add(sp2[d0:d0 + n], lpt, out=t1[:n])
            sd += em
            u0 = o0 + 1 + r                  # up = sp[o + r]
            su = np.add(sp[u0:u0 + n], lps, out=t2[:n])
            su += em
            l0 = o0 + r                      # left = sp[o + r - 1]
            sl = sp[l0:l0 + n] + lskip
            m2 = np.maximum(sd, su)
            np.equal(m2, su, out=from_u[bi, o0:o1 + 1])
            m3 = np.maximum(m2, sl, out=cur[o0 + 1:o1 + 2])
            np.equal(m3, sl, out=from_l[bi, o0:o1 + 1])
        ot = -1 - ll_k                       # the trim column, ki == -1
        if 0 <= ot < W:
            et = ll_e - ot
            if 0 <= et < T:
                cur[ot + 1] = ltrim * (f32(et) + f32(1.0))
                from_u[bi, ot] = True
        oe = K - 1 - ll_k                    # the last kmer
        if o0 <= oe <= o1:
            ee = ll_e - oe
            s = fma32(f32(T) - f32(ee), ltrim, cur[oe + 1])
            if s > best_s:
                best_s, best_e = float(s), ee
        sp2, sp, cur = sp, cur, sp2
        r_prev = r

    # the walk back (raw_loader.cpp:302-362)
    codes = np.where(from_l, np.uint8(L), from_u.view(np.uint8))
    starts = np.full(K, -1, np.int64)
    stops = np.full(K, -1, np.int64)
    ki, ei = K - 1, best_e
    walk_e, walk_k = [], []
    max_gap = cur_gap = 0
    while True:
        bi = ei + ki + 2
        off = int(ll_e_of[bi]) - ei
        mv = int(codes[bi, min(max(off, 0), W - 1)])
        walk_e.append(ei)
        walk_k.append(ki)
        cur_gap = cur_gap + 1 if mv == L else 0
        max_gap = max(max_gap, cur_gap)
        term = ((ki if mv == U else ki - 1) < 0) or \
            ((ei if mv == L else ei - 1) < 0)
        if mv != L or term:
            if starts[ki] == -1 or ei < starts[ki]:
                starts[ki] = ei
            stops[ki] = max(stops[ki], ei)
        if term:
            break
        if mv in (D, L):
            ki -= 1
        if mv in (D, U):
            ei -= 1
    we = np.asarray(walk_e)
    wk = np.asarray(walk_k)
    lp = _emission(ev[we], mu[wk], sigma[wk], c[wk], prec)
    sum_em = np.cumsum(lp, dtype=f32)[-1]      # in the walk's order
    return (np.stack([starts, stops], axis=1), sum_em, len(we), max_gap,
            int(wk[-1]), int(we.min()), int(we.max()))


def recalibrate(levels, model_mean, model_stdv, mask, K, prec: Precision):
    """Shift and scale by weighted least squares, var from the residuals
    (methyltrain.cpp:246-303); ``None`` with fewer than 200 events."""
    f32 = np.float32
    zero = f32(0.0)
    inv_var = np.where(mask, f32(1.0) / (model_stdv * model_stdv), zero)
    maskf = mask.astype(f32)
    cols = [maskf, model_mean]

    def osum(x):
        return ordered_sum(_padded(x, K))

    A = [[osum(ci * cj * inv_var) for cj in cols] for ci in cols]
    b = [osum(ci * levels * inv_var) for ci in cols]
    count = int(mask.sum())
    if count < MIN_EVENTS_TO_RESCALE:
        return None
    shift, scale = solve2(A, b)
    shift, scale = prec.q(shift), prec.q(scale)
    yi = levels - shift - scale * model_mean
    v = osum(np.where(mask, yi * yi / (model_stdv * model_stdv), zero))
    var = prec.q(f32(np.sqrt(f32(v / f32(count)))))
    return float(shift), float(scale), float(var)


def ingest(name, evts: Events, basecall_ranks: np.ndarray, level_mean,
           level_stdv, T: int, K: int, prec: Precision = F32
           ) -> IngestedRead:
    """MoM, banded alignment, QC and recalibration of one read whose
    batch was padded to T events and K kmers."""
    f32 = np.float32
    mean = prec.q(evts.mean)
    evts = Events(mean=mean, stdv=evts.stdv, start_time=evts.start_time,
                  duration=evts.duration)
    lvl_mean = level_mean[basecall_ranks].astype(f32)
    lvl_stdv = level_stdv[basecall_ranks].astype(f32)
    nk = len(lvl_mean)
    shift, scale = mom_scalings(mean, lvl_mean, T, K)
    shift, scale = prec.q(shift), prec.q(scale)
    mu = prec.q((scale * lvl_mean).astype(f32) + shift)
    sigma = prec.q(lvl_stdv)
    c = prec.q(emission_constant(lvl_stdv))
    lp_stay, lp_step = transition_terms(len(mean), nk)
    (b2e, sum_em, n_pairs, max_gap, last_ki, min_ev,
     max_ev) = banded_align(mean, mu, sigma, c, lp_stay, lp_step, prec)
    avg = f32(sum_em / f32(max(n_pairs, 1)))
    failed = (avg < MIN_AVG_LOG_EMISSION or last_ki != 0 or
              max_gap > MAX_GAP or n_pairs == 0)
    epb = float(f32(f32(max_ev - min_ev) / f32(max(nk, 1))))
    bad = IngestedRead(name, evts, None, 0.0, 1.0, 1.0, 0.0, False)
    if failed:
        return bad
    # 'M' events: a kmer's first event where its rank differs from the
    # previous mapped kmer's
    st = b2e[:, 0]
    valid = st >= 0
    kpos = np.arange(nk)
    ff = np.maximum.accumulate(np.where(valid, kpos, -1))
    prev = np.concatenate([[-1], ff[:-1]])
    prev_rank = np.where(prev >= 0, basecall_ranks[np.maximum(prev, 0)], -1)
    mask = valid & (basecall_ranks != prev_rank)
    levels = mean[np.clip(st, 0, len(mean) - 1)]
    rec = recalibrate(levels, lvl_mean, lvl_stdv, mask, K, prec)
    if rec is None or rec[2] > MIN_CALIBRATION_VAR or \
            epb > MAX_EVENTS_PER_BASE:
        return IngestedRead(name, evts, b2e, 0.0, 1.0, 1.0, epb, False)
    return IngestedRead(name, evts, b2e, rec[0], rec[1], rec[2], epb, True)
