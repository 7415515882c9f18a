"""Per-read scaling estimation: method-of-moments init + weighted
least-squares recalibration, batched over reads (PyTorch).

Specs:
  * estimate_scalings_mom (reference: src/nanopolish_raw_loader.cpp:17-60)
  * recalibrate_model (reference: src/nanopolish_methyltrain.cpp:204-307) —
    the Eigen normal-equation solve becomes a batched [B,n,n] solve.

All functions take tensors and compute on their device.  The f32 row
sums follow the reference's compiled order (``ordered_sum``) and the
normal equations are solved with the operation sequence of LAPACK's
partial-pivoting LU as the host BLAS evaluates it (``solve2`` for shift
and scale, ``solve3`` with drift), so the scalings reproduce the JAX
package's bits on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .emissions import fma32

MIN_EVENTS_TO_RESCALE = 200  # methyltrain.cpp:242
SUM_WINDOW = 32


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 row sums of [B, N] in the order of the reference's compiled
    reductions: the row is zero-padded to a multiple of 32 (the padding
    split evenly before and after), each window of 32 is summed left to
    right, and the window sums are reduced the same way until at most 32
    remain, which are summed left to right."""
    B, N = x.shape
    if N <= SUM_WINDOW:
        acc = torch.zeros(B, dtype=x.dtype, device=x.device)
        for j in range(N):
            acc = acc + x[:, j]
        return acc
    n = -(-N // SUM_WINDOW) * SUM_WINDOW
    lo = (n - N) // 2
    xp = torch.zeros((B, n), dtype=x.dtype, device=x.device)
    xp[:, lo:lo + N] = x
    w = xp.view(B, n // SUM_WINDOW, SUM_WINDOW)
    acc = torch.zeros((B, n // SUM_WINDOW), dtype=x.dtype, device=x.device)
    for j in range(SUM_WINDOW):
        acc = acc + w[:, :, j]
    return ordered_sum(acc)


def solve2(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 solve A x = b ([B, 2, 2], [B, 2]) with the operation
    sequence of LAPACK's partial-pivoting LU (getrf) and triangular solves
    (getrs) as the host BLAS evaluates them: pivot on the larger
    |first-column| entry, multiplier by the reciprocal pivot, unfused
    trailing update; fused right-hand-side updates and reciprocal
    back-substitution."""
    a00, a01, a10, a11 = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    b0, b1 = b[:, 0], b[:, 1]
    sw = a10.abs() > a00.abs()
    p00 = torch.where(sw, a10, a00)
    p01 = torch.where(sw, a11, a01)
    r10 = torch.where(sw, a00, a10)
    r11 = torch.where(sw, a01, a11)
    c0 = torch.where(sw, b1, b0)
    c1 = torch.where(sw, b0, b1)
    inv_p = 1.0 / p00
    l10 = r10 * inv_p
    u11 = r11 - l10 * p01
    y1 = fma32(-l10, c0, c1)
    x1 = y1 * (1.0 / u11)
    x0 = fma32(-p01, x1, c0) * inv_p
    return torch.stack([x0, x1], dim=1)


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve A x = b ([B, 3, 3], [B, 3]) with the operation
    sequence of the host BLAS's partial-pivoting LU and triangular solves:
    pivots on the first largest |column| entry; multipliers by the
    reciprocal pivot; column 1's update unfused, the last row's column-2
    update as one fused two-term dot product subtracted once.  The forward
    pass solves rows 0-1 with fused updates and updates row 2 by a fused
    dot product subtracted once; the backward pass updates rows 0-1 from
    row 2 unfused, then solves them with a fused update; every division
    is a product with the reciprocal diagonal."""
    def swap(sw, x, y):
        return torch.where(sw, y, x), torch.where(sw, x, y)

    r0, r1, r2 = A[:, 0, :], A[:, 1, :], A[:, 2, :]
    c0, c1, c2 = b[:, 0], b[:, 1], b[:, 2]
    m0, m1, m2 = r0[:, 0].abs(), r1[:, 0].abs(), r2[:, 0].abs()
    first = (m0 >= m1) & (m0 >= m2)
    pick1 = ~first & (m1 >= m2)
    pick2 = ~first & ~pick1
    r0, r1 = swap(pick1[:, None], r0, r1)
    c0, c1 = swap(pick1, c0, c1)
    r0, r2 = swap(pick2[:, None], r0, r2)
    c0, c2 = swap(pick2, c0, c2)
    u00, u01, u02 = r0.unbind(1)
    inv0 = 1.0 / u00
    l10 = r1[:, 0] * inv0
    l20 = r2[:, 0] * inv0
    b1 = r1[:, 1] - l10 * u01
    b2 = r2[:, 1] - l20 * u01
    sw = b2.abs() > b1.abs()
    l10, l20 = swap(sw, l10, l20)
    u11, b2 = swap(sw, b1, b2)
    a12, a22 = swap(sw, r1[:, 2], r2[:, 2])
    c1, c2 = swap(sw, c1, c2)
    inv1 = 1.0 / u11
    l21 = b2 * inv1
    u12 = a12 - l10 * u02
    u22 = a22 - fma32(l21, u12, l20 * u02)
    y0 = c0
    y1 = fma32(-l10, y0, c1)
    y2 = c2 - fma32(l21, y1, l20 * y0)
    x2 = y2 * (1.0 / u22)
    y1 = y1 - u12 * x2
    y0 = y0 - u02 * x2
    x1 = y1 * inv1
    x0 = fma32(-u01, x1, y0) * inv0
    return torch.stack([x0, x1, x2], dim=1)


def estimate_scalings_mom(event_mean, n_events, kmer_level_mean, n_kmers):
    """Batched method-of-moments shift/scale (raw_loader.cpp:17-60).

    Args:
      event_mean: [B, T] f32 padded event levels
      n_events:   [B] i32
      kmer_level_mean: [B, K] f32 padded model levels of the read's kmers
      n_kmers:    [B] i32
    Returns:
      shift [B], scale [B] (drift=0, var=1 implied)
    """
    T = event_mean.shape[1]
    K = kmer_level_mean.shape[1]
    dev = event_mean.device
    ev_mask = torch.arange(T, device=dev)[None, :] < n_events[:, None]
    km_mask = torch.arange(K, device=dev)[None, :] < n_kmers[:, None]
    nev = n_events.to(torch.float32)
    nkm = n_kmers.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    event_sum = ordered_sum(torch.where(ev_mask, event_mean, zero))
    kmer_sum = ordered_sum(torch.where(km_mask, kmer_level_mean, zero))
    kmer_sq_sum = ordered_sum(torch.where(
        km_mask, kmer_level_mean * kmer_level_mean, zero))
    shift = event_sum / nev - kmer_sum / nkm
    dev2 = event_mean - shift[:, None]
    ev_sq_sum = ordered_sum(torch.where(ev_mask, dev2 * dev2, zero))
    scale = (ev_sq_sum / nev) / (kmer_sq_sum / nkm)
    return shift, scale


class RecalibrationResult(NamedTuple):
    shift: torch.Tensor       # [B]
    scale: torch.Tensor       # [B]
    drift: torch.Tensor       # [B]
    var: torch.Tensor         # [B]
    recalibrated: torch.Tensor  # [B] bool (>= 200 usable events)


def recalibrate(levels, times, model_mean, model_stdv, mask,
                scale_var: bool = True, scale_drift: bool = False
                ) -> RecalibrationResult:
    """Batched weighted least squares: level ~ shift + scale*mu (+ drift*t).

    Args:
      levels:     [B, N] f32 unscaled event levels ('M'-state aligned events)
      times:      [B, N] f32 event times (only used when scale_drift)
      model_mean: [B, N] f32 model level_mean per aligned event
      model_stdv: [B, N] f32 model level_stdv per aligned event
      mask:       [B, N] bool valid entries
    Matches methyltrain.cpp:246-303 (normal equations, var = sqrt of mean
    squared standardized residual).  Reads with fewer than
    MIN_EVENTS_TO_RESCALE usable events get a 1e-6 ridge so the batched
    solve stays finite; their result is flagged not recalibrated.
    """
    dev = levels.device
    maskf = mask.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inv_var = torch.where(mask, 1.0 / (model_stdv * model_stdv), zero)
    mu = model_mean
    e = levels
    n = 3 if scale_drift else 2

    cols = [maskf, mu, times] if scale_drift else [maskf, mu]

    # normal equations A x = b with per-row weight 1/sigma^2
    A = torch.stack([
        torch.stack([ordered_sum(ci * cj * inv_var) for cj in cols], dim=-1)
        for ci in cols], dim=-2)                                   # [B, n, n]
    b = torch.stack([ordered_sum(ci * e * inv_var) for ci in cols], dim=-1)

    count = mask.sum(dim=1)
    ok = count >= MIN_EVENTS_TO_RESCALE
    ridge = (1e-6 * (~ok).to(torch.float32))[:, None, None] * \
        torch.eye(n, dtype=torch.float32, device=dev)[None]
    x = (solve2 if n == 2 else solve3)(A + ridge, b)              # [B, n]

    shift = x[:, 0]
    scale = x[:, 1]
    drift = x[:, 2] if scale_drift else torch.zeros_like(shift)

    if scale_var:
        yi = e - shift[:, None] - scale[:, None] * mu
        if scale_drift:
            yi = yi - drift[:, None] * times
        var = ordered_sum(torch.where(
            mask, yi * yi / (model_stdv * model_stdv), zero))
        var = torch.sqrt(var / torch.clamp(count, min=1))
    else:
        var = torch.ones_like(shift)

    return RecalibrationResult(shift=shift, scale=scale, drift=drift, var=var,
                               recalibrated=ok)


def mstate_events_batch(b2e_start, b2e_stop, kmer_ranks, n_kmers):
    """Vectorized batched 'M'-event extraction.

    For each kmer with events, the 'M' event is the FIRST event of the kmer
    (b2e_start), taken only when the kmer's rank differs from the previous
    mapped kmer's rank (squiggle_read.cpp:384).  Subsequent events of the
    same kmer are 'E' and never counted: within one kmer only the first
    event can be 'M' (squiggle_read.cpp:340-391).

    Args: b2e_start/stop [B, K] i32, kmer_ranks [B, K] i32, n_kmers [B]
    (tensors on one device).
    Returns: mask [B, K] bool ('M' kmers), event_idx = b2e_start
    """
    B, K = b2e_start.shape
    kpos = torch.arange(K, dtype=torch.int64,
                        device=b2e_start.device)[None, :]
    valid = (b2e_start >= 0) & (kpos < n_kmers[:, None])
    # previous mapped kmer's rank: forward-fill ranks over valid positions
    idx = torch.where(valid, kpos, -1)
    ff = torch.cummax(idx, dim=1).values                  # last valid pos <= k
    prev_ff = torch.cat([torch.full((B, 1), -1, dtype=ff.dtype,
                                    device=ff.device), ff[:, :-1]], dim=1)
    prev_rank = torch.where(
        prev_ff >= 0,
        torch.gather(kmer_ranks, 1, torch.clamp(prev_ff, min=0)),
        -1)
    return valid & (kmer_ranks != prev_rank)
