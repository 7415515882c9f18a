"""Reference-exact adaptive banded event alignment on the card.

Counterpart of ``nanopolish_tpu/ops/pallas_banded_exact.py``: the two
hand-written CUDA kernels ``csrc/banded_fill.cu`` (the band fill) and
``csrc/banded_backtrack.cu`` (the walk replay, writing the base->event
map directly), then the reference's QC (``finish_banded``).

Each wrapper takes tensors on one device.  For CPU tensors it runs its
kernel's plain version from ``ops/banded_align.py``; for CUDA tensors it
launches the kernel (building it at first use) or raises.  Both produce
identical outputs, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from .banded_align import (LP_SKIP, LP_TRIM, TRACE_BYTES, BandedAlignResult,
                           banded_backtrack_plain, banded_fill_plain,
                           finish_banded, n_bands_for, prepare_banded_inputs)


def banded_fill(event_mean, n_events, mu, sigma, c, n_kmers, lp_stay,
                lp_step):
    """Band fill: (trace [B, n_bands, 32] u8, moves [B, n_bands] u8,
    ll_e_last [B] i32, best_e [B] i32, best_s [B] f32).
    See ``banded_fill_plain`` for the layout."""
    if event_mean.device.type == "cpu":
        return banded_fill_plain(event_mean, n_events, mu, sigma, c,
                                 n_kmers, lp_stay, lp_step)
    cuda_build.require_cuda(event_mean)
    dev = event_mean.device
    B, T = event_mean.shape
    K = mu.shape[1]
    f32, i32 = torch.float32, torch.int32
    cuda_build.check_tensor("event_mean", event_mean, f32, (B, T), dev)
    for nm, t in (("mu", mu), ("sigma", sigma), ("c", c)):
        cuda_build.check_tensor(nm, t, f32, (B, K), dev)
    cuda_build.check_tensor("n_events", n_events, i32, (B,), dev)
    cuda_build.check_tensor("n_kmers", n_kmers, i32, (B,), dev)
    cuda_build.check_tensor("lp_stay", lp_stay, f32, (B,), dev)
    cuda_build.check_tensor("lp_step", lp_step, f32, (B,), dev)
    n_bands = n_bands_for(T, K)
    trace = torch.empty((B, n_bands, TRACE_BYTES), dtype=torch.uint8,
                        device=dev)
    moves = torch.empty((B, n_bands), dtype=torch.uint8, device=dev)
    lle = torch.empty(B, dtype=i32, device=dev)
    best_e = torch.empty(B, dtype=i32, device=dev)
    best_s = torch.empty(B, dtype=f32, device=dev)
    cuda_build.launch(
        "banded_fill", event_mean.data_ptr(), T, mu.data_ptr(),
        sigma.data_ptr(), c.data_ptr(), K, n_events.data_ptr(),
        n_kmers.data_ptr(), lp_stay.data_ptr(), lp_step.data_ptr(),
        float(np.float32(LP_SKIP)), float(np.float32(LP_TRIM)), B, n_bands,
        trace.data_ptr(), moves.data_ptr(), lle.data_ptr(), best_e.data_ptr(),
        best_s.data_ptr())
    cuda_build.count_launch("banded_fill")
    return trace, moves, lle, best_e, best_s


def banded_backtrack(trace, moves, ll_e_last, best_e, event_mean, mu, sigma,
                     c, n_kmers):
    """Walk replay: (b2e_start [B, K] i32, b2e_stop [B, K] i32 before QC
    masking, sum_em [B] f32, stats [B, 5] i32 = n_pairs, max_gap,
    last_ki, min_ev, max_ev)."""
    if trace.device.type == "cpu":
        return banded_backtrack_plain(trace, moves, ll_e_last, best_e,
                                      event_mean, mu, sigma, c, n_kmers)
    cuda_build.require_cuda(trace)
    dev = trace.device
    B, n_bands, _ = trace.shape
    T = event_mean.shape[1]
    K = mu.shape[1]
    f32, i32 = torch.float32, torch.int32
    cuda_build.check_tensor("trace", trace, torch.uint8,
                            (B, n_bands, TRACE_BYTES), dev)
    cuda_build.check_tensor("moves", moves, torch.uint8, (B, n_bands), dev)
    cuda_build.check_tensor("ll_e_last", ll_e_last, i32, (B,), dev)
    cuda_build.check_tensor("best_e", best_e, i32, (B,), dev)
    cuda_build.check_tensor("event_mean", event_mean, f32, (B, T), dev)
    for nm, t in (("mu", mu), ("sigma", sigma), ("c", c)):
        cuda_build.check_tensor(nm, t, f32, (B, K), dev)
    cuda_build.check_tensor("n_kmers", n_kmers, i32, (B,), dev)
    b2e_start = torch.empty((B, K), dtype=i32, device=dev)
    b2e_stop = torch.empty((B, K), dtype=i32, device=dev)
    sum_em = torch.empty(B, dtype=f32, device=dev)
    stats = torch.empty((B, 5), dtype=i32, device=dev)
    cuda_build.launch(
        "banded_backtrack", trace.data_ptr(), moves.data_ptr(),
        ll_e_last.data_ptr(), best_e.data_ptr(), event_mean.data_ptr(), T,
        mu.data_ptr(), sigma.data_ptr(), c.data_ptr(), K, n_kmers.data_ptr(),
        B, n_bands, b2e_start.data_ptr(), b2e_stop.data_ptr(),
        sum_em.data_ptr(), stats.data_ptr())
    cuda_build.count_launch("banded_backtrack")
    return b2e_start, b2e_stop, sum_em, stats


def banded_align_exact(event_mean, n_events, mu, sigma, log_sigma, n_kmers,
                       lp_stay=None, lp_step=None, device=None
                       ) -> BandedAlignResult:
    """Reference-exact batched adaptive banded event alignment on
    ``device`` (``cuda`` unless ``cpu`` is asked): same arguments and result as
    ``ops.banded_align.banded_align_batch``; kernels on CUDA, their plain
    versions on the CPU."""
    x = prepare_banded_inputs(event_mean, n_events, mu, sigma, log_sigma,
                              n_kmers, lp_stay, lp_step, device=device)
    return align_prepared(x)


def align_prepared(x) -> BandedAlignResult:
    """Fill + backtrack + QC on the tensors of ``prepare_banded_inputs``."""
    trace, moves, lle, best_e, _ = banded_fill(
        x["event_mean"], x["n_events"], x["mu"], x["sigma"], x["c"],
        x["n_kmers"], x["lp_stay"], x["lp_step"])
    b2e_start, b2e_stop, sum_em, stats = banded_backtrack(
        trace, moves, lle, best_e, x["event_mean"], x["mu"], x["sigma"],
        x["c"], x["n_kmers"])
    return finish_banded(b2e_start, b2e_stop, sum_em, stats, x["n_kmers"])
