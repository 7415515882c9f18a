"""Model-training ops: per-kmer sufficient statistics + Gaussian updates.

Behavioral spec: methyltrain's per-round accumulation of per-kmer event
observations followed by a per-kmer Gaussian update (reference:
src/nanopolish_methyltrain.cpp:329-474, :589-719 and
src/training_core.cpp:13-135).

Each process scatter-adds weighted moment sums keyed by kmer rank
(``index_add_``); an all-reduce over the data process group
(``psum_moments``) then yields the global statistics, and the M-step is
a closed-form elementwise update over the (shardable) kmer table.

The sums are f64 from the scatter through the all-reduce, and
``gaussian_update`` rounds them to f32 once before its f32 arithmetic.
On the card ``index_add_`` adds atomically, in an order that changes from
run to run; in f64 that order reaches the f32 result only where a sum
lies within an f64 rounding of an f32 rounding boundary, so the card and
the CPU agree for one mesh, and meshes of another data width agree up to
that one rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .emissions import fma32

# event filters (methyltrain.cpp:450-454)
MIN_EVENT_DURATION = 0.002
MIN_LEVEL = 1.0


class KmerMoments(NamedTuple):
    """Weighted moment sums per kmer rank, the cross-process payload."""

    n: torch.Tensor    # [R] f64  sum of weights
    x: torch.Tensor    # [R] f64  sum of w * level
    x2: torch.Tensor   # [R] f64  sum of w * level^2


def kmer_moments(ranks, levels, weights, n_ranks: int) -> KmerMoments:
    """Scatter-add weighted level moments by kmer rank, in f64.

    Args:
      ranks:   [...] integer kmer ranks (invalid entries may be any value:
               they are clipped to [0, n_ranks))
      levels:  [...] f32 fully-scaled event levels
      weights: [...] f32 responsibility/mask weights (0 for invalid)
      n_ranks: table size (4^k or 5^k)
    All three on one device; the sums are made there.
    """
    dev = levels.device
    r = torch.as_tensor(ranks, device=dev).reshape(-1).to(torch.int64)
    r = r.clamp(0, n_ranks - 1)
    w = torch.as_tensor(weights, device=dev).reshape(-1).to(torch.float64)
    x = levels.reshape(-1).to(torch.float64)
    # keep NaNs in masked lanes out of the sums
    x = torch.where(w > 0, x, torch.zeros((), dtype=x.dtype, device=dev))
    wx = w * x

    def scatter(v):
        return torch.zeros(n_ranks, dtype=torch.float64,
                           device=dev).index_add_(0, r, v)

    return KmerMoments(n=scatter(w), x=scatter(wx), x2=scatter(wx * x))


def merge_moments(a: KmerMoments, b: KmerMoments) -> KmerMoments:
    return KmerMoments(n=a.n + b.n, x=a.x + b.x, x2=a.x2 + b.x2)


def psum_moments(m: KmerMoments, group=None) -> KmerMoments:
    """All-reduce the moment sums over a process group (the data column
    of the mesh), as one [3, R] f64 payload; ``group`` None is a run of
    one process and returns ``m``."""
    if group is None:
        return m
    # imported here: parallel/ imports this module
    from ..parallel.distributed import all_reduce
    return KmerMoments(*all_reduce(torch.stack(list(m)), group).unbind(0))


def gaussian_update(m: KmerMoments, prior_mean, prior_stdv,
                    min_events: float = 100.0):
    """Closed-form single-Gaussian M-step with a keep-prior fallback, in
    f32 on the sums rounded to f32, as the JAX train step's compiled
    program evaluates it (XLA fuses ``x2/n - mean*mean`` into one fused
    multiply-add).

    Kmers with fewer than ``min_events`` observations keep the prior model
    (methyltrain.cpp min 100 events/kmer, :146).
    """
    n32 = m.n.to(torch.float32)
    n = n32.clamp(min=1e-9)
    mean = m.x.to(torch.float32) / n
    var = fma32(-mean, mean, m.x2.to(torch.float32) / n).clamp(min=1e-8)
    stdv = torch.sqrt(var)
    ok = n32 >= min_events
    return (torch.where(ok, mean, prior_mean),
            torch.where(ok, stdv, prior_stdv))
