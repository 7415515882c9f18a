"""Batched HMM segment execution: the device dispatch layer.

Every analysis module reduces to scoring/aligning batches of "segments":
(event slice, kmer window) pairs with per-read scalings.  This module packs
heterogeneous segments into padded (T, K) buckets, runs the profile-HMM
kernels batched, and unpacks per-segment results — the batched
replacement for the reference's per-call profile_hmm_align
(src/hmm/nanopolish_profile_hmm.cpp:14-65).  Soft-clip flags are
per-segment kernel inputs, so segments with different flags share a
launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.squiggle import SquiggleRead
from ..ops.profile_hmm import paths_to_segments
from ..ops.profile_hmm_viterbi import prepare_viterbi_inputs, viterbi_paths
from ..utils.device import resolve_device

import threading

_CACHE_INIT_LOCK = threading.Lock()


def _read_cache(read, attr: str) -> dict:
    """Get-or-create a per-read cache dict with double-checked locking:
    jobs sharing a SquiggleRead can run on different wavefront threads,
    and an unguarded getattr-then-set could overwrite a freshly
    populated dict."""
    cache = getattr(read, attr, None)
    if cache is None:
        with _CACHE_INIT_LOCK:
            cache = getattr(read, attr, None)
            if cache is None:
                cache = {}
                setattr(read, attr, cache)
    return cache


@dataclass
class HMMSegment:
    """One profile-HMM call: events [n_events] against kmers [n_kmers].

    levels are drift-scaled event means in traversal order; mu/sigma are the
    read-scaled gaussians of the window's kmers (scale*level_mean + shift,
    level_stdv * var).
    """

    levels: np.ndarray
    mu: np.ndarray
    sigma: np.ndarray
    events_per_base: float
    flags: int = 0


def read_drift_levels(read: SquiggleRead, strand: int) -> np.ndarray:
    """Whole-read drift-corrected event levels, cached on the read:
    level[i] = mean[i] - (start_time[i] - start_time[0]) * drift.
    Identity-keyed on the scalings object (calibration REPLACES
    read.scalings[strand], calibration.py), so a stale cache is
    impossible."""
    cache = _read_cache(read, "_drift_levels_cache")
    s = read.scalings[strand]
    entry = cache.get(strand)
    if entry is None or entry[0] is not s:
        ev = read.events[strand]
        levels = np.asarray(
            ev.mean - (ev.start_time - ev.start_time[0]) * s.drift,
            np.float32)
        entry = (s, levels)
        cache[strand] = entry
    return entry[1]


def segment_levels(read: SquiggleRead, strand: int,
                   event_start: int, event_stop: int) -> np.ndarray:
    """Drift-corrected event levels over [start..stop] (either
    direction) — shared by every segment scoring the same event range
    (e.g. a group's unmethylated/methylated pair).  A slice of the
    cached whole-read array (bit-identical: the per-range expression
    subtracts the same start_time[0])."""
    stride = 1 if event_stop >= event_start else -1
    stop = event_stop + stride
    if stop < 0:
        stop = None                      # reversed slice reaching index 0
    return read_drift_levels(read, strand)[event_start:stop:stride]


def _model_tables(read: SquiggleRead, strand: int, model
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Read-calibrated Gaussian tables (mu, sigma) hoisted per (read,
    strand, model): every segment of the same read then costs one gather
    per array.  Identity keys are sound because calibration REPLACES
    read.scalings[strand] (calibration.py:56) rather than mutating it."""
    s = read.scalings[strand]
    cache = _read_cache(read, "_segment_model_cache")
    entry = cache.get(strand)
    if entry is None or entry[0] is not model or entry[1] is not s:
        entry = (model, s,
                 (s.scale * model.level_mean + s.shift).astype(np.float32),
                 (model.level_stdv * s.var).astype(np.float32))
        cache[strand] = entry
    return entry[2], entry[3]


def make_segment(read: SquiggleRead, strand: int, ranks: np.ndarray,
                 event_start: int, event_stop: int, model=None,
                 flags: int = 0, levels: Optional[np.ndarray] = None
                 ) -> HMMSegment:
    """Build a segment from a read's event range [start..stop] (either
    direction) and a window's kmer ranks."""
    if model is None:
        model = read.base_model[strand]
    if levels is None:
        levels = segment_levels(read, strand, event_start, event_stop)
    mu_tab, sig_tab = _model_tables(read, strand, model)
    mu = mu_tab[ranks]
    sigma = sig_tab[ranks]
    return HMMSegment(levels=levels,
                      mu=np.asarray(mu, np.float32),
                      sigma=np.asarray(sigma, np.float32),
                      events_per_base=float(read.events_per_base[strand]),
                      flags=flags)


def _pow2(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _buckets(segments: Sequence[HMMSegment], max_batch: int):
    """Segment indices grouped by power-of-two padded event length and
    kmer width, cut into launches of at most max_batch segments."""
    buckets = {}
    for i, s in enumerate(segments):
        key = (_pow2(len(s.levels), 64), _pow2(len(s.mu), 32))
        buckets.setdefault(key, []).append(i)
    for (tp, _kp), idxs in buckets.items():
        for lo in range(0, len(idxs), max_batch):
            yield tp, idxs[lo:lo + max_batch]


def viterbi_segments(segments: Sequence[HMMSegment],
                     indel_bias: float = 1.0,
                     max_batch: int = 1024,
                     device=None,
                     ) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    """Viterbi-align each segment on ``device`` (``cuda`` unless ``cpu``
    is asked); returns per-segment (event_offsets, kmer_idxs,
    state_string) in forward order (profile_hmm_align_r9 semantics,
    r9.cpp:73-204)."""
    dev = resolve_device(device)
    results: List[Optional[Tuple]] = [None] * len(segments)
    for tp, chunk in _buckets(segments, max_batch):
        B = len(chunk)
        K = max(len(segments[si].mu) for si in chunk)
        levels = np.zeros((B, tp), np.float32)
        mu = np.zeros((B, K), np.float32)
        sigma = np.ones((B, K), np.float32)
        n_events = np.zeros(B, np.int32)
        n_kmers = np.zeros(B, np.int32)
        epb = np.zeros(B, np.float32)
        flags = np.zeros(B, np.int32)
        for bi, si in enumerate(chunk):
            s = segments[si]
            ne, nk = len(s.levels), len(s.mu)
            levels[bi, :ne] = s.levels
            mu[bi, :nk] = s.mu
            sigma[bi, :nk] = s.sigma
            n_events[bi] = ne
            n_kmers[bi] = nk
            epb[bi] = s.events_per_base
            flags[bi] = s.flags
        x = prepare_viterbi_inputs(levels, n_events, mu, sigma, n_kmers, epb,
                                   flags, indel_bias, device=dev)
        backs = paths_to_segments(viterbi_paths(x).cpu().numpy())
        for bi, si in enumerate(chunk):
            results[si] = backs[bi]
    return results  # type: ignore[return-value]
