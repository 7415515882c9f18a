"""Batched HMM segment execution: the device dispatch layer.

Every analysis module reduces to scoring/aligning batches of "segments":
(event slice, kmer window) pairs with per-read scalings.  This module packs
heterogeneous segments into padded (T, K) buckets, runs the profile-HMM
kernels batched, and unpacks per-segment results — the batched
replacement for the reference's per-call profile_hmm_align and
profile_hmm_score (src/hmm/nanopolish_profile_hmm.cpp:14-65).  Soft-clip
flags are per-segment kernel inputs, so segments with different flags
share a launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.squiggle import SquiggleRead
from ..ops.profile_hmm import paths_to_segments
from ..ops.profile_hmm_forward import forward_scores, prepare_forward_inputs
from ..ops.profile_hmm_viterbi import prepare_viterbi_inputs, viterbi_paths
from ..utils.device import resolve_device

import threading

_CACHE_INIT_LOCK = threading.Lock()

# segments per Forward launch: bounds the padded inputs' memory (a launch
# runs one block per segment, so it takes any count)
FORWARD_BATCH = 4096


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


def _bucket_key(n_events: int, n_kmers: int) -> Tuple[int, int]:
    """Power-of-two padded event length and kmer width of one segment."""
    return _pow2(n_events, 64), _pow2(n_kmers, 32)


def _buckets(segments: Sequence[HMMSegment], max_batch: int):
    """Segment indices grouped by power-of-two padded event length and
    kmer width, cut into launches of at most max_batch segments."""
    buckets = {}
    for i, s in enumerate(segments):
        key = _bucket_key(len(s.levels), len(s.mu))
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


def forward_arrays_async(levels_mat: np.ndarray, n_events: np.ndarray,
                         mu_mat: np.ndarray, sigma_mat: np.ndarray,
                         n_kmers: np.ndarray, epb: np.ndarray,
                         flags: np.ndarray, indel_bias: float = 1.0,
                         device=None):
    """Forward-score n segments given as padded arrays (levels_mat
    [n, Tmax], mu/sigma_mat [n, Kmax], n_events/n_kmers [n] i32, epb [n]
    f32, flags [n] i32) on ``device`` (``cuda`` unless ``cpu`` is asked).
    Every launch is issued before this returns; the returned zero-arg
    closure makes one device-to-host copy of the concatenated scores and
    returns them as [n] f32.  Rows are bucketed by power-of-two event
    length and kmer width, at most FORWARD_BATCH per launch; a score does
    not depend on its bucket's padding."""
    dev = resolve_device(device)
    n = len(n_events)
    out = np.zeros(n, np.float32)
    if n == 0:
        return lambda: out
    n_events = np.asarray(n_events, np.int32)
    n_kmers = np.asarray(n_kmers, np.int32)
    epb = np.asarray(epb, np.float32)
    flags = np.broadcast_to(np.asarray(flags, np.int32), (n,))
    buckets: dict = {}
    for i, key in enumerate(zip(n_events.tolist(), n_kmers.tolist())):
        buckets.setdefault(_bucket_key(*key), []).append(i)
    order, pending = [], []
    for (tp, kp), idxs in buckets.items():
        T = min(levels_mat.shape[1], tp)
        K = min(mu_mat.shape[1], kp)
        for lo in range(0, len(idxs), FORWARD_BATCH):
            ii = np.asarray(idxs[lo:lo + FORWARD_BATCH])
            x = prepare_forward_inputs(
                levels_mat[ii, :T], n_events[ii], mu_mat[ii, :K],
                sigma_mat[ii, :K], n_kmers[ii], epb[ii], flags[ii],
                indel_bias, device=dev)
            pending.append(forward_scores(x))
            order.append(ii)
    cat = torch.cat(pending)
    order = np.concatenate(order)

    def materialize() -> np.ndarray:
        out[order] = cat.cpu().numpy()
        return out

    return materialize


def forward_arrays(levels_mat: np.ndarray, n_events: np.ndarray,
                   mu_mat: np.ndarray, sigma_mat: np.ndarray,
                   n_kmers: np.ndarray, epb: np.ndarray,
                   flags: np.ndarray, indel_bias: float = 1.0,
                   device=None) -> np.ndarray:
    """``forward_arrays_async`` resolved at once: [n] f32 scores."""
    return forward_arrays_async(levels_mat, n_events, mu_mat, sigma_mat,
                                n_kmers, epb, flags, indel_bias,
                                device=device)()


def forward_segments(segments: Sequence[HMMSegment],
                     indel_bias: float = 1.0, device=None) -> np.ndarray:
    """Forward-score each segment on ``device`` (``cuda`` unless ``cpu``
    is asked); returns [n_segments] float32 log-likelihoods
    (profile_hmm_score_r9 semantics, r9.cpp:35-65)."""
    n = len(segments)
    T = max((len(s.levels) for s in segments), default=1)
    K = max((len(s.mu) for s in segments), default=1)
    levels = np.zeros((n, T), np.float32)
    mu = np.zeros((n, K), np.float32)
    sigma = np.ones((n, K), np.float32)
    n_events = np.zeros(n, np.int32)
    n_kmers = np.zeros(n, np.int32)
    epb = np.zeros(n, np.float32)
    flags = np.zeros(n, np.int32)
    for i, s in enumerate(segments):
        ne, nk = len(s.levels), len(s.mu)
        levels[i, :ne] = s.levels
        mu[i, :nk] = s.mu
        sigma[i, :nk] = s.sigma
        n_events[i] = ne
        n_kmers[i] = nk
        epb[i] = s.events_per_base
        flags[i] = s.flags
    return forward_arrays(levels, n_events, mu, sigma, n_kmers, epb, flags,
                          indel_bias, device=device)
