"""Batched HMM segment execution: the device dispatch layer.

Every analysis module reduces to scoring/aligning batches of "segments":
(event slice, kmer window) pairs with per-read scalings.  This module packs
heterogeneous segments into padded (T, K) buckets, runs the profile-HMM
kernels batched, and unpacks per-segment results — the batched
replacement for the reference's per-call profile_hmm_align and
profile_hmm_score (src/hmm/nanopolish_profile_hmm.cpp:14-65).  Soft-clip
flags are per-segment kernel inputs, so segments with different flags
share a launch.  ``ScoreBatcher`` pools variants' (sequence set, event
range) units and drains them through the indexed Forward
(``ops/profile_hmm_indexed``), which gathers each segment from shared
inputs instead of padded per-segment copies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.squiggle import SquiggleRead
from ..ops.banded_align import emission_constant
from ..ops.profile_hmm import (HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP,
                               make_transitions, paths_to_segments)
from ..ops.profile_hmm_forward import forward_scores, prepare_forward_inputs
from ..ops.profile_hmm_indexed import forward_indexed_scores
from ..ops.profile_hmm_viterbi import prepare_viterbi_inputs, viterbi_paths
from ..utils.device import resolve_device
from ..utils.logsum import logsum_mode
from ..utils.profiler import profile_scope
from ..utils.syncstats import timed_fetch

import threading

_CACHE_INIT_LOCK = threading.Lock()

# segments per Forward launch: bounds the padded inputs' memory (a launch
# runs one block per segment, so it takes any count)
FORWARD_BATCH = 4096
# bytes of one launch's per-(event, kmer) or per-kmer arrays (the Viterbi
# trace [B, T, KP] u8; the Forward's padded tables and, past 16k kmers,
# the wide row's buffers): wide segments get fewer per launch
LAUNCH_BYTES = 1 << 29


def _launch_size(max_batch: int, cell_bytes: int) -> int:
    """Segments per launch: at most max_batch, and within LAUNCH_BYTES at
    cell_bytes per segment (at least one)."""
    return max(1, min(max_batch, LAUNCH_BYTES // max(cell_bytes, 1)))


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


def model_table_rows(read: SquiggleRead, strand: int, model) -> np.ndarray:
    """[3, S] f32 rows mu, sigma, c of the indexed Forward's per-read tables
    (``ops/profile_hmm_indexed``): ``_model_tables`` and
    ``c = LOG_INV_SQRT_2PI - log(sigma)`` as ``prepare_viterbi_inputs``
    computes it, cached like ``_model_tables``."""
    mu, sig = _model_tables(read, strand, model)
    cache = _read_cache(read, "_indexed_table_cache")
    key = (strand, id(model))
    entry = cache.get(key)
    if entry is None or entry[0] is not mu:
        entry = (mu, np.stack([mu, sig, emission_constant(np.log(sig))]))
        cache[key] = entry
    return entry[1]


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
    kmer width, cut into launches of at most max_batch segments whose
    traces stay within LAUNCH_BYTES."""
    buckets = {}
    for i, s in enumerate(segments):
        key = _bucket_key(len(s.levels), len(s.mu))
        buckets.setdefault(key, []).append(i)
    for (tp, kp), idxs in buckets.items():
        step = _launch_size(max_batch, tp * kp)
        for lo in range(0, len(idxs), step):
            yield tp, idxs[lo:lo + step]


def viterbi_segments(segments: Sequence[HMMSegment],
                     indel_bias: float = 1.0,
                     max_batch: int = 1024,
                     device=None, probs: Optional[dict] = None,
                     ) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    """Viterbi-align each segment on ``device`` (``cuda`` unless ``cpu``
    is asked); returns per-segment (event_offsets, kmer_idxs,
    state_string) in forward order (profile_hmm_align_r9 semantics,
    r9.cpp:73-204).  ``probs`` overrides make_transitions' p_skip, p_bad,
    p_skip_self and p_bad_self."""
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
        x = prepare_viterbi_inputs(
            levels, n_events, mu, sigma, n_kmers, epb, flags, indel_bias,
            make_transitions(epb, indel_bias, **(probs or {})), device=dev)
        backs = paths_to_segments(timed_fetch(viterbi_paths(x)))
        for bi, si in enumerate(chunk):
            results[si] = backs[bi]
    return results  # type: ignore[return-value]


def forward_arrays_async(levels_mat: np.ndarray, n_events: np.ndarray,
                         mu_mat: np.ndarray, sigma_mat: np.ndarray,
                         n_kmers: np.ndarray, epb: np.ndarray,
                         flags: np.ndarray, indel_bias: float = 1.0,
                         device=None, probs: Optional[dict] = None):
    """Forward-score n segments given as padded arrays (levels_mat
    [n, Tmax], mu/sigma_mat [n, Kmax], n_events/n_kmers [n] i32, epb [n]
    f32, flags [n] i32) on ``device`` (``cuda`` unless ``cpu`` is asked).
    Every launch is issued before this returns; the returned zero-arg
    closure makes one device-to-host copy of the concatenated scores and
    returns them as [n] f32.  Rows are bucketed by power-of-two event
    length and kmer width, at most FORWARD_BATCH per launch and within
    LAUNCH_BYTES; a score does not depend on its bucket's padding.
    ``probs`` as in ``viterbi_segments``.  Sums as ``NPT_LOGSUM`` says,
    read at each call (``utils.logsum.logsum_mode``)."""
    dev = resolve_device(device)
    logsum = logsum_mode()
    n = len(n_events)
    out = np.zeros(n, np.float32)
    if n == 0:
        return lambda: out
    n_events = np.asarray(n_events, np.int32)
    n_kmers = np.asarray(n_kmers, np.int32)
    epb = np.asarray(epb, np.float32)
    flags = np.broadcast_to(np.asarray(flags, np.int32), (n,))
    trans = make_transitions(epb, indel_bias, **(probs or {}))
    buckets: dict = {}
    for i, key in enumerate(zip(n_events.tolist(), n_kmers.tolist())):
        buckets.setdefault(_bucket_key(*key), []).append(i)
    order, pending = [], []
    for (tp, kp), idxs in buckets.items():
        T = min(levels_mat.shape[1], tp)
        K = min(mu_mat.shape[1], kp)
        # the table kernel's strip boundary: 16 bytes per event row
        step = _launch_size(FORWARD_BATCH, 4 * tp + 24 * kp +
                            (16 * tp if logsum == "table" else 0))
        for lo in range(0, len(idxs), step):
            ii = np.asarray(idxs[lo:lo + step])
            with profile_scope("segments.fa_pack"):
                x = prepare_forward_inputs(
                    levels_mat[ii, :T], n_events[ii], mu_mat[ii, :K],
                    sigma_mat[ii, :K], n_kmers[ii], epb[ii], flags[ii],
                    indel_bias, trans[ii], device=dev)
            with profile_scope("segments.fa_dispatch"):
                pending.append(forward_scores(x, logsum))
            order.append(ii)
    cat = torch.cat(pending)
    order = np.concatenate(order)

    def materialize() -> np.ndarray:
        out[order] = timed_fetch(cat)
        return out

    return materialize


def forward_arrays(levels_mat: np.ndarray, n_events: np.ndarray,
                   mu_mat: np.ndarray, sigma_mat: np.ndarray,
                   n_kmers: np.ndarray, epb: np.ndarray,
                   flags: np.ndarray, indel_bias: float = 1.0,
                   device=None, probs: Optional[dict] = None) -> np.ndarray:
    """``forward_arrays_async`` resolved at once: [n] f32 scores."""
    return forward_arrays_async(levels_mat, n_events, mu_mat, sigma_mat,
                                n_kmers, epb, flags, indel_bias,
                                device=device, probs=probs)()


def forward_segments(segments: Sequence[HMMSegment],
                     indel_bias: float = 1.0, device=None,
                     probs: Optional[dict] = None) -> np.ndarray:
    """Forward-score each segment on ``device`` (``cuda`` unless ``cpu``
    is asked); returns [n_segments] float32 log-likelihoods
    (profile_hmm_score_r9 semantics, r9.cpp:35-65).  ``probs`` as in
    ``viterbi_segments``."""
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
                          indel_bias, device=device, probs=probs)


def seq_set_key(sequences) -> tuple:
    """Memo-key fragment for a sequence set, cached per HMMInputSequence
    (they are not modified once built)."""
    frags = []
    for hs in sequences:
        f = getattr(hs, "_seq_key", None)
        if f is None:
            f = hs._seq_key = (hs.seq, hs.alphabet.name)
        frags.append(f)
    return tuple(frags)


def event_key(data) -> tuple:
    """Identity of an event range (read, strand, rc, start, stop), cached
    on the EventSequence: the polishing loop rebuilds the objects every
    round, but they describe the same slices."""
    dk = getattr(data, "_memo_frag", None)
    if dk is None:
        dk = data._memo_frag = (data.sr.read_name, data.strand, data.rc,
                                data.event_start_idx, data.event_stop_idx)
    return dk


class ScoreBatcher:
    """Pools (sequence set, event range) scoring units; ``flush()`` scores
    every pending segment, both soft clips allowed (the scoring of
    profile_hmm_score_set), in one indexed drain on ``device`` and resolves
    each unit to its profile_hmm_score_set value (the log-mean over the
    alternative sequences, profile_hmm.cpp:32-56).

    With a ``memo`` dict (AlignmentDB.score_memo) resolved unit scores are
    cached by (sequence set, read, strand, event range): the polishing
    loop re-screens every candidate each round and scores the shared base
    haplotype once per candidate edit at a position; both are fixed for a
    loaded region, so repeats skip the device.  Identical units added
    before a flush resolve to one unit (in-flight dedup).  ``probs`` as in
    ``viterbi_segments``."""

    def __init__(self, indel_bias: float = 1.0,
                 memo: Optional[dict] = None, device=None,
                 probs: Optional[dict] = None):
        self._device = resolve_device(device)
        self._probs = probs or {}
        # pending segments as (sequence, event range); the heavy work
        # (rank rows, level slices, tables) happens once in flush()
        self._pend: List[Tuple] = []
        # unit -> (start, count, memo_key) pending, or (None, value, None)
        self._units: List[Tuple] = []
        self._results: Optional[np.ndarray] = None
        self._indel_bias = indel_bias
        self._memo = memo
        self._inflight: dict = {}

    def add(self, sequences, data, frags: Optional[tuple] = None) -> int:
        """Enqueue one scoring unit; ``frags`` is seq_set_key(sequences)
        when the caller has it already."""
        key = None
        if self._memo is not None:
            if frags is None:
                frags = seq_set_key(sequences)
            key = (frags, event_key(data), self._indel_bias)
            hit = self._memo.get(key)
            if hit is not None:
                self._units.append((None, hit, None))
                return len(self._units) - 1
            prev = self._inflight.get(key)
            if prev is not None:
                return prev
        start = len(self._pend)
        for hs in sequences:
            self._pend.append((hs, data))
        self._units.append((start, len(sequences), key))
        idx = len(self._units) - 1
        if key is not None:
            self._inflight[key] = idx
        return idx

    def flush(self):
        scores = self._score_pending() if self._pend \
            else np.zeros(0, np.float32)
        out = np.zeros(len(self._units), np.float64)
        memo = self._memo
        if all(count == 1 for start, count, _ in self._units
               if start is not None):
            # no methylation alternatives: a unit's score is its segment's
            starts = np.array([s if s is not None else -1
                               for s, _, _ in self._units], np.int64)
            pend = starts >= 0
            out[~pend] = [c for s, c, _ in self._units if s is None]
            out[pend] = scores[starts[pend]].astype(np.float64)
            if memo is not None:
                for i in np.flatnonzero(pend):
                    memo[self._units[i][2]] = out[i]
        else:
            for i, (start, count, key) in enumerate(self._units):
                if start is None:           # memo hit recorded in add()
                    out[i] = count
                    continue
                vals = scores[start:start + count].astype(np.float64)
                m = vals.max()
                out[i] = m + math.log(np.exp(vals - m).sum()) - math.log(count)
                if memo is not None:
                    memo[key] = out[i]
        self._results = out

    def _score_pending(self) -> np.ndarray:
        """Score every pending segment through the indexed drain
        (``ops/profile_hmm_indexed.forward_indexed_scores``): the unique
        event slices, per-read tables, kmer-rank rows and transition rows
        go to the device once, plus four ids per segment.  Under
        ``NPT_LOGSUM=table`` the drain gathers them into the flat layout
        for the table-route Forward."""
        n = len(self._pend)
        ids = np.empty((n, 4), np.int32)
        ev_rows: List[Tuple] = []      # (sr, strand, e1, e2)
        tab_rows: List[Tuple] = []     # (sr, strand, model)
        rank_rows: List[np.ndarray] = []
        trans_rows: List[float] = []   # events per base per (sr, strand)
        ev_ids: dict = {}
        tab_ids: dict = {}
        trans_ids: dict = {}
        # a flush sees each EventSequence and HMMInputSequence many times
        # (a position's ~18 screening units share one event list); their
        # row ids are cached on the objects under a per-flush epoch
        epoch = object()
        for i, (hs, data) in enumerate(self._pend):
            st = getattr(data, "_flush_st", None)
            if st is None or st[0] is not epoch:
                ekey = (id(data.sr), data.strand, data.event_start_idx,
                        data.event_stop_idx)
                ei = ev_ids.get(ekey)
                if ei is None:
                    ei = ev_ids[ekey] = len(ev_rows)
                    ev_rows.append((data.sr, data.strand,
                                    data.event_start_idx,
                                    data.event_stop_idx))
                xkey = (id(data.sr), data.strand)
                xi = trans_ids.get(xkey)
                if xi is None:
                    xi = trans_ids[xkey] = len(trans_rows)
                    trans_rows.append(
                        float(data.sr.events_per_base[data.strand]))
                st = data._flush_st = (epoch, ei, xi, {})
            _, ei, xi, tmap = st
            aname = hs.alphabet.name
            tm = tmap.get(aname)
            if tm is None:
                model = data.sr.get_model(data.strand, aname) \
                    if aname != "nucleotide" \
                    else data.sr.base_model[data.strand]
                tkey = (id(data.sr), data.strand, id(model))
                ti = tab_ids.get(tkey)
                if ti is None:
                    ti = tab_ids[tkey] = len(tab_rows)
                    tab_rows.append((data.sr, data.strand, model))
                tm = tmap[aname] = (ti, model)
            ti, model = tm
            rst = getattr(hs, "_flush_rids", None)
            if rst is None or rst[0] is not epoch:
                rst = hs._flush_rids = (epoch, {})
            rkey = (data.rc, model.k)
            ri = rst[1].get(rkey)
            if ri is None:
                ri = rst[1][rkey] = len(rank_rows)
                rank_rows.append(hs.kmer_ranks(model.k, data.rc))
            ids[i] = (ei, ti, ri, xi)

        n_ev_u = np.array([abs(e2 - e1) + 1 for _, _, e1, e2 in ev_rows],
                          np.int32)
        n_km_u = np.array([len(r) for r in rank_rows], np.int32)
        levels_u = np.zeros((len(ev_rows), int(n_ev_u.max())), np.float32)
        for e, (sr, strand, e1, e2) in enumerate(ev_rows):
            levels_u[e, :n_ev_u[e]] = segment_levels(sr, strand, e1, e2)
        rank_mat = np.zeros((len(rank_rows), max(int(n_km_u.max()), 1)),
                            np.int32)
        for r, rk in enumerate(rank_rows):
            rank_mat[r, :len(rk)] = rk
        tabs = table_stack([model_table_rows(sr, strand, model)
                            for sr, strand, model in tab_rows])
        trans_u = make_transitions(np.array(trans_rows, np.float32),
                                   self._indel_bias, **self._probs)
        return forward_indexed_scores(levels_u, n_ev_u, tabs, rank_mat,
                                      n_km_u, trans_u, ids,
                                      HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP,
                                      device=self._device,
                                      logsum=logsum_mode())

    def get(self, unit_idx: int) -> float:
        return float(self._results[unit_idx])

    @property
    def scores(self) -> np.ndarray:
        """All unit scores (valid after flush)."""
        return self._results


def table_stack(rows: Sequence[np.ndarray]) -> np.ndarray:
    """[3, R, S] tables from per-read [3, S_r] rows (``model_table_rows``),
    padded to the widest model with mu 0, sigma 1 and the c of sigma 1."""
    S = max(r.shape[1] for r in rows)
    tabs = np.zeros((3, len(rows), S), np.float32)
    tabs[1] = 1.0
    tabs[2] = emission_constant(np.zeros(1, np.float32))[0]
    for t, r in enumerate(rows):
        tabs[:, t, :r.shape[1]] = r
    return tabs
