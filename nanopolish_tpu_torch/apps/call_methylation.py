"""`call-methylation` subcommand: per-read methylation log-likelihood ratios.

Rebuild of call_methylation_main / calculate_methylation_for_read
(reference: src/nanopolish_call_methylation.cpp:591-630,726-756 and
src/basemods/nanopolish_basemods.cpp:238-457) with reference-exact TSV
and modbam output.

Every (read, strand, motif group) gives two Forward scoring tasks: the
window's unmethylated and methylated sequence against the same events.
On the array path (the default) a chunk's groups are collected as
struct-of-arrays blocks (the native geometry of ``csrc/meth_geometry.cpp``,
or its NumPy twin under ``NPT_METH_NATIVE=0``), gathered into padded
matrices on the host and scored by one asynchronous sweep of the Forward
kernel (``alignment.segments.forward_arrays_async``); a worker thread
resolves the scores while the next chunk loads.  The object path
(``NPT_METH_ARRAY=0``) builds an HMMInputSequence pair per group and
scores a chunk's pairs in one ``ScoreBatcher`` flush, the indexed drain
(``csrc/forward_indexed.cu`` on the card).  Both print the same rows;
neither falls back to the other.  The object path is the JAX package's
``NPT_METH_ARRAY=0`` route, and the one call-methylation route through the
indexed Forward: on the card it holds the array path's scores to a second
kernel.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..alignment.records import (MAX_EVENT_TO_BP_RATIO, EventAlignmentRecord,
                                 SequenceAlignmentRecord)
from ..alignment.alignment_db import EventSequence
from ..alignment.segments import (ScoreBatcher, _model_tables,
                                  forward_arrays_async, read_drift_levels)
from ..io.bam import BamRecord, BamWriter
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..models.hmm_input import HMMInputSequence
from ..models.pore_model import PoreModelSet
from ..models.read_builder import GLOBAL_READ_STATS
from ..models.read_loader import load_squiggle_reads
from ..ops.profile_hmm import HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP
from ..utils.alphabet import DNA_ALPHABET, get_alphabet_by_name
from ..utils.device import resolve_device
from ..utils.native import get_native_lib
from ..utils.profiler import profile_scope
from .bam_processor import BamBatchProcessor

HMM_FLAGS = HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP

# reads per pipeline chunk, chunks loading ahead, loader threads
PIPE_CHUNK = 64
LOOKAHEAD = 4
LOADERS = 3


@dataclass
class CallingParameters:
    """basemods.h:68-80."""

    methylation_type: str = "cpg"
    min_separation: int = 10
    min_flank: int = 10

    @property
    def alphabet(self):
        return get_alphabet_by_name(self.methylation_type)


@dataclass
class ScoredSite:
    """basemods.h:33-56."""

    chromosome: str = ""
    start_position: int = -1
    end_position: int = -1
    n_motif: int = 0
    sequence: str = ""
    ll_unmethylated: List[float] = field(default_factory=lambda: [0.0, 0.0])
    ll_methylated: List[float] = field(default_factory=lambda: [0.0, 0.0])
    strands_scored: int = 0


def motif_groups(motif_sites: List[int], min_separation: int
                 ) -> List[Tuple[int, int]]:
    """basemods.cpp:306-320: (first, end) index bounds of the maximal runs
    of motif sites whose gaps are <= min_separation."""
    groups = []
    curr = 0
    n = len(motif_sites)
    while curr < n:
        end = curr + 1
        while end < n:
            if motif_sites[end] - motif_sites[end - 1] > min_separation:
                break
            end += 1
        groups.append((curr, end))
        curr = end
    return groups


def _motif_group_spans(motif_arr: np.ndarray, min_separation: int):
    """Motif groups (basemods.cpp:306-320), vectorized: group index bounds
    (gs[i], ge[i]) of the maximal runs whose inter-site gaps are <=
    min_separation."""
    n = len(motif_arr)
    breaks = np.flatnonzero(np.diff(motif_arr) > min_separation)
    gs = np.concatenate([[0], breaks + 1])
    ge = np.concatenate([breaks + 1, [n]])
    return gs, ge


def _find_by_ref_bounds_vec(pairs: np.ndarray, ref_start: np.ndarray,
                            ref_stop: np.ndarray):
    """alignment.records.find_by_ref_bounds for arrays of bounds: returns
    (e1, e2, ok) with identical per-element semantics (incl. the
    reference's `refs[i2+1] >= ref_start` right-bound quirk,
    alignment_db.cpp:688-731)."""
    n = pairs.shape[0]
    if n == 0:
        z = np.zeros(len(ref_start), np.int64)
        return z, z, np.zeros(len(ref_start), bool)
    refs = pairs[:, 0]
    i1 = np.searchsorted(refs, ref_start, side="left")
    i2 = np.searchsorted(refs, ref_stop, side="left")
    inb = (i1 < n) & (i2 < n)
    i1c = np.minimum(i1, n - 1)
    i2c = np.minimum(i2, n - 1)
    left_b = (refs[i1c] <= ref_start) | \
        ((i1 > 0) & (refs[np.maximum(i1 - 1, 0)] <= ref_start))
    right_b = (refs[i2c] >= ref_stop) | \
        ((i2 + 1 < n) & (refs[np.minimum(i2 + 1, n - 1)] >= ref_start))
    ok = inb & left_b & right_b
    return pairs[i1c, 1], pairs[i2c, 1], ok


def _spans_empty_vec(arr: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Per-element: sorted arr has no value in [lo_i, hi_i]."""
    if len(arr) == 0:
        return np.ones(len(lo), bool)
    i = np.searchsorted(arr, lo, side="left")
    return (i >= len(arr)) | (arr[np.minimum(i, len(arr) - 1)] > hi)


class _Groups:
    """A read's strand-independent motif-group geometry (basemods.cpp:
    273-330), shared by both collectors: the whole-read sequences and,
    per group, its motif index span (gs, ge), first/last motif, window
    [sub_start, sub_end], reference positions, the QC mask ok0, and
    fast_v, true where the window's methylated ranks are a slice of the
    whole-read methylated ranks: no recognition site straddles a window
    boundary and no modified char in the halo outside the window could
    bleed into its site-aware reverse complement (tests/test_alphabet.py
    property-tests the rule); the other groups methylate their own
    window."""

    def __init__(self, ref_seq, ref_start_pos, params, region_start,
                 region_end):
        alphabet = params.alphabet
        self.motif_arr = motif_arr = alphabet.motif_positions(ref_seq)
        if len(motif_arr) == 0:
            return
        rl = alphabet.recognition_length
        self.n_ref = n_ref = len(ref_seq)
        self.rc_ref = alphabet.reverse_complement(ref_seq)
        self.meth_ref = meth_ref = alphabet.methylate(ref_seq)
        self.rc_meth_ref = alphabet.reverse_complement(meth_ref)
        # positions where whole-read methylation modified a char
        mod_pos = np.flatnonzero(
            np.frombuffer(meth_ref.encode("ascii"), np.uint8)
            != np.frombuffer(ref_seq.encode("ascii"), np.uint8))
        site_halo = max(len(s) for s in alphabet.recognition_sites) - 1

        self.gs, self.ge = gs, ge = _motif_group_spans(motif_arr,
                                                       params.min_separation)
        self.first = first = motif_arr[gs]
        self.last = last = motif_arr[ge - 1]
        self.sub_start = sub_start = first - params.min_flank
        self.sub_end = sub_end = last + params.min_flank
        ok0 = ((sub_start > params.min_separation) & (last - first <= 200)
               & (sub_end < n_ref))
        self.start_pos = first + ref_start_pos
        self.end_pos = last + ref_start_pos
        if region_start != -1:
            ok0 &= self.start_pos >= region_start
        if region_end != -1:
            ok0 &= self.end_pos < region_end
        self.ok0 = ok0
        self.fast_v = (
            _spans_empty_vec(motif_arr, sub_start - rl + 1, sub_start - 1)
            & _spans_empty_vec(motif_arr, sub_end - rl + 2, sub_end)
            & _spans_empty_vec(mod_pos, np.maximum(0, sub_start - site_halo),
                               sub_start - 1)
            & _spans_empty_vec(mod_pos, sub_end + 1, sub_end + site_halo))

    def strand_ok(self, event_record, ref_start_pos):
        """Per strand: each group's event bounds (e1, e2), their span d and
        the groups that pass the event QC (d > 10, the event-to-base
        ratio)."""
        e1_v, e2_v, okb = _find_by_ref_bounds_vec(
            event_record.aligned_events, self.sub_start + ref_start_pos,
            self.sub_end + ref_start_pos)
        d = np.abs(e2_v - e1_v)
        ratio = d.astype(np.float64) / np.maximum(
            self.sub_end - self.sub_start, 1)
        ok = self.ok0 & okb & (d > 10) & ~(ratio > MAX_EVENT_TO_BP_RATIO)
        return e1_v, e2_v, d, ok


def collect_read_tasks(sr, record, ref_seq, ref_start_pos, params,
                       region_start, region_end):
    """Per-read task generation (basemods.cpp:273-380) for the object path
    (``NPT_METH_ARRAY=0``).  Returns (segments, metas): two
    (HMMInputSequence, EventSequence) scoring units (unmethylated,
    methylated) per scored group, consumed by score_batch's shared
    ScoreBatcher, and one meta dict per group."""
    segments: List[Tuple] = []
    metas = []
    alphabet = params.alphabet
    g = _Groups(ref_seq, ref_start_pos, params, region_start, region_end)
    if len(g.motif_arr) == 0:
        return segments, metas
    # the unmethylated windows are slices of ref_seq, so their reverse
    # complements and kmer ranks are slices of once-per-read arrays, as
    # are the methylated windows' where g.fast_v holds
    n_ref, rc_ref = g.n_ref, g.rc_ref
    meth_ref, rc_meth_ref = g.meth_ref, g.rc_meth_ref
    ref_ranks: Dict[int, np.ndarray] = {}
    rc_ref_ranks: Dict[int, np.ndarray] = {}
    meth_ranks: Dict[int, np.ndarray] = {}
    rc_meth_ranks: Dict[int, np.ndarray] = {}
    for strand_idx, meth_model, event_record in _scorable_strands(
            sr, record, params):
        k = sr.get_model_k(strand_idx)
        rc = event_record.rc
        e1_v, e2_v, _, ok = g.strand_ok(event_record, ref_start_pos)

        if k not in ref_ranks:
            ref_ranks[k] = alphabet.seq_to_kmer_ranks(ref_seq, k)
            rc_ref_ranks[k] = alphabet.seq_to_kmer_ranks(rc_ref, k)
        for gi in np.flatnonzero(ok):
            sub_start_pos = int(g.sub_start[gi])
            sub_end_pos = int(g.sub_end[gi])
            e1, e2 = int(e1_v[gi]), int(e2_v[gi])
            subseq = ref_seq[sub_start_pos:sub_end_pos + 1]
            rc_subseq = rc_ref[n_ref - 1 - sub_end_pos:n_ref - sub_start_pos]

            unmeth = HMMInputSequence(subseq, rc_subseq, alphabet)
            nk_sub = sub_end_pos + 1 - sub_start_pos - k + 1
            unmeth._rank_cache[(k, False)] = \
                ref_ranks[k][sub_start_pos:sub_start_pos + nk_sub]
            s0 = n_ref - 1 - sub_end_pos
            unmeth._rank_cache[(k, True)] = \
                rc_ref_ranks[k][s0:s0 + nk_sub][::-1].copy()
            if g.fast_v[gi]:
                m_subseq = meth_ref[sub_start_pos:sub_end_pos + 1]
                meth = HMMInputSequence(
                    m_subseq, rc_meth_ref[s0:n_ref - sub_start_pos],
                    alphabet)
                if k not in meth_ranks:
                    meth_ranks[k] = alphabet.seq_to_kmer_ranks(meth_ref, k)
                    rc_meth_ranks[k] = alphabet.seq_to_kmer_ranks(
                        rc_meth_ref, k)
                meth._rank_cache[(k, False)] = \
                    meth_ranks[k][sub_start_pos:sub_start_pos + nk_sub]
                meth._rank_cache[(k, True)] = \
                    rc_meth_ranks[k][s0:s0 + nk_sub][::-1].copy()
            else:
                m_subseq = alphabet.methylate(subseq)
                meth = HMMInputSequence(m_subseq,
                                        alphabet.reverse_complement(m_subseq),
                                        alphabet)
            es = EventSequence(sr=sr, strand=strand_idx, rc=rc,
                               stride=event_record.stride,
                               event_start_idx=e1, event_stop_idx=e2)
            segments.append((unmeth, es))
            segments.append((meth, es))
            site_output_start = int(g.first[gi]) - k + 1
            site_output_end = int(g.last[gi]) + k
            metas.append({
                "strand_idx": strand_idx,
                "start_position": int(g.start_pos[gi]),
                "end_position": int(g.end_pos[gi]),
                "n_motif": int(g.ge[gi] - g.gs[gi]),
                "sequence": ref_seq[site_output_start:site_output_end],
            })
    return segments, metas


def score_batch(tasks, device=None) -> None:
    """The object path's scoring: every collected unit of the chunk in one
    ScoreBatcher flush (the indexed drain, ``csrc/forward_indexed.cu`` on
    the card) on ``device``; fills each read's site_score_map."""
    b = ScoreBatcher(device=device)
    index = []
    n_units = 0
    for t in tasks:
        for mi in range(len(t["metas"])):
            index.append((t, mi))
        for hs, es in t["segments"]:
            b.add([hs], es)
            n_units += 1
    if not n_units:
        return
    b.flush()
    scores = b.scores
    si = 0
    for (t, mi) in index:
        m = t["metas"][mi]
        unmeth_score = float(scores[si])
        meth_score = float(scores[si + 1])
        si += 2
        smap: Dict[int, ScoredSite] = t["site_score_map"]
        pos = m["start_position"]
        ss = smap.get(pos)
        if ss is None:
            ss = ScoredSite(chromosome=t["contig"], start_position=pos,
                            end_position=m["end_position"],
                            n_motif=m["n_motif"], sequence=m["sequence"])
            smap[pos] = ss
        ss.ll_unmethylated[m["strand_idx"]] = unmeth_score
        ss.ll_methylated[m["strand_idx"]] = meth_score
        ss.strands_scored += 1


class _ScoreArrays:
    """Per-chunk registries: whole-read rank rows, drift-level rows and
    calibrated model tables are registered once per read (or read-strand)
    and every group refers to them by (id, start, step);
    score_batch_arrays then builds the kernel inputs with a handful of
    batched gathers instead of per-group Python."""

    def __init__(self):
        self.rank_rows: List[np.ndarray] = []
        self.lev_rows: List[np.ndarray] = []
        self.mu_tabs: List[np.ndarray] = []
        self.sig_tabs: List[np.ndarray] = []

    def add_rank(self, arr: np.ndarray) -> int:
        self.rank_rows.append(arr)
        return len(self.rank_rows) - 1

    def add_levels(self, arr: np.ndarray) -> int:
        self.lev_rows.append(arr)
        return len(self.lev_rows) - 1

    def add_table(self, mu: np.ndarray, sig: np.ndarray) -> int:
        self.mu_tabs.append(mu)
        self.sig_tabs.append(sig)
        return len(self.mu_tabs) - 1


def _scorable_strands(sr, record, params):
    """(strand_idx, methylation model, event record) for each strand of
    the read that has events, a methylation model and aligned events."""
    pms = PoreModelSet.instance()
    for strand_idx in (0, 1):
        if not sr.has_events_for_strand(strand_idx):
            continue
        k = sr.get_model_k(strand_idx)
        if not pms.has_model(sr.get_model_kit_name(strand_idx),
                             params.methylation_type,
                             sr.get_model_strand_name(strand_idx), k):
            continue
        meth_model = sr.get_model(strand_idx, params.methylation_type)
        seq_record = SequenceAlignmentRecord.from_bam(record)
        event_record = EventAlignmentRecord.build(sr, strand_idx, seq_record)
        if event_record.aligned_events.shape[0] == 0:
            continue
        yield strand_idx, meth_model, event_record


def collect_read_tasks_arrays(sr, record, ref_seq, ref_start_pos, params,
                              region_start, region_end, reg: _ScoreArrays):
    """Per-read task generation (basemods.cpp:273-380) as one
    struct-of-arrays block per scored strand: group geometry, event
    bounds and QC, and each group's unmethylated/methylated rank row as
    (row id, start, step) into `reg`.  Returns a list of blocks."""
    alphabet = params.alphabet
    g = _Groups(ref_seq, ref_start_pos, params, region_start, region_end)
    if len(g.motif_arr) == 0:
        return []
    n_ref, rc_ref = g.n_ref, g.rc_ref
    meth_ref, rc_meth_ref = g.meth_ref, g.rc_meth_ref
    sub_start, sub_end = g.sub_start, g.sub_end
    ref_rank_ids: Dict[Tuple[int, bool], int] = {}
    meth_rank_ids: Dict[Tuple[int, bool], int] = {}

    blocks = []
    for strand_idx, meth_model, event_record in _scorable_strands(
            sr, record, params):
        k = sr.get_model_k(strand_idx)
        rc = event_record.rc
        e1_v, e2_v, d, ok = g.strand_ok(event_record, ref_start_pos)
        idx = np.flatnonzero(ok)
        if len(idx) == 0:
            continue

        # whole-read rank rows for this k, one direction (= event rc)
        rkey = (k, rc)
        ri_u = ref_rank_ids.get(rkey)
        if ri_u is None:
            ri_u = ref_rank_ids[rkey] = reg.add_rank(
                alphabet.seq_to_kmer_ranks(rc_ref if rc else ref_seq, k))
        ss = sub_start[idx]
        se = sub_end[idx]
        nk = se - ss - k + 2
        s0 = n_ref - 1 - se
        if rc:
            # the window's rc row is rc_ranks[s0 : s0+nk][::-1]
            ru_start = s0 + nk - 1
            rstep = -1
        else:
            ru_start = ss
            rstep = 1
        rm_src = np.empty(len(idx), np.int64)
        rm_start = np.empty(len(idx), np.int64)
        fast = g.fast_v[idx]
        if fast.any():
            mi = meth_rank_ids.get(rkey)
            if mi is None:
                mi = meth_rank_ids[rkey] = reg.add_rank(
                    alphabet.seq_to_kmer_ranks(
                        rc_meth_ref if rc else meth_ref, k))
            rm_src[fast] = mi
            rm_start[fast] = (s0 + nk - 1)[fast] if rc else ss[fast]
        for j in np.flatnonzero(~fast):
            m_subseq = alphabet.methylate(ref_seq[ss[j]:se[j] + 1])
            row = alphabet.seq_to_kmer_ranks(
                alphabet.reverse_complement(m_subseq) if rc else m_subseq, k)
            rm_src[j] = reg.add_rank(row)
            rm_start[j] = len(row) - 1 if rc else 0

        mu_t, sig_t = _model_tables(sr, strand_idx, meth_model)
        blocks.append({
            "lev": reg.add_levels(read_drift_levels(sr, strand_idx)),
            "tab": reg.add_table(mu_t, sig_t),
            "epb": float(sr.events_per_base[strand_idx]),
            "strand_idx": strand_idx,
            "e1": e1_v[idx],
            "estep": np.where(e2_v[idx] >= e1_v[idx], 1, -1),
            "nev": d[idx] + 1,
            "ru_src": np.full(len(idx), ri_u, np.int64),
            "ru_start": ru_start,
            "rstep": np.full(len(idx), rstep, np.int64),
            "rm_src": rm_src,
            "rm_start": rm_start,
            "nk": nk,
            "start_pos": g.start_pos[idx],
            "end_pos": g.end_pos[idx],
            "n_motif": g.ge[idx] - g.gs[idx],
            "seq_lo": g.first[idx] - k + 1,
            "seq_hi": g.last[idx] + k,
        })
    return blocks


def collect_read_tasks_native(sr, record, ref_seq, ref_start_pos, params,
                              region_start, region_end, reg: _ScoreArrays):
    """collect_read_tasks_arrays with the geometry in native code
    (csrc/meth_geometry.cpp): motif scan, grouping, event bounds, QC and
    the rank rows come back from one C call per strand.  The rank
    matrices register as one flat rank row whose per-group slices are
    addressed by (start=row*k_cap, step=1).  Returns None when the native
    library is unavailable or declines; the caller then uses the NumPy
    path."""
    lib = get_native_lib()
    if lib is None:
        return None
    alphabet = params.alphabet
    blocks = []
    for strand_idx, meth_model, event_record in _scorable_strands(
            sr, record, params):
        k = sr.get_model_k(strand_idx)
        g = lib.meth_geometry(
            ref_seq, event_record.aligned_events, ref_start_pos,
            region_start, region_end, params.min_separation,
            params.min_flank, k, event_record.rc, MAX_EVENT_TO_BP_RATIO,
            alphabet)
        if g is None:
            return None
        ng = g["ng"]
        if ng == 0:
            continue
        k_cap = g["k_cap"]
        ri_u = reg.add_rank(g["ranks_u"].reshape(-1))
        ri_m = reg.add_rank(g["ranks_m"].reshape(-1))
        row_starts = np.arange(ng, dtype=np.int64) * k_cap
        mu_t, sig_t = _model_tables(sr, strand_idx, meth_model)
        blocks.append({
            "lev": reg.add_levels(read_drift_levels(sr, strand_idx)),
            "tab": reg.add_table(mu_t, sig_t),
            "epb": float(sr.events_per_base[strand_idx]),
            "strand_idx": strand_idx,
            "e1": g["e1"],
            "estep": g["estep"],
            "nev": g["nev"],
            "ru_src": np.full(ng, ri_u, np.int64),
            "ru_start": row_starts,
            "rstep": np.ones(ng, np.int64),
            "rm_src": np.full(ng, ri_m, np.int64),
            "rm_start": row_starts,
            "nk": g["nk"],
            "start_pos": g["start_pos"],
            "end_pos": g["end_pos"],
            "n_motif": g["n_motif"],
            "seq_lo": g["seq_lo"],
            "seq_hi": g["seq_hi"],
        })
    return blocks


def score_batch_arrays(tasks, reg: _ScoreArrays, device=None):
    """Gather every task block's kernel inputs with batched host gathers
    and issue one asynchronous Forward sweep on ``device``; returns a
    zero-arg resolve() that fetches the scores and fills each task's
    site columns (run it on a worker thread to overlap the fetch with
    the next chunk's loading)."""
    blocks = [b for t in tasks for b in t["blocks"]]
    if not blocks:
        return lambda: None

    def cat(key):
        return np.concatenate([np.asarray(b[key], np.int64) for b in blocks])

    e1 = cat("e1")
    estep = cat("estep")
    nev = cat("nev")
    ru_src = cat("ru_src")
    ru_start = cat("ru_start")
    rstep = cat("rstep")
    rm_src = cat("rm_src")
    rm_start = cat("rm_start")
    nk = cat("nk")
    sizes = np.array([len(b["e1"]) for b in blocks], np.int64)
    lev_id = np.repeat([b["lev"] for b in blocks], sizes)
    tab_id = np.repeat([b["tab"] for b in blocks], sizes)
    epb = np.repeat(np.array([b["epb"] for b in blocks], np.float32), sizes)
    G = len(e1)

    lev_off = np.concatenate(
        [[0], np.cumsum([len(a) for a in reg.lev_rows])])[:-1]
    lev_buf = np.concatenate(reg.lev_rows + [np.zeros(1, np.float32)])
    lev_sentinel = len(lev_buf) - 1
    rank_off = np.concatenate(
        [[0], np.cumsum([len(a) for a in reg.rank_rows])])[:-1]
    rank_buf = np.concatenate(
        [np.asarray(a, np.int64) for a in reg.rank_rows]
        + [np.zeros(1, np.int64)])
    rank_sentinel = len(rank_buf) - 1

    Tc = int(nev.max())
    Kc = int(nk.max())
    art = np.arange(Tc, dtype=np.int64)[None, :]
    t_idx = lev_off[lev_id][:, None] + e1[:, None] + art * estep[:, None]
    t_idx = np.where(art < nev[:, None], t_idx, lev_sentinel)
    lev_g = lev_buf[t_idx]                       # [G, Tc] f32, 0-padded
    ark = np.arange(Kc, dtype=np.int64)[None, :]
    k_valid = ark < nk[:, None]
    ku = np.where(k_valid, rank_off[ru_src][:, None] + ru_start[:, None]
                  + ark * rstep[:, None], rank_sentinel)
    km = np.where(k_valid, rank_off[rm_src][:, None] + rm_start[:, None]
                  + ark * rstep[:, None], rank_sentinel)
    ranks_u = rank_buf[ku]
    ranks_m = rank_buf[km]

    S = max(len(t) for t in reg.mu_tabs)
    mu_stack = np.zeros((len(reg.mu_tabs), S), np.float32)
    sig_stack = np.ones((len(reg.mu_tabs), S), np.float32)
    for t, (mt, st) in enumerate(zip(reg.mu_tabs, reg.sig_tabs)):
        mu_stack[t, :len(mt)] = mt
        sig_stack[t, :len(st)] = st
    tcol = tab_id[:, None]
    z32 = np.float32(0.0)
    one32 = np.float32(1.0)
    mu_mat = np.concatenate([np.where(k_valid, mu_stack[tcol, ranks_u], z32),
                             np.where(k_valid, mu_stack[tcol, ranks_m], z32)])
    sig_mat = np.concatenate(
        [np.where(k_valid, sig_stack[tcol, ranks_u], one32),
         np.where(k_valid, sig_stack[tcol, ranks_m], one32)])
    levels_mat = np.concatenate([lev_g, lev_g])
    nev2 = np.tile(nev, 2).astype(np.int32)
    nk2 = np.tile(nk, 2).astype(np.int32)
    epb2 = np.tile(epb, 2)
    flags = np.full(2 * G, HMM_FLAGS, np.int32)
    with profile_scope("meth.drain_dispatch"):
        fetch = forward_arrays_async(levels_mat, nev2, mu_mat, sig_mat, nk2,
                                     epb2, flags, device=device)
    return _make_resolver(tasks, fetch, G)


def _make_resolver(tasks, fetch, G):
    """resolve(): fetch 2G scores (unmethylated block, then methylated)
    and fill each task's site columns."""
    def resolve():
        scores = fetch()
        su = scores[:G]
        sm = scores[G:]
        off = 0
        for t in tasks:
            bs = t["blocks"]
            if not bs:
                t["site_cols"] = None
                continue
            n_t = sum(len(b["e1"]) for b in bs)
            sl = slice(off, off + n_t)
            off += n_t
            pos = np.concatenate([b["start_pos"] for b in bs])
            endp = np.concatenate([b["end_pos"] for b in bs])
            nm = np.concatenate([b["n_motif"] for b in bs])
            lo = np.concatenate([b["seq_lo"] for b in bs])
            hi = np.concatenate([b["seq_hi"] for b in bs])
            # merge strands by position: metadata from the FIRST
            # occurrence (np.unique's return_index is the minimal index),
            # log-likelihood sums in concatenation order (strand 0 blocks
            # precede strand 1), output sorted by position
            uniq, first, inv = np.unique(pos, return_index=True,
                                         return_inverse=True)
            strand = np.concatenate(
                [np.full(len(b["e1"]), b["strand_idx"], np.int64)
                 for b in bs])
            su_t = su[sl].astype(np.float64)
            sm_t = sm[sl].astype(np.float64)
            sum_u = np.zeros(len(uniq))
            sum_m = np.zeros(len(uniq))
            np.add.at(sum_u, inv, su_t)
            np.add.at(sum_m, inv, sm_t)
            # strand-0 contributions kept separately: the modbam path
            # reads ll[0] alone (basemods.cpp:60 uses the template
            # strand's likelihoods)
            u0 = np.zeros(len(uniq))
            m0 = np.zeros(len(uniq))
            s0 = strand == 0
            np.add.at(u0, inv[s0], su_t[s0])
            np.add.at(m0, inv[s0], sm_t[s0])
            t["site_cols"] = {
                "pos": uniq, "end": endp[first], "n_motif": nm[first],
                "seq_lo": lo[first], "seq_hi": hi[first],
                "sum_u": sum_u, "sum_m": sum_m, "u0": u0, "m0": m0,
                "strands": np.bincount(inv, minlength=len(uniq)),
            }

    return resolve


def site_cols_to_map(t) -> Dict[int, ScoredSite]:
    """ScoredSite objects from resolved column arrays, for the modbam
    writers.  Strand-0 lls are exact (accumulated separately); strand 1
    is sum - strand0, which only the TSV sums would notice, and the TSV
    renders from the columns."""
    cols = t.get("site_cols")
    smap: Dict[int, ScoredSite] = {}
    if cols is None:
        return smap
    ref_seq = t["ref_seq"]
    for p, e, n, l, h, u, m, u0, m0, st in zip(
            cols["pos"].tolist(), cols["end"].tolist(),
            cols["n_motif"].tolist(), cols["seq_lo"].tolist(),
            cols["seq_hi"].tolist(), cols["sum_u"].tolist(),
            cols["sum_m"].tolist(), cols["u0"].tolist(),
            cols["m0"].tolist(), cols["strands"].tolist()):
        ss = ScoredSite(chromosome=t["contig"], start_position=p,
                        end_position=e, n_motif=n, sequence=ref_seq[l:h])
        ss.ll_unmethylated[0] = u0
        ss.ll_methylated[0] = m0
        ss.ll_unmethylated[1] = u - u0
        ss.ll_methylated[1] = m - m0
        ss.strands_scored = st
        smap[p] = ss
    return smap


def write_read_sites_cols(fp: TextIO, record, t) -> None:
    """The rows of call_methylation.cpp:532-550 (same float64 sums, :.2f
    formatting and position order) from resolved column arrays."""
    cols = t.get("site_cols")
    if cols is None:
        return
    orientation = "-" if record.is_reverse else "+"
    chrom = t["contig"]
    qname = record.qname
    ref_seq = t["ref_seq"]
    lib = get_native_lib()
    if lib is not None:
        res = lib.format_methylation_rows(chrom, orientation, qname,
                                          ref_seq, cols)
        if res is not None:
            fp.write(res)
            return
    rows = []
    for p, e, u, m, st, n, l, h in zip(
            cols["pos"].tolist(), cols["end"].tolist(),
            cols["sum_u"].tolist(), cols["sum_m"].tolist(),
            cols["strands"].tolist(), cols["n_motif"].tolist(),
            cols["seq_lo"].tolist(), cols["seq_hi"].tolist()):
        rows.append(f"{chrom}\t{orientation}\t{p}\t{e}\t{qname}\t"
                    f"{m - u:.2f}\t{m:.2f}\t{u:.2f}\t{st}\t{n}\t"
                    f"{ref_seq[l:h]}\n")
    fp.write("".join(rows))


# ---------------------------------------------------------------------------
# modbam output (basemods.cpp:34-235)
# ---------------------------------------------------------------------------

METHYLATED_SYMBOL = "M"


def get_modification_symbols(alphabet):
    """basemods.cpp:34-48: the canonical base carrying the modification."""
    site = alphabet.recognition_sites[0]
    site_m = alphabet.recognition_sites_methylated[0]
    for a, b in zip(site, site_m):
        if b == METHYLATED_SYMBOL:
            return a, METHYLATED_SYMBOL
    raise ValueError("no methylated symbol in recognition site")


def calculate_call_vectors(site_score_map, alphabet):
    """basemods.cpp:50-80."""
    positions: List[int] = []
    probs: List[int] = []
    for pos in sorted(site_score_map):
        call = site_score_map[pos]
        m_seq = alphabet.methylate(call.sequence)
        flank_offset = m_seq.find(METHYLATED_SYMBOL)
        if flank_offset < 0:
            continue
        p_m = math.exp(call.ll_methylated[0])
        p_u = math.exp(call.ll_unmethylated[0])
        denom = p_m + p_u
        prob = p_m / denom if denom > 0 else 0.5
        code = min(255, int(prob * 255))
        for j, ch in enumerate(m_seq):
            if ch == METHYLATED_SYMBOL:
                positions.append(call.start_position + j - flank_offset)
                probs.append(code)
    return positions, probs


def generate_mm_tag(unmodified_symbol: str, sequence: str,
                    call_seq_indices) -> str:
    """basemods.cpp:82-105."""
    parts = [f"{unmodified_symbol}+m?"]
    count_start = 0
    for idx in call_seq_indices:
        count = sum(1 for j in range(count_start, idx)
                    if sequence[j] == unmodified_symbol)
        parts.append(f",{count}")
        count_start = idx + 1
    return "".join(parts) + ";"


def create_modbam_record(record, site_score_map, alphabet):
    """Read-style modbam record (basemods.cpp:107-177)."""
    unmod, _ = get_modification_symbols(alphabet)
    positions, probs = calculate_call_vectors(site_score_map, alphabet)
    rc = record.is_reverse
    aln = SequenceAlignmentRecord.from_bam(record)
    original = DNA_ALPHABET.reverse_complement(record.seq) if rc \
        else record.seq
    ref_to_read = {}
    for ref_pos, read_pos in aln.aligned_bases:
        ref_to_read[int(ref_pos)] = (len(original) - int(read_pos) - 1) \
            if rc else int(read_pos)
    strand_offset = 1 if rc else 0
    idxs, out_probs = [], []
    for pos, prob in zip(positions, probs):
        ri = ref_to_read.get(pos + strand_offset)
        if ri is not None and original[ri] == unmod:
            idxs.append(ri)
            out_probs.append(prob)
    if rc:
        idxs.reverse()
        out_probs.reverse()
    delta = generate_mm_tag(unmod, original, idxs)
    out = BamRecord(qname=record.qname, flag=record.flag, tid=record.tid,
                    pos=record.pos, mapq=record.mapq,
                    cigar=list(record.cigar), mtid=record.mtid,
                    mpos=record.mpos, tlen=record.tlen, seq=record.seq,
                    qual=record.qual, tags=dict(record.tags))
    out.tags["Mm"] = ("Z", delta)
    out.tags["Ml"] = ("B", ("C", out_probs))
    return out


def create_reference_modbam_record(fai, contig, record, site_score_map,
                                   alphabet):
    """Reference-style modbam record (basemods.cpp:181-235)."""
    unmod, _ = get_modification_symbols(alphabet)
    positions, probs = calculate_call_vectors(site_score_map, alphabet)
    ref_seq = DNA_ALPHABET.disambiguate(
        fai.fetch(contig, record.pos, record.reference_end() + 1).upper())
    idxs = [p - record.pos for p in positions]
    delta = generate_mm_tag(unmod, ref_seq, idxs)
    return BamRecord(qname=record.qname, flag=0, tid=record.tid,
                     pos=record.pos, mapq=record.mapq,
                     cigar=[(0, len(ref_seq))], mtid=-1, mpos=-1, tlen=0,
                     seq=ref_seq, qual=np.full(len(ref_seq), 30, np.uint8),
                     tags={"Mm": ("Z", delta), "Ml": ("B", ("C", probs))})


def write_site_header(fp: TextIO):
    fp.write("chromosome\tstrand\tstart\tend\tread_name\t"
             "log_lik_ratio\tlog_lik_methylated\tlog_lik_unmethylated\t"
             "num_calling_strands\tnum_motifs\tsequence\n")


def write_read_sites(fp: TextIO, record, site_score_map):
    """call_methylation.cpp:532-550 with identical formats, from the object
    path's ScoredSite map."""
    orientation = "-" if record.is_reverse else "+"
    for pos in sorted(site_score_map):
        ss = site_score_map[pos]
        sum_ll_m = ss.ll_methylated[0] + ss.ll_methylated[1]
        sum_ll_u = ss.ll_unmethylated[0] + ss.ll_unmethylated[1]
        diff = sum_ll_m - sum_ll_u
        fp.write(f"{ss.chromosome}\t{orientation}\t{ss.start_position}\t"
                 f"{ss.end_position}\t")
        fp.write(f"{record.qname}\t{diff:.2f}\t")
        fp.write(f"{sum_ll_m:.2f}\t{sum_ll_u:.2f}\t")
        fp.write(f"{ss.strands_scored}\t{ss.n_motif}\t{ss.sequence}\n")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanopolish_tpu_torch call-methylation",
        description="classify nucleotides as methylated or not")
    p.add_argument("-r", "--reads", default="")
    p.add_argument("-b", "--bam", default="")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-q", "--methylation", default="cpg")
    p.add_argument("-w", "--window", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-K", "--batchsize", type=int, default=512)
    p.add_argument("--min-mapping-quality", type=int, default=20)
    p.add_argument("--min-separation", type=int, default=10)
    p.add_argument("--min-flank", type=int, default=10)
    p.add_argument("--models-fofn", default="")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--shard", default="0/1",
                   help="process shard as index/total (e.g. 2/8)")
    p.add_argument("--modbam-output-name", default="")
    p.add_argument("--modbam-style", default="reference",
                   choices=["read", "reference"])
    p.add_argument("--watch", default="",
                   help="watch a sequencing run directory for new reads")
    p.add_argument("--watch-process-total", type=int, default=1)
    p.add_argument("--watch-process-index", type=int, default=0)
    p.add_argument("--watch-mapper", default="minimap2",
                   help="external mapper executable for watch mode")
    p.add_argument("--watch-mapper-opts", default="-ax map-ont",
                   help="options passed to the mapper before genome+fastq")
    p.add_argument("--watch-poll", type=float, default=30.0,
                   help="seconds between directory scans")
    p.add_argument("--watch-once", action="store_true",
                   help="process the current backlog, then exit")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest and the HMM run (default: cuda; "
                        "there is no automatic fallback to the cpu)")
    return p


def _discover_watch_work(opt) -> List[str]:
    """Assigned, unfinished fastq files under the watched run directory.
    Mirrors the reference's layout assumptions (fastq_pass/ trees,
    call_methylation.cpp:268-321) and its process sharding by numeric
    file suffix mod N (call_methylation.cpp:489-508)."""
    import glob
    import re
    import zlib

    files = sorted({f for pat in ("*.fastq", "*.fq")
                    for f in glob.glob(os.path.join(opt.watch, "**", pat),
                                       recursive=True)})
    in_pass = [f for f in files if "fastq_pass" in f]
    files = in_pass or files
    sel = []
    for f in files:
        m = re.search(r"(\d+)\.f(?:ast)?q$", os.path.basename(f))
        idx = int(m.group(1)) if m else zlib.crc32(f.encode())
        if idx % opt.watch_process_total == opt.watch_process_index:
            sel.append(f)
    return sel


def _process_watch_pair(opt, fastq: str, out_tsv: str, device) -> None:
    """Index + map + call one fastq chunk on ``device``; writes out_tsv
    atomically."""
    import copy
    import glob
    import shlex
    import subprocess

    from ..io.bam import sam_to_bam
    from . import index as index_app

    sys.stderr.write(f"[watch] processing {fastq}\n")
    # signal source: sibling fast5_pass/slow5_pass tree, else alongside
    fq_dir = os.path.dirname(fastq)
    sig_dir = fq_dir
    for sub in ("fast5_pass", "slow5_pass", "blow5_pass"):
        cand = fq_dir.replace("fastq_pass", sub)
        if cand != fq_dir and os.path.isdir(cand):
            sig_dir = cand
            break
    slow5s = sorted(glob.glob(os.path.join(sig_dir, "*.slow5")) +
                    glob.glob(os.path.join(sig_dir, "*.blow5")))
    argv = [fastq]
    if slow5s:
        stem = os.path.splitext(os.path.basename(fastq))[0]
        match = [s for s in slow5s
                 if os.path.splitext(os.path.basename(s))[0] == stem]
        argv += ["--slow5", (match or slow5s)[0]]
    else:
        argv += ["-d", sig_dir]
    index_app.main(argv)

    sam = fastq + ".watch.sam"
    bam = fastq + ".watch.bam"
    cmd = [opt.watch_mapper] + shlex.split(opt.watch_mapper_opts) + \
        [opt.genome, fastq]
    with open(sam, "w") as sfh:
        subprocess.run(cmd, stdout=sfh, check=True)
    sam_to_bam(sam, bam)

    opt2 = copy.copy(opt)
    opt2.watch = ""
    opt2.reads = fastq
    opt2.bam = bam
    if opt.modbam_output_name:
        opt2.modbam_output_name = fastq + ".mods.bam"
    tmp = out_tsv + ".tmp"
    with open(tmp, "w") as fh:
        _call_single(opt2, fh, device)
    os.replace(tmp, out_tsv)


def run_watch_mode(opt, out, device):
    """Live calling mode (call_methylation.cpp:213-530): poll the run
    directory for finished fastq chunks, shard them across processes by
    numeric suffix mod N, map each with an external mapper (the reference
    embeds minimap2; this build shells out to one), then run the normal
    calling path per chunk on ``device``, writing <chunk>.meth.tsv next
    to it.  Existing .meth.tsv files mark chunks done, so a restarted
    watcher resumes where it left off."""
    import shutil
    import time

    if shutil.which(opt.watch_mapper) is None:
        raise SystemExit(
            f"call-methylation --watch requires a mapper executable "
            f"({opt.watch_mapper!r} not found in PATH). Install minimap2 "
            f"or pass --watch-mapper.")
    sys.stderr.write(
        f"[watch] watching {opt.watch} as process "
        f"{opt.watch_process_index}/{opt.watch_process_total}\n")
    processed = set()
    while True:
        did = 0
        for fastq in _discover_watch_work(opt):
            if fastq in processed:
                continue
            out_tsv = fastq + ".meth.tsv"
            if os.path.exists(out_tsv):
                processed.add(fastq)
                continue
            _process_watch_pair(opt, fastq, out_tsv, device)
            processed.add(fastq)
            did += 1
        if opt.watch_once:
            return 0
        if not did:
            time.sleep(opt.watch_poll)


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)
    if opt.watch:
        return run_watch_mode(opt, out, device)
    if not opt.reads or not opt.bam:
        raise SystemExit(
            "call-methylation: -r/--reads and -b/--bam are required "
            "(unless --watch is given)")
    return _call_single(opt, out, device)


def _call_single(opt, out, device):
    with profile_scope("meth.pass") as pass_span:
        return _call_pass(opt, out, device, pass_span)


def _call_pass(opt, out, device, pass_span):
    if opt.models_fofn:
        PoreModelSet.instance().initialize(opt.models_fofn)
    params = CallingParameters(methylation_type=opt.methylation,
                               min_separation=opt.min_separation,
                               min_flank=opt.min_flank)

    with profile_scope("meth.open"):
        read_db = ReadDB()
        read_db.load(opt.reads)
        fai = FastaIndex(opt.genome)
        shard_index, shard_total = (int(x) for x in opt.shard.split("/"))
        proc = BamBatchProcessor(opt.bam, region=opt.window,
                                 batch_size=opt.batchsize,
                                 min_mapping_quality=opt.min_mapping_quality,
                                 max_reads=opt.max_reads,
                                 shard_index=shard_index,
                                 shard_total=shard_total)
    region_start = proc.clip_start if opt.window else -1
    region_end = proc.clip_end if (opt.window and proc.clip_end >= 0) else -1

    bam_writer = None
    if opt.modbam_output_name:
        bam_writer = BamWriter(opt.modbam_output_name, proc.header_text,
                               proc.references, proc.reader.lengths)

    # NPT_METH_ARRAY=0 takes the object path (per-window HMMInputSequence
    # pairs through ScoreBatcher's indexed drain), NPT_METH_NATIVE=0 the
    # array path's NumPy geometry instead of csrc/meth_geometry.cpp
    use_array = os.environ.get("NPT_METH_ARRAY", "1") != "0"
    use_native = os.environ.get("NPT_METH_NATIVE", "1") != "0"

    def build_task(item, reads, reg):
        read_idx, rec = item
        sr = reads.get(rec.qname)
        if sr is None:
            return None
        contig = proc.references[rec.tid]
        ref_seq = DNA_ALPHABET.disambiguate(
            fai.fetch(contig, rec.pos, rec.reference_end() + 1).upper())
        t = {"record": rec, "contig": contig, "ref_seq": ref_seq}
        if reg is None:
            t["segments"], t["metas"] = collect_read_tasks(
                sr, rec, ref_seq, rec.pos, params, region_start, region_end)
            t["site_score_map"] = {}
            return t
        blocks = collect_read_tasks_native(
            sr, rec, ref_seq, rec.pos, params, region_start, region_end,
            reg) if use_native else None
        if blocks is None:
            blocks = collect_read_tasks_arrays(
                sr, rec, ref_seq, rec.pos, params, region_start, region_end,
                reg)
        t["blocks"] = blocks
        return t

    def load_and_build(records, chunk):
        """Loader-thread stage: signal load + ingest, then task geometry."""
        with profile_scope("meth.load_chunk", parent=pass_span, chunk=chunk):
            names = sorted({rec.qname for _, rec in records})
            reads = load_squiggle_reads(names, read_db,
                                        stats=GLOBAL_READ_STATS,
                                        num_threads=opt.threads,
                                        device=device)
            reg = _ScoreArrays() if use_array else None
            with profile_scope("meth.collect"):
                built = [build_task(item, reads, reg) for item in records]
            return [t for t in built if t is not None], reg

    def resolve_chunk(resolve, chunk):
        """Fetch-thread stage: a chunk's scores and site columns."""
        with profile_scope("meth.resolve", parent=pass_span, chunk=chunk):
            resolve()

    def write_tasks(tasks, chunk):
        with profile_scope("meth.write", chunk=chunk):
            for t in tasks:
                if use_array:
                    write_read_sites_cols(out, t["record"], t)
                    smap = site_cols_to_map(t) \
                        if bam_writer is not None else None
                else:
                    smap = t["site_score_map"]
                    write_read_sites(out, t["record"], smap)
                if bam_writer is None:
                    continue
                if opt.modbam_style == "read":
                    rec = create_modbam_record(t["record"], smap,
                                               params.alphabet)
                else:
                    rec = create_reference_modbam_record(
                        fai, t["contig"], t["record"], smap, params.alphabet)
                bam_writer.write(rec)

    # Chunks load (signal, ingest, geometry) on loader threads with a
    # bounded lookahead; on the array path this thread issues each chunk's
    # Forward sweep and a fetch thread resolves it, so a chunk's scoring
    # overlaps the next chunks' loading; the object path scores each chunk
    # here.  Output stays in BAM order within each batch.  A chunk's spans
    # on every thread share its id (the pass's span id, chunk index).
    write_site_header(out)
    pass_id = pass_span.id if pass_span else 0
    n_chunks = 0
    batches = proc.batches()
    with (ThreadPoolExecutor(LOADERS, thread_name_prefix="loader") as ing_pool,
          ThreadPoolExecutor(2, thread_name_prefix="fetch") as fetch_pool):
        while True:
            with profile_scope("meth.next_batch"):
                batch = next(batches, None)
            if batch is None:
                break
            subs = [batch[i:i + PIPE_CHUNK]
                    for i in range(0, len(batch), PIPE_CHUNK)]
            ids = [(pass_id, n_chunks + i) for i in range(len(subs))]
            n_chunks += len(subs)
            ing_futs = deque(ing_pool.submit(load_and_build, s, c)
                             for s, c in zip(subs[:LOOKAHEAD], ids))
            done: deque = deque()

            def drain(block: bool) -> None:
                while done:
                    tasks, fut, chunk = done[0]
                    if fut is not None:
                        if not block and not fut.done():
                            return
                        with profile_scope("meth.drain_wait", chunk=chunk):
                            fut.result()
                    done.popleft()
                    write_tasks(tasks, chunk)

            for ci in range(len(subs)):
                with profile_scope("meth.wait_chunk", chunk=ids[ci]):
                    tasks, reg = ing_futs.popleft().result()
                if ci + LOOKAHEAD < len(subs):
                    ing_futs.append(ing_pool.submit(
                        load_and_build, subs[ci + LOOKAHEAD],
                        ids[ci + LOOKAHEAD]))
                if use_array:
                    with profile_scope("meth.drain_prep", chunk=ids[ci]):
                        resolve = score_batch_arrays(tasks, reg,
                                                     device=device)
                    done.append((tasks, fetch_pool.submit(
                        resolve_chunk, resolve, ids[ci]), ids[ci]))
                else:
                    score_batch(tasks, device=device)
                    done.append((tasks, None, ids[ci]))
                drain(block=False)
            drain(block=True)
    if bam_writer is not None:
        bam_writer.close()
    proc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
