"""`variants` / `variants --consensus` subcommand: window-based variant
calling and assembly polishing.

Rebuild of src/nanopolish_call_variants.cpp (pipeline
call_variants_for_region :882-1011, candidate generation :288-361,
screening :364-402, expansion :406-450, haplotype calling :782-880) and
src/common/nanopolish_variant.cpp (score_variant_group :182-262,
simple_call :279-493, score_variant_thresholded :765-799).

Every phase pools its (sequence x read event range) Forward scoring into
one indexed drain on the card (``ops/profile_hmm_indexed``).  Screening
implements the reference's score_variant_thresholded early exit batched:
reads are consumed in chunks across all candidates at once, and a
candidate whose running sum falls below -screen_score_threshold stops
scoring; accepted variants (quality > 0) score every read, so their
qualities are those of the untruncated sum.  Unit scores and job totals
are memoized per loaded region, so the polishing loop's round-over-round
re-screens and the base haplotype shared by the ~9 candidate edits at a
position are scored once.  The transition probabilities (``--p-skip`` and
its family, the mode's indel bias) travel on ``Opts`` to every transition
table the app builds.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from ..alignment.alignment_db import AlignmentDB, EventSequence
from ..alignment.segments import (ScoreBatcher, event_key, forward_segments,
                                  make_segment, model_table_rows,
                                  read_drift_levels, seq_set_key,
                                  table_stack, viterbi_segments)
from ..io.vcf import Variant, VcfReader, VcfWriter
from ..models.duration_model import (MIN_DURATION, durations_from_alignment,
                                     log_gamma_sum)
from ..models.haplotype import Haplotype
from ..models.hmm_input import HMMInputSequence
from ..models.pore_model import PoreModelSet
from ..models.variant_db import (CO_WITH_REPLACEMENT, VariantDB, VariantGroup,
                                 combinations, nchoosek)
from ..ops.profile_hmm import (HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP,
                               make_transitions)
from ..ops.profile_hmm_indexed import forward_indexed_scores
from ..utils.alphabet import DNA_ALPHABET, get_alphabet_by_name
from ..utils.device import resolve_device
from ..utils.logsum import logsum_mode
from ..utils.profiler import profile_scope

ALIGNMENT_FLAGS = HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP


class Opts:
    """Defaults from nanopolish_call_variants.cpp:106-140."""

    def __init__(self):
        self.min_candidate_frequency = 0.2
        self.min_candidate_depth = 20
        self.min_distance_between_variants = 10
        self.min_flanking_sequence = 30
        self.max_haplotypes = 1000
        self.max_rounds = 50
        self.screen_score_threshold = 100
        self.screen_flanking_sequence = 10
        self.ploidy = 2
        self.consensus_mode = False
        self.genotype_only = False
        self.snps_only = False
        self.fix_homopolymers = False
        self.calculate_all_support = False
        self.verbose = False
        self.methylation_types: List[str] = []
        # hmm_indel_bias_factor (profile_hmm_r9.cpp:14-19): 1.0 until
        # main() applies the mode default 0.9 (consensus) / 0.8 (calling)
        # from call_variants.cpp:1114-1117, or the -i override
        self.indel_bias = 1.0
        # the reference's g_p_skip / g_p_skip_self / g_p_bad / g_p_bad_self
        # (call_variants.cpp:187-190); p_bad_self None = p_bad
        self.p_skip = 0.0025
        self.p_skip_self = 0.3
        self.p_bad = 0.001
        self.p_bad_self: Optional[float] = None
        self.device = None          # cuda, unless main() or a caller sets it

    def probs(self) -> dict:
        """The transition probabilities for make_transitions."""
        return dict(p_skip=self.p_skip, p_bad=self.p_bad,
                    p_skip_self=self.p_skip_self, p_bad_self=self.p_bad_self)

    def batcher(self, memo: Optional[dict] = None) -> ScoreBatcher:
        return ScoreBatcher(self.indel_bias, memo=memo, device=self.device,
                            probs=self.probs())


# ---------------------------------------------------------------------------
# batched scoring primitives
# ---------------------------------------------------------------------------

_SEQ_SET_CACHE: Dict[tuple, List[HMMInputSequence]] = {}
_SEQ_SET_CACHE_CAP = 300_000


def generate_methylated_alternatives(sequence: str,
                                     methylation_types: Sequence[str]
                                     ) -> List[HMMInputSequence]:
    """nanopolish_variant.cpp:161-178.

    Interned per (sequence, types): callers only read the returned list,
    so repeats (the 9 candidate edits at a position share a base
    haplotype; the polishing loop re-screens the same candidates every
    round) reuse one object, its kmer-rank cache and its rank row in a
    ScoreBatcher flush."""
    ckey = (sequence, tuple(methylation_types))
    out = _SEQ_SET_CACHE.get(ckey)
    if out is not None:
        return out
    out = [HMMInputSequence(sequence)]
    for mt in methylation_types:
        alphabet = get_alphabet_by_name(mt)
        methylated = alphabet.methylate(sequence)
        if methylated != sequence:
            out.append(HMMInputSequence(methylated, alphabet=alphabet))
    if len(_SEQ_SET_CACHE) >= _SEQ_SET_CACHE_CAP:
        _SEQ_SET_CACHE.clear()          # bound memory on huge windows
    _SEQ_SET_CACHE[ckey] = out
    return out


def _job_total_memo(alignments) -> dict:
    """Per-region job-total memo (reset with load_region, like
    score_memo)."""
    region = (alignments.get_region_contig(), alignments.get_region_start(),
              alignments.get_region_end())
    m = getattr(alignments, "_job_total_memo", None)
    if m is None or getattr(alignments, "_job_memo_region", None) != region:
        m = alignments._job_total_memo = {}
        alignments._job_memo_region = region
    return m


_DEFER = object()        # marks a job-total memo key built after scoring


def _events_memo_key(events) -> tuple:
    return tuple(event_key(d) for d in events)


def score_variants_batched_arrays(variant_jobs, indel_bias: float = 1.0,
                                  screen_threshold: Optional[float] = None,
                                  chunk_reads: int = 8,
                                  total_memo: Optional[dict] = None,
                                  device=None, probs: Optional[dict] = None
                                  ) -> Optional[List[float]]:
    """score_variants_batched for single-sequence scoring sets (no
    methylation alternatives) over fresh haplotypes, with the indexed
    inputs built by array operations instead of per-unit ScoreBatcher
    calls.  Same chunk schedule, early-exit checkpoints, f64 accumulation
    order and Forward drain as the object path, so the totals are
    bit-identical to it.  Returns None when a job's haplotype is not a
    fresh reference substring or a read's model is not a 6-mer nucleotide
    model (the caller then takes the object path)."""
    n_jobs = len(variant_jobs)
    totals = np.full(n_jobs, float("-inf"))
    if n_jobs == 0:
        return totals.tolist()
    dev = resolve_device(device)

    k = 6
    # this path ranks plain-nucleotide 6-mers; any other model k or
    # alphabet takes the object path, which uses model.k.  Checked once
    # per event list and (read, strand): the jobs repeat them ~9x
    seen_ev_lists = set()
    seen_models = set()
    for _, _, events in variant_jobs:
        if id(events) in seen_ev_lists:
            continue
        seen_ev_lists.add(id(events))
        for d in events:
            mk = (id(d.sr), d.strand)
            if mk in seen_models:
                continue
            seen_models.add(mk)
            m = d.sr.base_model[d.strand]
            if m.k != k or m.alphabet.name != "nucleotide":
                return None
    # ---- registries ----
    seq_rows: Dict[str, int] = {}
    seq_list: List[str] = []
    ev_rows: Dict[tuple, int] = {}
    ev_list: List[EventSequence] = []
    evlist_ids: Dict[int, Tuple[np.ndarray, tuple]] = {}

    def seq_row(s: str) -> int:
        r = seq_rows.get(s)
        if r is None:
            r = seq_rows[s] = len(seq_list)
            seq_list.append(s)
        return r

    def ev_row(d) -> int:
        dk = event_key(d)
        r = ev_rows.get(dk)
        if r is None:
            r = ev_rows[dk] = len(ev_list)
            ev_list.append(d)
        return r

    # ---- per-job prep: Haplotype.apply_variant on a fresh haplotype ----
    job_base = np.full(n_jobs, -1, np.int64)
    job_var = np.full(n_jobs, -1, np.int64)
    job_evlist: List[Optional[np.ndarray]] = [None] * n_jobs
    job_keys: List[Optional[tuple]] = [None] * n_jobs
    alive: List[int] = []
    for ji, (hap, v, events) in enumerate(variant_jobs):
        base_seq = hap.sequence
        if base_seq != hap.reference:
            return None                 # not a fresh haplotype
        di = v.ref_position - hap.ref_position
        rl_ = len(v.ref_seq)
        if di < 0 or di + rl_ > len(base_seq) or \
                base_seq[di:di + rl_] != v.ref_seq:
            continue                    # apply_variant fails: -inf
        var_seq = base_seq[:di] + v.alt_seq + base_seq[di + rl_:]
        ent = evlist_ids.get(id(events))
        if ent is None:
            ent = evlist_ids[id(events)] = (
                np.array([ev_row(d) for d in events], np.int64),
                _events_memo_key(events))
        rows, ekey = ent
        if total_memo is not None:
            if total_memo:
                kkey = (((base_seq, "nucleotide"),),
                        ((var_seq, "nucleotide"),),
                        ekey, screen_threshold, chunk_reads, indel_bias)
                hit = total_memo.get(kkey)
                if hit is not None:
                    totals[ji] = hit
                    continue
                job_keys[ji] = kkey
            else:
                # a region's first screen: every lookup would miss, so the
                # key (two window strings per job) is built after scoring
                # and only for the jobs that may be screened again
                job_keys[ji] = (_DEFER, ekey)
        job_base[ji] = seq_row(base_seq)
        job_var[ji] = seq_row(var_seq)
        job_evlist[ji] = rows
        totals[ji] = 0.0
        alive.append(ji)
    if not alive:
        return totals.tolist()

    # ---- unique event rows: levels by one windowed gather ----
    E = len(ev_list)
    lev_srcs: Dict[tuple, int] = {}
    lev_bufs: List[np.ndarray] = []
    tab_list: List[EventSequence] = []
    lev_id = np.empty(E, np.int64)
    e1 = np.empty(E, np.int64)
    estep = np.empty(E, np.int64)
    nev = np.empty(E, np.int64)
    tab_of_ev = np.empty(E, np.int64)
    for r, d in enumerate(ev_list):
        key = (id(d.sr), d.strand)
        li = lev_srcs.get(key)
        if li is None:
            li = lev_srcs[key] = len(lev_bufs)
            lev_bufs.append(read_drift_levels(d.sr, d.strand))
            tab_list.append(d)
        lev_id[r] = li
        tab_of_ev[r] = li
        e1[r] = d.event_start_idx
        estep[r] = 1 if d.event_stop_idx >= d.event_start_idx else -1
        nev[r] = abs(d.event_stop_idx - d.event_start_idx) + 1
    lev_off = np.concatenate(
        [[0], np.cumsum([len(a) for a in lev_bufs])])[:-1]
    lev_buf = np.concatenate(lev_bufs + [np.zeros(1, np.float32)])
    sent = len(lev_buf) - 1
    Tc = int(nev.max())
    art = np.arange(Tc, dtype=np.int64)[None, :]
    # reversed ranges (stop < start) walk the read backwards
    t_idx = lev_off[lev_id][:, None] + e1[:, None] + art * estep[:, None]
    t_idx = np.where(art < nev[:, None], t_idx, sent)
    levels_u = lev_buf[t_idx].astype(np.float32)
    n_ev_u = nev.astype(np.int32)

    # ---- unique sequences' rank rows: one rank pass over them joined ----
    lens = np.array([len(s) for s in seq_list], np.int64)
    pad = k                             # >= k-1 separator: no kmer spans two
    starts = np.concatenate([[0], np.cumsum(lens + pad)])[:-1]
    big = ("A" * pad).join(seq_list) + "A" * pad
    big_ranks = DNA_ALPHABET.seq_to_kmer_ranks(big, k)
    n_km_u = (lens - k + 1).astype(np.int32)
    Kc = int(n_km_u.max())
    akc = np.arange(Kc, dtype=np.int64)[None, :]
    ridx = np.minimum(starts[:, None] + akc, len(big_ranks) - 1)
    rank_mat = np.where(akc < n_km_u[:, None], big_ranks[ridx],
                        0).astype(np.int32)

    # ---- tables + transitions per (read, strand) ----
    tabs = table_stack([model_table_rows(d.sr, d.strand,
                                         d.sr.base_model[d.strand])
                        for d in tab_list])
    epb_arr = np.array([d.sr.events_per_base[d.strand] for d in tab_list],
                       np.float32)
    trans_u = make_transitions(epb_arr, indel_bias, **(probs or {}))

    def score_ids(ids):
        with profile_scope("va.score_ids"):
            return forward_indexed_scores(levels_u, n_ev_u, tabs, rank_mat,
                                          n_km_u, trans_u, ids,
                                          ALIGNMENT_FLAGS, device=dev,
                                          logsum=logsum_mode())

    # ---- geometric chunk loop (the object path's schedule and order) ----
    max_events = max(len(job_evlist[ji]) for ji in alive)
    lo = 0
    step = max(1, chunk_reads // 2) if screen_threshold is not None \
        else max(max_events, 1)
    alive_arr = np.asarray(alive, np.int64)
    n_seq = len(seq_list) + 1
    while lo < max_events and alive_arr.size:
        parts = []
        jis = []
        for ji in alive_arr.tolist():
            rows = job_evlist[ji][lo:lo + step]
            if rows.size:
                parts.append(rows)
                jis.append(np.full(rows.size, ji, np.int64))
        if not parts:
            break
        evc = np.concatenate(parts)
        jic = np.concatenate(jis)
        tabc = tab_of_ev[evc]
        # the ~9 edits at a position share the base haplotype: score each
        # unique (event row, base sequence) once (the object path's
        # in-flight dedup), then broadcast through the inverse map
        uniq_b, inv_b = np.unique(evc * n_seq + job_base[jic],
                                  return_inverse=True)
        ub_ev = uniq_b // n_seq
        ub_tab = tab_of_ev[ub_ev]
        ids_base = np.stack([ub_ev, ub_tab, uniq_b % n_seq, ub_tab],
                            axis=1).astype(np.int32)
        ids_var = np.stack([evc, tabc, job_var[jic], tabc],
                           axis=1).astype(np.int32)
        s_all = score_ids(np.concatenate([ids_base, ids_var]))
        nub = len(uniq_b)
        delta = s_all[nub:].astype(np.float64) - \
            s_all[:nub].astype(np.float64)[inv_b.reshape(-1)]
        np.add.at(totals, jic, delta)
        if screen_threshold is not None:
            alive_arr = alive_arr[totals[alive_arr] > -screen_threshold]
        lo += step
        step *= 2
    if total_memo is not None:
        keep_thr = -screen_threshold if screen_threshold is not None \
            else float("-inf")
        for ji, kk in enumerate(job_keys):
            if kk is None:
                continue
            if kk[0] is _DEFER:
                if not (totals[ji] > keep_thr) or job_base[ji] < 0:
                    continue
                kk = (((seq_list[job_base[ji]], "nucleotide"),),
                      ((seq_list[job_var[ji]], "nucleotide"),),
                      kk[1], screen_threshold, chunk_reads, indel_bias)
            total_memo[kk] = totals[ji]
    return totals.tolist()


def score_variants_batched(variant_jobs, methylation_types,
                           indel_bias: float = 1.0,
                           memo: Optional[dict] = None,
                           screen_threshold: Optional[float] = None,
                           chunk_reads: int = 8,
                           total_memo: Optional[dict] = None,
                           device=None, probs: Optional[dict] = None
                           ) -> List[float]:
    """Each job: (base_haplotype, variant, event_sequences).  Returns the
    summed (variant - base) score over reads per job.

    With ``screen_threshold``, reads are consumed in chunks and a job whose
    running sum falls below -threshold stops scoring further reads: the
    reference's score_variant_thresholded early exit
    (nanopolish_variant.cpp:765-799), batched.  The reference checks after
    every read, this after each chunk (chunk_reads/2 reads, then doubling),
    so every variant the reference would accept gets the identical
    untruncated quality and rejected ones are scored a few reads further.
    Without it, every read is scored (exact sum)."""
    prepared: List[Optional[Tuple]] = []
    for base_hap, variant, events in variant_jobs:
        var_hap = Haplotype(base_hap.ref_name, base_hap.ref_position,
                            base_hap.get_reference())
        var_hap.sequence = base_hap.sequence
        var_hap.coordinate_map = list(base_hap.coordinate_map)
        if not var_hap.apply_variant(variant):
            prepared.append(None)
            continue
        base_seqs = generate_methylated_alternatives(
            base_hap.get_sequence(), methylation_types)
        var_seqs = generate_methylated_alternatives(
            var_hap.get_sequence(), methylation_types)
        prepared.append((base_seqs, var_seqs, events,
                         seq_set_key(base_seqs), seq_set_key(var_seqs)))

    n_jobs = len(prepared)
    totals = np.full(n_jobs, float("-inf"))
    # job-total memo: the polishing loop re-screens the same candidates
    # over the same region reads every round, and a job's total (with its
    # truncation point) depends only on its inputs
    job_keys: List[Optional[tuple]] = [None] * n_jobs
    alive = []
    for ji, p in enumerate(prepared):
        if p is None:
            continue
        if total_memo is not None:
            base_seqs, var_seqs, events, base_key, var_key = p
            kk = (base_key, var_key, _events_memo_key(events),
                  screen_threshold, chunk_reads, indel_bias)
            hit = total_memo.get(kk)
            if hit is not None:
                totals[ji] = hit
                continue
            job_keys[ji] = kk
        alive.append(ji)
        totals[ji] = 0.0
    max_events = max((len(p[2]) for p in prepared if p is not None),
                     default=0)
    # geometric chunk schedule: most screening candidates are losers whose
    # running sum dives at once, so the first checkpoint comes after
    # chunk_reads/2 reads and later chunks double
    lo = 0
    step = max(1, chunk_reads // 2) if screen_threshold is not None \
        else max(max_events, 1)
    while lo < max_events:
        b = ScoreBatcher(indel_bias, memo=memo, device=device, probs=probs)
        units: List[Tuple[int, int, int]] = []
        add = b.add
        for ji in alive:
            base_seqs, var_seqs, events, base_key, var_key = prepared[ji]
            for ev in events[lo:lo + step]:
                units.append((ji, add(base_seqs, ev, base_key),
                              add(var_seqs, ev, var_key)))
        if not units:
            break
        b.flush()
        ua = np.asarray(units, np.int64)
        s = b.scores
        np.add.at(totals, ua[:, 0], s[ua[:, 2]] - s[ua[:, 1]])
        if screen_threshold is not None:
            alive = [ji for ji in alive if totals[ji] > -screen_threshold]
            if not alive:
                break
        lo += step
        step *= 2
    if total_memo is not None:
        for ji, kk in enumerate(job_keys):
            if kk is not None:
                total_memo[kk] = totals[ji]
    return totals.tolist()


# ---------------------------------------------------------------------------
# candidate generation / screening / expansion
# ---------------------------------------------------------------------------

def _screen_scores(jobs, alignments, opts) -> List[float]:
    """Screening: the array path for plain nucleotide scoring over fresh
    haplotypes, the object path otherwise (methylation alternatives, or
    every screen under ``NPT_VAR_ARRAY=0``)."""
    kw = dict(screen_threshold=opts.screen_score_threshold,
              total_memo=_job_total_memo(alignments), device=opts.device,
              probs=opts.probs())
    if not opts.methylation_types and \
            os.environ.get("NPT_VAR_ARRAY", "1") != "0":
        scores = score_variants_batched_arrays(jobs, opts.indel_bias, **kw)
        if scores is not None:
            return scores
    return score_variants_batched(jobs, opts.methylation_types,
                                  opts.indel_bias,
                                  memo=alignments.score_memo, **kw)


def generate_candidate_single_base_edits(alignments: AlignmentDB,
                                         region_start: int, region_end: int,
                                         opts: Opts) -> List[Variant]:
    """call_variants.cpp:288-361."""
    contig = alignments.get_region_contig()
    flank = opts.screen_flanking_sequence
    jobs = []
    positions = [i for i in range(region_start, region_end)
                 if alignments.are_coordinates_valid(contig, i - flank,
                                                     i + 1 + flank)]
    pos_arr = np.asarray(positions, np.int64)
    events_per_pos = alignments.get_event_subsequences_batch(
        contig, pos_arr - flank, pos_arr + 1 + flank)
    for i, events in zip(positions, events_per_pos):
        calling_start = i - flank
        calling_end = i + 1 + flank
        ref_base = alignments.get_reference_substring(contig, i, i)
        tmp = []
        for j in "ACGT":
            v = Variant(ref_name=contig, ref_position=i, ref_seq=ref_base,
                        alt_seq=j)
            if v.ref_seq != v.alt_seq:
                tmp.append(v)
            ins = Variant(ref_name=contig, ref_position=i, ref_seq=ref_base,
                          alt_seq=ref_base + j)
            if ins.alt_seq[1] != ins.ref_seq[0]:
                tmp.append(ins)
        del_ref = alignments.get_reference_substring(contig, i - 1, i)
        dele = Variant(ref_name=contig, ref_position=i - 1, ref_seq=del_ref,
                       alt_seq=del_ref[0])
        if dele.alt_seq[0] != dele.ref_seq[1]:
            tmp.append(dele)

        hap = Haplotype(contig, calling_start,
                        alignments.get_reference_substring(
                            contig, calling_start, calling_end))
        for v in tmp:
            jobs.append((hap, v, events))
    scores = _screen_scores(jobs, alignments, opts)
    out = []
    for (hap, v, events), q in zip(jobs, scores):
        if q > 0:
            out.append(Variant(ref_name=v.ref_name,
                               ref_position=v.ref_position,
                               ref_seq=v.ref_seq, alt_seq=v.alt_seq,
                               quality=q))
    return out


def screen_variants_by_score(alignments: AlignmentDB,
                             candidate_variants: List[Variant],
                             opts: Opts) -> List[Variant]:
    """call_variants.cpp:364-402."""
    contig = alignments.get_region_contig()
    jobs = []
    kept = []
    for v in candidate_variants:
        calling_start = v.ref_position - opts.screen_flanking_sequence
        calling_end = v.ref_position + len(v.ref_seq) + \
            opts.screen_flanking_sequence
        if not alignments.are_coordinates_valid(contig, calling_start,
                                                calling_end):
            continue
        hap = Haplotype(contig, calling_start,
                        alignments.get_reference_substring(
                            contig, calling_start, calling_end))
        events = alignments.get_event_subsequences(contig, calling_start,
                                                   calling_end)
        jobs.append((hap, v, events))
        kept.append(v)
    scores = _screen_scores(jobs, alignments, opts)
    out = []
    for v, q in zip(kept, scores):
        if q > 0:
            out.append(Variant(ref_name=v.ref_name,
                               ref_position=v.ref_position,
                               ref_seq=v.ref_seq, alt_seq=v.alt_seq,
                               quality=q))
    return out


def expand_variants(alignments: AlignmentDB,
                    candidate_variants: List[Variant],
                    opts: Opts) -> List[Variant]:
    """call_variants.cpp:406-450."""
    out = []
    for v in candidate_variants:
        out.append(v)
        if len(v.ref_seq) == 1 and len(v.alt_seq) == 1:
            continue
        deletion_end = v.ref_position + len(v.ref_seq)
        if alignments.are_coordinates_valid(v.ref_name, v.ref_position,
                                            deletion_end) and \
                alignments.get_region_end() - deletion_end > \
                opts.min_flanking_sequence:
            out.append(Variant(ref_name=v.ref_name,
                               ref_position=v.ref_position,
                               ref_seq=alignments.get_reference_substring(
                                   v.ref_name, v.ref_position, deletion_end),
                               alt_seq=v.alt_seq))
        for j in "ACGT":
            out.append(Variant(ref_name=v.ref_name,
                               ref_position=v.ref_position,
                               ref_seq=v.ref_seq, alt_seq=v.alt_seq + j))
    return out


def dedup_sorted(variants: List[Variant]) -> List[Variant]:
    seen = {}
    for v in variants:
        seen.setdefault(v.key(), v)
    out = list(seen.values())
    out.sort(key=lambda v: (v.ref_position, v.ref_seq, v.alt_seq))
    return out


def _derived_copy(hap: Haplotype) -> Haplotype:
    """A haplotype over hap's reference with hap's sequence and map."""
    out = Haplotype(hap.ref_name, hap.ref_position, hap.get_reference())
    out.sequence = hap.sequence
    out.coordinate_map = list(hap.coordinate_map)
    return out


def annotate_variants_with_all_support(variants, alignments: AlignmentDB,
                                       opts: Opts):
    """--calculate-all-support (nanopolish_variant.cpp:802-880): per SNP,
    the read-support fraction of each of A/C/G/T, in one flush."""
    ref_hap = Haplotype(alignments.get_region_contig(),
                        alignments.get_region_start(),
                        alignments.get_reference())
    b = opts.batcher(alignments.score_memo)
    jobs = []
    for v in variants:
        calling_start = v.ref_position - opts.min_flanking_sequence
        calling_end = v.ref_position + opts.min_flanking_sequence
        if not alignments.are_coordinates_valid(v.ref_name, calling_start,
                                                calling_end):
            jobs.append(None)
            continue
        calling_hap = ref_hap.substr_by_reference(calling_start, calling_end)
        events = alignments.get_event_subsequences(v.ref_name, calling_start,
                                                   calling_end)
        units = []
        for base in "ACGT":
            var_hap = _derived_copy(calling_hap)
            if base != v.ref_seq:
                var_hap.apply_variant(Variant(
                    ref_name=v.ref_name, ref_position=v.ref_position,
                    ref_seq=v.ref_seq, alt_seq=base))
            seqs = [HMMInputSequence(var_hap.get_sequence())]
            units.append([b.add(seqs, ev) for ev in events])
        jobs.append(units)
    b.flush()
    for v, units in zip(variants, jobs):
        if units is None:
            continue
        n_events = len(units[0])
        support = np.zeros(4)
        for ri in range(n_events):
            scores = np.array([b.get(units[bi][ri]) for bi in range(4)])
            p = np.exp(scores - scores.max())
            support += p / p.sum()
        if n_events:
            support /= n_events
        v.add_info("SupportFractionByBase",
                   ",".join(f"{x:.3f}" for x in support))


# ---------------------------------------------------------------------------
# group scoring + genotyping
# ---------------------------------------------------------------------------

def score_variant_group(group: VariantGroup, base_haplotype: Haplotype,
                        events: List[EventSequence], opts: Opts,
                        memo: Optional[dict] = None, batcher=None):
    """nanopolish_variant.cpp:182-262, batched over (haplotype combination
    x read).  With a shared ``batcher`` the units are only enqueued and a
    finisher is returned: the caller flushes once for all groups."""
    num_variants = group.get_num_variants()
    sum_h = 0
    max_r = 1
    while max_r <= num_variants:
        n_r = nchoosek(num_variants, max_r)
        if n_r + sum_h < opts.max_haplotypes:
            sum_h += n_r
        else:
            break
        max_r += 1
    max_r -= 1
    if max_r != num_variants:
        print(f"Number of variants in span ({num_variants}) would exceed "
              "max-haplotypes. Variants may be missed. Consider running with "
              "a higher value of max-haplotypes!", file=sys.stderr)

    haplotypes: List[Tuple[Haplotype, int]] = []
    for r in range(0, max_r + 1):
        for vc in combinations(num_variants, r):
            hap = _derived_copy(base_haplotype)
            if hap.apply_variants(group.get_variants(vc)):
                haplotypes.append((hap, group.add_combination(vc)))

    read_ids = []
    for ev in events:
        rid = f"{ev.sr.read_name}:{ev.strand}"
        read_ids.append(rid)
        group.set_read_strand(rid, ev.rc)

    b = batcher if batcher is not None else opts.batcher(memo)
    hap_seqs = []
    for hap, vc_idx in haplotypes:
        seqs = generate_methylated_alternatives(hap.get_sequence(),
                                                opts.methylation_types)
        hap_seqs.append((seqs, seq_set_key(seqs), vc_idx))
    units = []
    for ri, ev in enumerate(events):
        for seqs, frags, vc_idx in hap_seqs:
            units.append((vc_idx, read_ids[ri], b.add(seqs, ev, frags=frags)))

    def finish():
        for vc_idx, rid, u in units:
            group.set_combination_read_score(vc_idx, rid, b.get(u))

    if batcher is not None:
        return finish
    b.flush()
    finish()


def make_genotype(alt_count: int, ploidy: int) -> str:
    """nanopolish_variant.cpp:149-158 (refs first, then alts)."""
    return "/".join(["0"] * (ploidy - alt_count) + ["1"] * alt_count)


def calculate_sor(ref_fwd, ref_rev, alt_fwd, alt_rev) -> float:
    """nanopolish_variant.cpp:264-277."""
    ref_fwd += 1
    ref_rev += 1
    alt_fwd += 1
    alt_rev += 1
    r = (ref_fwd * alt_rev) / (alt_fwd * ref_rev)
    sym_ratio = r + 1.0 / r
    ref_ratio = min(ref_fwd, ref_rev) / max(ref_fwd, ref_rev)
    alt_ratio = min(alt_fwd, alt_rev) / max(alt_fwd, alt_rev)
    return math.log(sym_ratio) + math.log(ref_ratio) - math.log(alt_ratio)


def simple_call(group: VariantGroup, ploidy: int,
                genotype_all_input_variants: bool) -> List[Variant]:
    """nanopolish_variant.cpp:279-493."""
    from scipy.stats import fisher_exact

    log_2 = math.log(2)
    group_reads = group.get_read_sum_scores()
    n_combos = group.get_num_combinations()
    if n_combos <= 1:
        return []

    base_score = float("-inf")
    best_score = float("-inf")
    best_set: List[int] = []
    base_set: List[int] = []
    for current_set in combinations(n_combos, ploidy, CO_WITH_REPLACEMENT):
        is_base_set = all(
            len(group.get_variants(group.get_combination(ci))) == 0
            for ci in current_set)
        set_score = 0.0
        for read_id, read_sum in group_reads:
            set_sum = float("-inf")
            for ci in current_set:
                rhs = group.get_combination_read_score(ci, read_id)
                set_sum = np.logaddexp(set_sum, rhs - log_2)
            set_score += set_sum
        if is_base_set:
            base_score = set_score
            base_set = current_set
        if set_score > best_score:
            best_score = set_score
            best_set = current_set

    if best_score - base_score < 20:
        best_set = base_set

    total_variants = group.get_num_variants()
    read_variant_assignment = np.zeros((len(group_reads), total_variants))
    read_variant_support = np.zeros(total_variants)
    for ci in range(n_combos):
        vc = group.get_combination(ci)
        for ri, (read_id, read_sum) in enumerate(group_reads):
            score = group.get_combination_read_score(ci, read_id)
            posterior = math.exp(min(score - read_sum, 0.0))
            for var_id in vc:
                read_variant_assignment[ri, var_id] += posterior
                read_variant_support[var_id] += posterior

    allele_strand_support = np.zeros((total_variants, 4))
    for vi in range(total_variants):
        for ri, (read_id, _) in enumerate(group_reads):
            strand = int(group.is_read_rc(read_id))
            pp_alt = read_variant_assignment[ri, vi]
            allele_strand_support[vi, 0 + strand] += 1 - pp_alt
            allele_strand_support[vi, 2 + strand] += pp_alt

    out = []
    for vi in range(total_variants):
        var_count = sum(
            sum(1 for k in group.get_combination(ci) if k == vi)
            for ci in best_set)
        if not (genotype_all_input_variants or var_count > 0):
            continue
        v = group.get(vi)
        v = Variant(ref_name=v.ref_name, ref_position=v.ref_position,
                    ref_seq=v.ref_seq, alt_seq=v.alt_seq)
        v.quality = best_score - base_score if var_count > 0 else 0.0
        v.add_info("TotalReads", len(group_reads))
        v.add_info("AlleleCount", var_count)
        v.add_info("SupportFraction",
                   read_variant_support[vi] / max(len(group_reads), 1))
        ref_fwd, ref_rev, alt_fwd, alt_rev = allele_strand_support[vi]
        sf_f = alt_fwd / (ref_fwd + alt_fwd) if ref_fwd + alt_fwd > 0 else 0
        sf_r = alt_rev / (ref_rev + alt_rev) if ref_rev + alt_rev > 0 else 0
        v.add_info("SupportFractionByStrand", f"{sf_f:g},{sf_r:g}")
        v.add_info("StrandSupport",
                   f"{round(ref_fwd)},{round(ref_rev)},"
                   f"{round(alt_fwd)},{round(alt_rev)}")
        table = [[round(ref_fwd), round(ref_rev)],
                 [round(alt_fwd), round(alt_rev)]]
        try:
            _, two = fisher_exact(table)
        except ValueError:
            two = 1.0
        fisher_scaled = int(-4.343 * math.log(max(two, 1e-300)) + 0.499)
        if fisher_scaled < 0:
            fisher_scaled = 1000
        v.add_info("StrandFisherTest", fisher_scaled)
        v.add_info("SOR", calculate_sor(ref_fwd, ref_rev, alt_fwd, alt_rev))
        v.genotype = make_genotype(var_count, ploidy) if group_reads else "."
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# homopolymer fixing (duration model)
# ---------------------------------------------------------------------------

def fix_homopolymers(input_haplotype: Haplotype, alignments: AlignmentDB,
                     opts: Opts) -> Haplotype:
    """call_variants.cpp:541-780: recall homopolymer lengths 3..9 from the
    gamma duration model plus the event likelihood; the Viterbi
    alignments and Forward scores of every (homopolymer, read, length)
    run in one batch each."""
    MIN_HP_LENGTH, MAX_HP_LENGTH = 3, 9
    CALL_THRESHOLD = 10.0
    KMER_SIZE = 6
    fixed = _derived_copy(input_haplotype)
    fixed.variants = list(input_haplotype.variants)
    hap_seq = input_haplotype.get_sequence()

    # --- scan homopolymers + collect all scoring tasks ---
    hps = []
    i = 0
    while i < len(hap_seq):
        hp_base = hap_seq[i]
        hap_hp_start = i
        while i < len(hap_seq) and hap_seq[i] == hp_base:
            i += 1
        if i >= len(hap_seq):
            break
        hap_hp_end = i
        hp_length = hap_hp_end - hap_hp_start
        if hp_length < MIN_HP_LENGTH or hp_length > MAX_HP_LENGTH:
            continue
        if hap_hp_start < opts.min_flanking_sequence or \
                hap_hp_end + opts.min_flanking_sequence >= len(hap_seq):
            continue
        rng = input_haplotype.get_enclosing_reference_range_for_haplotype_range(
            hap_hp_start - opts.min_flanking_sequence,
            hap_hp_end + opts.min_flanking_sequence)
        if rng is None:
            continue
        hap_calling_start, _, ref_calling_start, ref_calling_end = rng
        if ref_calling_start < alignments.get_region_start() or \
                ref_calling_end >= alignments.get_region_end():
            continue
        if ref_calling_start < input_haplotype.ref_position or \
                ref_calling_end >= input_haplotype.get_reference_end():
            continue
        calling_hap = input_haplotype.substr_by_reference(ref_calling_start,
                                                          ref_calling_end)
        events = alignments.get_event_subsequences(
            alignments.get_region_contig(), ref_calling_start,
            ref_calling_end)
        k0 = hap_hp_start - hap_calling_start - KMER_SIZE + 1
        hps.append({"base": hp_base, "hap_start": hap_hp_start,
                    "hap_end": hap_hp_end, "length": hp_length, "k0": k0,
                    "hap_calling_start": hap_calling_start,
                    "calling_sequence": calling_hap.get_sequence(),
                    "events": events})
    if not hps:
        return fixed

    segs, tasks = [], []
    for hp in hps:
        for ev in hp["events"]:
            if abs(ev.event_start_idx - ev.event_stop_idx) < 10:
                continue
            sr = ev.sr
            local_time = abs(sr.get_time(ev.event_start_idx, ev.strand)
                             - sr.get_time(ev.event_stop_idx, ev.strand))
            local_avg = local_time / max(len(hp["calling_sequence"]), 1)
            if local_avg <= 0:
                continue
            rate = (1.0 / local_avg) * 2.461964
            model = sr.base_model[ev.strand]
            for length in range(MIN_HP_LENGTH, MAX_HP_LENGTH + 1):
                diff = length - hp["length"]
                pos = hp["hap_start"] - hp["hap_calling_start"]
                vs = hp["calling_sequence"]
                if diff < 0:
                    vs = vs[:pos] + vs[pos - diff:]
                elif diff > 0:
                    vs = vs[:pos] + hp["base"] * diff + vs[pos:]
                hseq = HMMInputSequence(vs, alphabet=model.alphabet)
                ranks = hseq.kmer_ranks(model.k, ev.rc)
                segs.append(make_segment(sr, ev.strand, ranks,
                                         ev.event_start_idx,
                                         ev.event_stop_idx, model=model,
                                         flags=0))
                tasks.append((hp, ev, length, diff, rate,
                              len(vs) - model.k + 1))
    if not tasks:
        return fixed
    backs = viterbi_segments(segs, indel_bias=opts.indel_bias,
                             device=opts.device, probs=opts.probs())
    fwd_scores = forward_segments(segs, indel_bias=opts.indel_bias,
                                  device=opts.device, probs=opts.probs())

    per_hp_dur = {id(hp): np.zeros(MAX_HP_LENGTH + 1) for hp in hps}
    per_hp_ev = {id(hp): np.zeros(MAX_HP_LENGTH + 1) for hp in hps}
    for ti, (hp, ev, length, diff, rate, n_kmers) in enumerate(tasks):
        stride = 1 if ev.event_start_idx <= ev.event_stop_idx else -1
        dur = durations_from_alignment(backs[ti], ev.event_start_idx, stride,
                                       ev.sr.events[ev.strand].duration,
                                       n_kmers)
        call_window = 2
        v0 = hp["k0"] + 4 - call_window
        v1 = hp["k0"] + hp["length"] + diff + call_window
        sum_duration = float(dur[max(v0, 0):max(v1, 0)].sum())
        lg = log_gamma_sum(sum_duration, v1 - v0, 2.461964, rate) \
            if sum_duration > MIN_DURATION else 0.0
        per_hp_dur[id(hp)][length] += lg
        per_hp_ev[id(hp)][length] += float(fwd_scores[ti])

    # --- per-homopolymer call + haplotype edit (call_variants.cpp:691-780)
    for hp in hps:
        scores = per_hp_dur[id(hp)] + per_hp_ev[id(hp)]
        call = max(range(MIN_HP_LENGTH, MAX_HP_LENGTH + 1),
                   key=lambda ln: scores[ln])
        score = scores[call] - scores[hp["length"]]
        if score < CALL_THRESHOLD:
            continue
        size_diff = call - hp["length"]
        if size_diff == 0:
            continue
        for kpos in range(hp["hap_start"], hp["hap_end"] + 1):
            ref_pos = input_haplotype.get_reference_position_for_haplotype_base(
                kpos)
            if ref_pos is None:
                continue
            if size_diff > 0:
                ref_seq = fixed.substr_by_reference(ref_pos,
                                                    ref_pos).get_sequence()
                if not (len(ref_seq) == 1 and ref_seq[0] == hp["base"]):
                    continue
                alt_seq = ref_seq + hp["base"]
            else:
                ref_seq = fixed.substr_by_reference(
                    ref_pos, ref_pos + 1).get_sequence()
                if not (len(ref_seq) == 2 and ref_seq[0] == hp["base"] and
                        ref_seq[1] == hp["base"]):
                    continue
                alt_seq = ref_seq[0]
            v = Variant(ref_name=fixed.ref_name, ref_position=ref_pos,
                        ref_seq=ref_seq, alt_seq=alt_seq, quality=score)
            v.add_info("TotalReads", len(hp["events"]))
            v.add_info("AlleleCount", 1)
            if fixed.apply_variant(v):
                break
    return fixed


# ---------------------------------------------------------------------------
# region pipeline
# ---------------------------------------------------------------------------

class CandidateOrderError(ValueError):
    """A candidate file whose records are out of position order gives a
    group an empty or inverted calling window."""


def _vcf_record(v: Variant) -> str:
    return f"{v.ref_name}:{v.ref_position + 1} {v.ref_seq}>{v.alt_seq}"


def call_haplotype_from_candidates(alignments: AlignmentDB,
                                   candidate_variants: List[Variant],
                                   opts: Opts) -> Haplotype:
    """call_variants.cpp:782-880.  The candidates must be in position
    order, as the reference reads them: a group whose calling window is
    empty or inverted (a later record before an earlier one) raises
    CandidateOrderError, which names the group's first and last records;
    neither this nor the JAX app sorts them."""
    derived = Haplotype(alignments.get_region_contig(),
                        alignments.get_region_start(),
                        alignments.get_reference())
    db = VariantDB()
    curr = 0
    n = len(candidate_variants)
    shared = opts.batcher(alignments.score_memo)
    finishers = []
    while curr < n:
        end = curr + 1
        while end < n:
            d = candidate_variants[end].ref_position - \
                candidate_variants[end - 1].ref_position
            if d > opts.min_distance_between_variants:
                break
            end += 1
        calling_start = candidate_variants[curr].ref_position - \
            opts.min_flanking_sequence
        calling_end = candidate_variants[end - 1].ref_position + \
            len(candidate_variants[end - 1].ref_seq) + \
            opts.min_flanking_sequence
        if calling_end <= calling_start:
            raise CandidateOrderError(
                f"candidate records {_vcf_record(candidate_variants[curr])} "
                f"and {_vcf_record(candidate_variants[end - 1])} give the "
                f"empty or inverted calling window [{calling_start} "
                f"{calling_end}]: the candidate file is out of position "
                f"order; sort it by position")
        if calling_end - calling_start <= 200:
            calling_hap = derived.substr_by_reference(calling_start,
                                                      calling_end)
            events = alignments.get_event_subsequences(
                alignments.get_region_contig(), calling_start, calling_end)
            gid = db.add_new_group(candidate_variants[curr:end])
            finishers.append(score_variant_group(
                db.get_group(gid), calling_hap, events, opts,
                memo=alignments.score_memo, batcher=shared))
        else:
            print(f"Warning: {end - curr} variants in span, region not "
                  f"called [{calling_start} {calling_end}]", file=sys.stderr)
        curr = end
    shared.flush()                  # one drain for every group
    for fin in finishers:
        fin()

    for gi in range(db.get_num_groups()):
        called = simple_call(db.get_group(gi), opts.ploidy,
                             opts.genotype_only)
        if opts.calculate_all_support:
            annotate_variants_with_all_support(
                [v for v in called if v.is_snp()], alignments, opts)
        for v in called:
            derived.apply_variant(v)
    return derived


def call_variants_for_region(contig: str, region_start: int, region_end: int,
                             alignments: AlignmentDB, opts: Opts,
                             candidates: Optional[List[Variant]] = None
                             ) -> Haplotype:
    """call_variants.cpp:882-1011."""
    BUFFER = opts.min_flanking_sequence + 10
    if region_start < BUFFER:
        region_start = BUFFER
    alignments.load_region(contig, region_start - BUFFER, region_end + BUFFER)
    region_end = alignments.get_region_end() - BUFFER

    if candidates is None:
        candidate_variants = alignments.get_variants_in_region(
            contig, region_start, region_end, opts.min_candidate_frequency,
            opts.min_candidate_depth)
    else:
        candidate_variants = [v for v in candidates
                              if v.ref_name == contig
                              and region_start <= v.ref_position <= region_end]

    if opts.consensus_mode:
        with profile_scope("var.sbe_screen"):
            sbe = generate_candidate_single_base_edits(
                alignments, region_start, region_end, opts)
        candidate_variants = dedup_sorted(candidate_variants + sbe)
    if opts.verbose:
        print(f"[variants] {contig}:{region_start}-{region_end}: "
              f"{len(candidate_variants)} candidates "
              f"({len(alignments._reads)} reads in region)",
              file=sys.stderr)

    called_haplotype = Haplotype(alignments.get_region_contig(),
                                 alignments.get_region_start(),
                                 alignments.get_reference())
    if not opts.consensus_mode:
        return call_haplotype_from_candidates(alignments, candidate_variants,
                                              opts)
    last_keys: set = set()
    for round_i in range(opts.max_rounds):
        with profile_scope("var.screen"):
            filtered = screen_variants_by_score(alignments,
                                                candidate_variants, opts)
        with profile_scope("var.call_group"):
            called_haplotype = call_haplotype_from_candidates(alignments,
                                                              filtered, opts)
        called_variants = called_haplotype.get_variants()
        this_keys = {v.key() for v in called_variants}
        changed = this_keys != last_keys
        last_keys = this_keys
        if opts.verbose:
            print(f"[variants] round {round_i}: {len(filtered)} screened "
                  f"candidates -> {len(called_variants)} called",
                  file=sys.stderr)
        if not changed:
            break
        with profile_scope("var.expand"):
            candidate_variants = expand_variants(alignments, called_variants,
                                                 opts)
    if opts.fix_homopolymers:
        called_haplotype = fix_homopolymers(called_haplotype, alignments,
                                            opts)
    return called_haplotype


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch variants",
                                description="find variants with respect to "
                                            "the reference")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-w", "--window", required=True)
    p.add_argument("-o", "--outfile", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-m", "--min-candidate-frequency", type=float, default=0.2)
    p.add_argument("-d", "--min-candidate-depth", type=int, default=20)
    p.add_argument("-x", "--max-haplotypes", type=int, default=1000)
    p.add_argument("-c", "--candidates", default="")
    p.add_argument("-p", "--ploidy", type=int, default=2)
    p.add_argument("-q", "--methylation-aware", default="")
    p.add_argument("--genotype", default="")
    p.add_argument("--consensus", action="store_true")
    p.add_argument("--faster", action="store_true")
    p.add_argument("--effort", type=int, default=None)
    p.add_argument("--max-rounds", type=int, default=50)
    p.add_argument("--min-flanking-sequence", type=int, default=30)
    p.add_argument("--snps", action="store_true")
    p.add_argument("--fix-homopolymers", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-round candidate/call diagnostics on stderr")
    p.add_argument("--calculate-all-support", action="store_true")
    p.add_argument("--models-fofn", default="")
    p.add_argument("-i", "--indel-bias", type=float, default=None,
                   help="HMM indel bias factor; default 0.9 (consensus) / "
                        "0.8 (calling) per call_variants.cpp:1114-1117")
    p.add_argument("--p-skip", type=float, default=None)
    p.add_argument("--p-skip-self", type=float, default=None)
    p.add_argument("--p-bad", type=float, default=None)
    p.add_argument("--p-bad-self", type=float, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest and the HMM run (default: cuda; "
                        "there is no automatic fallback to the cpu)")
    return p


def make_opts(opt: argparse.Namespace) -> Opts:
    """Opts from the parsed command line (call_variants.cpp:1040-1117)."""
    opts = Opts()
    opts.device = resolve_device(opt.device)
    opts.min_candidate_frequency = opt.min_candidate_frequency
    opts.min_candidate_depth = opt.min_candidate_depth
    opts.max_haplotypes = opt.max_haplotypes
    opts.ploidy = 1 if opt.consensus else opt.ploidy
    opts.consensus_mode = opt.consensus
    opts.max_rounds = opt.max_rounds
    opts.verbose = opt.verbose
    opts.min_flanking_sequence = opt.min_flanking_sequence
    opts.snps_only = opt.snps
    opts.fix_homopolymers = opt.fix_homopolymers
    opts.calculate_all_support = opt.calculate_all_support
    if opt.faster:
        opts.screen_score_threshold = 25
    if opt.effort is not None:
        opts.screen_score_threshold = opt.effort
    if opt.methylation_aware:
        opts.methylation_types = opt.methylation_aware.split(",")
    opts.genotype_only = bool(opt.genotype)
    # the mode's indel bias unless -i overrides (call_variants.cpp:1108-1117)
    opts.indel_bias = opt.indel_bias if opt.indel_bias is not None \
        else (0.9 if opt.consensus else 0.8)
    for name in ("p_skip", "p_skip_self", "p_bad", "p_bad_self"):
        if getattr(opt, name) is not None:
            setattr(opts, name, getattr(opt, name))
    return opts


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    opts = make_opts(opt)
    if opt.models_fofn:
        PoreModelSet.instance().initialize(opt.models_fofn)

    candidates = None
    if opt.genotype:
        candidates = VcfReader(opt.genotype).records()
    elif opt.candidates:
        candidates = VcfReader(opt.candidates).records()

    # the polishing window is 0-based (nanopolish_makerange.py convention)
    try:
        contig, rng = opt.window.rsplit(":", 1)
        start_base, end_base = (int(x.replace(",", ""))
                                for x in rng.split("-"))
    except ValueError:
        raise SystemExit("variants requires a -w contig:start-end window")

    alignments = AlignmentDB(opt.reads, opt.genome, opt.bam,
                             num_threads=opt.threads, device=opts.device)
    try:
        haplotype = call_variants_for_region(contig, start_base, end_base,
                                             alignments, opts, candidates)
    except CandidateOrderError as e:
        raise SystemExit(f"variants: {e}")

    fp = open(opt.outfile, "w") if opt.outfile else out
    writer = VcfWriter(fp, extra_header=[
        f"##nanopolish_window={contig}:{start_base}-{end_base}"])
    writer.write_header()
    fai = alignments._fai
    for v in haplotype.get_variants():
        if opts.snps_only and not v.is_snp():
            continue
        context_start = max(0, v.ref_position - 5)
        context_end = v.ref_position + len(v.ref_seq) + 5
        v.add_info("RefContext", fai.fetch(v.ref_name, context_start,
                                           context_end))
        writer.write_variant(v)
    if opt.outfile:
        fp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
