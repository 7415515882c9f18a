"""eventalign core: re-align read events to the reference, batched.

Rebuild of align_read_to_ref (src/alignment/nanopolish_eventalign.cpp:612-827).
The reference loops segment-by-segment per read (each ~100 ref bases,
emitting ~50 alignments, chained by the last output event/kmer).  The chain
is inherently sequential per read, so the port runs a **segment
wavefront**: every active (read, strand) job contributes its current
segment to one batched Viterbi launch per round; jobs advance until
exhausted.  Batch occupancy stays high while any reads remain.  On the
card the rounds run as the device chain (``alignment/device_chain``: the
per-round setup and bookkeeping below as kernels, no fetch per round);
the host wavefront here takes the jobs the chain declines or gives back.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.bam import BamRecord
from ..models.hmm_input import HMMInputSequence
from ..models.squiggle import SquiggleRead
from ..utils.device import resolve_device
from ..utils.profiler import profile_scope
from .anchor import (get_aligned_segments, get_end_pair, start_segment,
                     trim_pairs_to_kmer, trim_pairs_to_ref_region)
from .device_chain import CHAIN_STATS, run_device_chain, stage_job
from .segments import HMMSegment, make_segment, viterbi_segments

ALIGN_STRIDE = 100   # ref bases per HMM call (eventalign.cpp:668)
OUTPUT_STRIDE = 50   # alignments emitted per call (eventalign.cpp:669)


@dataclass
class EventAlignment:
    """One (reference kmer, event) alignment row
    (src/alignment/nanopolish_eventalign.h:53-69)."""

    ref_name: str = ""
    ref_position: int = -1
    ref_kmer: str = ""
    read_idx: int = -1
    strand_idx: int = 0
    event_idx: int = -1
    rc: bool = False
    model_kmer: str = ""
    hmm_state: str = "M"


@dataclass
class EventAlignmentColumns:
    """Struct-of-arrays alignment output for one (read, strand) job — the
    row-object-free representation the TSV emitter renders from.  Derived
    fields: ref_kmer = ref_seq[ref_position-ref_offset:+k]; model_kmer is
    ref_kmer (fwd), its alphabet reverse-complement (rc), or N*k for "B"
    rows — exactly what HMMInputSequence.get_kmer returns for the window
    slices the wavefront scores (the windows are slices of ref_seq)."""

    ref_name: str
    read_idx: int
    strand_idx: int
    rc: bool                      # the job's constant input_rc
    ref_offset: int
    ref_seq: str
    model: object
    ref_position: np.ndarray      # [n] int64
    event_idx: np.ndarray         # [n] int64
    state: np.ndarray             # [n] uint8 of 'M'/'B'/'E'... ascii codes
    # whole-window kmer-rank arrays (the same arrays the wavefront scored
    # with); consumers that need per-row model-kmer ranks slice these
    # instead of re-ranking strings (methyltrain's event collection)
    wranks_fwd: Optional[np.ndarray] = None
    wranks_rc: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.ref_position)

    def model_kmer_ranks(self) -> np.ndarray:
        """Per-row rank of the model kmer (-1 for 'B' rows, which have no
        rank — the scalar path's kmer_rank KeyError).  Ranks come from
        the whole-window arrays, i.e. the exact ranks the wavefront
        scored each window with (_prepare's slice semantics)."""
        k = self.model.k
        p = np.asarray(self.ref_position, np.int64) - self.ref_offset
        if self.rc:
            wr = self.wranks_rc
            idx = len(self.ref_seq) - k - p
        else:
            wr = self.wranks_fwd
            idx = p
        valid = (self.state != 66) & (idx >= 0) & (idx < len(wr))
        return np.where(valid, wr[np.clip(idx, 0, len(wr) - 1)],
                        -1).astype(np.int64)

    def to_rows(self) -> List[EventAlignment]:
        """Materialize EventAlignment objects (compat path for low-volume
        consumers: SAM emit, summaries, calibration).  rc model kmers are
        slices of the whole-window reverse complement — the same
        site-aware-revcomp semantics the wavefront scored with and the
        TSV emitter renders (the reference's HMMInputSequence::get_kmer
        likewise slices a window-level rc, nanopolish_eventalign.cpp)."""
        k = self.model.k
        alphabet = self.model.alphabet
        out = []
        seq = self.ref_seq
        rc_seq = alphabet.reverse_complement(seq) if self.rc else ""
        nseq = len(seq)
        off = self.ref_offset
        nk = "N" * k
        for rp, ev, st in zip(self.ref_position.tolist(),
                              self.event_idx.tolist(), self.state.tolist()):
            ref_kmer = seq[rp - off:rp - off + k]
            if st == 66:            # 'B'
                model_kmer = nk
            else:
                model_kmer = rc_seq[nseq - (rp - off) - k:nseq - (rp - off)] \
                    if self.rc else ref_kmer
            out.append(EventAlignment(
                ref_name=self.ref_name, ref_position=rp, ref_kmer=ref_kmer,
                read_idx=self.read_idx, strand_idx=self.strand_idx,
                event_idx=ev, rc=self.rc, model_kmer=model_kmer,
                hmm_state=chr(st)))
        return out


@dataclass
class _Job:
    """Wavefront state for one (read, strand) alignment."""

    read: SquiggleRead
    record: BamRecord
    strand: int
    read_idx: int
    model: object
    ref_name: str
    ref_offset: int
    ref_seq: str
    rc_ref_seq: str
    pair_segments: List[np.ndarray]
    wranks_fwd: Optional[np.ndarray] = None
    wranks_rc: Optional[np.ndarray] = None
    out_ref: List[np.ndarray] = field(default_factory=list)
    out_ev: List[np.ndarray] = field(default_factory=list)
    out_st: List[np.ndarray] = field(default_factory=list)

    seg_i: int = 0
    started: bool = False
    done: bool = False

    # per-aligned-segment chain state
    pairs: Optional[np.ndarray] = None
    curr_start_event: int = 0
    curr_start_ref: int = 0
    curr_pair_idx: int = 0
    last_event: int = 0
    forward: bool = True

    # per-round context
    _input_rc: bool = False
    _event_stop: int = 0
    _last_section: bool = False
    _end_pair_idx: int = 0


def _prepare(job: _Job) -> Optional[HMMSegment]:
    """Build the next HMM segment for this job, or None when finished.
    Mirrors the loop body of align_read_to_ref (eventalign.cpp:691-760)."""
    read = job.read
    model = job.model
    k = model.k
    while True:
        if job.done:
            return None
        if job.pairs is None:
            if not start_segment(job):
                return None
        # loop condition (eventalign.cpp:689-690)
        if not ((job.forward and job.curr_start_event < job.last_event) or
                (not job.forward and job.curr_start_event > job.last_event)):
            job.pairs = None
            job.seg_i += 1
            continue

        pairs = job.pairs
        end_pair_idx = get_end_pair(pairs, job.curr_start_ref + ALIGN_STRIDE,
                                    job.curr_pair_idx)
        curr_end_ref = int(pairs[end_pair_idx, 0])
        curr_end_read = int(pairs[end_pair_idx, 1])
        do_base_rc = job.record.is_reverse
        if do_base_rc:
            curr_end_read = read.flip_k_strand(curr_end_read, k)
        if curr_end_read < 0:
            job.pairs = None
            job.seg_i += 1
            continue

        s = job.curr_start_ref - job.ref_offset
        l = curr_end_ref - job.curr_start_ref + 1
        if l < 2 * k:                   # minimum sequence (eventalign.cpp:723)
            job.pairs = None
            job.seg_i += 1
            continue

        event_stop = read.get_closest_event_to(curr_end_read, job.strand)
        if abs(job.curr_start_event - event_stop) < 2:  # eventalign.cpp:744
            job.pairs = None
            job.seg_i += 1
            continue

        rc_flags = (do_base_rc, not do_base_rc)
        input_rc = rc_flags[job.strand]
        # window kmer ranks as slices of the once-per-job whole-window
        # rank arrays (HMMInputSequence.kmer_ranks semantics: the rc row
        # is ranks(rc_subseq) reversed, and rc_subseq is the mirrored
        # slice of rc_ref_seq) — the per-round HMMInputSequence build +
        # rank scan was ~30 us x jobs x rounds of pure host time
        nseq = len(job.ref_seq)
        nkr = l - k + 1
        if input_rc:
            r0 = nseq - s - l
            ranks = job.wranks_rc[r0:r0 + nkr][::-1]
        else:
            ranks = job.wranks_fwd[s:s + nkr]

        job._input_rc = input_rc
        job._event_stop = event_stop
        job._end_pair_idx = end_pair_idx
        job._last_section = end_pair_idx == pairs.shape[0] - 1
        return make_segment(read, job.strand, ranks, job.curr_start_event,
                            event_stop, model=model)


def _consume(job: _Job, result: Tuple[np.ndarray, np.ndarray, str]):
    """Apply one Viterbi result: emit alignments + advance the chain
    (eventalign.cpp:762-823).  Vectorized over the result rows; output
    lands in the job's column buffers (the kept-row set is identical to
    the scalar loop: skip K rows and the re-emitted chain-start event,
    cut at OUTPUT_STRIDE kept rows unless this is the segment's last
    section — model/ref kmer strings are derived at emit time since the
    scored windows are slices of ref_seq)."""
    evs, kms, states = result
    stride = 1 if job.curr_start_event <= job._event_stop else -1
    st = np.frombuffer(states.encode("ascii"), np.uint8) \
        if isinstance(states, str) else np.asarray(states, np.uint8)
    ev_abs = job.curr_start_event + np.asarray(evs, np.int64) * stride
    kept = np.flatnonzero((st != 75) & (ev_abs != job.curr_start_event))
    if not job._last_section:
        kept = kept[:OUTPUT_STRIDE]
    if kept.size == 0:
        job.pairs = None
        job.seg_i += 1
        return
    ref_pos = job.curr_start_ref + np.asarray(kms, np.int64)[kept]
    job.out_ref.append(ref_pos)
    job.out_ev.append(ev_abs[kept])
    job.out_st.append(st[kept])
    job.curr_start_event = int(ev_abs[kept[-1]])
    job.curr_start_ref = int(ref_pos[-1])
    job.curr_pair_idx = get_end_pair(job.pairs, job.curr_start_ref,
                                     job.curr_pair_idx)


def align_reads_to_ref(
    jobs_in: Sequence[Tuple[SquiggleRead, BamRecord, int, int]],
    fai, references: List[str],
    region_start: int = -1, region_end: int = -1,
    alphabet: str = "", columnar: bool = False,
    job_cache: Optional[dict] = None,
    device=None,
) -> List:
    """Align many (read, record, strand, read_idx) jobs via the segment
    wavefront.  Returns one EventAlignment list per input job — or, with
    `columnar=True`, one EventAlignmentColumns per job (no per-row
    objects; the high-volume TSV path renders directly from the arrays).

    `alphabet` selects an alternative pore model family (e.g. "cpg") as
    EventAlignmentParameters.alphabet does (nanopolish_eventalign.h:33).
    The Viterbi rounds run on ``device`` (``cuda`` unless ``cpu`` is
    asked): through the device chain (``alignment/device_chain``) where
    ``NPT_EA_DEVICE_CHAIN`` says so (``auto``, the default: on the card;
    ``1``: also on the CPU, with the plain versions; ``0``: never), and
    the host wavefront for the jobs the chain declines or gives back."""
    jobs: List[Optional[_Job]] = []
    for read, record, strand, read_idx in jobs_in:
        job = _make_job(read, record, strand, read_idx, fai, references,
                        region_start, region_end, alphabet,
                        job_cache=job_cache)
        jobs.append(job)

    live = [j for j in jobs if j is not None and not j.done]
    if live and _device_chain_on(device):
        _run_device_chain(live, device)
        live = [j for j in live if not j.done]
    with profile_scope("ea.wavefront"):
        _run_wavefront(live, device)

    out = []
    for j in jobs:
        if j is None:
            cols = None
        else:
            n = sum(len(a) for a in j.out_ref)
            cols = EventAlignmentColumns(
                ref_name=j.ref_name, read_idx=j.read_idx,
                strand_idx=j.strand, rc=j._input_rc,
                ref_offset=j.ref_offset, ref_seq=j.ref_seq, model=j.model,
                ref_position=(np.concatenate(j.out_ref) if n
                              else np.zeros(0, np.int64)),
                event_idx=(np.concatenate(j.out_ev) if n
                           else np.zeros(0, np.int64)),
                state=(np.concatenate(j.out_st) if n
                       else np.zeros(0, np.uint8)),
                wranks_fwd=j.wranks_fwd, wranks_rc=j.wranks_rc)
        if columnar:
            out.append(cols)
        else:
            out.append(cols.to_rows() if cols is not None else [])
    return out


def _device_chain_on(device) -> bool:
    mode = os.environ.get("NPT_EA_DEVICE_CHAIN", "auto")
    if mode not in ("auto", "0", "1"):
        raise ValueError(f"NPT_EA_DEVICE_CHAIN={mode!r}: use auto, 0 or 1")
    return mode == "1" or (mode == "auto"
                           and resolve_device(device).type == "cuda")


def _run_device_chain(live: List[_Job], device) -> None:
    """Stage each job for the device chain and run the chain, one queue
    per kmer size; the jobs it declines or gives back stay not done."""
    by_k: dict = {}
    with profile_scope("ea.stage_jobs"):
        for j in live:
            d = stage_job(j)
            if d is not None:
                by_k.setdefault(j.model.k, []).append(d)
            elif not j.done:
                # a job stage_job completed (nothing left to align) is no
                # fallback
                CHAIN_STATS["ineligible"] += 1
    for group in by_k.values():
        run_device_chain(group, device)


def _run_wavefront(active: List[_Job], device=None) -> None:
    """Advance one set of jobs to completion, one batched Viterbi round
    at a time."""
    while active:
        segs: List[HMMSegment] = []
        seg_jobs: List[_Job] = []
        for j in active:
            seg = _prepare(j)
            if seg is not None:
                segs.append(seg)
                seg_jobs.append(j)
        if not segs:
            break
        results = viterbi_segments(segs, device=device)
        for j, r in zip(seg_jobs, results):
            _consume(j, r)
        active = [j for j in seg_jobs if not j.done]


def _make_job(read: SquiggleRead, record: BamRecord, strand: int,
              read_idx: int, fai, references: List[str],
              region_start: int, region_end: int,
              alphabet: str = "",
              job_cache: Optional[dict] = None) -> Optional[_Job]:
    if record.is_unmapped or not read.has_events_for_strand(strand):
        return None
    model = read.get_model(strand, alphabet) if alphabet \
        else read.base_model[strand]
    k = model.k
    ref_name = references[record.tid]
    ref_offset = record.pos

    # the model-independent job constants (window strings, whole-window
    # rank arrays, trimmed CIGAR pairs) are reusable across repeated
    # alignments of the same record (methyltrain re-aligns every round
    # under an updated model; only the model tables change)
    ck = (record.qname, record.tid, record.pos, record.flag,
          tuple(map(tuple, record.cigar)), strand, alphabet,
          region_start, region_end)
    ent = job_cache.get(ck) if job_cache is not None else None
    if ent is None:
        ref_seq = fai.fetch(ref_name, ref_offset,
                            record.reference_end() + 1).upper()
        ref_seq = model.alphabet.disambiguate(ref_seq)
        rc_ref_seq = model.alphabet.reverse_complement(ref_seq)

        pair_segments = get_aligned_segments(record)
        max_kmer_idx = len(read.read_sequence) - k
        trimmed = []
        for pairs in pair_segments:
            if region_start != -1 and region_end != -1:
                pairs = trim_pairs_to_ref_region(pairs, region_start,
                                                 region_end)
            pairs = trim_pairs_to_kmer(pairs, max_kmer_idx)
            if pairs.shape[0] == 0:
                # an empty trimmed segment aborts the record
                # (eventalign.cpp:664)
                break
            trimmed.append(pairs)
        ent = (ref_seq, rc_ref_seq, trimmed,
               model.alphabet.seq_to_kmer_ranks(ref_seq, k),
               model.alphabet.seq_to_kmer_ranks(rc_ref_seq, k))
        if job_cache is not None:
            job_cache[ck] = ent
    ref_seq, rc_ref_seq, trimmed, wr_fwd, wr_rc = ent
    return _Job(read=read, record=record, strand=strand, read_idx=read_idx,
                model=model, ref_name=ref_name, ref_offset=ref_offset,
                ref_seq=ref_seq, rc_ref_seq=rc_ref_seq,
                pair_segments=list(trimmed),
                wranks_fwd=wr_fwd, wranks_rc=wr_rc)
