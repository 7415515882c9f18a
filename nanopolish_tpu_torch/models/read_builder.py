"""Batched SquiggleRead construction: raw signal -> calibrated read.

Rebuild of the universal ingest path ``SquiggleRead::load_from_raw``
(reference: src/nanopolish_squiggle_read.cpp:189-337), batched:

  host:   MAD trim -> event detection (native peak detector)
  device: MoM scaling -> adaptive banded alignment (CUDA kernels) ->
          'M'-event selection -> WLS recalibration
  host:   QC + SquiggleRead assembly

Reads are length-sorted and padded per chunk.  A chunk's intermediate
results stay on the device; its results come back in one fetch
(``ops/ingest_fused``), before the next chunk is issued: chunks in
flight gained nothing on the card (tools/ingest_window.py).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import event_detect
from ..ops.ingest_fused import ingest_align_recalibrate_async
from ..utils.device import resolve_device
from .pore_model import PoreModel, PoreModelSet
from .squiggle import (
    MAX_EVENTS_PER_BASE,
    MIN_CALIBRATION_VAR,
    SRF_LOAD_RAW_SAMPLES,
    SRNT_DNA,
    SRNT_RNA,
    EventTable,
    SquiggleRead,
    SquiggleScalings,
    T_IDX,
)


@dataclass
class ReadStats:
    """Global skip counters (squiggle_read.cpp:29-34, printed at exit by
    main/nanopolish.cpp:87-97).

    ``add`` is the thread-safe increment: build_reads runs event
    detection on a thread pool and the apps run whole chunk loads on
    concurrent workers, so plain ``+=`` on the shared instance can lose
    counts."""

    total_reads: int = 0
    unparseable_reads: int = 0
    qc_fail_reads: int = 0
    failed_calibration_reads: int = 0
    failed_alignment_reads: int = 0
    bad_fast5_file: int = 0

    def __post_init__(self):
        import threading
        self._lock = threading.Lock()

    def add(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def report(self) -> str:
        lines = []
        total = max(self.total_reads, 1)
        bad = (self.bad_fast5_file + self.unparseable_reads + self.qc_fail_reads
               + self.failed_calibration_reads + self.failed_alignment_reads)
        if bad > 0:
            lines.append(f"[readdb] skipped {bad} of {self.total_reads} reads: "
                         f"bad_signal_file={self.bad_fast5_file} "
                         f"unparseable={self.unparseable_reads} "
                         f"qc_fail={self.qc_fail_reads} "
                         f"failed_calibration={self.failed_calibration_reads} "
                         f"failed_alignment={self.failed_alignment_reads}")
        return "\n".join(lines)


GLOBAL_READ_STATS = ReadStats()


@dataclass
class RawReadInput:
    """One raw read as delivered by the signal loader (Fast5Data equivalent,
    io/nanopolish_fast5_loader.h:18-31)."""

    read_name: str
    sequence: str
    raw: np.ndarray                 # pA samples
    sample_rate: float = 4000.0
    experiment_type: str = "dna"    # "dna"|"rna"|"internal_rna"
    sequencing_kit: str = ""
    channel_id: int = 0
    start_time: int = 0


def _bucket_dims(n: int, quantum: int = 256) -> int:
    return max(quantum, int(math.ceil(n / quantum)) * quantum)


def build_reads(
    inputs: Sequence[RawReadInput],
    flags: int = 0,
    stats: Optional[ReadStats] = None,
    max_batch: int = 256,
    num_threads: int = 8,
    device=None,
) -> List[Optional[SquiggleRead]]:
    """Construct SquiggleReads for a batch of raw reads.

    Returns one SquiggleRead (or None for unparseable input) per input;
    QC-failed reads come back with empty event tables, matching the
    reference's skip semantics.  The batched stage runs on ``device``
    (``cuda`` unless the caller asks for ``cpu``).
    """
    dev = resolve_device(device)
    stats = stats if stats is not None else GLOBAL_READ_STATS
    results: List[Optional[SquiggleRead]] = [None] * len(inputs)

    # ---- host stage: trim + event detection (threaded native loops) ----
    def detect(idx_inp):
        i, inp = idx_inp
        stats.add("total_reads")
        seq = inp.sequence
        if len(seq) <= 20 or inp.raw is None or len(inp.raw) == 0:
            stats.add("bad_fast5_file")
            return i, None
        rna = (inp.experiment_type in ("rna", "internal_rna")
               and inp.sequencing_kit != "sqk-dcs108")
        params = (event_detect.EVENT_DETECTION_RNA if rna
                  else event_detect.EVENT_DETECTION_DEFAULTS)
        bounds = event_detect.trim_and_segment_raw(inp.raw, 200, 10, 100, 0.0)
        if bounds is None:
            stats.add("bad_fast5_file")
            return i, None
        start, end = bounds
        et = event_detect.detect_events(inp.raw[start:end], params)
        if len(et) == 0:
            stats.add("bad_fast5_file")
            return i, None
        return i, (et, rna, start, end)

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        detected = list(pool.map(detect, enumerate(inputs)))

    # ---- assemble per-read arrays ----
    work = []   # (i, inp, EventTable, rna, ranks, model)
    pms = PoreModelSet.instance()
    for i, payload in detected:
        if payload is None:
            continue
        et, rna, trim_start, trim_end = payload
        inp = inputs[i]
        seq = inp.sequence.replace("U", "T") if rna else inp.sequence
        if rna:
            model = pms.get_model("r9.4_70bps", "u_to_t_rna", "template", 5)
        else:
            model = pms.get_model("r9.4_450bps", "nucleotide", "template", 6)
        ranks = model.alphabet.seq_to_kmer_ranks(seq, model.k)
        if len(ranks) == 0:
            stats.add("unparseable_reads")
            continue
        durations = (et.length / inp.sample_rate).astype(np.float32)
        start_time = np.concatenate([[0.0], np.cumsum(durations)[:-1]]).astype(np.float32)
        means = et.mean
        stdvs = et.stdv
        if rna:
            # events reversed to 5'->3' (squiggle_read.cpp:261-263); note the
            # reference reverses AFTER computing start times, so times stay
            # in original order per event struct
            means = means[::-1].copy()
            stdvs = stdvs[::-1].copy()
            start_time = start_time[::-1].copy()
            durations = durations[::-1].copy()
        evt = EventTable(mean=means, stdv=stdvs, start_time=start_time,
                         duration=durations)
        samples = None
        if flags & SRF_LOAD_RAW_SAMPLES:
            samples = np.asarray(inp.raw[trim_start:trim_end], np.float32)
        work.append((i, inp, evt, rna, ranks, model, seq, samples, trim_start))

    # ---- device stage, bucketed ----
    work.sort(key=lambda w: (len(w[2]), len(w[4])))
    chunks = []
    for lo in range(0, len(work), max_batch):
        chunks.extend(_split_for_hbm(work[lo : lo + max_batch]))
    for c in chunks:
        _finish_chunk(c, _dispatch_chunk(c, dev), results, stats)
    return results


# device bytes per band per read held by the banded kernels (32 trace
# bytes + 1 placement byte); chunks above this budget are split
_TRACE_BYTES_PER_BAND = 33
_TRACE_BUDGET = 4 << 30


def _split_for_hbm(chunk):
    """The banded trace is B x (T+K) x 33 bytes on the device; split very
    long-read chunks rather than risk running out of device memory (reads
    are length-sorted, so splits stay homogeneous)."""
    B = len(chunk)
    if B == 0:
        return []
    T = _bucket_dims(max(len(w[2]) for w in chunk))
    K = _bucket_dims(max(len(w[4]) for w in chunk))
    if B > 8 and B * (T + K) * _TRACE_BYTES_PER_BAND > _TRACE_BUDGET:
        return _split_for_hbm(chunk[: B // 2]) + \
            _split_for_hbm(chunk[B // 2:])
    return [chunk]


def _pack_chunk_host(chunk, T, K):
    """Pad one length-sorted chunk into the batched ingest arrays."""
    B = len(chunk)
    ev_mean = np.zeros((B, T), np.float32)
    ev_time = np.zeros((B, T), np.float32)
    n_events = np.zeros(B, np.int32)
    lvl_mean = np.zeros((B, K), np.float32)
    lvl_stdv = np.ones((B, K), np.float32)
    ranks_pad = np.zeros((B, K), np.int32)
    n_kmers = np.zeros(B, np.int32)
    for bi, (i, inp, evt, rna, ranks, model, seq, samples, tstart) in \
            enumerate(chunk):
        ne, nk = len(evt), len(ranks)
        ev_mean[bi, :ne] = evt.mean
        ev_time[bi, :ne] = evt.start_time
        n_events[bi] = ne
        lvl_mean[bi, :nk] = model.level_mean[ranks]
        lvl_stdv[bi, :nk] = model.level_stdv[ranks]
        ranks_pad[bi, :nk] = ranks
        n_kmers[bi] = nk
    return ev_mean, ev_time, n_events, lvl_mean, lvl_stdv, ranks_pad, n_kmers


def _dispatch_chunk(chunk, dev: torch.device):
    """Issue one chunk's MoM -> banded alignment -> 'M' events ->
    recalibration on ``dev``; returns the closure that fetches it
    (``ops/ingest_fused``)."""
    T = _bucket_dims(max(len(w[2]) for w in chunk))
    K = _bucket_dims(max(len(w[4]) for w in chunk))
    return ingest_align_recalibrate_async(*_pack_chunk_host(chunk, T, K),
                                          device=dev)


def _finish_chunk(chunk, resolve, results, stats: ReadStats):
    r = resolve()
    _assemble_reads(chunk, r.b2e_start, r.b2e_stop, r.failed,
                    r.events_per_base, r.shift, r.scale, r.drift, r.var,
                    r.recal_ok, results, stats)


def _assemble_reads(chunk, b2e_start, b2e_stop, failed_align,
                    events_per_base, r_shift, r_scale, r_drift, r_var,
                    r_ok, results, stats: ReadStats):
    """Build the chunk's SquiggleReads from the fetched ingest results."""
    for bi, (i, inp, evt, rna, ranks, model, seq, samples, tstart) in enumerate(chunk):
        nk = len(ranks)
        read = SquiggleRead(
            read_name=inp.read_name,
            read_sequence=seq,
            nucleotide_type=SRNT_RNA if rna else SRNT_DNA,
            fast5_path="",
            sample_rate=inp.sample_rate,
            channel_id=inp.channel_id,
            sample_start_time=0,
        )
        read.base_model[T_IDX] = model
        read.samples = chunk[bi][7]
        results[i] = read

        if failed_align[bi]:
            stats.add("failed_alignment_reads")
            read.events_per_base[T_IDX] = 0.0
            continue

        b2e = np.stack([b2e_start[bi, :nk], b2e_stop[bi, :nk]], axis=1).astype(np.int32)
        read.base_to_event_map[T_IDX] = b2e
        read.events_per_base[T_IDX] = float(events_per_base[bi])

        if (not r_ok[bi]) or r_var[bi] > MIN_CALIBRATION_VAR:
            stats.add("failed_calibration_reads")
            read.base_to_event_map[T_IDX] = None
            continue

        read.scalings[T_IDX] = SquiggleScalings.from4(
            r_shift[bi], r_scale[bi], r_drift[bi], r_var[bi])
        read.events[T_IDX] = evt

        # events/base QC (squiggle_read.cpp:332-336)
        if read.events_per_base[T_IDX] > MAX_EVENTS_PER_BASE:
            stats.add("qc_fail_reads")
            read.events[T_IDX] = None
            read.base_to_event_map[T_IDX] = None
