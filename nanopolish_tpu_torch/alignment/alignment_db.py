"""AlignmentDB: a reference window + all overlapping reads' alignments.

Rebuild of src/alignment/nanopolish_alignment_db.{h,cpp}: loads the region
reference, the BAM records overlapping it, builds per-read sequence and
event alignment records, serves event subsequences by reference bounds,
and discovers candidate variants from the read pileup.  The reads'
ingest runs on ``device`` (``cuda`` unless ``cpu`` is asked).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..io.bam import BamReader
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..io.vcf import Variant
from ..models.read_builder import GLOBAL_READ_STATS
from ..models.read_loader import load_squiggle_reads
from ..models.squiggle import SquiggleRead
from ..utils.device import resolve_device
from .records import (MAX_EVENT_TO_BP_RATIO, EventAlignmentRecord,
                      SequenceAlignmentRecord, find_by_ref_bounds)


@dataclass
class EventSequence:
    """One read's event range over a reference window (HMMInputData
    equivalent, nanopolish_common.h)."""

    sr: SquiggleRead
    strand: int
    rc: bool
    stride: int
    event_start_idx: int
    event_stop_idx: int


class AlignmentDB:
    def __init__(self, reads_file: str, reference_file: str, bam_file: str,
                 min_mapping_quality: int = 0, num_threads: int = 8,
                 device=None):
        self.device = resolve_device(device)
        self.num_threads = num_threads
        self.bam_file = bam_file
        self.min_mapping_quality = min_mapping_quality
        self._read_db = ReadDB()
        self._read_db.load(reads_file)
        self._fai = FastaIndex(reference_file)

        self.region_contig = ""
        self.region_start = 0
        self.region_end = 0
        self.region_ref_sequence = ""
        self.sequence_records: List[SequenceAlignmentRecord] = []
        self.event_records: List[EventAlignmentRecord] = []
        self._reads: Dict[str, SquiggleRead] = {}
        # scoring-unit memo for the loaded region: (sequence set, event
        # range) -> Forward score.  Valid while the region's reads and
        # alignments are fixed, so load_region resets it (and the
        # job-total memo of apps/variants.py, keyed on the region).
        self.score_memo: Dict = {}

    # ---------------- loading ----------------
    def load_region(self, contig: str, start_position: int,
                    stop_position: int):
        """alignment_db.cpp:370-421."""
        self.score_memo = {}
        self.region_contig = contig
        self.region_start = start_position
        contig_length = self._fai.length(contig)
        self.region_end = min(stop_position, contig_length - 1)
        self.region_ref_sequence = self._fai.fetch(
            contig, self.region_start, self.region_end + 1).upper()

        bam = BamReader(self.bam_file)
        records = [r for r in bam.fetch(contig, start_position,
                                        self.region_end)
                   if not r.is_unmapped
                   and r.mapq >= self.min_mapping_quality]
        bam.close()

        names = sorted({r.qname for r in records})
        self._reads = load_squiggle_reads(names, self._read_db,
                                          stats=GLOBAL_READ_STATS,
                                          num_threads=self.num_threads,
                                          device=self.device)

        self.sequence_records = []
        self.event_records = []
        for rec in records:
            seq_rec = SequenceAlignmentRecord.from_bam(rec)
            # read bases for pileup candidate discovery
            seq_rec.sequence = rec.seq
            self.sequence_records.append(seq_rec)
            sr = self._reads.get(rec.qname)
            if sr is None:
                continue
            for strand in (0, 1):
                if not sr.has_events_for_strand(strand):
                    continue
                ev_rec = EventAlignmentRecord.build(sr, strand, seq_rec)
                if ev_rec.aligned_events.shape[0] == 0:
                    continue
                self.event_records.append(ev_rec)

    # ---------------- reference helpers ----------------
    def get_region_contig(self) -> str:
        return self.region_contig

    def get_region_start(self) -> int:
        return self.region_start

    def get_region_end(self) -> int:
        return self.region_end

    def get_reference(self) -> str:
        return self.region_ref_sequence

    def get_reference_substring(self, contig: str, start: int, end: int) -> str:
        """Inclusive-end substring (alignment_db semantics)."""
        assert contig == self.region_contig
        return self.region_ref_sequence[start - self.region_start:
                                        end - self.region_start + 1]

    def are_coordinates_valid(self, contig: str, start: int, end: int) -> bool:
        return (contig == self.region_contig
                and start >= self.region_start
                and end <= self.region_end
                and start <= end)

    # ---------------- event access ----------------
    def get_event_subsequences(self, contig: str, start_position: int,
                               stop_position: int) -> List[EventSequence]:
        """alignment_db.cpp:172-221."""
        out: List[EventSequence] = []
        for rec in self.event_records:
            sr = rec.sr
            if not sr.has_events_for_strand(rec.strand):
                continue
            bounds = find_by_ref_bounds(rec.aligned_events, start_position,
                                        stop_position)
            if bounds is None:
                continue
            e1, e2 = bounds
            ratio = abs(e1 - e2) / max(abs(stop_position - start_position), 1)
            if ratio >= MAX_EVENT_TO_BP_RATIO:
                continue
            out.append(EventSequence(sr=sr, strand=rec.strand, rc=rec.rc,
                                     stride=rec.stride, event_start_idx=e1,
                                     event_stop_idx=e2))
        return out

    def get_event_subsequences_batch(self, contig: str,
                                     starts: np.ndarray,
                                     stops: np.ndarray
                                     ) -> List[List[EventSequence]]:
        """get_event_subsequences for many windows at once: one
        vectorized bounds search per event record instead of one scalar
        find_by_ref_bounds per (record, window); the consensus screen
        probes every region position.  The lists equal per-window
        get_event_subsequences calls (records, order, bounds)."""
        starts = np.asarray(starts, np.int64)
        stops = np.asarray(stops, np.int64)
        out: List[List[EventSequence]] = [[] for _ in range(len(starts))]
        denom = np.maximum(np.abs(stops - starts), 1)
        for rec in self.event_records:
            pairs = rec.aligned_events
            n = pairs.shape[0]
            sr = rec.sr
            if not sr.has_events_for_strand(rec.strand):
                continue
            refs = pairs[:, 0]
            i1 = np.searchsorted(refs, starts, side="left")
            i2 = np.searchsorted(refs, stops, side="left")
            valid = (i1 < n) & (i2 < n)
            i1c = np.minimum(i1, n - 1)
            i2c = np.minimum(i2, n - 1)
            left_b = (refs[i1c] <= starts) | \
                ((i1 > 0) & (refs[np.maximum(i1 - 1, 0)] <= starts))
            # find_by_ref_bounds' right bound, including its `>= ref_start`
            right_b = (refs[i2c] >= stops) | \
                ((i2 + 1 < n) & (refs[np.minimum(i2 + 1, n - 1)] >= starts))
            e1 = pairs[i1c, 1]
            e2 = pairs[i2c, 1]
            ok = valid & left_b & right_b & \
                (np.abs(e1 - e2) / denom < MAX_EVENT_TO_BP_RATIO)
            for w in np.flatnonzero(ok):
                out[w].append(EventSequence(
                    sr=sr, strand=rec.strand, rc=rec.rc, stride=rec.stride,
                    event_start_idx=int(e1[w]), event_stop_idx=int(e2[w])))
        return out

    # ---------------- candidate discovery ----------------
    def get_variants_in_region(self, contig: str, start_position: int,
                               stop_position: int,
                               min_frequency: float = 0.2,
                               min_depth: int = 20) -> List[Variant]:
        """Pileup candidate discovery (alignment_db.cpp:259-368)."""
        MIN_DISTANCE_TO_REGION_END = 1
        counts: Dict[str, Tuple[Variant, int]] = {}
        depth = np.zeros(stop_position - start_position + 1, np.int64)
        ref = self.region_ref_sequence
        r0 = self.region_start

        for record in self.sequence_records:
            ab = record.aligned_bases
            if ab.shape[0] == 0:
                continue
            refs = ab[:, 0]
            i1 = int(np.searchsorted(refs, start_position, side="left"))
            i2 = int(np.searchsorted(refs, stop_position, side="left"))
            if i1 >= ab.shape[0] or i2 >= ab.shape[0]:
                continue
            depth_start = max(int(ab[i1, 0]), start_position)
            depth_end = min(int(ab[i2, 0]), stop_position)
            if depth_end > depth_start:
                depth[depth_start - start_position:
                      depth_end - start_position] += 1

            seq = record.sequence
            it = i1
            while it < i2:
                rp = int(ab[it, 0])
                if rp < start_position or rp > stop_position:
                    it += 1
                    continue
                is_mismatch = ref[rp - r0] != seq[int(ab[it, 1])]
                nxt = it + 1
                is_gap = nxt < i2 and (
                    ab[nxt, 0] != ab[it, 0] + 1 or ab[nxt, 1] != ab[it, 1] + 1)
                if is_gap:
                    while nxt < i2:
                        if ref[int(ab[nxt, 0]) - r0] == seq[int(ab[nxt, 1])]:
                            break
                        nxt += 1
                if nxt < i2 and (is_mismatch or is_gap) and \
                        int(ab[nxt, 0]) < stop_position - MIN_DISTANCE_TO_REGION_END:
                    v = Variant(
                        ref_name=contig, ref_position=rp,
                        ref_seq=ref[rp - r0:int(ab[nxt, 0]) - r0],
                        alt_seq=seq[int(ab[it, 1]):int(ab[nxt, 1])])
                    key = v.key()
                    if key in counts:
                        counts[key] = (counts[key][0], counts[key][1] + 1)
                    else:
                        counts[key] = (v, 1)
                it = nxt

        variants = []
        for v, count in counts.values():
            d = int(depth[v.ref_position - start_position])
            if d == 0:
                continue
            f = count / d
            if f >= min_frequency and d >= min_depth:
                v.add_info("BaseCalledReadsWithVariant", count)
                v.add_info("BaseCalledFraction", f)
                variants.append(v)
        variants.sort(key=lambda v: v.ref_position)
        return variants
