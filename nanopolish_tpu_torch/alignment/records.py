"""Sequence/event alignment records: BAM record -> ref<->read<->event maps.

Rebuild of SequenceAlignmentRecord / EventAlignmentRecord and the
ref-bounds binary search (reference:
src/alignment/nanopolish_alignment_db.cpp:29-91, :688-731).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..io.bam import BamRecord
from ..models.squiggle import SquiggleRead
from .anchor import get_aligned_segments

MAX_EVENT_TO_BP_RATIO = 20  # nanopolish_alignment_db.h:18


@dataclass
class SequenceAlignmentRecord:
    """Read sequence + (read_pos, ref_pos) pairs from the CIGAR
    (alignment_db.cpp:29-50)."""

    read_name: str
    rc: bool
    aligned_bases: np.ndarray      # [n, 2] int64 of (ref_pos, read_pos)
    sequence: str = ""             # read bases (BAM orientation)

    @classmethod
    def from_bam(cls, record: BamRecord) -> "SequenceAlignmentRecord":
        segs = get_aligned_segments(record)
        pairs = np.concatenate(segs, axis=0) if segs else \
            np.zeros((0, 2), np.int64)
        return cls(read_name=record.qname, rc=record.is_reverse,
                   aligned_bases=pairs)


@dataclass
class EventAlignmentRecord:
    """ref_pos -> event_idx pairs via the base-to-event map
    (alignment_db.cpp:55-91)."""

    aligned_events: np.ndarray     # [n, 2] int64 of (ref_pos, event_idx)
    rc: bool = False
    stride: int = 1
    strand: int = 0
    sr: object = None              # owning SquiggleRead

    @classmethod
    def build(cls, sr: SquiggleRead, strand_idx: int,
              seq_record: SequenceAlignmentRecord) -> "EventAlignmentRecord":
        k = sr.get_model_k(strand_idx)
        read_length = len(sr.read_sequence)
        ab = seq_record.aligned_bases
        keep = (ab[:, 1] >= k) & (ab[:, 1] + k < read_length)
        ab = ab[keep]
        closest = closest_event_table(sr, strand_idx)
        if seq_record.rc:
            kmer_pos = (read_length - ab[:, 1] - k).astype(np.int64)
        else:
            kmer_pos = ab[:, 1].astype(np.int64)
        kmer_pos = np.clip(kmer_pos, 0, len(closest) - 1)
        events = closest[kmer_pos]
        aligned = np.stack([ab[:, 0], events], axis=1).astype(np.int64)
        rc = seq_record.rc if strand_idx == 0 else not seq_record.rc
        stride = 1
        if aligned.shape[0]:
            stride = 1 if aligned[0, 1] < aligned[-1, 1] else -1
            if aligned[0, 1] == aligned[-1, 1]:    # degenerate
                aligned = aligned[:0]
        return cls(aligned_events=aligned, rc=rc, stride=stride,
                   strand=strand_idx, sr=sr)


def closest_event_table(sr: SquiggleRead, strand_idx: int) -> np.ndarray:
    """Vectorized get_closest_event_to for every kmer index
    (squiggle_read.cpp:155-186: nearest mapped kmer within +-1000,
    preferring the one at or before).  Cached on the read."""
    cache = getattr(sr, "_closest_event_cache", None)
    if cache is None:
        cache = sr._closest_event_cache = {}
    if strand_idx in cache:
        return cache[strand_idx]
    b2e = sr.base_to_event_map[strand_idx]
    n = b2e.shape[0]
    idx = np.arange(n)
    mapped = b2e[:, 0] != -1
    last_le = np.maximum.accumulate(np.where(mapped, idx, -1))
    rev_first = np.minimum.accumulate(np.where(mapped, idx, 2 * n)[::-1])[::-1]
    before_ok = (last_le >= 0) & (idx - last_le <= 1000)
    after_ok = (rev_first < 2 * n) & (rev_first - idx <= 1000)
    ev_before = np.where(before_ok, b2e[np.maximum(last_le, 0), 0], -1)
    ev_after = np.where(after_ok, b2e[np.minimum(rev_first, n - 1), 0], -1)
    out = np.where(ev_before != -1, ev_before, ev_after).astype(np.int64)
    cache[strand_idx] = out
    return out


def find_by_ref_bounds(pairs: np.ndarray, ref_start: int, ref_stop: int
                       ) -> Optional[Tuple[int, int]]:
    """Binary-search (ref -> second column) bounds
    (alignment_db.cpp:688-731).  pairs must be ref-sorted ascending.
    Returns (val_at_start, val_at_stop) of the second column or None."""
    if pairs.shape[0] == 0:
        return None
    refs = pairs[:, 0]
    i1 = int(np.searchsorted(refs, ref_start, side="left"))
    i2 = int(np.searchsorted(refs, ref_stop, side="left"))
    n = pairs.shape[0]
    if i1 >= n or i2 >= n:
        return None
    left_bounded = refs[i1] <= ref_start or \
        (i1 > 0 and refs[i1 - 1] <= ref_start)
    right_bounded = refs[i2] >= ref_stop or \
        (i2 + 1 < n and refs[i2 + 1] >= ref_start)
    if not (left_bounded and right_bounded):
        return None
    return int(pairs[i1, 1]), int(pairs[i2, 1])
