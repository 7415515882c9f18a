"""CIGAR walking: read<->reference aligned pairs, split into segments on N.

Rebuild of get_aligned_segments (src/alignment/nanopolish_anchor.cpp:20-88).
Pairs are (ref_pos, read_pos) numpy columns per segment; read_stride
supports event-space CIGARs (stride ±1).  Also the anchors eventalign's
segment chain starts from and advances by (``start_segment``,
``get_end_pair``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..io.bam import BamRecord

# cigar op codes
_M, _I, _D, _N, _S, _H, _P, _EQ, _X = range(9)


def get_aligned_segments(rec: BamRecord, read_stride: int = 1
                         ) -> List[np.ndarray]:
    """Each segment is an int64 array [n, 2] of (ref_pos, read_pos)."""
    # aligned runs are arithmetic in both coordinates, so each M/=/X op
    # contributes two aranges instead of a per-pair Python loop
    segments: List[List[np.ndarray]] = [[]]
    read_pos = 0
    ref_pos = rec.pos
    for op, length in rec.cigar:
        read_inc = 0
        ref_inc = 0
        is_aligned = False
        if op in (_M, _EQ, _X):
            is_aligned = True
            read_inc = read_stride
            ref_inc = 1
        elif op == _D:
            ref_inc = 1
        elif op == _N:
            segments.append([])
            ref_inc = 1
        elif op == _I:
            read_inc = read_stride
        elif op == _S:
            read_inc = 1        # special case, do not use read_stride
        elif op == _H:
            read_inc = 0
        else:
            raise ValueError(f"unhandled cigar op {op}")
        if is_aligned:
            run = np.empty((length, 2), np.int64)
            ar = np.arange(length, dtype=np.int64)
            run[:, 0] = ref_pos + ar
            run[:, 1] = read_pos + read_inc * ar
            segments[-1].append(run)
        read_pos += read_inc * length
        ref_pos += ref_inc * length
    return [np.concatenate(s, axis=0) if s
            else np.empty((0, 2), np.int64) for s in segments]


def trim_pairs_to_ref_region(pairs: np.ndarray, ref_start: int,
                             ref_end: int) -> np.ndarray:
    """eventalign.cpp:180-192 (inclusive bounds)."""
    m = (pairs[:, 0] >= ref_start) & (pairs[:, 0] <= ref_end)
    return pairs[m]


def trim_pairs_to_kmer(pairs: np.ndarray, max_kmer_idx: int) -> np.ndarray:
    """eventalign.cpp:167-177: drop trailing pairs with read_pos >
    max_kmer_idx."""
    n = pairs.shape[0]
    idx = n - 1
    while idx >= 0 and pairs[idx, 1] > max_kmer_idx:
        idx -= 1
    return pairs[: idx + 1]


def get_end_pair(pairs: np.ndarray, ref_pos_max: int, pair_idx: int) -> int:
    """First index from pair_idx whose ref_pos exceeds ref_pos_max, minus
    one; else the last pair (eventalign.cpp:196-205)."""
    n = pairs.shape[0]
    i = pair_idx
    while i < n:
        if pairs[i, 0] > ref_pos_max:
            return i - 1
        i += 1
    return n - 1


def start_segment(job) -> bool:
    """Initialize an eventalign job's chain state
    (``alignment/eventalign._Job``) for aligned segment seg_i: its first
    pair and its first and last events; False if the whole job is
    finished.  Shared by the host wavefront and the device chain's
    staging."""
    read = job.read
    k = job.model.k
    while job.seg_i < len(job.pair_segments):
        pairs = job.pair_segments[job.seg_i]
        if pairs.shape[0] == 0:
            job.seg_i += 1
            continue
        do_base_rc = job.record.is_reverse
        read_kidx_start = int(pairs[0, 1])
        read_kidx_end = int(pairs[-1, 1])
        if do_base_rc:
            read_kidx_start = read.flip_k_strand(read_kidx_start, k)
            read_kidx_end = read.flip_k_strand(read_kidx_end, k)
        if read_kidx_start < 0 or read_kidx_end < 0:
            job.seg_i += 1
            continue
        first_event = read.get_closest_event_to(read_kidx_start, job.strand)
        last_event = read.get_closest_event_to(read_kidx_end, job.strand)
        if first_event == -1 or last_event == -1:
            job.seg_i += 1
            continue
        job.pairs = pairs
        job.curr_start_event = first_event
        job.last_event = last_event
        job.forward = first_event < last_event
        job.curr_start_ref = int(pairs[0, 0])
        job.curr_pair_idx = 0
        return True
    job.done = True
    return False
