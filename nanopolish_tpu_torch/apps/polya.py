"""`polya` subcommand: poly(A) tail length estimation for direct RNA.

Rebuild of polya_main / estimate_polya_for_single_read
(reference: src/nanopolish_polya_estimator.cpp:700-890): segmentation HMM
over raw samples (batched on the card), read rate from median collapsed
kmer duration, tail length = polya duration x rate - 5, QC tags.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, TextIO

import numpy as np

from ..io.readdb import ReadDB
from ..models.read_builder import GLOBAL_READ_STATS, SRF_LOAD_RAW_SAMPLES
from ..models.read_loader import load_squiggle_reads
from ..ops.segmentation_hmm import Segmentation, segment_reads
from ..utils.device import resolve_device
from .bam_processor import BamBatchProcessor

ESTIMATION_ERROR_OFFSET = -5.0

TSV_HEADER = ("readname\tcontig\tposition\tleader_start\tadapter_start\t"
              "polya_start\ttranscript_start\tread_rate\tpolya_length")


def estimate_unaligned_duration_profile(sr, strand_idx: int) -> float:
    """Median per-kmer collapsed duration -> read rate
    (polya_estimator.cpp:563-599)."""
    b2e = sr.base_to_event_map[strand_idx]
    durations = sr.events[strand_idx].duration
    # range sums via the duration prefix sum:
    # sum(durations[s:e+1]) = csum[e+1] - csum[s]
    csum = np.concatenate([[0.0], np.cumsum(durations, dtype=np.float64)])
    s = b2e[:, 0].astype(np.int64)
    e = b2e[:, 1].astype(np.int64)
    valid = s != -1
    per_kmer = np.where(valid,
                        csum[np.clip(e, 0, None) + 1] - csum[np.clip(s, 0, None)],
                        0.0)
    per_kmer.sort()
    median = per_kmer[len(per_kmer) // 2]
    if median <= 0:
        return float("inf")
    return 1.0 / median


def estimate_polya_length(sr, seg: Segmentation, read_rate: float) -> float:
    """polya_estimator.cpp:638-662."""
    polya_duration = (seg.polya - (seg.adapter + 1)) / sr.sample_rate
    return max(0.0, polya_duration * read_rate + ESTIMATION_ERROR_OFFSET)


def pre_segmentation_qc(suffix_clip: int) -> str:
    return "SUFFCLIP" if suffix_clip > 200 else "PASS"


def post_segmentation_qc(seg: Segmentation) -> str:
    num_adapter = (seg.adapter + 1) - seg.leader
    num_polya = seg.polya - (seg.adapter + 1)
    return "NOREGION" if (num_adapter < 200.0 or num_polya < 200.0) else "PASS"


def post_estimation_qc(seg: Segmentation, sr, read_rate: float) -> str:
    adapter_duration = (seg.adapter - (seg.leader - 1)) / sr.sample_rate
    adapter_length = adapter_duration * read_rate
    return "ADAPTER" if adapter_length > 300.0 else "PASS"


def resolve_qc(pre: str, post_seg: str, post_est: str) -> str:
    if post_seg != "PASS":
        return post_seg
    if post_est != "PASS":
        return post_est
    if pre != "PASS":
        return pre
    return "PASS"


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The options polya and detect-polyi share."""
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-w", "--window", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest and the segmentation HMM run "
                        "(default: cuda; there is no automatic fallback "
                        "to the cpu)")
    return p


def make_parser() -> argparse.ArgumentParser:
    return add_common_args(argparse.ArgumentParser(
        prog="nanopolish_tpu_torch polya",
        description="estimate poly-A tail lengths"))


def segmented_batches(opt, device, out: TextIO, params=None):
    """For each BAM batch: load the reads with their raw samples, write a
    READ_FAILED_LOAD row for each that cannot be segmented, segment the
    rest in one call on device, and yield the batch's rows [(rec,
    ref_name, sr, seg, qc, read_rate, polya_length)]."""
    read_db = ReadDB()
    read_db.load(opt.reads)
    proc = BamBatchProcessor(opt.bam, region=opt.window,
                             max_reads=opt.max_reads)
    try:
        for batch in proc.batches():
            recs = [(i, r) for i, r in batch if not r.is_secondary]
            names = sorted({r.qname for _, r in recs})
            reads = load_squiggle_reads(names, read_db,
                                        flags=SRF_LOAD_RAW_SAMPLES,
                                        stats=GLOBAL_READ_STATS,
                                        num_threads=opt.threads,
                                        device=device)
            jobs = []
            for read_idx, rec in recs:
                ref_name = proc.references[rec.tid]
                sr = reads.get(rec.qname)
                if sr is None or not sr.has_events_for_strand(0) or \
                        sr.samples is None or len(sr.samples) < 8:
                    out.write(f"{rec.qname}\t{ref_name}\t{rec.pos}\t-1.0\t"
                              f"-1.0\t-1.0\t-1.0\t-1.00\t-1.00\t"
                              f"READ_FAILED_LOAD\n")
                    continue
                suffix_clip = rec.cigar[-1][1] if rec.cigar and \
                    rec.cigar[-1][0] == 4 else 0
                jobs.append((rec, ref_name, sr, suffix_clip))
            if not jobs:
                continue
            segs = segment_reads(
                [j[2].samples for j in jobs],
                [(j[2].scalings[0].scale, j[2].scalings[0].shift,
                  j[2].scalings[0].var) for j in jobs],
                params=params, device=device)
            rows = []
            for (rec, ref_name, sr, suffix_clip), seg in zip(jobs, segs):
                read_rate = estimate_unaligned_duration_profile(sr, 0)
                qc = resolve_qc(pre_segmentation_qc(suffix_clip),
                                post_segmentation_qc(seg),
                                post_estimation_qc(seg, sr, read_rate))
                rows.append((rec, ref_name, sr, seg, qc, read_rate,
                             estimate_polya_length(sr, seg, read_rate)))
            yield rows
    finally:
        proc.close()


def row_prefix(rec, ref_name, seg, read_rate, polya_length) -> str:
    return (f"{rec.qname}\t{ref_name}\t{rec.pos}\t"
            f"{seg.start + 1:.1f}\t{seg.leader + 1:.1f}\t"
            f"{seg.adapter + 1:.1f}\t{seg.polya + 1:.1f}\t"
            f"{read_rate:.2f}\t{polya_length:.2f}")


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)
    out.write(TSV_HEADER + "\tqc_tag\n")
    for rows in segmented_batches(opt, device, out):
        for rec, ref_name, sr, seg, qc, read_rate, polya_length in rows:
            out.write(row_prefix(rec, ref_name, seg, read_rate, polya_length)
                      + f"\t{qc}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
