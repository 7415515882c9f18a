"""`phase-reads` subcommand: assign reads to haplotypes at het SNPs.

Rebuild of phase_single_read (reference:
src/nanopolish_phase_reads.cpp:178-347): for each read x SNP, HMM-score
the ref vs alt haplotype (+-30 bp flank) batched on the card; emit a SAM
record whose SEQ is the reference with called alleles substituted and
per-base qualities = phred of P(wrong call).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import List, Optional, TextIO

import numpy as np

from ..alignment.records import (MAX_EVENT_TO_BP_RATIO, EventAlignmentRecord,
                                 SequenceAlignmentRecord, find_by_ref_bounds)
from ..alignment.segments import forward_segments, make_segment
from ..io.bam import BamRecord
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..io.vcf import VcfReader
from ..models.haplotype import Haplotype
from ..models.hmm_input import HMMInputSequence
from ..models.read_builder import GLOBAL_READ_STATS
from ..models.read_loader import load_squiggle_reads
from ..ops.profile_hmm import HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP
from ..utils.device import resolve_device
from ..utils.logsum import add_logs_np
from .bam_processor import BamBatchProcessor
from .eventalign import emit_sam_header

MAX_Q_SCORE = 30
HMM_FLAGS = HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch phase-reads",
                                description="phase reads using haplotype information")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("variants", help="VCF of variants to phase against")
    p.add_argument("-w", "--window", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--min-flanking-sequence", type=int, default=30)
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest and the HMM run (default: cuda; "
                        "there is no automatic fallback to the cpu)")
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)

    variants = sorted(VcfReader(opt.variants).records(),
                      key=lambda v: (v.ref_name, v.ref_position))
    read_db = ReadDB()
    read_db.load(opt.reads)
    fai = FastaIndex(opt.genome)
    proc = BamBatchProcessor(opt.bam, region=opt.window,
                             max_reads=opt.max_reads)
    emit_sam_header(out, proc.header_text, proc.references,
                    proc.reader.lengths)

    for batch in proc.batches():
        names = sorted({rec.qname for _, rec in batch})
        reads = load_squiggle_reads(names, read_db, stats=GLOBAL_READ_STATS,
                                    num_threads=opt.threads, device=device)
        tasks = []       # scoring tasks: 2 segments per (read, variant)
        per_record = []
        for read_idx, rec in batch:
            sr = reads.get(rec.qname)
            if sr is None or not sr.has_events_for_strand(0):
                continue
            strand_idx = 0    # only phase using template (phase_reads.cpp:247)
            ref_name = proc.references[rec.tid]
            astart, aend = rec.pos, rec.reference_end()
            rvars = [v for v in variants
                     if v.ref_name == ref_name
                     and astart <= v.ref_position <= aend and v.is_snp()]
            ref_seq = fai.fetch(ref_name, astart, aend + 1).upper()
            outseq = list(ref_seq)
            outqual = [int(MAX_Q_SCORE)] * len(ref_seq)
            ref_hap = Haplotype(ref_name, astart, ref_seq)

            seq_rec = SequenceAlignmentRecord.from_bam(rec)
            ev_rec = EventAlignmentRecord.build(sr, strand_idx, seq_rec)
            model = sr.base_model[strand_idx]
            k = model.k
            entry = {"record": rec, "outseq": outseq, "outqual": outqual,
                     "astart": astart, "calls": []}
            for v in rvars:
                calling_start = v.ref_position - opt.min_flanking_sequence
                calling_end = v.ref_position + opt.min_flanking_sequence
                if calling_start < astart or calling_end >= ref_hap.get_reference_end():
                    continue
                bounds = find_by_ref_bounds(ev_rec.aligned_events,
                                            calling_start, calling_end)
                if bounds is None:
                    continue
                e1, e2 = bounds
                if abs(e2 - e1) / max(calling_end - calling_start, 1) \
                        > MAX_EVENT_TO_BP_RATIO or abs(e2 - e1) < 2:
                    continue
                calling_hap = ref_hap.substr_by_reference(calling_start,
                                                          calling_end)
                ref_subseq = calling_hap.get_sequence()
                if not calling_hap.apply_variant(v):
                    continue
                alt_subseq = calling_hap.get_sequence()
                for seq in (ref_subseq, alt_subseq):
                    hs = HMMInputSequence(seq, model.alphabet.
                                          reverse_complement(seq),
                                          model.alphabet)
                    ranks = hs.kmer_ranks(k, ev_rec.rc)
                    tasks.append(make_segment(sr, strand_idx, ranks, e1, e2,
                                              model=model, flags=HMM_FLAGS))
                entry["calls"].append(v)
            per_record.append(entry)

        scores = forward_segments(tasks, device=device) if tasks else []
        si = 0
        for entry in per_record:
            for v in entry["calls"]:
                ref_score = float(scores[si])
                alt_score = float(scores[si + 1])
                si += 2
                log_sum = add_logs_np(ref_score, alt_score)
                if alt_score > ref_score:
                    call = v.alt_seq[0]
                    log_p_wrong = ref_score - log_sum
                else:
                    call = v.ref_seq[0]
                    log_p_wrong = alt_score - log_sum
                q = min(MAX_Q_SCORE, -10.0 * log_p_wrong / math.log(10))
                pos = v.ref_position - entry["astart"]
                entry["outseq"][pos] = call
                entry["outqual"][pos] = int(q)
            rec = entry["record"]
            outrec = BamRecord(
                qname=rec.qname, flag=rec.flag, tid=rec.tid, pos=rec.pos,
                mapq=rec.mapq, cigar=[(0, len(entry["outseq"]))],
                mtid=-1, mpos=-1, tlen=0,
                seq="".join(entry["outseq"]),
                qual=np.asarray(entry["outqual"], np.uint8))
            out.write(outrec.to_sam(proc.references) + "\n")
    proc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
