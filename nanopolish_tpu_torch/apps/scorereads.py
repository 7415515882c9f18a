"""`scorereads` subcommand: per-read/per-strand model fit diagnostics.

Rebuild of scorereads_main / model_score
(reference: src/nanopolish_scorereads.cpp:116-203, :306-462): align each
read to the reference, Forward-score 500-event segments (batched on the
card), optionally recalibrate, print per-segment and per-read scores.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, TextIO

from ..alignment.eventalign import align_reads_to_ref
from ..alignment.segments import forward_segments, make_segment, viterbi_segments
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..models.calibration import recalibrate_model
from ..models.hmm_input import HMMInputSequence
from ..models.pore_model import PoreModelSet
from ..models.read_builder import GLOBAL_READ_STATS
from ..models.read_loader import load_squiggle_reads
from ..models.transition_parameters import TransitionParameters
from ..utils.device import resolve_device
from .bam_processor import BamBatchProcessor

EVENTS_PER_SEGMENT = 500


def _segment_tasks(sr, strand_idx, fai, contig, alignment,
                   alphabet: str = "nucleotide"):
    """One scoring task per 500-event alignment chunk
    (model_score, scorereads.cpp:116-203)."""
    tasks = []
    n = len(alignment)
    model = sr.get_model(strand_idx, alphabet)
    k = model.k
    for start in range(EVENTS_PER_SEGMENT, n - EVENTS_PER_SEGMENT,
                       EVENTS_PER_SEGMENT):
        a0 = alignment[start]
        a1 = alignment[start + EVENTS_PER_SEGMENT]
        ref_start, ref_end = a0.ref_position, a1.ref_position
        if ref_end < ref_start:
            continue
        ref_seq = fai.fetch(contig, ref_start, ref_end + 1).upper()
        if len(ref_seq) <= k:
            continue
        ref_seq = model.alphabet.disambiguate(ref_seq)
        hmm_seq = HMMInputSequence(ref_seq, model.alphabet.reverse_complement(
            ref_seq), model.alphabet)
        rc = alignment[0].rc
        ranks = hmm_seq.kmer_ranks(k, rc)
        seg = make_segment(sr, strand_idx, ranks, a0.event_idx, a1.event_idx,
                           model=model)
        n_events = abs(a1.event_idx - a0.event_idx) + 1
        sub = alignment[start:start + EVENTS_PER_SEGMENT]
        tasks.append({"segment": seg, "n_events": n_events, "sub": sub,
                      "model": model, "hmm_seq": hmm_seq, "rc": rc,
                      "event_start": a0.event_idx,
                      "stride": 1 if a1.event_idx >= a0.event_idx else -1})
    return tasks


def read_model_scores(items, alphabet: str = "nucleotide",
                      device=None) -> List[float]:
    """``read_model_score`` of each (sr, strand_idx, fai, contig,
    alignment) item, every 500-event chunk of every item Forward-scored in
    one batch on ``device``."""
    device = resolve_device(device)
    per_item = [_segment_tasks(*it, alphabet=alphabet) for it in items]
    segments = [t["segment"] for tasks in per_item for t in tasks]
    scores = forward_segments(segments, device=device) if segments else []
    out, si = [], 0
    for tasks in per_item:
        if not tasks:
            out.append(float("-inf"))
            continue
        mine = scores[si:si + len(tasks)]
        si += len(tasks)
        out.append(sum(float(s) for s in mine) /
                   sum(t["n_events"] for t in tasks))
    return out


def read_model_score(sr, strand_idx, fai, contig, alignment,
                     alphabet: str = "nucleotide", device=None) -> float:
    """Average per-event Forward log-likelihood of a read's alignment
    (model_score, scorereads.cpp:116-203), its 500-event chunks scored on
    ``device`` (``cuda`` unless ``cpu`` is asked); methyltrain
    --output-scores (methyltrain.cpp:380-404) scores its reads in batches
    through ``read_model_scores``."""
    return read_model_scores([(sr, strand_idx, fai, contig, alignment)],
                             alphabet=alphabet, device=device)[0]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch scorereads",
                                description="score reads against an alignment")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-m", "--models-fofn", default="")
    p.add_argument("-w", "--window", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-c", "--calibrate", action="store_true")
    p.add_argument("-z", "--zero-drift", action="store_true")
    p.add_argument("-i", "--individual-reads", default="")
    p.add_argument("--train-transitions", action="store_true")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest and the HMM run (default: cuda; "
                        "there is no automatic fallback to the cpu)")
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)
    if opt.models_fofn:
        PoreModelSet.instance().initialize(opt.models_fofn)
    scale_drift = not opt.zero_drift
    readnames = [r for r in opt.individual_reads.split(",") if r] \
        if opt.individual_reads else []

    transition_training = [TransitionParameters(), TransitionParameters()]

    read_db = ReadDB()
    read_db.load(opt.reads)
    fai = FastaIndex(opt.genome)
    proc = BamBatchProcessor(opt.bam, region=opt.window,
                             max_reads=opt.max_reads)
    region_start = proc.clip_start if opt.window else -1
    region_end = (proc.clip_end - 1) if (opt.window and proc.clip_end >= 0) \
        else -1

    for batch in proc.batches():
        recs = [(i, r) for i, r in batch
                if not readnames or r.qname in readnames]
        names = sorted({r.qname for _, r in recs})
        reads = load_squiggle_reads(names, read_db, stats=GLOBAL_READ_STATS,
                                    num_threads=opt.threads, device=device)
        jobs = []
        for read_idx, rec in recs:
            sr = reads.get(rec.qname)
            if sr is None:
                continue
            for strand in (0, 1):
                if sr.has_events_for_strand(strand):
                    jobs.append((sr, rec, strand, read_idx))
        alignments = align_reads_to_ref(jobs, fai, proc.references,
                                        region_start, region_end,
                                        device=device)

        # collect all 500-event segments across the batch, score together
        per_job_tasks = []
        for (sr, rec, strand, read_idx), ao in zip(jobs, alignments):
            if not ao:
                per_job_tasks.append(None)
                continue
            if opt.calibrate:
                recalibrate_model(sr, sr.get_model(strand, "nucleotide"),
                                  strand, ao, True, scale_drift,
                                  device=device)
            contig = proc.references[rec.tid]
            per_job_tasks.append(_segment_tasks(sr, strand, fai, contig, ao))
        all_segments = [t["segment"] for tasks in per_job_tasks if tasks
                        for t in tasks]
        scores = forward_segments(all_segments, device=device) \
            if all_segments else []
        backs = viterbi_segments(all_segments, device=device) \
            if (opt.train_transitions and all_segments) else None

        si = 0
        for (sr, rec, strand, read_idx), tasks in zip(jobs, per_job_tasks):
            if not tasks:
                continue
            if backs is not None:
                for toff, t in enumerate(tasks):
                    evs, kms, states = backs[si + toff]
                    aln = [(t["event_start"] + int(e) * t["stride"], int(km),
                            st) for e, km, st in zip(evs, kms, states)]
                    transition_training[strand].add_training_from_alignment(
                        sr, strand, t["model"], t["hmm_seq"], t["rc"], aln)
            curr_score = 0.0
            nevents = 0
            for t in tasks:
                seg_score = float(scores[si])
                si += 1
                # per-segment recalibration diagnostics (restores scalings)
                saved = sr.scalings[strand]
                recalibrate_model(sr, t["model"], strand, t["sub"], True,
                                  scale_drift, device=device)
                sc = sr.scalings[strand]
                out.write(f"SEGMENT\t{sr.read_name}\t{nevents}\t"
                          f"{seg_score / t['n_events']:.3f}\t{t['n_events']}\t"
                          f"{sc.shift:.2f}\t{sc.scale:.2f}\t{sc.drift:.2f}\t"
                          f"{sc.var:.2f}\n")
                sr.scalings[strand] = saved
                curr_score += seg_score
                nevents += t["n_events"]
            if nevents == 0:
                continue
            score = curr_score / nevents
            if score > 0:
                continue
            sc = sr.scalings[strand]
            model = sr.get_model(strand, "nucleotide")
            out.write(f"{sr.read_name} "
                      f"{'complement' if strand else 'template'} "
                      f"{model.name} {score:g} shift {sc.shift:g} "
                      f"scale {sc.scale:g} drift {sc.drift:g} "
                      f"var {sc.var:g}\n")
    if opt.train_transitions:
        for strand_idx in (0, 1):
            print(f"Transition parameters for {strand_idx}", file=sys.stderr)
            transition_training[strand_idx].train()
            transition_training[strand_idx].print()
    proc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
