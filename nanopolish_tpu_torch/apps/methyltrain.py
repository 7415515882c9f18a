"""`methyltrain` subcommand: train k-mer emission models (methylation or
any alphabet).

Rebuild of methyltrain_main / train_one_round / add_aligned_events /
retrain_model_from_events (reference: src/nanopolish_methyltrain.cpp:
310-474, :589-719, :721-923): per round, align every read to the reference
under the training alphabet, reservoir-sample per-kmer fully-scaled event
levels (cap 1000), then fit per-kmer Gaussian mixtures (methylated kmers
get a 5% unmethylated contamination component).

On the card: the read ingest (banded fill and backtrack kernels) once,
each round's re-alignment (Viterbi fill and backtrack kernels), the
--output-scores Forward scoring (Forward kernel), and one mixture EM over
ALL kmers at once (ops/mixture_em) instead of OpenMP-over-kmers.  Event
collection and the reservoir stay on the host.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import List, Optional, TextIO

import numpy as np
import torch

from ..alignment.eventalign import align_reads_to_ref
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..models.calibration import recalibrate_model_columns
from ..models.pore_model import PoreModel, PoreModelSet
from ..models.read_builder import GLOBAL_READ_STATS
from ..models.read_loader import load_squiggle_reads
from ..ops.mixture_em import train_gaussian_mixture_batched
from ..utils.device import resolve_device
from ..utils.syncstats import timed_fetch
from .bam_processor import BamBatchProcessor
from .scorereads import read_model_scores

# defaults (methyltrain.cpp:144-148)
MIN_EVENT_DURATION = 0.002
MIN_DISTANCE_FROM_ALIGNMENT_END = 5
MIN_NUMBER_OF_EVENTS_TO_TRAIN = 100
NUM_TRAINING_ROUNDS = 5
MAX_EVENTS = 1000
INCOMPLETE_METHYLATION_RATE = 0.05


class KmerSummary:
    __slots__ = ("events", "num_matches", "num_skips", "num_stays")

    def __init__(self):
        self.events: List = []    # (level, scaled_read_var)
        self.num_matches = 0
        self.num_skips = 0
        self.num_stays = 0


def _extract_job_events(cols, sr, strand, acc):
    """Per-job half of the vectorized add_aligned_events body
    (methyltrain.cpp:406-474): per-row model-kmer ranks from the
    whole-window rank arrays the wavefront scored with, the use-filter
    (interior rows, M state, duration and scaled-level floors) in one
    boolean pass.  Appends (ranks, states, used ranks/levels/svar) to
    the batch accumulator; _finalize_events reduces once per batch."""
    n = len(cols)
    if n == 0:
        return
    ranks = cols.model_kmer_ranks()
    valid = ranks >= 0                      # B rows / invalid kmers skipped
    st = cols.state
    is_m = st == 77
    acc["count_r"].append(ranks[valid])
    acc["count_st"].append(st[valid])

    i = np.arange(n)
    ev = np.asarray(cols.event_idx, np.int64)
    dur = np.asarray(sr.get_duration(ev, strand))
    lvl = np.asarray(sr.get_fully_scaled_level(ev, strand), np.float64)
    use = (valid & is_m
           & (i > MIN_DISTANCE_FROM_ALIGNMENT_END)
           & (i + MIN_DISTANCE_FROM_ALIGNMENT_END < n)
           & (dur >= MIN_EVENT_DURATION)
           & (lvl >= 1.0))
    sel = np.flatnonzero(use)
    if sel.size == 0:
        return
    sc = sr.scalings[strand]
    acc["r"].append(ranks[sel])
    acc["l"].append(lvl[sel])
    acc["sv"].append(np.full(sel.size, sc.var / sc.scale))


def _finalize_events(acc, summaries, event_count, match_count,
                     stay_count, rng):
    """Batch half: one concatenated pass over every job's used events,
    in job order — identical reservoir stream to the per-row loop.

    ``rng`` is a NumPy Generator on purpose: the reservoir's draws are
    the host stream ``np.random.default_rng(seed)`` of the reference
    package, so a seed gives the same trained model in both packages."""
    if acc["count_r"]:
        cr = np.concatenate(acc["count_r"])
        cst = np.concatenate(acc["count_st"])
        np.add.at(match_count, cr[cst == 77], 1)
        np.add.at(stay_count, cr[cst == 69], 1)
    if not acc["r"]:
        return
    r_arr = np.concatenate(acc["r"])
    l_arr = np.concatenate(acc["l"])
    sv_arr = np.concatenate(acc["sv"])
    n_states = len(summaries)
    counts_new = np.bincount(r_arr, minlength=n_states)

    # ranks that stay under the reservoir cap take a grouped bulk
    # append (no rng draws happen below the cap, so only the relative
    # order of OVER-cap ranks' events feeds the rng stream — preserved
    # by the scalar tail below); identical output to the scalar loop
    over = (event_count + counts_new > MAX_EVENTS) & (counts_new > 0)
    over_mask = over[r_arr]
    bulk = np.flatnonzero(~over_mask)
    if bulk.size:
        order = bulk[np.argsort(r_arr[bulk], kind="stable")]
        rs = r_arr[order]
        pairs = np.stack([l_arr[order], sv_arr[order]], axis=1)
        bounds = np.flatnonzero(np.diff(rs)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(rs)]])
        for s0, e0 in zip(starts.tolist(), ends.tolist()):
            summaries[int(rs[s0])].events.extend(
                map(tuple, pairs[s0:e0].tolist()))
        np.add.at(event_count, rs[starts], ends - starts)
    scal = np.flatnonzero(over_mask)
    for rank, level, svar in zip(r_arr[scal].tolist(),
                                 l_arr[scal].tolist(),
                                 sv_arr[scal].tolist()):
        c = event_count[rank] = event_count[rank] + 1
        summ_events = summaries[rank].events
        # reservoir sampling (methyltrain.cpp:310-327)
        if c <= MAX_EVENTS:
            summ_events.append((level, svar))
        else:
            loc = int(rng.integers(0, c))
            if loc < MAX_EVENTS:
                summ_events[loc] = (level, svar)


def _load_batch(names, read_db, opt, device, reads_cache):
    """The batch's SquiggleReads: loaded and ingested once, then, in later
    rounds, the cached reads with their as-ingested scalings put back.
    The original scalings OBJECTS are restored: calibration replaces
    ``sr.scalings[strand]`` and never mutates it, so the per-read tables
    cached against a scalings object's identity (alignment/segments.py)
    stay sound."""
    if reads_cache is not None and all(n_ in reads_cache for n_ in names):
        reads = {}
        for n_ in names:
            sr, orig_scalings = reads_cache[n_]
            if sr is not None:
                sr.scalings = list(orig_scalings)
                reads[n_] = sr
        return reads
    reads = load_squiggle_reads(names, read_db, stats=GLOBAL_READ_STATS,
                                num_threads=opt.threads, device=device)
    if reads_cache is not None:
        for n_ in names:
            sr = reads.get(n_)
            reads_cache[n_] = (
                sr, list(sr.scalings) if sr is not None else None)
    return reads


def _score_calibrate_extract(work, fai, references, alphabet: str,
                             calibrate: bool, score_prefix: Optional[str],
                             device):
    """For each aligned job of a batch, in the reference's per-job order:
    its model score (when ``score_prefix`` is set), recalibration (with
    ``calibrate``), its score again, then its training events
    (methyltrain.cpp:380-474).  Returns the jobs' output lines and event
    accumulators, both in job order.

    Jobs of different reads are independent, so the scoring is batched:
    the k-th job of each (read, strand) goes in wave k, and each wave's
    reads are Forward-scored in one batch before and one after its
    calibration.  A read aligned twice is so scored after its first
    alignment's calibration, as in the per-job loop."""
    waves: List[list] = []
    seen: dict = {}
    for pos, ((sr, rec, strand, read_idx), cols) in enumerate(work):
        k = seen.get((id(sr), strand), 0)
        seen[(id(sr), strand)] = k + 1
        if k == len(waves):
            waves.append([])
        waves[k].append((pos, sr, rec, strand, read_idx, cols))
    lines = [""] * len(work)
    accs: List[Optional[dict]] = [None] * len(work)
    for wave in waves:
        items = None
        if score_prefix is not None:
            items = [(sr, strand, fai, references[rec.tid], cols.to_rows())
                     for _, sr, rec, strand, _, cols in wave]
            orig = read_model_scores(items, alphabet, device=device)
        if calibrate:
            for _, sr, _, strand, _, cols in wave:
                recalibrate_model_columns(
                    sr, sr.get_model(strand, alphabet), strand, cols,
                    scale_var=True, scale_drift=True, device=device)
        if items is not None and calibrate:
            rescaled = read_model_scores(items, alphabet, device=device)
        for i, (pos, sr, _, strand, read_idx, cols) in enumerate(wave):
            if items is not None:
                # six significant digits, as the reference's std::cout
                # prints them: the Forward's last bits depend on its exp
                # and log, so more digits would print noise
                head = f"{score_prefix} {read_idx} {strand}"
                lines[pos] = f"{head} Original {orig[i]:g}\n"
                if calibrate:
                    lines[pos] += (
                        f"{head} Rescaled {rescaled[i]:g}\n"
                        f"{head} Delta {rescaled[i] - orig[i]:g}\n")
            accs[pos] = {"count_r": [], "count_st": [], "r": [], "l": [],
                         "sv": []}
            _extract_job_events(cols, sr, strand, accs[pos])
    return lines, accs


def collect_round_events(opt, read_db, fai, model: PoreModel, rng,
                         calibrate: bool, round_idx: int = 0,
                         out=None, read_cache: Optional[dict] = None,
                         device=None):
    """One pass over the BAM collecting per-kmer training events
    (add_aligned_events, methyltrain.cpp:329-474) on ``device``.

    `read_cache` (owned by the round loop) keeps loaded SquiggleReads
    and their as-ingested scalings across rounds: signal load, event
    detection, and the banded event-to-base ingest depend only on the
    read's base model, not the model being trained, so the reference's
    per-round reload (methyltrain.cpp:791-819) is equivalent to
    restoring the original scalings objects and re-running only the
    Viterbi re-alignment under the updated model."""
    alphabet = model.alphabet
    n_states = model.level_mean.shape[0]
    summaries = [KmerSummary() for _ in range(n_states)]
    event_count = np.zeros(n_states, np.int64)
    match_count = np.zeros(n_states, np.int64)
    stay_count = np.zeros(n_states, np.int64)

    output_scores = getattr(opt, "output_scores", False) and out is not None
    # namespaced sub-caches (read names share the outer dict otherwise)
    job_cache = None if read_cache is None else \
        read_cache.setdefault("__jobs__", {})
    reads_cache = None if read_cache is None else \
        read_cache.setdefault("__reads__", {})
    # decoded BAM batches + region bounds are round-invariant; cache them
    # with the reads
    bam_cache = read_cache.get("__bam__") if read_cache is not None else None
    if bam_cache is None:
        proc = BamBatchProcessor(opt.bam, region=opt.window,
                                 max_reads=opt.max_reads)
        region_start = proc.clip_start if opt.window else -1
        region_end = (proc.clip_end - 1) \
            if (opt.window and proc.clip_end >= 0) else -1
        batches = list(proc.batches())
        references = proc.references
        proc.close()
        if read_cache is not None:
            read_cache["__bam__"] = (batches, references, region_start,
                                     region_end)
    else:
        batches, references, region_start, region_end = bam_cache
    for batch in batches:
        names = sorted({rec.qname for _, rec in batch})
        reads = _load_batch(names, read_db, opt, device, reads_cache)
        jobs = []
        for read_idx, rec in batch:
            sr = reads.get(rec.qname)
            if sr is None:
                continue
            for strand in (0, 1):
                if sr.has_events_for_strand(strand):
                    jobs.append((sr, rec, strand, read_idx))
        alignments = align_reads_to_ref(jobs, fai, references,
                                        region_start, region_end,
                                        alphabet=alphabet.name,
                                        columnar=True, job_cache=job_cache,
                                        device=device)
        work = [(j, cols) for j, cols in zip(jobs, alignments)
                if cols is not None and len(cols) > 0]
        lines, accs = _score_calibrate_extract(
            work, fai, references, alphabet.name, calibrate,
            f"{round_idx} {model.name}" if output_scores else None, device)
        if output_scores:
            out.write("".join(lines))
        acc = {key: [a for job_acc in accs for a in job_acc[key]]
               for key in ("count_r", "count_st", "r", "l", "sv")}
        _finalize_events(acc, summaries, event_count, match_count,
                         stay_count, rng)
    for r in np.flatnonzero(match_count):
        summaries[r].num_matches = int(match_count[r])
    for r in np.flatnonzero(stay_count):
        summaries[r].num_stays = int(stay_count[r])
    return summaries


def training_inputs(model: PoreModel, summaries, idx: np.ndarray,
                    is_m: np.ndarray, kmers):
    """The EM's padded inputs for the trainable ranks ``idx``: levels and
    scaled read variances [len(idx), N] f32 (padded with 1.0), their mask,
    and the initial mixture [len(idx), 2] (a methylated kmer: 95% itself,
    5% its unmethylated kmer; any other: itself alone)."""
    alphabet, k = model.alphabet, model.k
    n_ev = np.array([len(summaries[r].events) for r in idx.tolist()])
    mask = np.arange(int(n_ev.max()))[None, :] < n_ev[:, None]
    flat = np.fromiter(itertools.chain.from_iterable(
        itertools.chain.from_iterable(summaries[r].events
                                      for r in idx.tolist())),
        np.float64, count=2 * int(n_ev.sum())).astype(np.float32)
    levels = np.ones(mask.shape, np.float32)
    svar = np.ones(mask.shape, np.float32)
    levels[mask] = flat[0::2]
    svar[mask] = flat[1::2]

    m = is_m[idx]
    logw0 = np.full((idx.size, 2), -np.inf, np.float32)
    logw0[:, 0] = np.where(m, np.float32(np.log(
        1 - INCOMPLETE_METHYLATION_RATE)), np.float32(0.0))
    logw0[m, 1] = np.log(INCOMPLETE_METHYLATION_RATE)
    um = np.array([alphabet.kmer_rank(alphabet.unmethylate(kmers[r]), k)
                   for r in idx[m].tolist()], np.int64)
    mu0 = np.ones((idx.size, 2), np.float32)
    sd0 = np.ones((idx.size, 2), np.float32)
    mu0[:, 0] = model.level_mean[idx]
    sd0[:, 0] = model.level_stdv[idx]
    mu0[m, 1] = model.level_mean[um]
    sd0[m, 1] = model.level_stdv[um]
    return levels, svar, mask, logw0, mu0, sd0


def retrain_model_from_events(model: PoreModel, summaries,
                              training_target: str,
                              summary_fp: Optional[TextIO],
                              model_short_name: str,
                              min_events: int = MIN_NUMBER_OF_EVENTS_TO_TRAIN,
                              device=None):
    """Batched per-kmer mixture fits (methyltrain.cpp:589-719) on
    ``device``; one device-to-host copy brings the trained means and
    stdvs back."""
    alphabet = model.alphabet
    k = model.k
    R = model.level_mean.shape[0]
    kmers = alphabet.all_kmers(k)
    is_m = np.char.find(np.array(kmers, dtype="U"), "M") >= 0
    n_events = np.array([len(s.events) for s in summaries])
    update = np.ones(R, bool)
    if training_target == "methylated":
        update = is_m
    elif training_target == "unmethylated":
        update = ~is_m
    trainable = update & (n_events >= min_events)

    new_mean = model.level_mean.copy()
    new_stdv = model.level_stdv.copy()
    idx = np.nonzero(trainable)[0]
    if idx.size:
        fit = train_gaussian_mixture_batched(
            *training_inputs(model, summaries, idx, is_m, kmers),
            device=device)
        fetched = timed_fetch(torch.cat([fit.means[:, 0], fit.stdvs[:, 0]]))
        new_mean[idx] = fetched[:idx.size]
        new_stdv[idx] = fetched[idx.size:]

    if summary_fp is not None:
        for r in range(R):
            s = summaries[r]
            summary_fp.write(
                f"{model_short_name}\t{kmers[r]}\t{s.num_matches}\t"
                f"{s.num_skips}\t{s.num_stays}\t{len(s.events)}\t"
                f"{int(bool(trainable[r]))}\t{new_mean[r]:.2f}\t"
                f"{new_stdv[r]:.2f}\n")

    return model.with_states(new_mean, new_stdv), int(trainable.sum())


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch methyltrain",
                                description="train a methylation model")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-m", "--models-fofn", required=True)
    p.add_argument("-w", "--window", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-c", "--calibrate", action="store_true")
    p.add_argument("--output-scores", action="store_true",
                   help="print per-read model scores during training")
    p.add_argument("--train-kmers", default="all",
                   choices=["all", "methylated", "unmethylated"])
    p.add_argument("--rounds", type=int, default=NUM_TRAINING_ROUNDS)
    p.add_argument("--min-events", type=int,
                   default=MIN_NUMBER_OF_EVENTS_TO_TRAIN)
    p.add_argument("--out-suffix", default="")
    p.add_argument("--no-write-models", action="store_true")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where ingest, alignment, scoring and the mixture "
                        "EM run (default: cuda; there is no automatic "
                        "fallback to the cpu)")
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)
    pms = PoreModelSet.instance()
    imported = pms.initialize(opt.models_fofn)
    if not imported:
        raise SystemExit("methyltrain: no models imported from fofn")
    model0 = imported[0]
    kit, alphabet, strand, k = model0.key()
    print(f"Training {kit} for alphabet {alphabet} for {k}-mers",
          file=sys.stderr)

    read_db = ReadDB()
    read_db.load(opt.reads)
    fai = FastaIndex(opt.genome)
    rng = np.random.default_rng(opt.seed)

    # elapsed-time round progress (the reference's Progress bar around
    # training, nanopolish_methyltrain.cpp:788,816-818); tty-gated so
    # redirected logs stay clean
    prog = None
    if sys.stderr.isatty():
        from ..utils.profiler import Progress
        prog = Progress("methyltrain")

    read_cache: dict = {}
    for rnd in range(opt.rounds):
        if prog is not None:
            prog.update(rnd / max(opt.rounds, 1))
        print(f"Starting round {rnd}", file=sys.stderr)
        model = pms.get_model(kit, alphabet, strand, k)
        summaries = collect_round_events(opt, read_db, fai, model, rng,
                                         opt.calibrate, round_idx=rnd,
                                         out=out, read_cache=read_cache,
                                         device=device)
        summary_path = f"methyltrain{opt.out_suffix}.summary"
        with open(summary_path, "w") as summary_fp:
            summary_fp.write(
                "model_short_name\tkmer\tnum_matches\tnum_skips\tnum_stays\t"
                "num_events_for_training\twas_trained\ttrained_level_mean\t"
                "trained_level_stdv\n")
            trained_model, n_trained = retrain_model_from_events(
                model, summaries, opt.train_kmers, summary_fp, model.name,
                min_events=opt.min_events, device=device)
        pms.add_model(trained_model)
        if not opt.no_write_models and n_trained > 0:
            out_name = f"{kit}.{alphabet}.{k}mer.{strand}{opt.out_suffix}" \
                f".round{rnd}.model"
            trained_model.write(out_name, out_name)
        print(f"Round {rnd}: trained {n_trained} kmers", file=sys.stderr)
    if prog is not None:
        prog.end()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
