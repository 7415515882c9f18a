"""`train-poremodel-from-basecalls` subcommand: bootstrap a nucleotide
pore model from basecalled reads only (no reference).

The reference's implementation body is disabled (`#if 0` in
src/nanopolish_train_poremodel_from_basecalls.cpp:209+); this provides a
working equivalent of its documented design: initialize a model from the
read with the most events (per-kmer median levels), then iterate rounds of
event-to-basecall banded alignment + single-Gaussian updates.

Each round aligns every read in one launch of the banded kernels
(ops/banded_exact: csrc/banded_fill.cu, csrc/banded_backtrack.cu) on
``--device``; the per-kmer statistics are host NumPy.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, TextIO

import numpy as np

from ..io.readdb import ReadDB
from ..models.pore_model import PoreModel
from ..models.read_builder import GLOBAL_READ_STATS
from ..models.read_loader import load_raw_inputs
from ..ops import event_detect
from ..ops.banded_exact import banded_align_exact
from ..utils.alphabet import DNA_ALPHABET
from ..utils.device import resolve_device
from ..utils.syncstats import timed_fetch

MIN_VALUES_TO_UPDATE = 10
MIN_STDV = 0.5


def _detect_all(inputs):
    """Event tables + kmer ranks for each read."""
    out = []
    for name, inp in inputs.items():
        bounds = event_detect.trim_and_segment_raw(inp.raw, 200, 10, 100, 0.0)
        if bounds is None:
            continue
        et = event_detect.detect_events(inp.raw[bounds[0]:bounds[1]],
                                        event_detect.EVENT_DETECTION_DEFAULTS)
        if len(et) == 0:
            continue
        out.append((name, inp.sequence, et))
    return out


def _align_and_collect(reads, model, k, device=None) -> List[np.ndarray]:
    """Banded-align each read's events to its basecall under `model`, all
    reads in one batch on ``device``; return each kmer rank's event levels
    (those >= 1 pA), in the order reads, kmers ascending, events
    ascending."""
    n_states = model.level_mean.shape[0]
    B = len(reads)
    if B == 0:
        return [np.zeros(0)] * n_states
    T = max(len(et) for _, _, et in reads)
    K = max(len(seq) - k + 1 for _, seq, _ in reads)
    ev = np.zeros((B, max(T, 8)), np.float32)
    mu = np.zeros((B, max(K, 8)), np.float32)
    sd = np.ones((B, max(K, 8)), np.float32)
    ranks_all = np.zeros((B, max(K, 8)), np.int64)
    nev = np.zeros(B, np.int32)
    nk = np.zeros(B, np.int32)
    for i, (_, seq, et) in enumerate(reads):
        ranks = DNA_ALPHABET.seq_to_kmer_ranks(seq, k)
        ev[i, :len(et)] = et.mean
        mu[i, :len(ranks)] = model.level_mean[ranks]
        sd[i, :len(ranks)] = model.level_stdv[ranks]
        ranks_all[i, :len(ranks)] = ranks
        nev[i] = len(et)
        nk[i] = len(ranks)
    res = banded_align_exact(ev, nev, mu, sd, np.log(sd), nk, device=device)
    b2e_start, b2e_stop, failed = (
        timed_fetch(x) for x in (res.b2e_start, res.b2e_stop, res.failed))

    # every (read, kmer, event) of the base->event maps, in row-major order
    kmer_ok = (np.arange(b2e_start.shape[1])[None, :] < nk[:, None]) \
        & (b2e_start != -1) & ~failed[:, None]
    rows, kis = np.nonzero(kmer_ok)
    starts = b2e_start[rows, kis].astype(np.int64)
    counts = np.maximum(b2e_stop[rows, kis].astype(np.int64) - starts + 1, 0)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    events = np.repeat(starts, counts) + np.arange(int(counts.sum())) - first
    ev_rows = np.repeat(rows, counts)
    lvl = ev[ev_rows, events].astype(np.float64)
    rk = np.repeat(ranks_all[rows, kis], counts)
    keep = lvl >= 1.0
    lvl, rk = lvl[keep], rk[keep]
    order = np.argsort(rk, kind="stable")
    bounds = np.searchsorted(rk[order], np.arange(n_states + 1))
    lvl = lvl[order]
    return [lvl[bounds[r]:bounds[r + 1]] for r in range(n_states)]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanopolish_tpu_torch train-poremodel-from-basecalls",
        description="bootstrap a pore model from basecalled reads")
    p.add_argument("-r", "--reads", required=True,
                   help="basecalled reads with a built readdb index")
    p.add_argument("-k", type=int, default=6)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("-o", "--output", default="bootstrapped.model")
    p.add_argument("--max-reads", type=int, default=100)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the banded alignment runs (default: cuda; "
                        "there is no automatic fallback to the cpu)")
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    device = resolve_device(opt.device)
    k = opt.k
    read_db = ReadDB()
    read_db.load(opt.reads)
    names = read_db.get_all_read_names()[:opt.max_reads]
    inputs = load_raw_inputs(names, read_db, stats=GLOBAL_READ_STATS)
    reads = _detect_all(inputs)
    if not reads:
        raise SystemExit("no usable reads")
    print(f"Loaded {len(reads)} reads", file=sys.stderr)

    # bootstrap means from a proportional event split of the read with the
    # most events
    n_states = DNA_ALPHABET.num_strings(k)
    best = max(reads, key=lambda r: len(r[2]))
    name, seq, et = best
    ranks = DNA_ALPHABET.seq_to_kmer_ranks(seq, k)
    ki = np.minimum((np.arange(len(et)) * len(ranks)) // max(len(et), 1),
                    len(ranks) - 1)
    level_mean = np.full(n_states, 100.0)
    sums = np.zeros(n_states)
    cnts = np.zeros(n_states)
    np.add.at(sums, ranks[ki], et.mean)
    np.add.at(cnts, ranks[ki], 1)
    got = cnts > 0
    level_mean[got] = sums[got] / cnts[got]
    level_stdv = np.full(n_states, 2.5)
    model = PoreModel(kit="bootstrap", strand="template", k=k,
                      alphabet=DNA_ALPHABET, level_mean=level_mean,
                      level_stdv=level_stdv,
                      sd_mean=np.zeros(n_states), sd_stdv=np.ones(n_states),
                      name=f"bootstrap_{k}mer")

    for rnd in range(opt.rounds):
        per_rank = _align_and_collect(reads, model, k, device=device)
        trained = 0
        for r, v in enumerate(per_rank):
            if len(v) >= MIN_VALUES_TO_UPDATE:
                level_mean[r] = float(np.median(v))
                level_stdv[r] = max(float(v.std()), MIN_STDV)
                trained += 1
        model = model.with_states(level_mean.copy(), level_stdv.copy())
        print(f"Round {rnd}: updated {trained}/{n_states} kmers",
              file=sys.stderr)

    model.write(opt.output, model.name)
    print(f"Wrote {opt.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
