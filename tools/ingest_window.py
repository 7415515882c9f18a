#!/usr/bin/env python3
"""What an ingest window buys on the card: build_reads with each chunk
resolved before the next is issued (a window of 1, what build_reads
does) against up to ``--window`` chunks in flight.

    python3 tools/ingest_window.py [--window 3] [--reps 4] [--out FILE]

Synthesizes seeded reads (the r9.4_450bps template 6-mer model, 10
samples a base, a 300-sample leader) and times build_reads on
``--device cuda`` in three cases:

  batch-8kb    512 reads x 8 kb at the default max_batch (256): the two
               chunks an `eventalign` batch (--batchsize 512) of 8 kb
               reads gives the ingest
  scale        500 reads x 1.2 kb at the default max_batch: the scale
               corpus's one eventalign batch, two chunks
  chunks-8kb   512 reads x 8 kb at max_batch 64: eight chunks

The window is made here, not in the library: build_reads' own
``_finish_chunk`` is wrapped so that a chunk's resolve (the wait for its
fetch and its reads' assembly) is held back until W chunks are in
flight, and the held ones are resolved when build_reads returns (it
fills its result list in place).  Each case runs once to warm up, then
with windows 1, W, W, 1 repeated ``--reps // 2`` times, so that drift in
the host's speed falls on both sides alike.  Per run it records the wall
of build_reads and its device stage: from the first chunk's dispatch
(models/read_builder._dispatch_chunk: packing, upload, launches) to the
last chunk's resolve; event detection on the host comes before it and is
left out.  The reads of the two windows are compared (maps, scalings,
events per base) and must be identical.  Prints the card's name and
power limit, then one JSON line; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import deque

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("batch-8kb", 512, 8000, 256), ("scale", 500, 1200, 256),
         ("chunks-8kb", 512, 8000, 64))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_inputs(n_reads, read_len, seed):
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.models.read_builder import RawReadInput
    from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
    from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                      synthetic_raw_signal)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        seq = random_sequence(rng, read_len)
        raw = synthetic_raw_signal(
            rng, seq, model, SquiggleScalings.from4(0.0, 1.0, 0.0, 1.0),
            samples_per_base=10.0, leader=300, trailer=60)
        out.append(RawReadInput(read_name=f"r{i:04d}", sequence=seq,
                                raw=raw))
    return out


def read_key(r):
    if r is None:
        return None
    sc = r.scalings[0]
    m = r.base_to_event_map[0]
    return (r.read_name, None if m is None else m.tobytes(),
            np.float32(r.events_per_base[0]).tobytes(),
            np.array([sc.shift, sc.scale, sc.drift, sc.var],
                     np.float32).tobytes())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nanopolish_tpu_torch.models import read_builder as rb

    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=3,
                    help="chunks in flight against serial chunks")
    ap.add_argument("--reps", type=int, default=4,
                    help="runs of each window per case (even)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    span = {}
    held = deque()
    now = {"window": 1}
    dispatch, finish = rb._dispatch_chunk, rb._finish_chunk

    def timed_dispatch(*a, **k):
        span.setdefault("t0", time.perf_counter())
        return dispatch(*a, **k)

    def windowed_finish(*a):
        held.append(a)
        if len(held) >= now["window"]:
            finish(*held.popleft())

    rb._dispatch_chunk, rb._finish_chunk = timed_dispatch, windowed_finish
    window = args.window
    print(card(), flush=True)
    result = {"card": card(), "window": window, "cases": {}}
    for ci, (name, n_reads, read_len, max_batch) in enumerate(CASES):
        t0 = time.perf_counter()
        inputs = make_inputs(n_reads, read_len, seed=500 + ci)
        setup_s = time.perf_counter() - t0
        runs = {1: [], window: []}
        keys = {}

        def run(w):
            now["window"] = w
            span.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            reads = rb.build_reads(inputs, max_batch=max_batch,
                                   device="cuda")
            while held:
                finish(*held.popleft())
            t1 = time.perf_counter()
            return reads, t1 - t, t1 - span["t0"]

        run(window)                                  # warm-up
        order = [1, window, window, 1] * max(1, args.reps // 2)
        for w in order:
            reads, wall, dev_s = run(w)
            runs[w].append({"wall_s": wall, "device_stage_s": dev_s})
            keys.setdefault(w, [read_key(r) for r in reads])
        if keys[1] != keys[window]:
            print(f"{name}: reads differ between windows 1 and {window}",
                  file=sys.stderr)
            return 1
        med = {w: statistics.median(r["device_stage_s"] for r in runs[w])
               for w in runs}
        chunks = -(-n_reads // max_batch)
        result["cases"][name] = {
            "reads": n_reads, "read_len": read_len, "max_batch": max_batch,
            "chunks": chunks, "setup_s": setup_s,
            "runs": {str(w): runs[w] for w in runs},
            "median_device_stage_s": {str(w): med[w] for w in med},
            "gain_s": med[1] - med[window]}
        print(f"{name}: {n_reads} reads x {read_len} in {chunks} chunks; "
              f"device stage median {med[1]:.4f} s serial, "
              f"{med[window]:.4f} s with {window} in flight", flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
