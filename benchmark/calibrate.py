#!/usr/bin/env python3
"""Readings that the comparison's limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 3]

For each seed: the cell's inputs, one pass of the port at the cell's own
size (the window's call and flags), the plain reference, and the numbers
the run would compare: the program's (sound runs: the lower readings).
For the first ``--control-seeds`` seeds also the control's: the plain
reference computed in bfloat16 (``reference.common.CONTROL``) put in the
program's place (the upper readings).  One JSON line a seed; all seeds in one
process, so that set-up is paid once.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import run  # noqa: E402
from harness import check, spec  # noqa: E402
from reference.common import CONTROL  # noqa: E402


def readings(cell: spec.Cell, seed: int, device: str, control: bool,
             workdir: str) -> dict:
    d = os.path.join(workdir, f"seed{seed}")
    ds, names, new_sink, one_pass = run.prepare(cell, seed, device, d)
    t = time.perf_counter()
    sink = one_pass(new_sink())
    pass_s = time.perf_counter() - t
    prog = {n: sink.lines(n) for n in names}
    reads = [r for r in ds.reads if r.name in set(names)]
    t = time.perf_counter()
    ref = check.reference_rows(cell, ds, reads, device, prog)
    ref_s = time.perf_counter() - t
    out = {"seed": seed, "pass_s": pass_s, "reference_s": ref_s,
           "rows": sum(len(v) for v in ref.values()),
           "program": dict(check.compare(cell.app, prog, ref),
                           reads_missing=len({r.name for r in ds.reads}
                                             - sink.seen))}
    if control:
        ctl = check.reference_rows(cell, ds, reads, device, prog,
                                   prec=CONTROL)
        ctl_lines = {n: [line for line, _ in rows]
                     for n, rows in ctl.items()}
        out["control"] = check.compare(cell.app, ctl_lines, ref)
    shutil.rmtree(d, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    workdir = tempfile.mkdtemp(prefix="npcal-")
    try:
        for i, s in enumerate(seeds):
            r = readings(cell, s, "cuda", i < args.control_seeds,
                         workdir)
            print(json.dumps(dict(r, workload=args.workload)), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
