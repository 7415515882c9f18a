#!/usr/bin/env python3
"""The benchmark of nanopolish_tpu_torch on one or more CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run is one process: set-up (the cell's reads made from the seed in
$TMPDIR, the port's ``index`` once, one warm pass), the
window (a closed loop of passes, each one call of the app's entry in
process writing into an in-memory sink), the comparison with the plain
reference, and one JSON line on stdout.  Every run records the window's
device operations with torch.profiler (CUDA activity): the end-to-end
metrics are ``setup_s`` and what ``metrics/<name>.py`` reads from that
record; ``--trace 1`` also sets ``NPT_PROFILE=1`` and reports the
per-layer metrics instead.  Without a CUDA card, or with fewer than the
cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import atexit  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import check, devtrace, generator, isolation, spec, window  # noqa: E402
from harness.sink import Sink  # noqa: E402


MODELS_NPZ = os.path.join(spec.REPO, "nanopolish_tpu_torch", "data",
                          "builtin_models.npz")


def _sync(device: str):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def prepare(cell: spec.Cell, seed: int, device: str, workdir: str):
    """The cell's inputs from the seed, written under workdir, and the
    means to run a pass: (dataset, the sampled reads' names, a sink
    factory, one_pass(sink) -> sink)."""
    cfg, app = cell.config, cell.app
    ds = generator.synthesize(cfg, cell.traffic, seed, MODELS_NPZ)
    paths = generator.write_files(ds, os.path.join(workdir, "data"))
    names = [r.name for r in check.sample(
        ds, int(cell.traffic["check_reads"]), seed)]
    by_index = {r.bam_index: r.name for r in ds.reads}
    main = app.entry()
    argv = ["-r", paths["fastq"], "-b", paths["bam"], "-g", paths["ref_fa"],
            *cfg["app"]["flags"], "--device", device]

    def new_sink(keep=names):
        return Sink(lambda line: app.read_key(line, by_index), keep)

    def one_pass(sink):
        main(argv, stdout=sink)
        _sync(device)
        return sink
    return ds, names, new_sink, one_pass


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, workdir: str) -> dict:
    """Set-up, window and check of one run; returns the result line's
    fields (without ``device``'s card fields when on the cpu)."""
    import torch
    cfg, app = cell.config, cell.app
    ds, names, new_sink, one_pass = prepare(cell, seed, device, workdir)
    # one whole pass warms every shape the window uses (the first pass of
    # a process also fills the allocators' caches); the set-up's objects
    # then leave the collector's generations, so that a full collection
    # in the window scans only what the passes make
    one_pass(new_sink(()))
    gc.collect()
    gc.freeze()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    kept = []

    def counted_pass(i):
        kept.append(one_pass(new_sink()))

    # every run records the window's device operations: the seconds its
    # kernels held the card are an end-to-end metric, the per-layer
    # metrics read the rest
    if trace:
        from nanopolish_tpu_torch.alignment.device_chain import CHAIN_STATS
        from nanopolish_tpu_torch.utils import profiler as nprof
        from nanopolish_tpu_torch.utils.syncstats import SYNC_STATS
        chain0, sync0, scopes0 = (dict(CHAIN_STATS), SYNC_STATS.snapshot(),
                                  nprof.snapshot())
    if device == "cuda":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0, ends = window.run(counted_pass, seconds)
        iv = devtrace.device_intervals(prof)
        del prof
    else:
        t0, ends = window.run(counted_pass, seconds)
        iv = []
    wall = ends[-1] - t0
    rec = dict(app=cfg["app"]["name"], wall_s=wall,
               bases=len(ends) * ds.bases, busy_s=devtrace.union_seconds(iv),
               kernel_busy_s=devtrace.union_seconds(devtrace.kernels(iv)),
               window_s=wall, kernel_s=devtrace.by_name(iv))
    if trace:
        sync1, scopes1 = SYNC_STATS.snapshot(), nprof.snapshot()
        rec.update(scopes={k: v[1] - scopes0.get(k, (0, 0.0))[1]
                           for k, v in scopes1.items()},
                   chain={k: CHAIN_STATS[k] - chain0[k] for k in chain0},
                   blocked_s=sync1.blocked_s - sync0.blocked_s,
                   breakdown=devtrace.breakdown(iv))
        atexit.unregister(nprof._report)
    del iv
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # the program's state goes before the reference runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    per_pass = [{n: s.lines(n) for n in names} for s in kept]
    t_check = time.perf_counter()
    ref = check.reference_rows(cell, ds, [r for r in ds.reads
                                          if r.name in set(names)],
                               device, per_pass[0])
    all_reads = {r.name for r in ds.reads}
    failed = sum(len(all_reads - s.seen) for s in kept)
    numbers = check.compare(app, per_pass[0], ref)
    numbers["passes_differing"] = check.passes_differing(per_pass)
    numbers["reads_missing"] = failed
    limits = dict(cfg["limits"], passes_differing=0, reads_missing=0)

    out = dict(correct=check.judge(numbers, limits),
               attempted=len(ends) * len(all_reads), failed=failed,
               passes=len(ends), window_s=ends[-1] - t0,
               pass_s=[b - a for a, b in zip([t0] + ends, ends)],
               check_s=time.perf_counter() - t_check)
    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["name"] in cell.readers:
            v = cell.readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"], out["trace"] = metrics, rec
    out["rate"] = window.rate(ds.bases, t0, ends)
    out["memory_peak_bytes"] = peak
    out["numbers"], out["limits"] = numbers, limits
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        print(f"benchmark: cannot load workload {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    if args.trace:
        os.environ["NPT_PROFILE"] = "1"
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import nanopolish_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is not importable: {e}", file=sys.stderr)
        return 4
    workdir = tempfile.mkdtemp(prefix="npbench-")
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = isolation.forbidden_loaded()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device, "passes": out["passes"]}
    if args.trace:
        rec = out["trace"]
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["window_s"]
        result["breakdown"] = rec["breakdown"]
    print(f"benchmark: {args.workload} seed {args.seed}: {out['passes']} "
          f"passes in {out['window_s']:.3f} s (each {out['pass_s']}), "
          f"{out['rate']:.1f} bases/s, card busy {out['trace']['busy_s']:.4f}"
          f" s, kernels {out['trace']['kernel_busy_s']:.4f} s, "
          f"check {out['check_s']:.1f} s", file=sys.stderr)
    result["check"] = check.report(out["numbers"], out["limits"])
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


# glibc's allocator keeps what it frees, and Python allocates through it,
# so that a pass does not fault its hundreds of MB of rows and arrays in
# again: on the card's host, passes of one run spread less with it (a
# run's passes: 4.9% for 10.4% of their mean on ea-longread, 8.1% for
# 26.1% on cm-longread).  glibc and Python read these once, at start-up.
STEADY_ENV = {"MALLOC_MMAP_THRESHOLD_": "33554432",
              "MALLOC_TRIM_THRESHOLD_": "17179869184",
              "MALLOC_TOP_PAD_": "268435456",
              "PYTHONMALLOC": "malloc"}


def steady_env():
    """Start again under STEADY_ENV where this process lacks it, keeping
    the first start as the set-up's start."""
    global T_START
    if any(os.environ.get(k) != v for k, v in STEADY_ENV.items()):
        os.environ.update(STEADY_ENV, NPBENCH_T_START=repr(T_START))
        os.execv(sys.executable, [sys.executable] + sys.argv)
    T_START = float(os.environ.pop("NPBENCH_T_START", T_START))


if __name__ == "__main__":
    steady_env()
    sys.exit(main())
