#!/usr/bin/env python3
"""Where nanopolish_tpu_torch's eventalign spends its time on the card.

    python3 tools/port_trace_eventalign.py [--summary]

Builds the chip_smoke.py main-path corpus (64 synthetic reads of 8 kb
from a 100 kb genome), runs `eventalign --device cuda` once to warm up (kernel build,
allocator), once more with wall-clock timers around the pipeline's
stages, and a third time under torch.profiler for the device's kernel
time (the profiler's own host overhead inflates that run's wall, so the
idle share is taken against the un-profiled wall):

  ingest      models.read_loader.load_squiggle_reads (signal load, event
              detection on the host, the batched device chain)
    detect    ops.event_detect.detect_events (host, per read, threaded)
    device    models.read_builder._process_chunk (MoM, banded kernels,
              WLS, one fetch)
  align       alignment.eventalign.align_reads_to_ref (the wavefront)
    viterbi   alignment.segments.viterbi_segments (per round: padding,
              upload, two kernels, fetch, path expansion)
  emit        everything else in apps.eventalign.main (TSV rendering,
              BAM reading, and with --summary the per-read summary file,
              which chip_smoke.py's main-path run writes)

and prints one JSON line: wall and stage seconds (detect is summed over
its worker threads), device kernel time by
kernel, the device's busy and idle share of the wall.  The Chrome trace
goes to build/port_trace/trace.json.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from nanopolish_tpu_torch.alignment import eventalign as ea_core
    from nanopolish_tpu_torch.alignment import segments
    from nanopolish_tpu_torch.apps import eventalign as ea_app
    from nanopolish_tpu_torch.models import read_builder, read_loader
    from nanopolish_tpu_torch.ops import event_detect

    ap = argparse.ArgumentParser()
    ap.add_argument("--summary", action="store_true",
                    help="also write eventalign --summary")
    args = ap.parse_args()

    totals = {}
    lock = threading.Lock()

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    totals[name] = totals.get(name, 0.0) + \
                        time.perf_counter() - t0
        return run

    ea_app.load_squiggle_reads = timed("ingest", read_loader.load_squiggle_reads)
    ea_app.align_reads_to_ref = timed("align", ea_core.align_reads_to_ref)
    event_detect.detect_events = timed("detect", event_detect.detect_events)
    read_builder._process_chunk = timed("device", read_builder._process_chunk)
    ea_core.viterbi_segments = timed("viterbi", segments.viterbi_segments)

    d = os.path.join(ROOT, "build", "port_trace")
    ref_fa, fastq, bam = chip_smoke.build_main_corpus(d)
    argv = ["-r", fastq, "-b", bam, "-g", ref_fa, "--device", "cuda"]
    out_path = os.path.join(d, "eventalign.tsv")
    if args.summary:
        argv += ["--summary", os.path.join(d, "summary.tsv")]

    def run():
        with open(out_path, "w") as fh:
            ea_app.main(argv, stdout=fh)
        torch.cuda.synchronize()

    run()                                            # warm-up
    totals.clear()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    stages = dict(totals)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
    wall_profiled = time.perf_counter() - t0

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e6
    busy = sum(kernels.values())
    prof.export_chrome_trace(os.path.join(d, "trace.json"))
    rows = sum(1 for _ in open(out_path)) - 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    print(json.dumps({
        "card": smi, "reads": chip_smoke.MAIN_READS,
        "read_len": chip_smoke.MAIN_READ_LEN,
        "summary": args.summary,
        "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
        "stages_s": {k: stages.get(k, 0.0) for k in
                     ("ingest", "detect", "device", "align", "viterbi")},
        "emit_s": wall - stages.get("ingest", 0.0) - stages.get("align", 0.0),
        "wall_profiled_s": wall_profiled,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "kernels_s": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
