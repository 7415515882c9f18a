#!/usr/bin/env python3
"""Where nanopolish_tpu_torch spends its time on the card.

    python3 tools/port_trace.py eventalign [--summary] [--corpus longread]
                                           [--chain on|off]
    python3 tools/port_trace.py call-methylation

Builds the chip_smoke.py main-path corpus (64 synthetic reads of 8 kb
from a 100 kb genome; for call-methylation every other read carries
cpg-methylated signal), or with `--corpus longread` the 100 kb read of
utils/synthetic.build_longread_corpus (eventalign only), runs the
subcommand with `--device cuda` under NPT_PROFILE=1 once to warm up
(kernel build, allocator), once more for the program's own spans
(utils/profiler) and fetch waits (utils/syncstats), and a third time
under torch.profiler for the device's kernel time (the profiler's own
host overhead inflates that run's wall, so the idle share is taken
against the un-profiled wall).  eventalign runs with the device chain
(`--chain on`, the default on the card) or the host wavefront alone
(`--chain off`: NPT_EA_DEVICE_CHAIN=0).

Stages, from the timed run's spans (seconds; a stage on several threads
is summed over them):
  ingest      read_loader.load_raw + read_builder.detect +
              read_builder.assemble + read_builder.process_chunk
    load_raw  signal reading and decompression
    detect    host event detection
    assemble  kmer ranks, event tables, chunking
    device    a chunk's MoM, banded kernels and WLS, issued and fetched
eventalign:
  chain       ea.stage_jobs + ea.chain_build + ea.chain_unpack (the
              device chain's host work around its rounds)
  emit        ea.emit (TSV rendering, and with --summary the summary)
  rest        ea.pass less ingest and emit: everything else of the
              pass on the main thread, unsplit (the readdb, FASTA and BAM
              opening and record reading, the alignment, the chain's
              rounds or, with --chain off, the host wavefront, whose
              rounds no span or counter reports)
  chain_stats device_chain.CHAIN_STATS: the chain's calls, rounds,
              active-count reads and refilled slots, and the jobs it gave
              back
call-methylation (ingest and geometry on the loader threads, resolve on
the fetch threads):
  geometry    meth.collect
  score       meth.drain_prep (host gathers, upload, Forward launches)
  resolve     meth.resolve (the score fetch and the per-site columns)
  write       meth.write (TSV rows and modbam records)
  wait        meth.wait_chunk (the main thread waiting on the loaders)

Prints one JSON line: wall, stage and span seconds, the fetch waits,
device kernel time by kernel, the device's busy and idle share of the
wall.  Into build/port_trace/<subcommand>/ go the spans (spans.json,
NPT_PROFILE_TRACE, of all three runs), the profiled run's device trace
(trace.json) and the two merged on one clock (merged.json, for
Perfetto; tools/merge_traces.py).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INGEST = ("read_loader.load_raw", "read_builder.detect",
          "read_builder.assemble", "read_builder.process_chunk")
STAGES = {
    "ingest": INGEST,
    "load_raw": ("read_loader.load_raw",),
    "detect": ("read_builder.detect",),
    "assemble": ("read_builder.assemble",),
    "device": ("read_builder.process_chunk",),
}
EA_STAGES = {
    "chain": ("ea.stage_jobs", "ea.chain_build", "ea.chain_unpack"),
    "emit": ("ea.emit",),
}
CM_STAGES = {
    "geometry": ("meth.collect",),
    "score": ("meth.drain_prep",),
    "resolve": ("meth.resolve",),
    "write": ("meth.write",),
    "wait": ("meth.wait_chunk",),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("subcommand", choices=("eventalign", "call-methylation"))
    ap.add_argument("--summary", action="store_true",
                    help="also write eventalign --summary")
    ap.add_argument("--corpus", choices=("main", "longread"), default="main",
                    help="eventalign's corpus: chip_smoke's 64 x 8 kb, or "
                         "the long-read mix's 100 kb read")
    ap.add_argument("--chain", choices=("on", "off"), default="on",
                    help="eventalign through the device chain (the default "
                         "on the card) or the host wavefront alone")
    args = ap.parse_args()
    d = os.path.join(ROOT, "build", "port_trace", args.subcommand
                     + ("" if args.corpus == "main" else "_" + args.corpus)
                     + ("" if args.chain == "on" else "_host"))
    os.makedirs(d, exist_ok=True)
    os.environ["NPT_EA_DEVICE_CHAIN"] = "1" if args.chain == "on" else "0"
    os.environ["NPT_PROFILE"] = "1"
    os.environ.setdefault("NPT_PROFILE_TRACE", os.path.join(d, "spans.json"))

    sys.path.insert(0, ROOT)
    import chip_smoke
    from merge_traces import merge
    from nanopolish_tpu_torch.alignment import device_chain as dc
    from nanopolish_tpu_torch.apps import call_methylation as cm_app
    from nanopolish_tpu_torch.apps import eventalign as ea_app
    from nanopolish_tpu_torch.utils import profiler
    from nanopolish_tpu_torch.utils.syncstats import SYNC_STATS

    n_reads, read_len = chip_smoke.MAIN_READS, chip_smoke.MAIN_READ_LEN
    out_path = os.path.join(d, "out.tsv")
    if args.subcommand == "eventalign":
        if args.corpus == "longread":
            from nanopolish_tpu_torch.utils.synthetic import \
                build_longread_corpus
            c = build_longread_corpus(d, subset=("lr0",))
            ref_fa, fastq, bam = c["ref_fa"], c["fastq"], c["subset_bam"]
            n_reads, read_len = 1, 100_000
        else:
            ref_fa, fastq, bam = chip_smoke.build_main_corpus(d)
        app, extra = ea_app, []
        if args.summary:
            extra = ["--summary", os.path.join(d, "summary.tsv")]
        stages = dict(STAGES, **EA_STAGES)
    else:
        ref_fa, fastq, bam = chip_smoke.build_main_corpus(
            d, chip_smoke.main_methylated())
        app = cm_app
        extra = ["--modbam-output-name", os.path.join(d, "mods.bam")]
        stages = dict(STAGES, **CM_STAGES)
    argv = ["-r", fastq, "-b", bam, "-g", ref_fa, "--device", "cuda"] + extra

    def run():
        with open(out_path, "w") as fh:
            app.main(argv, stdout=fh)
        torch.cuda.synchronize()

    run()                                            # warm-up
    dc.reset_chain_stats()
    before = profiler.snapshot()
    with SYNC_STATS.capture() as sync:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    spans = {k: v[1] - before.get(k, (0, 0.0))[1]
             for k, v in profiler.snapshot().items()}
    chain = dict(dc.CHAIN_STATS)
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
    spans_path = profiler.export_trace()
    if spans_path:
        merge(spans_path, os.path.join(d, "trace.json"),
              os.path.join(d, "merged.json"))
    rows = sum(1 for _ in open(out_path)) - 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    stage_s = {k: sum(spans.get(n, 0.0) for n in names)
               for k, names in stages.items()}
    result = {
        "card": smi, "subcommand": args.subcommand, "corpus": args.corpus,
        "reads": n_reads, "read_len": read_len,
        "summary": args.summary,
        "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
        "stages_s": stage_s,
        "spans_s": dict(sorted(spans.items(), key=lambda kv: -kv[1])),
        "sync": sync.as_dict(),
        "wall_profiled_s": wall_profiled,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "kernels_s": top}
    if args.subcommand == "eventalign":
        result.update(
            chain=args.chain, chain_stats=chain,
            rest_s=spans.get("ea.pass", 0.0) - stage_s["ingest"]
            - stage_s["emit"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
