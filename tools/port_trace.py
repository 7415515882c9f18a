#!/usr/bin/env python3
"""Where nanopolish_tpu_torch spends its time on the card.

    python3 tools/port_trace.py eventalign [--summary] [--corpus longread]
                                           [--chain on|off]
    python3 tools/port_trace.py call-methylation

Builds the chip_smoke.py main-path corpus (64 synthetic reads of 8 kb
from a 100 kb genome; for call-methylation every other read carries
cpg-methylated signal), or with `--corpus longread` the 100 kb read of
utils/synthetic.build_longread_corpus (eventalign only), runs the
subcommand with `--device cuda` once to warm up (kernel build,
allocator), once more with wall-clock timers
around the pipeline's stages, and a third time under torch.profiler for
the device's kernel time (the profiler's own host overhead inflates that
run's wall, so the idle share is taken against the un-profiled wall).
eventalign runs with the device chain (`--chain on`, the default on the
card) or the host wavefront alone (`--chain off`: NPT_EA_DEVICE_CHAIN=0).

eventalign stages:
  ingest      models.read_loader.load_squiggle_reads (signal load, event
              detection on the host, the batched device chain)
    detect    ops.event_detect.detect_events (host, per read, threaded)
    device    models.read_builder._dispatch_chunk (a chunk's MoM, banded
              kernels and WLS issued)
    fetch     models.read_builder._finish_chunk (the wait for a chunk's
              results and the reads' assembly)
  align       alignment.eventalign.align_reads_to_ref (the device chain,
              then the host wavefront for the jobs it gives back)
    chain     alignment.device_chain.ChainBatch.run (a batch's rounds:
              four launches each)
      check   ChainBatch.n_active (the read of the active count every
              CHECK_EVERY rounds: the host blocked on the card)
    viterbi   alignment.segments.viterbi_segments (per wavefront round:
              padding, upload, two kernels, fetch, path expansion)
      launch  ops.profile_hmm_viterbi.viterbi_paths as the host sees
              it: the two kernels' launches
    sync      the wait for the card after each wavefront round's launches
              and before a chain batch's fetch (a torch.cuda.synchronize
              before the fetch, which would otherwise wait there): the
              host blocked on the card
  rounds      the host wavefront's Viterbi rounds (calls of
              viterbi_segments); chain_rounds, the device chain's
  python      align minus sync and check: the host work of align
  host_us_per_chain_round   (chain - check) / chain_rounds: the host's
              time to issue a chain round
  emit        the rest of apps.eventalign.main (TSV rendering, BAM
              reading, and with --summary the per-read summary file,
              which chip_smoke.py's main-path run writes)

call-methylation stages (ingest and geometry run on the loader threads,
resolve on a fetch thread; each is summed over its threads):
  ingest      models.read_loader.load_squiggle_reads, as above
    detect    ops.event_detect.detect_events
    device    models.read_builder._dispatch_chunk, as above
    fetch     models.read_builder._finish_chunk, as above
  geometry    apps.call_methylation.collect_read_tasks_native (motif
              groups, event bounds, rank rows; native code) or its NumPy
              twin
  score       apps.call_methylation.score_batch_arrays on the main thread
              (host gathers into padded matrices, upload, Forward
              launches)
  resolve     the score fetch and the per-site columns
  write       TSV rows and modbam records

Prints one JSON line: wall and stage seconds, device kernel time by
kernel, the device's busy and idle share of the wall.  The Chrome trace
goes to build/port_trace/<subcommand>/trace.json.  Needs a GPU.
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
    from nanopolish_tpu_torch.alignment import device_chain as dc
    from nanopolish_tpu_torch.alignment import eventalign as ea_core
    from nanopolish_tpu_torch.alignment import segments
    from nanopolish_tpu_torch.apps import call_methylation as cm_app
    from nanopolish_tpu_torch.apps import eventalign as ea_app
    from nanopolish_tpu_torch.models import read_builder, read_loader
    from nanopolish_tpu_torch.ops import event_detect

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
    os.environ["NPT_EA_DEVICE_CHAIN"] = "1" if args.chain == "on" else "0"

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

    event_detect.detect_events = timed("detect", event_detect.detect_events)
    read_builder._dispatch_chunk = timed("device",
                                         read_builder._dispatch_chunk)
    read_builder._finish_chunk = timed("fetch", read_builder._finish_chunk)
    ingest = timed("ingest", read_loader.load_squiggle_reads)
    d = os.path.join(ROOT, "build", "port_trace", args.subcommand
                     + ("" if args.corpus == "main" else "_" + args.corpus)
                     + ("" if args.chain == "on" else "_host"))
    n_reads, read_len = chip_smoke.MAIN_READS, chip_smoke.MAIN_READ_LEN
    out_path = os.path.join(d, "out.tsv")
    rounds = [0]
    if args.subcommand == "eventalign":
        ea_app.load_squiggle_reads = ingest
        ea_app.align_reads_to_ref = timed("align", ea_core.align_reads_to_ref)
        viterbi = timed("viterbi", segments.viterbi_segments)

        def counted(*a, **k):
            rounds[0] += 1
            return viterbi(*a, **k)

        ea_core.viterbi_segments = counted
        paths = timed("launch", segments.viterbi_paths)
        sync = timed("sync", torch.cuda.synchronize)

        def launched_then_synced(x):
            out = paths(x)
            sync()
            return out

        segments.viterbi_paths = launched_then_synced
        dc.ChainBatch.run = timed("chain", dc.ChainBatch.run)
        dc.ChainBatch.n_active = timed("check", dc.ChainBatch.n_active)
        unpack = dc.ChainBatch.unpack

        def synced_then_unpacked(batch):
            sync()
            return unpack(batch)

        dc.ChainBatch.unpack = synced_then_unpacked
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
        names = ("ingest", "detect", "device", "fetch", "align", "chain",
                 "check", "viterbi", "launch", "sync")
        inner = ("ingest", "align")
    else:
        cm_app.load_squiggle_reads = ingest
        for fn in ("collect_read_tasks_native", "collect_read_tasks_arrays"):
            setattr(cm_app, fn, timed("geometry", getattr(cm_app, fn)))
        cm_app.score_batch_arrays = timed("score", cm_app.score_batch_arrays)
        make_resolver = cm_app._make_resolver
        cm_app._make_resolver = lambda *a: timed("resolve", make_resolver(*a))
        for fn in ("write_read_sites_cols", "site_cols_to_map",
                   "create_reference_modbam_record"):
            setattr(cm_app, fn, timed("write", getattr(cm_app, fn)))
        ref_fa, fastq, bam = chip_smoke.build_main_corpus(
            d, chip_smoke.main_methylated())
        app = cm_app
        extra = ["--modbam-output-name", os.path.join(d, "mods.bam")]
        names = ("ingest", "detect", "device", "fetch", "geometry",
                 "score", "resolve", "write")
        inner = ()
    argv = ["-r", fastq, "-b", bam, "-g", ref_fa, "--device", "cuda"] + extra

    def run():
        with open(out_path, "w") as fh:
            app.main(argv, stdout=fh)
        torch.cuda.synchronize()

    run()                                            # warm-up
    totals.clear()
    rounds[0] = 0
    dc.reset_chain_stats()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    stages = dict(totals)
    n_rounds = rounds[0]
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
    rows = sum(1 for _ in open(out_path)) - 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    result = {
        "card": smi, "subcommand": args.subcommand, "corpus": args.corpus,
        "reads": n_reads, "read_len": read_len,
        "summary": args.summary,
        "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
        "stages_s": {k: stages.get(k, 0.0) for k in names},
        "wall_profiled_s": wall_profiled,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "kernels_s": top}
    if inner:
        waits = stages.get("sync", 0.0) + stages.get("check", 0.0)
        align = stages.get("align", 0.0)
        result.update(
            chain=args.chain, chain_stats=chain,
            emit_s=wall - sum(stages.get(k, 0.0) for k in inner),
            rounds=n_rounds, chain_rounds=chain["rounds"],
            python_s=align - waits,
            sync_share_of_align=waits / max(align, 1e-12),
            host_us_per_chain_round=(
                (stages.get("chain", 0.0) - stages.get("check", 0.0))
                / chain["rounds"] * 1e6 if chain["rounds"] else None))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
