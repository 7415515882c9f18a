#!/usr/bin/env python3
"""Drive nanopolish_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build the eight CUDA kernels from
     nanopolish_tpu_torch/csrc/ (one nvcc per source, all at once);
  2. banded-alignment kernels (fill, backtrack) against their plain
     PyTorch versions on the card, bit for bit, on 32 reads x 2 kb plus
     tiny, garbage, noisy and mixed-length batches and two whose bands
     run along an edge (far more kmers than events, and far more events
     than kmers); then timing at 256 reads x 8 kb (2 events/base,
     r9.4_450bps 6-mer), beside estimates of the fill's and the
     backtrack's chain-latency floors (logged only);
  3. profile-HMM Viterbi kernels (fill, backtrack) against their plain
     versions on 512 eventalign-shaped segments with all four soft-clip
     flag combinations (identical traces and tracebacks), and on one
     batch at each row layout of the fill (kmer width 32, 64, 128, 256:
     the warp kernel at 1, 2, 4, 8 kmers per lane; 512: the block
     kernel; 2,048 and 32,768: the wide row, its rows in shared memory
     and in global scratch), each with n_kmers short of the width, all
     four clip flags and a one-event segment; the backtrack also at
     1,024 kmers (the block row) and in a one-segment and a 32-segment
     launch; then timing, the backtrack beside an estimate of its
     chain-latency floor (logged only);
  4. the Forward kernels' log1pf against torch.log1p on every float in
     [0, 1]; the profile-HMM Forward kernel against its plain version, bit
     for bit, on 2,048 call-methylation-shaped segments (17-221 kmers, 30-460
     events, all four clip flags), 64 scorereads-shaped ones (501 x 250)
     and the batches of phase 3's widths; then timing, the 2,048 at one
     width and bucketed as segments.forward_arrays_async buckets them;
  4b. the indexed Forward kernel (variants' drain) against its plain
     version and against the flat Forward kernel on the same gathered
     inputs, bit for bit, launched as a flush launches it
     (profile_hmm_indexed.plan_flush): a screening-shaped batch (8,192
     segments of 5-32 kmers and 10-80 events, ~10 sequences per event
     slice, all in one launch at 8 lanes a window), every width 1-32,
     calling-shaped batches (512 segments of 100-256 and of 33-64
     kmers), 64 of 257-1,024 kmers (block row) and 8 of 1,025-3,000
     (wide row); then one flush of widths 1-3,000 through
     forward_indexed_scores;
  4c. the segmentation kernels (Viterbi fill, backtrack with the summary
     fused) against their plain versions, bit for bit (backpointer
     bytes, final scores, labels, summary), with the polya and the
     detect-polyi parameters: the three batches of
     tests/test_pallas_segmentation.py, a batch at the backtrack's edges
     (reads of 1-3 and 12 samples, walks of one 4,096-sample tile less
     one, one and one more) and a mixed-length batch of 512 reads x
     2,000-65,536 samples; then timing on that batch, beside estimates of
     both kernels' chain-latency floors (logged only); then the backtrack
     alone on random backpointer bytes, rows at every alignment;
  5. the goldens on the card through the CLI entry points: the 4-read
     eventalign pipeline of tests/test_golden_outputs.py (byte for byte),
     the 3-read methylation pipeline (TSV and both modbam styles) and the
     12-read consensus pipeline (`variants --consensus`, plain and with
     --fix-homopolymers), the last two under the printed-output rule of
     tests/printed_output.py, and the 3-read direct-RNA polya pipeline
     (byte for byte);
  6. the main paths on the card, each with the launch counts reset just
     before it and read just after, and each kernel's device time on its
     path from torch.profiler: `index` + `eventalign` on 64 reads x
     8 kb from a 100 kb synthetic genome, then `call-methylation` (with a
     modbam) on 64 reads x 8 kb of which half carry cpg-methylated
     signal; then `scorereads` on 8 of the eventalign reads and on one
     read with a dense run of deletions (a 500-event chunk of 1,384
     kmers: the wide row), and `phase-reads` on a 2-read phased corpus,
     each held to the port's CPU run under the printed-output rule; then
     `variants --consensus`
     on a 50 kb draft window (250 reads x 2 kb of true signal, depth ~10,
     332 planted substitutions: the corpus of tools/perf_e2e_variants.py
     at NPT_E2E_WINDOW=50000, NPT_E2E_READS=250, NPT_E2E_READLEN=2000,
     seed 41) with wall-clock stage timers and the card's busy time from
     torch.profiler, and `vcf2fasta` on its VCF; then `polya` and
     `detect-polyi` on 512 direct-RNA reads (tools/perf_e2e_polya.py's
     corpus: seed 43, a planted 120-nt tail, ~19.5k samples per read),
     with the card's busy time; then the training paths: `methyltrain` at
     full width (the r9.4_450bps cpg 6-mer model, all 15,625 kmers,
     MAX_EVENTS 1,000) on 64 reads x 8 kb of cpg-methylated signal from a
     100 kb genome, its start model's M-kmer means raised by 4 pA, `-c
     --output-scores`, 5 rounds, held to the recovery rule of
     tests/test_methyltrain_e2e.py; the mixture EM alone at full shape
     (15,625 kmers x 1,000 events x 2 components) on the card and on the
     cpu, its time beside its bound; `methyltrain` on 8 of those reads, 2
     rounds, on the card and on the cpu (the cpu run in a second process
     from the start of this phase; integer summary columns identical,
     trained values within the EM tolerance, score lines under the
     printed-output rule); `train-poremodel-from-basecalls` on the card on
     the eventalign corpus's 64 reads and on 64 reads of one 400-base
     stretch (its levels against the model that made the signal), and on
     8 of the short reads on the card and on the cpu (byte-identical
     models); one JSON line of the training paths' launches and device ms
     per kernel;
  6b. several processes on the one card (the usable cores printed):
     `parallel.launch` of call-methylation over 1, 2 and 4 processes and
     of `eventalign --summary` over 2, each child on its own `--shard
     i/n` and on the card, the shards' rows held to phase 6's
     single-process outputs (their union equal, no row in two shards),
     sites/s and rows/s by process count; then the sharded methyltrain
     round (`parallel.make_train_step`) at full table width (the
     r9.4_450bps nucleotide 6-mers, on the eventalign corpus's events and
     basecall kmers) on a 1 x 1 mesh (one process, a one-rank NCCL group)
     and a 2 x 2 mesh (four processes over gloo on the one card): n_scored
     equal, trained values within the EM tolerance, losses within 2e-3
     nats or 1e-5 relative, the banded and Forward kernels launched in
     every rank; one `parallel_paths` JSON line;
  7. one JSON line describing each kernel (with `path_ms`, its summed
     device time in one run of its own main path), then the result line.

Everything it writes goes under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# the main path's corpus: reads x bases from a synthetic genome
MAIN_READS, MAIN_READ_LEN, MAIN_GENOME_LEN = 64, 8000, 100_000
# Forward kernel check: call-methylation-shaped and scorereads-shaped
FWD_SEGMENTS, FWD_LONG = 2048, 64
# one batch at each row layout of the profile-HMM fills (row_layout);
# the wide row at 2,048 kmers (a scorereads chunk across deletions: 500
# events) and at 32,768 (its rows in global scratch: 40 events)
HMM_WIDTHS, WIDTH_SEGMENTS = (32, 64, 128, 256, 512), 64
WIDE_WIDTHS = {2048: (8, 400, 500), 32768: (4, 30, 40)}
# f32 operations of the scan's Forward per (event, kmer) cell, with an
# expf/log1pf pair counted as two and an fma as two: the emission (5),
# the five M-term adds, nine logaddexps of six operations each (five for
# M, one each for B, the K chain's input and its two tree combines),
# the M add, four B/K-input adds and two tree adds; plus per event row
# the end terms (three logaddexps, an add and the flank)
FWD_OPS_CELL = 5 + 5 + 9 * 6 + 1 + 4 + 2
FWD_OPS_ROW = 3 * 6 + 4
LLR = 5          # log_lik_ratio column of the call-methylation TSV
# indexed Forward check: screening-shaped and calling-shaped batches
IDX_SCREEN, IDX_CALL = 8192, 512
# segmentation check: a mixed-length batch of direct-RNA-sized reads
SEG_READS, SEG_MAX = 512, 65536
SEG_EDGES = (1, 2, 3, 12, 4097, 4098, 4099, 4100, 40)
# the polya / detect-polyi main path: tools/perf_e2e_polya.py's corpus
POLYA_READS, POLYA_NT, POLYA_TRANSCRIPT = 512, 120, 500
# the variants main path: a draft window polished by tiled reads
VAR_WINDOW, VAR_READS, VAR_READ_LEN = 50_000, 250, 2000
SUB = {"A": "G", "C": "T", "G": "A", "T": "C"}
# the training phase: methyltrain on the r9.4_450bps cpg 6-mer model (all
# 15,625 states, MAX_EVENTS 1,000) over MAIN_READS reads of cpg-methylated
# signal, its M-kmer means raised by TRAIN_PERTURB pA at the start
NUC_KEY = ("r9.4_450bps", "nucleotide", "template", 6)
CPG_KEY = ("r9.4_450bps", "cpg", "template", 6)
TRAIN_SEED, TRAIN_PERTURB, TRAIN_ROUNDS = 51, 4.0, 5
TRAIN_MIN_EVENTS, TRAIN_MIN_M_KMERS = 30, 100
TRAIN_KERNELS = ("banded_fill", "banded_backtrack", "viterbi_fill",
                 "viterbi_backtrack", "forward_fill")
# card against cpu: TRAIN_SUBSET reads, TRAIN_SUBSET_ROUNDS rounds
TRAIN_SUBSET, TRAIN_SUBSET_ROUNDS, TRAIN_SUBSET_MIN_EVENTS = 8, 2, 10
# torch threads of the subset's cpu run (a second process at nice 10)
CPU_SUBSET_THREADS = 4
# the EM tolerance (tests/test_torch_methyltrain.py: MEAN_ATOL and
# APP_STDV_RTOL)
EM_MEAN_ATOL, EM_STDV_RTOL = 1e-4, 1e-3
# train-poremodel-from-basecalls: rounds; on TP_SHORT_LEN-base reads of one
# stretch, the least kmers updated and the largest median |level - builtin|
# over them: the JAX app's 173 kmers and 10.512 pA on 8 such reads
# (tools/train_poremodel_levels.py --reads 8 --read-len 400 --genome-len
# 400), the median given 25% for the other reads' kmers
TP_ROUNDS, TP_SHORT_LEN, TP_SHORT_MIN_UPDATED = 3, 400, 100
TP_LEVEL_MAX = 13.1
# the EM alone at full shape: every cpg 6-mer, MAX_EVENTS events
EM_R, EM_N = 15_625, 1000
# the multi-process phase: parallel.launch of call-methylation over each
# of PAR_CM_PROCS processes and of eventalign over PAR_EA_PROCS, on one
# card; the train step (r9.4_450bps nucleotide 6-mers, the eventalign
# corpus) on meshes of (data, model) processes: one process over a
# one-rank NCCL group, four over gloo; its kernels, launched in every
# rank; the loss tolerance (tests/test_torch_parallel.py); the 1 x 1
# step's Forward inputs (the wide row at its kmer width) of its
# PAR_FWD_READS longest reads, held to the plain version
PAR_CM_PROCS, PAR_EA_PROCS = (1, 2, 4), 2
PAR_MESHES = ((1, 1), (2, 2))
PAR_KERNELS = ("banded_fill", "banded_backtrack", "forward_fill")
PAR_LOSS_ATOL, PAR_LOSS_RTOL = 2e-3, 1e-5
PAR_CHILD_TIMEOUT = 300
PAR_FWD_READS = 4
FWD_ARGS = ("levels", "n_events", "mu", "sigma", "c", "n_kmers", "trans",
            "clips")

# published peaks of one H100 SXM (dense, no sparsity)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# dependent cycles of one step of a chain, for the logged floor estimates:
# a band of the banded fill (the edge broadcasts, the placement compare and
# select, two adds and two maxima per cell, the neighbour shuffles), and a
# step of the Viterbi walk (a shared-memory load and the decode)
BANDED_CHAIN_CYCLES = 60
VIT_BT_STEP_CYCLES = 50
# a visited cell of the banded walk (two broadcast shared-memory loads, the
# 2-bit decode, the select of the next offset), and a step of the
# segmentation backtrack's threads (one application of a map: a shift and
# a mask)
BANDED_BT_STEP_CYCLES = 30
SEG_BT_STEP_CYCLES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bits_equal(a, b) -> bool:
    """Exact equality, comparing floats by their bit patterns."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a = a.contiguous().view(torch.int32)
        b = b.contiguous().view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch
    a = a.double()
    b = b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(torch.equal(torch.isfinite(a), torch.isfinite(b))):
        return float("inf")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds of fn() over reps runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int = 3) -> float:
    """Device milliseconds of one port kernel (cuda_build.KERNELS) per
    fn() call, from torch.profiler over reps calls after a warm-up: the
    kernel alone, without the host work and copies fn() also does.  A
    profile has come back with fewer of the kernel's launches than were
    made, and with none three times running (seg_backtrack, 30 us a
    launch): the time is the mean of the launches it recorded times the
    launches made (cuda_build.LAUNCHES), and with none recorded another
    profile is taken over twice the calls, failing after six."""
    import torch
    from nanopolish_tpu_torch.utils import cuda_build
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(6):
        calls = reps << attempt
        made = cuda_build.LAUNCHES[kernel]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        made = cuda_build.LAUNCHES[kernel] - made
        us, seen = kernel_device_us(prof.key_averages())[kernel]
        if seen:
            return us / seen * made / calls / 1e3
        log(f"torch.profiler recorded none of {made} {kernel} launches; "
            f"profiling again over {2 * calls} calls")
    fail(f"torch.profiler recorded no device time for {kernel}")


def once_ms(fn):
    """Device milliseconds of one fn() call, and its result."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def kernel_constant(name: str, const: str) -> int:
    """An integer constexpr of csrc/<name>.cu."""
    import re
    with open(os.path.join(ROOT, "nanopolish_tpu_torch", "csrc",
                           f"{name}.cu")) as fh:
        return int(re.search(rf"constexpr int {const} = (\d+);",
                             fh.read()).group(1))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2 --

def banded_case(model, B, K, T, epk=2.0, seed=0, noise=1.0, n_events=None,
                n_kmers=None, garbage=False):
    """Synthetic banded-alignment batch: random 6-mers, events drawn from
    their scaled model gaussians (or uniform noise for garbage reads)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, model.num_states, size=(B, K))
    mu = model.level_mean[ranks].astype(np.float32)
    sigma = model.level_stdv[ranks].astype(np.float32)
    if garbage:
        ev = rng.uniform(0, 200, size=(B, T)).astype(np.float32)
    else:
        reps = np.minimum((np.arange(T) / epk).astype(int), K - 1)
        ev = (mu[:, reps] + rng.normal(0, noise, size=(B, T)).astype(np.float32)
              * sigma[:, reps]).astype(np.float32)
    nev = np.full(B, T, np.int32) if n_events is None else np.asarray(n_events, np.int32)
    nk = np.full(B, K, np.int32) if n_kmers is None else np.asarray(n_kmers, np.int32)
    return ev, nev, mu, sigma, nk


def banded_compare(x):
    """Kernel vs plain on the card for one prepared batch; returns the
    two fill/backtrack output tuples after asserting bit equality."""
    from nanopolish_tpu_torch.ops import banded_align as ba
    from nanopolish_tpu_torch.ops import banded_exact as bx
    args = (x["event_mean"], x["n_events"], x["mu"], x["sigma"], x["c"],
            x["n_kmers"], x["lp_stay"], x["lp_step"])
    fk = bx.banded_fill(*args)
    fp = ba.banded_fill_plain(*args)
    for name, a, b in zip(("trace", "moves", "ll_e_last", "best_e", "best_s"),
                          fk, fp):
        if not bits_equal(a, b):
            fail(f"banded_fill {name} differs from the plain version")
    tail = (x["event_mean"], x["mu"], x["sigma"], x["c"], x["n_kmers"])
    bk = bx.banded_backtrack(fk[0], fk[1], fk[2], fk[3], *tail)
    bp = ba.banded_backtrack_plain(fp[0], fp[1], fp[2], fp[3], *tail)
    for name, a, b in zip(("b2e_start", "b2e_stop", "sum_em", "stats"), bk, bp):
        if not bits_equal(a, b):
            fail(f"banded_backtrack {name} differs from the plain version")
    return fk, fp, bk, bp


def banded_work(nev, nk):
    """Bytes and f32 operations the banded fill/backtrack need for these
    reads: every band a read reaches (nev + nk + 2), 100 cells each."""
    nev = np.asarray(nev, np.float64)
    nk = np.asarray(nk, np.float64)
    bands = nev + nk + 2
    fill_bytes = float(np.sum(bands * 33 + nev * 4 + nk * 12 + 20))
    fill_flops = float(np.sum((nev + nk) * 100 * 12))
    bt_bytes = float(np.sum(bands * 33 + nev * 4 + nk * 12 + nk * 8 + 24))
    bt_flops = float(np.sum((nev + nk) * 10))
    return fill_bytes, fill_flops, bt_bytes, bt_flops


def phase_banded(model, dev, report):
    import torch
    from nanopolish_tpu_torch.ops import banded_align as ba
    from nanopolish_tpu_torch.ops import banded_exact as bx

    cases = {
        "32x2kb": banded_case(model, 32, 2000, 4000, seed=1),
        "tiny_40x90": banded_case(model, 4, 40, 90, epk=90 / 40, seed=5),
        "tiny_126x130": banded_case(model, 4, 126, 130, epk=130 / 126, seed=5),
        "garbage": banded_case(model, 2, 300, 640, seed=9, garbage=True),
        "noisy": banded_case(model, 4, 257, 530, seed=11, noise=3.0),
        "mixed": banded_case(model, 4, 280, 590, seed=31,
                             n_events=[590, 95, 590, 160],
                             n_kmers=[280, 45, 280, 80]),
        "edge_kmers": banded_case(model, 4, 300, 120, epk=0.4, seed=7,
                                  n_events=[120, 90, 120, 60],
                                  n_kmers=[300, 300, 250, 300]),
        "edge_events": banded_case(model, 4, 40, 400, epk=10.0, seed=8,
                                   n_events=[400, 400, 300, 400],
                                   n_kmers=[40, 30, 40, 25]),
    }
    for name, (ev, nev, mu, sigma, nk) in cases.items():
        x = ba.prepare_banded_inputs(ev, nev, mu, sigma, np.log(sigma), nk,
                                     device=dev)
        banded_compare(x)
        res = bx.align_prepared(x)
        log(f"banded {name}: kernels == plain (bit-identical); "
            f"failed={int(res.failed.sum())}/{len(nev)}")
        if name == "garbage" and not bool(res.failed.all()):
            fail("garbage reads passed banded QC")
    # the plain version on the card equals the plain version on the CPU
    ev, nev, mu, sigma, nk = cases["mixed"]
    gpu = ba.banded_align_batch(ev, nev, mu, sigma, np.log(sigma), nk,
                                device=dev)
    cpu = ba.banded_align_batch(ev, nev, mu, sigma, np.log(sigma), nk,
                                device="cpu")
    for f in gpu._fields:
        if not bits_equal(getattr(gpu, f).cpu(), getattr(cpu, f)):
            fail(f"plain banded {f} differs between cuda and cpu")
    log("banded plain version: cuda == cpu (bit-identical)")

    # bench shape: 256 reads x 8 kb, 2 events/base
    B, K, T = 256, 8000, 16000
    ev, nev, mu, sigma, nk = banded_case(model, B, K, T, seed=3)
    x = ba.prepare_banded_inputs(ev, nev, mu, sigma, np.log(sigma), nk,
                                 device=dev)
    args = (x["event_mean"], x["n_events"], x["mu"], x["sigma"], x["c"],
            x["n_kmers"], x["lp_stay"], x["lp_step"])
    tail = (x["event_mean"], x["mu"], x["sigma"], x["c"], x["n_kmers"])
    fill = bx.banded_fill(*args)
    fill_ms = cuda_ms(lambda: bx.banded_fill(*args))
    bt_ms = kernel_ms(lambda: bx.banded_backtrack(fill[0], fill[1], fill[2],
                                                  fill[3], *tail),
                      "banded_backtrack")
    fill_plain_ms, fp = once_ms(lambda: ba.banded_fill_plain(*args))
    bt_plain_ms, bp = once_ms(lambda: ba.banded_backtrack_plain(
        fp[0], fp[1], fp[2], fp[3], *tail))
    for name, a, b in zip(("trace", "moves", "ll_e_last", "best_e", "best_s"),
                          fill, fp):
        if not bits_equal(a, b):
            fail(f"banded_fill {name} differs from plain at the bench shape")
    bk = bx.banded_backtrack(fill[0], fill[1], fill[2], fill[3], *tail)
    for name, a, b in zip(("b2e_start", "b2e_stop", "sum_em", "stats"), bk, bp):
        if not bits_equal(a, b):
            fail(f"banded_backtrack {name} differs from plain at the bench shape")
    res = ba.finish_banded(*bk, x["n_kmers"])
    torch.cuda.synchronize()
    fb, ff, bb, bf = banded_work(nev, nk)
    reads_s = B / ((fill_ms + bt_ms) / 1e3)
    clk = sm_clock_mhz()
    n_bands = ba.n_bands_for(T, K)
    floor = n_bands * BANDED_CHAIN_CYCLES / (clk * 1e3)
    visits = int(bk[3][:, 0].max())
    bt_floor = visits * BANDED_BT_STEP_CYCLES / (clk * 1e3)
    log(f"banded bench {B} reads x {K} kmers x {T} events: fill {fill_ms:.3f} ms "
        f"(plain {fill_plain_ms:.1f} ms; chain latency floor {floor:.3f} ms, "
        f"an estimate: {BANDED_CHAIN_CYCLES} cycles x {n_bands} bands at "
        f"{clk:.0f} MHz), backtrack {bt_ms:.3f} ms "
        f"(plain {bt_plain_ms:.1f} ms; chain latency floor {bt_floor:.3f} ms, "
        f"an estimate: {BANDED_BT_STEP_CYCLES} cycles x the longest walk's "
        f"{visits} visited cells at {clk:.0f} MHz); {reads_s:.1f} reads/s; "
        f"failed={int(res.failed.sum())}/{B}")
    for name, ms, pms, nbytes, flops, err in (
            ("banded_fill", fill_ms, fill_plain_ms, fb, ff,
             max_abs_err(fill[4], fp[4])),
            ("banded_backtrack", bt_ms, bt_plain_ms, bb, bf,
             max_abs_err(bk[2], bp[2]))):
        bms, by = bound(nbytes, flops)
        report[name].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                            max_abs_err=err)
    return reads_s


# ---------------------------------------------------------------- phase 3 --

def viterbi_batch(model, S, seed=0):
    """S eventalign-shaped segments: ~105 kmers, ~200-260 events, all four
    clip-flag combinations."""
    rng = np.random.default_rng(seed)
    nk = rng.integers(95, 116, S).astype(np.int32)
    nev = rng.integers(200, 261, S).astype(np.int32)
    return hmm_batch(model, nk, nev, rng)


def hmm_batch(model, nk, nev, rng):
    """Segments of nk kmers and nev events: random 6-mers, event levels
    drawn from their gaussians along a uniform path; epb in 1.6-2.4 and
    clip flags cycling through 0-3."""
    S = len(nk)
    K, T = int(nk.max()), int(nev.max())
    mu = np.zeros((S, K), np.float32)
    sd = np.ones((S, K), np.float32)
    lv = np.zeros((S, T), np.float32)
    for s in range(S):
        ranks = rng.integers(0, model.num_states, nk[s])
        mu[s, :nk[s]] = model.level_mean[ranks]
        sd[s, :nk[s]] = model.level_stdv[ranks]
        reps = np.minimum((np.arange(nev[s]) * nk[s] / nev[s]).astype(int),
                          nk[s] - 1)
        lv[s, :nev[s]] = mu[s, reps] + rng.normal(0, 1, nev[s]) * sd[s, reps]
    epb = rng.uniform(1.6, 2.4, S).astype(np.float32)
    flags = (np.arange(S) % 4).astype(np.int32)
    return lv, nev, mu, sd, nk, epb, flags


def path_max_abs_err(a, b) -> float:
    """Largest difference in event offset, kmer index or state between
    two tracebacks [B, 1 + L] over each path's length (inf where two
    paths differ in length)."""
    import torch
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    if not bool(torch.equal(a[:, 0], b[:, 0])):
        return float("inf")
    a, b = a.long(), b.long()
    step = torch.arange(a.shape[1] - 1, device=a.device)[None, :]
    live = step < a[:, :1]
    err = 0.0
    for shift, mask in ((ph.PATH_EVENT_SHIFT, -1),
                        (ph.PATH_KMER_SHIFT, ph.MAX_KMERS - 1), (0, 3)):
        fa = (a[:, 1:] >> shift) & mask
        fb = (b[:, 1:] >> shift) & mask
        d = (fa - fb).abs()[live]
        if d.numel():
            err = max(err, float(d.max()))
    return err


def width_batch(model, kp, S, seed):
    """S segments at kmer width kp: n_kmers in kp/2+1 .. kp-1 (never the
    width itself), 1.6-2.4 events per kmer, segment 1 with one event, all
    four clip-flag combinations."""
    rng = np.random.default_rng(seed)
    nk = rng.integers(kp // 2 + 1, kp, S).astype(np.int32)
    nev = (nk * rng.uniform(1.6, 2.4, S)).astype(np.int32)
    nev[1] = 1
    return hmm_batch(model, nk, nev, rng)


def wide_batch(model, kp, seed):
    """WIDE_WIDTHS[kp] = (S, t_lo, t_hi): S segments of kp/2+1 .. kp-1
    kmers (segment 0 of kp - 1, segment 1 with one event) and t_lo..t_hi
    events, all four clip-flag combinations."""
    S, t_lo, t_hi = WIDE_WIDTHS[kp]
    rng = np.random.default_rng(seed)
    nk = rng.integers(kp // 2 + 1, kp, S).astype(np.int32)
    nk[0] = kp - 1
    nev = rng.integers(t_lo, t_hi + 1, S).astype(np.int32)
    nev[1] = 1
    return hmm_batch(model, nk, nev, rng)


def layout_name(kp):
    from nanopolish_tpu_torch.ops.profile_hmm_viterbi import row_layout
    mode, kpl = row_layout(kp)
    unit = "thread" if mode == "wide" else "lane"
    return f"{mode}, {kpl} kmers/{unit}" if kpl else mode


def viterbi_check(x, name):
    """Kernel vs plain fill and backtrack on one prepared batch; fail on
    any trace cell of a live event row (every kmer column) or traceback
    that differs.  Returns the fill's arguments, both traces, the live
    mask, both tracebacks and the plain versions' ms."""
    import torch
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    fargs = (x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
             x["n_kmers"], x["trans"], x["clips"])
    tk = pv.viterbi_fill(*fargs)
    fill_plain_ms, tp = once_ms(lambda: ph.viterbi_fill_plain(*fargs))
    rows = torch.arange(tk.shape[1], device=tk.device)[None, :, None]
    live = (rows < x["n_events"][:, None, None].long()).expand(tk.shape)
    n_diff_cells = int(((tk != tp) & live).sum())
    if n_diff_cells:
        fail(f"viterbi_fill: {n_diff_cells} trace cells differ from plain on "
             f"the {name} batch")
    pk = pv.viterbi_backtrack(tk, x["n_events"], x["n_kmers"])
    bt_plain_ms, pp = once_ms(lambda: ph.viterbi_backtrack_plain(
        tk, x["n_events"], x["n_kmers"]))
    seg_k = ph.paths_to_segments(pk.cpu().numpy())
    seg_p = ph.paths_to_segments(pp.cpu().numpy())
    n_diff = sum(1 for a, b in zip(seg_k, seg_p)
                 if not (np.array_equal(a[0], b[0]) and
                         np.array_equal(a[1], b[1]) and a[2] == b[2]))
    if n_diff:
        fail(f"viterbi_backtrack: {n_diff} of {len(seg_k)} tracebacks differ "
             f"from plain on the {name} batch")
    return fargs, tk, tp, live, pk, pp, fill_plain_ms, bt_plain_ms


def phase_viterbi(model, dev, report):
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv

    S = 512
    lv, nev, mu, sd, nk, epb, flags = viterbi_batch(model, S, seed=7)
    x = pv.prepare_viterbi_inputs(lv, nev, mu, sd, nk, epb, flags, device=dev)
    fargs, tk, tp, live, pk, pp, fill_plain_ms, bt_plain_ms = viterbi_check(
        x, "eventalign-shaped")
    # the plain version on the card equals the plain version on the CPU
    sub = slice(0, 16)
    xc = pv.prepare_viterbi_inputs(lv[sub], nev[sub], mu[sub], sd[sub],
                                   nk[sub], epb[sub], flags[sub], device="cpu")
    cpu = ph.paths_to_segments(pv.viterbi_paths(xc).numpy())
    seg_k = ph.paths_to_segments(pk[:16].cpu().numpy())
    for a, b in zip(cpu, seg_k):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                and a[2] == b[2]):
            fail("viterbi tracebacks differ between the cpu plain path and "
                 "the kernels")
    fill_ms = cuda_ms(lambda: pv.viterbi_fill(*fargs))
    bt_ms = kernel_ms(lambda: pv.viterbi_backtrack(tk, x["n_events"],
                                                   x["n_kmers"]),
                      "viterbi_backtrack", reps=10)
    lens = pk[:, 0].double().cpu().numpy()
    cells = float(np.sum(nev.astype(np.float64) * nk))
    fill_bytes = cells + float(np.sum(nev) * 4 + np.sum(nk) * 12 + S * 42)
    bt_bytes = float(np.sum(lens) * 5 + S * 12)
    clk = sm_clock_mhz()
    floor = float(lens.max()) * VIT_BT_STEP_CYCLES / (clk * 1e3)
    log(f"viterbi {S} segments (flags 0-3, kmer width {x['mu'].shape[1]}, "
        f"{layout_name(x['mu'].shape[1])}): traces and tracebacks == plain "
        f"(exact-tie differences: 0); fill {fill_ms:.4f} ms (plain "
        f"{fill_plain_ms:.1f} ms), backtrack {bt_ms:.4f} ms (plain "
        f"{bt_plain_ms:.1f} ms; chain latency floor {floor:.4f} ms, an "
        f"estimate: {VIT_BT_STEP_CYCLES} cycles x the longest walk's "
        f"{int(lens.max())} steps at {clk:.0f} MHz)")
    # the backtrack alone in a one-segment and a wavefront-sized launch
    for n in (1, 32):
        pn = pv.viterbi_backtrack(tk[:n].contiguous(), x["n_events"][:n],
                                  x["n_kmers"][:n])
        if path_max_abs_err(pn, pp[:n]) != 0.0:
            fail(f"viterbi_backtrack: a {n}-segment launch differs from plain")
    log("viterbi_backtrack 1- and 32-segment launches == plain")
    err = max_abs_err(tk[live].float(), tp[live].float())
    for kp in HMM_WIDTHS:
        arrays = width_batch(model, kp, WIDTH_SEGMENTS, seed=kp)
        xw = pv.prepare_viterbi_inputs(*arrays, device=dev)
        if xw["mu"].shape[1] != kp:
            fail(f"width batch {kp} prepared at width {xw['mu'].shape[1]}")
        wargs, tkw, tpw, livew, *_ = viterbi_check(xw, f"width-{kp}")
        err = max(err, max_abs_err(tkw[livew].float(), tpw[livew].float()))
        ms = cuda_ms(lambda: pv.viterbi_fill(*wargs))
        log(f"viterbi width {kp} ({layout_name(kp)}): {WIDTH_SEGMENTS} "
            f"segments, 0 of {int(livew.sum())} trace cells and 0 tracebacks "
            f"differ from plain; fill {ms:.4f} ms")
    # the block row's widest width: the backtrack's 256-kmer window
    xw = pv.prepare_viterbi_inputs(*width_batch(model, 1024, 8, seed=1024),
                                   device=dev)
    wargs, tkw, tpw, livew, *_ = viterbi_check(xw, "width-1024")
    err = max(err, max_abs_err(tkw[livew].float(), tpw[livew].float()))
    log(f"viterbi width 1024 ({layout_name(1024)}): 8 segments, 0 of "
        f"{int(livew.sum())} trace cells and 0 tracebacks differ from plain")
    del wargs, tkw, tpw, livew
    for kp in WIDE_WIDTHS:
        xw = pv.prepare_viterbi_inputs(*wide_batch(model, kp, seed=kp),
                                       device=dev)
        wargs, tkw, tpw, livew, *_ = viterbi_check(xw, f"width-{kp}")
        err = max(err, max_abs_err(tkw[livew].float(), tpw[livew].float()))
        ms = cuda_ms(lambda: pv.viterbi_fill(*wargs), reps=1)
        scratch = pv.wide_scratch(kp, 1, dev) is not None
        log(f"viterbi width {kp} ({layout_name(kp)}, rows in "
            f"{'global scratch' if scratch else 'shared memory'}): "
            f"{xw['mu'].shape[0]} segments, 0 of {int(livew.sum())} trace "
            f"cells and 0 tracebacks differ from plain; fill {ms:.4f} ms")
        del wargs, tkw, tpw, livew
    for name, ms, pms, nbytes, flops, e in (
            ("viterbi_fill", fill_ms, fill_plain_ms, fill_bytes, cells * 27,
             err),
            ("viterbi_backtrack", bt_ms, bt_plain_ms, bt_bytes,
             float(np.sum(lens)) * 8, path_max_abs_err(pk, pp))):
        bms, by = bound(nbytes, flops)
        report[name].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                            max_abs_err=e)


# ---------------------------------------------------------------- phase 4 --

def forward_work(nev, nk):
    """Bytes and f32 operations the Forward needs for these segments:
    each level, kmer table entry and score moved once."""
    nev = np.asarray(nev, np.float64)
    nk = np.asarray(nk, np.float64)
    nbytes = float(np.sum(nev * 4 + nk * 12 + 32 + 2 + 8 + 4))
    flops = float(np.sum(nev * nk * FWD_OPS_CELL + nev * FWD_OPS_ROW))
    return nbytes, flops


def log1p_unit_check(dev, chunk=1 << 28):
    """Hold the Forward kernels' log1pf (npt_log1p_unit, forward_common.cuh)
    to torch.log1p on every float in [0, 1]; fail on any difference."""
    import ctypes
    import torch
    from nanopolish_tpu_torch.utils import cuda_build
    fn = ctypes.CDLL(cuda_build.lib_path("forward_fill")).npt_log1p_unit_table
    fn.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    top = 0x3F800000 + 1                     # bit patterns of 0.0 ... 1.0
    out = torch.empty(chunk, dtype=torch.float32, device=dev)
    n_diff = 0
    t0 = time.perf_counter()
    for first in range(0, top, chunk):
        n = min(chunk, top - first)
        a = torch.arange(first, first + n, dtype=torch.int32,
                         device=dev).view(torch.float32)
        err = fn(first, n, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"npt_log1p_unit_table failed to launch (cudaError {err})")
        n_diff += int((out[:n].view(torch.int32) !=
                       torch.log1p(a).view(torch.int32)).sum())
    if n_diff:
        fail(f"npt_log1p_unit differs from torch.log1p on {n_diff} of {top} "
             f"floats in [0, 1]")
    log(f"npt_log1p_unit == torch.log1p on all {top} floats in [0, 1] "
        f"({time.perf_counter() - t0:.2f} s)")


def phase_forward(model, dev, report):
    import torch
    from nanopolish_tpu_torch.alignment.segments import _bucket_key
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf

    log1p_unit_check(dev)
    rng = np.random.default_rng(17)
    nk = rng.integers(17, 222, FWD_SEGMENTS).astype(np.int32)
    nev = np.clip((nk * rng.uniform(1.6, 2.4, FWD_SEGMENTS)).astype(np.int32),
                  30, 460).astype(np.int32)
    cases = {
        "call-methylation-shaped": hmm_batch(model, nk, nev, rng),
        "scorereads-shaped": hmm_batch(
            model, np.full(FWD_LONG, 250, np.int32),
            np.full(FWD_LONG, 501, np.int32), rng),
    }
    for kp in HMM_WIDTHS:
        cases[f"width-{kp}"] = width_batch(model, kp, WIDTH_SEGMENTS,
                                           seed=kp + 1)
    for kp in WIDE_WIDTHS:
        cases[f"width-{kp}"] = wide_batch(model, kp, seed=kp + 1)
    timed, scores, errs = None, {}, []
    for name, (lv, nev_c, mu, sd, nk_c, epb, flags) in cases.items():
        x = pf.prepare_forward_inputs(lv, nev_c, mu, sd, nk_c, epb, flags,
                                      device=dev)
        kp = x["mu"].shape[1]
        args = (x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
                x["n_kmers"], x["trans"], x["clips"])
        got = pf.forward_fill(*args)
        plain_ms, ref = once_ms(lambda: ph.forward_fill_plain(*args))
        err = max_abs_err(got, ref)
        if not bits_equal(got, ref):
            same = float((got.view(torch.int32) == ref.view(torch.int32))
                         .float().mean())
            fail(f"forward_fill differs from the plain version on the {name} "
                 f"batch: {same:.2%} bit-identical, max_abs_err {err} nats")
        ms = cuda_ms(lambda: pf.forward_fill(*args))
        nbytes, flops = forward_work(nev_c, nk_c)
        bms, by = bound(nbytes, flops)
        log(f"forward {name}: {len(nk_c)} segments, kmer width {kp} "
            f"({layout_name(kp)}), bit-identical to plain; kernel {ms:.4f} ms "
            f"(plain {plain_ms:.1f} ms), bound {bms:.4f} ms ({by})")
        scores[name] = got
        errs.append(err)
        if timed is None:                 # the main path's shape
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    # the 2,048 as the main path launches them: one launch per bucket of
    # power-of-two event length and kmer width (forward_arrays_async)
    lv, nev_c, mu, sd, nk_c, epb, flags = cases["call-methylation-shaped"]
    buckets = {}
    for i, key in enumerate(zip(nev_c.tolist(), nk_c.tolist())):
        buckets.setdefault(_bucket_key(*key), []).append(i)
    xs = []
    for (tp, kp), idx in sorted(buckets.items()):
        ii = np.asarray(idx)
        x = pf.prepare_forward_inputs(lv[ii, :tp], nev_c[ii], mu[ii, :kp],
                                      sd[ii, :kp], nk_c[ii], epb[ii],
                                      flags[ii], device=dev)
        if not bits_equal(pf.forward_scores(x),
                          scores["call-methylation-shaped"][ii]):
            fail(f"forward_fill: bucket ({tp} events, {kp} kmers) scores "
                 f"differ from the single-width launch")
        xs.append(x)
    bucketed_ms = cuda_ms(lambda: [pf.forward_scores(x) for x in xs])
    widths = sorted({x["mu"].shape[1] for x in xs})
    log(f"forward call-methylation-shaped, bucketed as the main path: "
        f"{len(xs)} launches (kmer widths {widths}), scores bit-identical to "
        f"the single-width launch; {bucketed_ms:.4f} ms in all (single "
        f"width {timed['ms']:.4f} ms)")
    report["forward_fill"].update(max_abs_err=max(errs), **timed)


# --------------------------------------------------------------- phase 4b --

def indexed_batch(model, rng, n_seg, k_lo, k_hi, t_lo, t_hi, per_ev,
                  n_reads=64, widths=None):
    """Indexed Forward inputs (ops/profile_hmm_indexed.py): n_seg segments
    of k_lo..k_hi kmers (or the given widths, cycled) against event rows
    of t_lo..t_hi levels, per_ev segments per event row; per-read tables
    of the model under random scalings; levels drawn along one of the
    row's candidate windows, every other row stored reversed."""
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops.banded_align import emission_constant
    S = model.num_states
    shift = rng.uniform(-2, 2, n_reads)
    scale = rng.uniform(0.95, 1.05, n_reads)
    var = rng.uniform(0.9, 1.3, n_reads)
    mu = (scale[:, None] * model.level_mean[None] + shift[:, None]
          ).astype(np.float32)
    sig = (model.level_stdv[None] * var[:, None]).astype(np.float32)
    tabs = np.stack([mu, sig, emission_constant(np.log(sig))])
    E = -(-n_seg // per_ev)
    U = max(n_seg // 4, 1)
    n_km_u = (np.resize(np.asarray(widths, np.int32), U) if widths is not None
              else rng.integers(k_lo, k_hi + 1, U).astype(np.int32))
    Kc = int(n_km_u.max())
    rank_mat = np.zeros((U, Kc), np.int32)
    for u in range(U):
        rank_mat[u, :n_km_u[u]] = rng.integers(0, S, n_km_u[u])
    read_of = rng.integers(0, n_reads, E)
    seg_ev = np.repeat(np.arange(E), per_ev)[:n_seg]
    seg_u = rng.integers(0, U, n_seg)
    n_ev_u = np.zeros(E, np.int32)
    first_u = np.zeros(E, np.int64)
    first_u[seg_ev[::-1]] = seg_u[::-1]
    for e in range(E):
        w = int(n_km_u[first_u[e]])
        lo = max(t_lo, w) if t_lo is not None else int(1.6 * w)
        hi = max(t_hi, lo) if t_hi is not None else int(2.4 * w)
        n_ev_u[e] = rng.integers(lo, hi + 1)
    Tc = int(n_ev_u.max())
    levels_u = np.zeros((E, Tc), np.float32)
    for e in range(E):
        u, t, r = first_u[e], int(n_ev_u[e]), read_of[e]
        w = int(n_km_u[u])
        ks = rank_mat[u, np.minimum((np.arange(t) * w / t).astype(int),
                                    w - 1)]
        row = mu[r, ks] + rng.normal(0, 1, t) * sig[r, ks]
        levels_u[e, :t] = row[::-1] if e % 2 else row
    epb = rng.uniform(1.6, 2.4, n_reads).astype(np.float32)
    trans_u = ph.make_transitions(epb, 0.9)
    ids = np.stack([seg_ev, read_of[seg_ev], seg_u, read_of[seg_ev]],
                   axis=1).astype(np.int32)
    return levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids


def indexed_work(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids):
    """Bytes and f32 operations of the indexed Forward on this batch: each
    event row, rank row, table entry and transition row the segments use
    read once, the ids and clips read and the scores written; the
    operations of forward_work on each segment's (events, kmers)."""
    ev_u, rk_u, tr_u = (np.unique(ids[:, c]) for c in (0, 2, 3))
    nk = n_km_u[ids[:, 2]].astype(np.int64)
    kmask = np.arange(rank_mat.shape[1])[None, :] < n_km_u[rk_u][:, None]
    pairs = np.unique(np.concatenate([
        (ids[ids[:, 2] == u, 1][:, None].astype(np.int64) * tabs.shape[2] +
         rank_mat[u, :n_km_u[u]][None, :]).ravel() for u in rk_u]))
    nbytes = float(np.sum(n_ev_u[ev_u].astype(np.float64) * 4 + 4) +
                   np.sum(kmask) * 4 + len(rk_u) * 4 + len(pairs) * 12 +
                   len(tr_u) * 32 + len(ids) * (16 + 2 + 4))
    _, flops = forward_work(n_ev_u[ids[:, 0]], nk)
    return nbytes, flops


def short_rows(arrays, t_max):
    """Indexed inputs with every event row cut to at most t_max levels (a
    wide window among few events: a chunk across deletions)."""
    levels_u, n_ev_u, *rest = arrays
    return (levels_u[:, :t_max].copy(),
            np.minimum(n_ev_u, t_max).astype(np.int32), *rest)


def indexed_tensors(arrays, dev):
    import torch
    dts = (torch.float32, torch.int32, torch.float32, torch.int32,
           torch.int32, torch.float32, torch.int32)
    return [torch.as_tensor(a, dtype=d, device=dev)
            for a, d in zip(arrays, dts)]


def phase_forward_indexed(model, dev, report):
    """The indexed kernel at every mode of indexed_layout, as a flush
    launches it (profile_hmm_indexed.plan_flush: the windows of up to 32
    kmers in one launch at kmer widths 8, 16 and 32, one launch per wider
    kmer width), bit for bit against forward_indexed_plain and against
    forward_fill on the gathered inputs; then one flush of mixed widths
    1-3,000 through forward_indexed_scores."""
    import torch
    import torch.nn.functional as F
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    from nanopolish_tpu_torch.ops import profile_hmm_indexed as pi
    from nanopolish_tpu_torch.ops.profile_hmm_viterbi import kmer_width

    rng = np.random.default_rng(23)
    cases = {
        "screening-shaped": indexed_batch(model, rng, IDX_SCREEN, 5, 32, 10,
                                          80, per_ev=10),
        "widths 1-32": indexed_batch(model, rng, 1024, 1, 32, 10, 80,
                                     per_ev=8, widths=np.arange(1, 33)),
        "calling-shaped": indexed_batch(model, rng, IDX_CALL, 100, 256, None,
                                        None, per_ev=4),
        "calling 33-64": indexed_batch(model, rng, IDX_CALL, 33, 64, None,
                                       None, per_ev=4),
        "block widths": short_rows(indexed_batch(model, rng, 64, 257, 1024,
                                                 40, 120, per_ev=2), 300),
        "wide": short_rows(indexed_batch(model, rng, 8, 1025, 3000, 40, 120,
                                         per_ev=1), 120),
    }
    errs, timed = [], None
    for name, arrays in cases.items():
        pi.check_indexed(*arrays)
        t = indexed_tensors(arrays, dev)
        ids_np = arrays[6]
        order, launches = pi.plan_flush(arrays[1][ids_np[:, 0]],
                                        arrays[4][ids_np[:, 2]])
        t[6] = t[6][torch.as_tensor(order, device=dev)].contiguous()
        n = t[6].shape[0]
        clips = torch.as_tensor(np.stack([np.arange(n) % 2,
                                          (np.arange(n) // 2) % 2], 1),
                                dtype=torch.uint8, device=dev)

        def run():
            return torch.cat(pi.run_flush(t[:6], t[6], clips, launches))

        got = run()
        plain_ms, ref = once_ms(lambda: ph.forward_indexed_plain(*t[:6], t[6],
                                                                 clips))
        lv, nev, mu, sg, c, nk, tr = ph.gather_indexed(*t[:6], t[6])
        kf = kmer_width(int(nk.max()))
        pad = kf - mu.shape[1]
        flat = pf.forward_fill(lv.contiguous(), nev.contiguous(),
                               F.pad(mu, (0, pad)).contiguous(),
                               F.pad(sg, (0, pad), value=1.0).contiguous(),
                               F.pad(c, (0, pad), value=ph.PAD_C).contiguous(),
                               nk.contiguous(), tr.contiguous(), clips)
        err = max(max_abs_err(got, ref), max_abs_err(got, flat))
        same = float((got.view(torch.int32) == ref.view(torch.int32))
                     .float().mean())
        if not (bits_equal(got, ref) and bits_equal(got, flat)):
            fail(f"forward_indexed differs from its plain version or from "
                 f"forward_fill on the {name} batch (max_abs_err {err}, "
                 f"{same:.2%} bit-identical)")
        # the flush's launches (CUDA events), and its kernels' device time
        # alone (torch.profiler)
        flush_ms = cuda_ms(run)
        ms = kernel_ms(run, "forward_indexed")
        nbytes, flops = indexed_work(*arrays)
        bms, by = bound(nbytes, flops)
        modes = ", ".join(
            (f"<=32: KP {'/'.join(str(w) for w in sorted(set(wd.tolist())))}"
             if wd is not None else
             f"{kp}: {'/'.join(map(str, pi.indexed_layout(kp)))}") +
            f" x{hi - lo}" for kp, lo, hi, wd in launches)
        log(f"forward_indexed {name}: {n} segments in {len(launches)} "
            f"launches ({modes}), {len(arrays[1])} event rows, "
            f"{len(arrays[4])} rank rows; max_abs_err {err} vs plain and vs "
            f"forward_fill, {same:.1%} bit-identical; kernels {ms:.4f} ms "
            f"(the launches {flush_ms:.4f} ms; plain {plain_ms:.1f} ms), "
            f"bound {bms:.4f} ms ({by})")
        errs.append(err)
        if timed is None:                 # the main path's dominant shape
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        del got, ref, flat, lv, mu, sg, c
    # one flush of every width, through the host side of the drain
    rng = np.random.default_rng(31)
    arrays = short_rows(indexed_batch(
        model, rng, 256, 1, 3000, 20, 90, per_ev=4,
        widths=np.concatenate([np.arange(1, 40, 3),
                               [64, 100, 200, 256, 300, 600, 1024, 1100,
                                3000]])), 200)
    got = pi.forward_indexed_scores(*arrays, 3, device=dev)
    t = indexed_tensors(arrays, dev)
    ones = torch.ones((len(arrays[6]), 2), dtype=torch.uint8, device=dev)
    ref = ph.forward_indexed_plain(*t, ones).cpu().numpy()
    if not np.array_equal(got.view(np.int32), ref.view(np.int32)):
        fail("forward_indexed_scores on a flush of widths 1-3,000 differs "
             "from forward_indexed_plain")
    n_launch = len(pi.plan_flush(arrays[1][arrays[6][:, 0]],
                                 arrays[4][arrays[6][:, 2]])[1])
    log(f"forward_indexed_scores, one flush of {len(got)} segments of widths "
        f"1-3,000 ({n_launch} launches): bit-identical to "
        f"forward_indexed_plain")
    report["forward_indexed"].update(max_abs_err=max(errs), **timed)


# --------------------------------------------------------------- phase 4c --

def seg_read(rng, n_leader=300, n_adapter=200, n_polya=400, n_transcript=600):
    """tests/test_pallas_segmentation.py's synthetic read: START-ish,
    LEADER, ADAPTER, POLYA and TRANSCRIPT levels in pA."""
    segs = [rng.normal(70.3, 3.8, 60), rng.normal(110.9, 5.2, n_leader),
            rng.normal(63.3, 2.7, n_adapter), rng.normal(108.9, 3.3, n_polya),
            rng.normal(79.7, 7.0, n_transcript)]
    return np.concatenate(segs).astype(np.float32)


def seg_batches():
    """{name: (reads, scalings [B, 3])}: the three batches of
    tests/test_pallas_segmentation.py and a mixed-length batch of
    SEG_READS reads of 2,000-65,536 samples (a 2 kb transcript at ~30
    samples/base), longest first as segment_reads orders them."""
    scal3 = [(1.0, 0.0, 1.0), (1.02, 2.0, 1.1), (0.98, -1.5, 0.9)]
    rng = np.random.default_rng(7)
    out = {"1560": ([seg_read(rng)[:1560]], scal3[:1])}
    rng = np.random.default_rng(7)
    out["1560,900,1233"] = ([seg_read(rng)[:n] for n in (1560, 900, 1233)],
                            scal3)
    rng = np.random.default_rng(3)
    out["dpi-shaped"] = ([seg_read(rng, 200, 150, 300, 400)], scal3[:1])
    # the backtrack's edges: reads of 1-3 samples, one shorter than a
    # thread's 16-byte group, walks of one tile (4,096 samples) less one,
    # one and one more, and reads shorter than the padded length
    rng = np.random.default_rng(11)
    out["edges"] = ([seg_read(rng, n_transcript=3600)[:n] for n in SEG_EDGES],
                    [scal3[i % 3] for i in range(len(SEG_EDGES))])
    rng = np.random.default_rng(29)
    lens = np.sort(rng.integers(2000, SEG_MAX + 1, SEG_READS))[::-1]
    lens[0] = SEG_MAX
    reads = []
    for n in lens:
        parts = (int(rng.integers(200, 600)), int(rng.integers(200, 600)),
                 int(rng.integers(600, 4000)))
        r = seg_read(rng, *parts, n_transcript=max(0, n - 60 - sum(parts)))
        reads.append(r[:n])
    scal = np.stack([rng.uniform(0.95, 1.05, SEG_READS),
                     rng.uniform(-3, 3, SEG_READS),
                     rng.uniform(0.9, 1.3, SEG_READS)], axis=1)
    out["mixed"] = (reads, scal)
    return out


def seg_inputs(reads, scal, dev):
    """Sample-major [N, B] samples (padded with 100.0), n [B] i32 and
    scal [B, 3] f32 on dev."""
    import torch
    N = max(len(r) for r in reads)
    x = np.full((N, len(reads)), 100.0, np.float32)
    for j, r in enumerate(reads):
        x[:len(r), j] = r
    return (torch.as_tensor(x, device=dev),
            torch.as_tensor([len(r) for r in reads], dtype=torch.int32,
                            device=dev),
            torch.as_tensor(np.asarray(scal, np.float32), device=dev))


def sm_clock_mhz() -> float:
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


# the segmentation chain's dependent cycles per sample: ~4 dependent f32
# operations (add, max, max, add) on the P state at ~4 cycles each
SEG_CHAIN_CYCLES = 16


def seg_work(lens, dpi=False):
    """Bytes and f32 operations of the segmentation fill and backtrack on
    reads of these lengths.  Fill: each sample read once (4 B) and its
    backpointer byte written once, per read n, scalings and final
    scores; per sample the emission formula (clamp 2; a Gaussian density
    6: sub, div, two muls, exp, div; a log density 6; S = density + mul,
    add, log = 9; L 6; A and T = two densities + two muls, add, log = 16
    each; P 6, or 16 as detect-polyi's mixture; C's band 2) and the chain
    (12 transition adds, 6 maxima, 6 emission adds, 8 comparisons).
    Backtrack: each byte read once, n read and the [5] summary written
    per read; per sample a decode, 4 pair tests and the cliff test."""
    lens = np.asarray(lens, np.float64)
    emit = 2 + 9 + 6 + 16 + (16 if dpi else 6) + 2 + 16
    fill_bytes = float(np.sum(lens * 5 + 4 + 12 + 24))
    fill_flops = float(np.sum(lens) * (emit + 32))
    bt_bytes = float(np.sum(lens + 4 + 20))
    bt_flops = float(np.sum(lens) * 6)
    return fill_bytes, fill_flops, bt_bytes, bt_flops


def phase_segmentation(dev, report):
    """Both segmentation kernels against their plain versions, bit for
    bit (backpointer bytes, final scores, labels, summary), with the
    polya and the detect-polyi parameters; then timing on the mixed
    batch."""
    import torch
    from nanopolish_tpu_torch.apps.detect_polyi import DPI_PARAMS
    from nanopolish_tpu_torch.ops import segmentation_hmm as sh
    from nanopolish_tpu_torch.ops import segmentation_viterbi as sv

    timed = None
    for name, (reads, scal) in seg_batches().items():
        x, n, s = seg_inputs(reads, scal, dev)
        for pname, params in (("polya", sh.SegmentationParams()),
                              ("dpi", DPI_PARAMS)):
            k = sh.seg_constants(params)
            bk, vk = sv.seg_viterbi_fill(x, n, s, k)
            fill_plain_ms, (bp, vp) = once_ms(
                lambda: sh.seg_viterbi_fill_plain(x, n, s, k))
            if not bits_equal(bk, bp):
                fail(f"seg_viterbi_fill: {int((bk != bp).sum())} backpointer "
                     f"bytes differ from plain ({name}, {pname})")
            if not bits_equal(vk, vp):
                fail(f"seg_viterbi_fill: final scores differ from plain "
                     f"({name}, {pname}; max_abs_err {max_abs_err(vk, vp)})")
            sk, lk = sv.seg_backtrack(bk, n, labels=True)
            bt_plain_ms, (sp, lp) = once_ms(
                lambda: sh.seg_backtrack_plain(bp, n))
            if not (bits_equal(sk, sp) and bits_equal(lk, lp)):
                fail(f"seg_backtrack: {int((lk != lp).sum())} labels, "
                     f"{int((sk != sp).any(1).sum())} summaries differ from "
                     f"plain ({name}, {pname})")
            # the main path's call: summary only, no labels
            s_only, none = sv.seg_backtrack(bk, n)
            if none is not None or not bits_equal(s_only, sp):
                fail(f"seg_backtrack without labels differs ({name}, {pname})")
            segs = [sh.segmentation_from_summary(r, len(rd))
                    for r, rd in zip(sp.cpu().numpy(), reads)]
            line = (f"segmentation {name} ({pname}): {len(reads)} reads, "
                    f"{sum(map(len, reads))} samples; kernels == plain "
                    f"(backpointers, final scores, labels, summary)")
            if name != "mixed":
                log(f"{line}; {segs[0]}")
                continue
            fill_ms = cuda_ms(lambda: sv.seg_viterbi_fill(x, n, s, k))
            bt_ms = kernel_ms(lambda: sv.seg_backtrack(bk, n), "seg_backtrack")
            fb, ff, bb, bf = seg_work([len(r) for r in reads],
                                      dpi=pname == "dpi")
            (fbms, fby), (bbms, bby) = bound(fb, ff), bound(bb, bf)
            clk = sm_clock_mhz()
            n_max = max(map(len, reads))
            floor = n_max * SEG_CHAIN_CYCLES / (clk * 1e3)
            threads = kernel_constant("seg_backtrack", "THREADS")
            spt = kernel_constant("seg_backtrack", "SPT")
            tiles = -(-(n_max - 2) // (threads * spt))
            steps = tiles * (2 * spt + 5 + threads // 32)
            bt_floor = steps * SEG_BT_STEP_CYCLES / (clk * 1e3)
            log(f"{line}; fill {fill_ms:.3f} ms (plain {fill_plain_ms:.1f} "
                f"ms, bound {fbms:.4f} ms {fby}, chain latency floor "
                f"{floor:.3f} ms, an estimate: {SEG_CHAIN_CYCLES} cycles x "
                f"{n_max} samples at {clk:.0f} MHz), "
                f"backtrack {bt_ms:.4f} ms "
                f"(plain {bt_plain_ms:.1f} ms, bound {bbms:.4f} ms {bby}, "
                f"chain latency floor {bt_floor:.4f} ms, an estimate: "
                f"{SEG_BT_STEP_CYCLES} cycles x {steps} steps a thread: "
                f"{tiles} tiles of {threads} x {spt} samples, each {spt} "
                f"composed, {spt} replayed, 5 scan levels and "
                f"{threads // 32} warp totals, at {clk:.0f} MHz); "
                f"{len(reads) / ((fill_ms + bt_ms) / 1e3):.0f} reads/s")
            if timed is None:             # the polya parameters
                timed = {"seg_viterbi_fill": dict(
                            ms=fill_ms, plain_ms=fill_plain_ms, bound_ms=fbms,
                            bound_by=fby, max_abs_err=max_abs_err(vk, vp)),
                         "seg_backtrack": dict(
                            ms=bt_ms, plain_ms=bt_plain_ms, bound_ms=bbms,
                            bound_by=bby,
                            max_abs_err=float((sk - sp).abs().max()))}
            del bk, vk, bp, vp, sk, lk, sp, lp
            torch.cuda.empty_cache()
    for name, r in timed.items():
        report[name].update(r)
    seg_backtrack_random(dev)


def random_backpointers(rng, N, B):
    """[N, B] uint8 backpointer bytes that keep each state for a while
    (its "stay" bit set with probability 0.97, P's code 0 with 0.9) and
    reach every state, with random bits 6-7 (ignored by the decode)."""
    stay = rng.random((N, B, 4)) < 0.97
    code = rng.choice(4, size=(N, B), p=[0.9, 0.05, 0.03, 0.02])
    return (stay[..., 0] | stay[..., 1] << 1 | code << 2 | stay[..., 2] << 4
            | stay[..., 3] << 5 | rng.integers(0, 4, (N, B)) << 6
            ).astype(np.uint8)


def seg_backtrack_random(dev):
    """seg_backtrack against its plain version on random backpointer
    bytes at every row alignment: 48 reads of 1-4,111 samples in a
    4,111-sample batch (random_backpointers)."""
    import torch
    from nanopolish_tpu_torch.ops import segmentation_hmm as sh
    from nanopolish_tpu_torch.ops import segmentation_viterbi as sv
    rng = np.random.default_rng(5)
    N, B = 4111, 48
    ns = np.concatenate([[1, 2, 3, 4, 17, 18], rng.integers(1, N + 1, B - 8),
                         [N - 1, N]]).astype(np.int32)
    bptr = torch.as_tensor(random_backpointers(rng, N, B), device=dev)
    n = torch.as_tensor(ns, device=dev)
    sk, lk = sv.seg_backtrack(bptr, n, labels=True)
    sp, lp = sh.seg_backtrack_plain(bptr, n)
    if not (bits_equal(sk, sp) and bits_equal(lk, lp)):
        fail(f"seg_backtrack: {int((lk != lp).sum())} labels, "
             f"{int((sk != sp).any(1).sum())} summaries differ from plain "
             f"on random backpointer bytes")
    log(f"seg_backtrack on random backpointer bytes ({B} reads of 1-{N} "
        f"samples, rows at every alignment): == plain (labels, summary); "
        f"{int((sp[:, :4] >= 0).sum())} transitions, "
        f"{int(sp[:, 4].sum())} cliff samples")


# ---------------------------------------------------------------- phase 5 --

def _write_fa(path, name, seq):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _adc(pa):
    return np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)


def build_pipeline(d, genome_len, plan, read_len, seed, shift=1.5,
                   scale=1.01, methylated=(), sort_bam=False,
                   meth_ref=False, leader=400, trailer=100):
    """Reference FASTA, basecalls, slow5 signal, readdb index and BAM for
    reads placed at plan = [(name, pos, is_rev)] (the layout of
    tests/test_golden_outputs.py; BAM records in plan order unless
    sort_bam).  Reads named in ``methylated`` carry signal drawn from the
    cpg model over their CpG-methylated basecall; with ``meth_ref`` the
    reference is the CpG-methylated genome."""
    from nanopolish_tpu_torch.apps import index as index_app
    from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
    from nanopolish_tpu_torch.io.slow5 import Slow5Writer
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
    from nanopolish_tpu_torch.utils.alphabet import (DNA_ALPHABET,
                                                     METHYL_CPG_ALPHABET)
    from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                      synthetic_raw_signal)

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    pms = PoreModelSet.instance()
    model = pms.get_model("r9.4_450bps", "nucleotide", "template", 6)
    cpg = pms.get_model("r9.4_450bps", "cpg", "template", 6)
    genome = random_sequence(rng, genome_len)
    ref_fa = os.path.join(d, "ref.fa")
    _write_fa(ref_fa, "tig1", METHYL_CPG_ALPHABET.methylate(genome)
              if meth_ref else genome)
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "sig.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, is_rev in plan:
            seg = genome[pos:pos + read_len]
            basecall = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
            fq.write(f"@{name}\n{basecall}\n+\n{'I' * read_len}\n")
            sc = SquiggleScalings.from4(shift, scale, 0.0, 1.0)
            if name in methylated:
                pa = synthetic_raw_signal(
                    rng, METHYL_CPG_ALPHABET.methylate(basecall), cpg, sc,
                    samples_per_base=10.0, leader=leader, trailer=trailer)
            else:
                pa = synthetic_raw_signal(rng, basecall, model, sc,
                                          samples_per_base=10.0,
                                          leader=leader, trailer=trailer)
            sw.write(name, _adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = os.path.join(d, "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [len(genome)])
    for name, pos, is_rev in (sorted(plan, key=lambda p: p[1]) if sort_bam
                              else plan):
        seg = genome[pos:pos + read_len]
        w.write(BamRecord(qname=name, flag=16 if is_rev else 0, tid=0,
                          pos=pos, mapq=60, cigar=[(0, read_len)], seq=seg,
                          qual=np.full(read_len, 30, np.uint8)))
    w.close()
    return ref_fa, fastq, bam


def same_as_golden(got: str, name: str) -> None:
    """Fail unless got is byte for byte tests/golden/<name>."""
    want = open(os.path.join(ROOT, "tests", "golden", name)).read()
    if got == want:
        return
    gl, wl = got.splitlines(), want.splitlines()
    for i, (g, w) in enumerate(zip(gl, wl)):
        if g != w:
            fail(f"{name} line {i + 1} differs:\n{g}\n{w}")
    fail(f"{name}: {len(gl)} lines, golden has {len(wl)}")


def assert_agree(got: str, want: str, name: str, **kw):
    """tests/printed_output.py's assert_agree, the module loaded by path:
    an installed package named `tests` may shadow the repository's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "printed_output", os.path.join(ROOT, "tests", "printed_output.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.assert_agree(got, want, name, **kw)


def render_bam(path: str) -> str:
    """Stable text rendering of a BAM (tests/test_golden_outputs.py:221)."""
    from nanopolish_tpu_torch.io.bam import BamReader
    r = BamReader(path)
    lines = [r.header_text.rstrip("\n")]
    for rec in r:
        lines.append(rec.to_sam(r.references))
    r.close()
    return "\n".join(lines) + "\n"


def phase_golden(dev):
    from nanopolish_tpu_torch.apps import call_methylation as cm_app
    from nanopolish_tpu_torch.apps import eventalign as ea_app

    d = os.path.join(WORK, "golden")
    plan = [("gr0", 40, False), ("gr1", 420, True),
            ("gr2", 180, False), ("gr3", 560, True)]
    ref_fa, fastq, bam = build_pipeline(d, 900, plan, 300, seed=1234)
    out = io.StringIO()
    summary = os.path.join(d, "summary.tsv")
    ea_app.main(["-r", fastq, "-b", bam, "-g", ref_fa, "--print-read-names",
                 "--summary", summary, "--device", dev.type], stdout=out)
    same_as_golden(out.getvalue(), "eventalign.tsv")
    same_as_golden(open(summary).read(), "eventalign_summary.tsv")
    out = io.StringIO()
    ea_app.main(["-r", fastq, "-b", bam, "-g", ref_fa, "--sam",
                 "--device", dev.type], stdout=out)
    same_as_golden(out.getvalue(), "eventalign.sam")
    log(f"golden eventalign on {dev.type}: tsv, summary and sam identical "
        f"to tests/golden/ byte for byte")

    # the methylation golden recipe (tests/test_golden_outputs.py:123-155)
    d = os.path.join(WORK, "golden_meth")
    plan = [("gm0", 60, False), ("gu0", 380, False), ("gm1", 600, True)]
    ref_fa, fastq, bam = build_pipeline(d, 1000, plan, 320, seed=77,
                                        shift=0.5, scale=1.0,
                                        methylated={"gm0", "gm1"},
                                        sort_bam=True)
    golden = os.path.join(ROOT, "tests", "golden")
    for style in ("read", "reference"):
        out = io.StringIO()
        modbam = os.path.join(d, f"mods_{style}.bam")
        cm_app.main(["-r", fastq, "-b", bam, "-g", ref_fa,
                     "--modbam-output-name", modbam, "--modbam-style", style,
                     "--device", dev.type], stdout=out)
        assert_agree(out.getvalue(),
                     open(os.path.join(golden, "methylation.tsv")).read(),
                     f"golden methylation.tsv on {dev.type}",
                     sign_cols=(LLR,))
        assert_agree(render_bam(modbam),
                     open(os.path.join(golden, f"modbam_{style}.sam")).read(),
                     f"golden modbam_{style}.sam on {dev.type}", sam=True)

    # the consensus golden recipe (tests/test_golden_outputs.py:166-208)
    from nanopolish_tpu_torch.apps import variants as va_app
    from nanopolish_tpu_torch.utils.synthetic import random_sequence
    rng = np.random.default_rng(31)
    truth = random_sequence(rng, 300)
    draft = truth[:130] + SUB[truth[130]] + truth[131:]
    d = os.path.join(WORK, "golden_cons")
    draft_fa, fastq, bam = build_variants_corpus(
        d, rng, draft, [(f"gc{i}", truth, 0) for i in range(12)], leader=400)
    for extra in ([], ["--fix-homopolymers"]):
        out = io.StringIO()
        va_app.main(["-r", fastq, "-b", bam, "-g", draft_fa, "-w",
                     "tig1:0-299", "--consensus", "-d", "5", "--device",
                     dev.type] + extra, stdout=out)
        assert_agree(out.getvalue(),
                     open(os.path.join(golden, "consensus.vcf")).read(),
                     f"golden consensus.vcf on {dev.type} {' '.join(extra)}")

    # the polya golden recipe (tests/test_golden_outputs.py:244-291)
    from nanopolish_tpu_torch.apps import polya as polya_app
    ref_fa, fastq, bam = build_polya_corpus(
        os.path.join(WORK, "golden_polya"), 3, 97, "grna")
    out = io.StringIO()
    with rna_reads():
        polya_app.main(["-r", fastq, "-b", bam, "-g", ref_fa, "--device",
                        dev.type], stdout=out)
    same_as_golden(out.getvalue(), "polya.tsv")
    log(f"golden polya on {dev.type}: identical to tests/golden/polya.tsv "
        f"byte for byte")


@contextlib.contextmanager
def rna_reads():
    """Slow5 records load as DNA; inside this block they report RNA (the
    patch of the JAX package's polya tests and tools/perf_e2e_polya.py)."""
    from nanopolish_tpu_torch.io.slow5 import Slow5Record
    orig = Slow5Record.to_fast5_data
    Slow5Record.to_fast5_data = (
        lambda self, kit="", experiment_type="dna":
        orig(self, kit=kit, experiment_type="rna"))
    try:
        yield
    finally:
        Slow5Record.to_fast5_data = orig


def rna_read_signal(rng, transcript, model):
    """3'->5' raw signal of one direct-RNA read: START | LEADER | ADAPTER
    | a POLYA_NT tail | the transcript's kmer levels in reverse, ~30
    samples/base (tests/test_polya_e2e.py's recipe)."""
    parts = [rng.normal(70.3, 2.0, size=300), rng.normal(110.9, 2.0, size=400),
             rng.normal(79.3, 2.5, size=400),
             rng.normal(108.9, 1.5, size=int(POLYA_NT * 30.0))]
    seq = transcript.replace("U", "T")
    ranks = model.alphabet.seq_to_kmer_ranks(seq, model.k)[::-1]
    nsamp = np.maximum(3, rng.poisson(30.0, size=len(ranks)))
    parts.append(rng.normal(np.repeat(model.level_mean[ranks], nsamp),
                            np.repeat(model.level_stdv[ranks], nsamp)))
    return np.concatenate(parts).astype(np.float32)


def build_polya_corpus(d, n_reads, seed, prefix, blow5=False):
    """Reference, basecalls, signal (4 kHz), readdb index and BAM for
    n_reads direct-RNA reads of one POLYA_TRANSCRIPT-base transcript,
    each aligned end to end (the layout of tests/test_golden_outputs.py
    and, with blow5, tools/perf_e2e_polya.py)."""
    from nanopolish_tpu_torch.apps import index as index_app
    from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
    from nanopolish_tpu_torch.io.slow5 import Blow5Writer, Slow5Writer
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.utils.synthetic import random_sequence

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    model = PoreModelSet.instance().get_model(
        "r9.4_70bps", "u_to_t_rna", "template", 5)
    L = POLYA_TRANSCRIPT
    transcript = random_sequence(rng, L)
    ref_fa = os.path.join(d, "ref.fa")
    _write_fa(ref_fa, "rna1", transcript)
    fastq = os.path.join(d, "reads.fastq")
    sig = os.path.join(d, "sig.blow5" if blow5 else "sig.slow5")
    with open(fastq, "w") as fq, (Blow5Writer if blow5 else Slow5Writer)(sig) as sw:
        for i in range(n_reads):
            fq.write(f"@{prefix}{i}\n{transcript}\n+\n{'I' * L}\n")
            pa = rna_read_signal(rng, transcript, model)
            sw.write(f"{prefix}{i}", _adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", sig])
    bam = os.path.join(d, "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["rna1"], [L])
    for i in range(n_reads):
        w.write(BamRecord(qname=f"{prefix}{i}", tid=0, pos=0, mapq=60,
                          cigar=[(0, L)], seq=transcript,
                          qual=np.full(L, 30, np.uint8)))
    w.close()
    return ref_fa, fastq, bam


def build_variants_corpus(d, rng, draft, reads, leader=450):
    """Draft FASTA, basecalls, blow5 signal, readdb index and BAM for
    reads = [(name, true sequence, draft position)], each aligned without
    gaps: the layout of tools/perf_e2e_variants.py and
    tests/test_golden_outputs.py (signal at 9 samples/base under a random
    shift per read, drawn from rng in read order)."""
    from nanopolish_tpu_torch.apps import index as index_app
    from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
    from nanopolish_tpu_torch.io.slow5 import Blow5Writer
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
    from nanopolish_tpu_torch.utils.synthetic import synthetic_raw_signal

    os.makedirs(d, exist_ok=True)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    draft_fa = os.path.join(d, "draft.fa")
    _write_fa(draft_fa, "tig1", draft)
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "sig.blow5")
    with open(fastq, "w") as fq, Blow5Writer(slow5) as sw:
        for name, seq, _ in reads:
            fq.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
            sc = SquiggleScalings.from4(float(rng.uniform(-2, 2)), 1.0,
                                        0.0, 1.0)
            pa = synthetic_raw_signal(rng, seq, model, sc,
                                      samples_per_base=9.0, leader=leader,
                                      trailer=90)
            sw.write(name, _adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = os.path.join(d, "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"],
                  [len(draft)])
    for name, seq, pos in sorted(reads, key=lambda r: r[2]):
        w.write(BamRecord(qname=name, tid=0, pos=pos, mapq=60,
                          cigar=[(0, len(seq))], seq=seq,
                          qual=np.full(len(seq), 30, np.uint8)))
    w.close()
    return draft_fa, fastq, bam


def main_plan():
    """MAIN_READS reads of MAIN_READ_LEN bases placed at random on a
    MAIN_GENOME_LEN synthetic genome: [(name, pos, is_rev)]."""
    rng = np.random.default_rng(2024)
    return [(f"r{i:03d}", int(p), bool(rng.integers(0, 2)))
            for i, p in enumerate(rng.integers(
                0, MAIN_GENOME_LEN - MAIN_READ_LEN, MAIN_READS))]


def main_methylated():
    """Every other read of main_plan(): the reads whose signal the
    call-methylation corpus draws from the cpg model."""
    return {name for i, (name, _, _) in enumerate(main_plan()) if i % 2 == 0}


def build_main_corpus(d, methylated=()):
    """The main paths' inputs under d (build_pipeline over main_plan())."""
    return build_pipeline(d, MAIN_GENOME_LEN, main_plan(), MAIN_READ_LEN,
                          seed=99, methylated=methylated, sort_bam=True)


def timed_run(fn, kernels):
    """Run fn() with the launch counts set to 0 just before it and read
    just after; fail unless each named kernel was launched.  Returns
    (wall seconds, launches)."""
    import torch
    from nanopolish_tpu_torch.utils import cuda_build
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    for name in kernels:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on this path")
    return wall, launches


def phase_eventalign(dev):
    from nanopolish_tpu_torch.apps import eventalign as ea_app

    n_reads, read_len = MAIN_READS, MAIN_READ_LEN
    d = os.path.join(WORK, "main")
    t0 = time.perf_counter()
    ref_fa, fastq, bam = build_main_corpus(d)
    setup_s = time.perf_counter() - t0
    out_path = os.path.join(d, "eventalign.tsv")

    def run():
        with open(out_path, "w") as fh:
            ea_app.main(["-r", fastq, "-b", bam, "-g", ref_fa, "--device",
                         dev.type, "--summary",
                         os.path.join(d, "summary.tsv")], stdout=fh)

    wall, launches, busy_s, top, path_ms = profiled_run(
        run, ("banded_fill", "banded_backtrack", "viterbi_fill",
              "viterbi_backtrack"))
    rows = 0
    bad = 0
    names = set()
    with open(out_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            f = line.rstrip("\n").split("\t")
            rows += 1
            names.add(f[3])
            # 'B' (bad-event) rows carry model kmer NNNNNN, a zero model
            # stdv and hence an infinite standardized level
            cols = (6, 7, 8, 10, 11) if set(f[9]) == {"N"} else \
                (6, 7, 8, 10, 11, 12)
            if len(f) != len(header) or not all(
                    math.isfinite(float(f[i])) for i in cols):
                bad += 1
    if rows == 0 or bad:
        fail(f"main path output: {rows} rows, {bad} malformed")
    if len(names) < n_reads * 0.9:
        fail(f"only {len(names)} of {n_reads} reads were aligned")
    log(f"main path eventalign {n_reads} reads x {read_len} bases on "
        f"{dev.type}: {rows} rows from {len(names)} reads in {wall:.2f} s "
        f"({rows / wall:.0f} rows/s, {n_reads / wall:.2f} reads/s; set-up "
        f"{setup_s:.1f} s; under torch.profiler); card busy {busy_s:.4f} s "
        f"(idle share {1 - busy_s / wall:.4f}), by kernel {json.dumps(top)}; "
        f"launches {json.dumps(launches)}; path ms {json.dumps(path_ms)}")
    return launches, path_ms, (ref_fa, fastq, bam)


def phase_call_methylation(dev):
    from nanopolish_tpu_torch.apps import call_methylation as cm_app

    methylated = main_methylated()
    d = os.path.join(WORK, "main_meth")
    t0 = time.perf_counter()
    ref_fa, fastq, bam = build_main_corpus(d, methylated)
    setup_s = time.perf_counter() - t0
    out_path = os.path.join(d, "methylation.tsv")
    modbam = os.path.join(d, "mods.bam")

    def run():
        with open(out_path, "w") as fh:
            cm_app.main(["-r", fastq, "-b", bam, "-g", ref_fa,
                         "--modbam-output-name", modbam,
                         "--device", dev.type], stdout=fh)

    wall, launches, busy_s, top, path_ms = profiled_run(
        run, ("banded_fill", "banded_backtrack", "forward_fill"))
    llr = {True: [], False: []}
    names = set()
    with open(out_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            f = line.rstrip("\n").split("\t")
            vals = [float(v) for v in f[5:8]]
            if len(f) != len(header) or not all(map(math.isfinite, vals)):
                fail(f"malformed call-methylation row: {line!r}")
            names.add(f[4])
            llr[f[4] in methylated].append(vals[0])
    sites = len(llr[True]) + len(llr[False])
    if len(names) < MAIN_READS * 0.9:
        fail(f"only {len(names)} of {MAIN_READS} reads were called")
    mean_m = float(np.mean(llr[True]))
    mean_u = float(np.mean(llr[False]))
    if not (mean_m > 0 > mean_u):
        fail(f"mean log_lik_ratio {mean_m:.3f} on methylated reads, "
             f"{mean_u:.3f} on the others")
    n_mod = sum(not ln.startswith("@")
                for ln in render_bam(modbam).splitlines())
    if n_mod != MAIN_READS:
        fail(f"modbam holds {n_mod} records for {MAIN_READS} reads")
    log(f"main path call-methylation {MAIN_READS} reads x {MAIN_READ_LEN} "
        f"bases on {dev.type} ({len(methylated)} with methylated signal): "
        f"{sites} sites from {len(names)} reads in {wall:.2f} s "
        f"({sites / wall:.0f} sites/s, {MAIN_READS / wall:.2f} reads/s; "
        f"set-up {setup_s:.1f} s; under torch.profiler); mean log_lik_ratio "
        f"{mean_m:.3f} methylated, {mean_u:.3f} unmethylated; card busy "
        f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.4f}), by kernel "
        f"{json.dumps(top)}; launches {json.dumps(launches)}; path ms "
        f"{json.dumps(path_ms)}")
    return launches, path_ms, (ref_fa, fastq, bam)


def build_phased(d):
    """The phased corpus of tests/test_phase_scorereads_e2e.py:23-82: two
    900-base reads over one SNP, one carrying the alt allele in its
    signal only."""
    from nanopolish_tpu_torch.apps import index as index_app
    from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
    from nanopolish_tpu_torch.io.slow5 import Slow5Writer
    from nanopolish_tpu_torch.io.vcf import Variant, VcfWriter
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
    from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                      synthetic_raw_signal)

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(21)
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    genome_len, read_len, pos0, snp = 1500, 900, 50, 300
    genome = random_sequence(rng, genome_len)
    ref_fa = os.path.join(d, "ref.fa")
    _write_fa(ref_fa, "tig1", genome)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[genome[snp]]
    vcf = os.path.join(d, "vars.vcf")
    with open(vcf, "w") as fh:
        VcfWriter(fh).write_variant(Variant(
            ref_name="tig1", ref_position=snp, ref_seq=genome[snp],
            alt_seq=alt, quality=50, genotype="0/1"))
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "sig.slow5")
    seg = genome[pos0:pos0 + read_len]
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, has_alt in (("hap_alt", True), ("hap_ref", False)):
            i = snp - pos0
            true_seq = seg[:i] + alt + seg[i + 1:] if has_alt else seg
            fq.write(f"@{name}\n{seg}\n+\n{'I' * read_len}\n")
            pa = synthetic_raw_signal(
                rng, true_seq, model, SquiggleScalings.from4(0.0, 1.0, 0.0,
                                                             1.0),
                samples_per_base=10.0, leader=500, trailer=100)
            sw.write(name, _adc(pa), 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = os.path.join(d, "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [genome_len])
    for name in ("hap_alt", "hap_ref"):
        w.write(BamRecord(qname=name, tid=0, pos=pos0, mapq=60,
                          cigar=[(0, read_len)], seq=seg,
                          qual=np.full(read_len, 30, np.uint8),
                          tags={"NM": ("i", 0)}))
    w.close()
    return ref_fa, fastq, bam, vcf


def phase_scorereads_phase(dev, ea_corpus):
    """scorereads on 8 eventalign reads and on build_deletion_corpus's read
    (a chunk of 1,384 kmers: the wide row), and phase-reads on the phased
    corpus, on the card and on the CPU, held to each other under the
    printed-output rule."""
    from nanopolish_tpu_torch.apps import phase_reads as pr_app
    from nanopolish_tpu_torch.apps import scorereads as sc_app
    from nanopolish_tpu_torch.utils.synthetic import build_deletion_corpus

    ref_fa, fastq, bam = ea_corpus
    ref_fa2, fastq2, bam2, vcf = build_phased(os.path.join(WORK, "phase"))
    ref_fa3, fastq3, bam3 = build_deletion_corpus(os.path.join(WORK, "wide"))
    runs = (("scorereads", sc_app, ["-r", fastq, "-b", bam, "-g", ref_fa,
                                    "--max-reads", "8"], False,
             ("banded_fill", "viterbi_fill", "forward_fill")),
            ("scorereads (a 1,384-kmer chunk)", sc_app,
             ["-r", fastq3, "-b", bam3, "-g", ref_fa3], False,
             ("banded_fill", "viterbi_fill", "forward_fill")),
            ("phase-reads", pr_app, ["-r", fastq2, "-b", bam2, "-g", ref_fa2,
                                     vcf], True, ("banded_fill",
                                                  "forward_fill")))
    for name, app, argv, sam, kernels in runs:
        outs = {}
        for d in (dev.type, "cpu"):
            out = io.StringIO()
            wall, launches = timed_run(
                lambda: app.main(argv + ["--device", d], stdout=out),
                kernels if d == dev.type else ())
            outs[d] = out.getvalue()
            log(f"{name} on {d}: {len(outs[d].splitlines())} lines in "
                f"{wall:.2f} s; launches {json.dumps(launches)}")
        assert_agree(outs[dev.type], outs["cpu"],
                     f"{name} on {dev.type} vs the cpu", sam=sam)


def variants_corpus(d, window, n_reads, read_len):
    """tools/perf_e2e_variants.py's corpus: a random truth (seed 41) whose
    draft carries a substitution every 150 bases from 120, polished by
    n_reads evenly staggered reads of read_len true bases."""
    from nanopolish_tpu_torch.utils.synthetic import random_sequence
    rng = np.random.default_rng(41)
    truth = random_sequence(rng, window)
    subs = list(range(120, window - 120, 150))
    draft = list(truth)
    for p in subs:
        draft[p] = SUB[draft[p]]
    draft = "".join(draft)
    span = window - read_len
    reads = [(f"r{i}", truth[pos:pos + read_len], pos)
             for i, pos in ((i, span * i // (n_reads - 1))
                            for i in range(n_reads))]
    return build_variants_corpus(d, rng, draft, reads), truth, draft, subs


def phase_variants(dev, window=VAR_WINDOW, n_reads=VAR_READS,
                   read_len=VAR_READ_LEN):
    """variants --consensus on the 50 kb window, then vcf2fasta; stage
    timers around the pipeline's stages, the card's busy time from
    torch.profiler (CUDA activity only).  Returns the launch counts and
    device ms per kernel."""
    from nanopolish_tpu_torch.alignment.alignment_db import AlignmentDB
    from nanopolish_tpu_torch.apps import variants as va_app
    from nanopolish_tpu_torch.apps import vcf2fasta as v2f_app

    d = os.path.join(WORK, "main_variants")
    t0 = time.perf_counter()
    (draft_fa, fastq, bam), truth, draft, subs = variants_corpus(
        d, window, n_reads, read_len)
    setup_s = time.perf_counter() - t0
    vcf = os.path.join(d, "polished.vcf")
    stages = {}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stages[name] = stages.get(name, 0.0) + time.perf_counter() - t
        return run

    patched = [(AlignmentDB, "load_region"),
               (va_app, "generate_candidate_single_base_edits"),
               (va_app, "screen_variants_by_score"),
               (va_app, "call_haplotype_from_candidates"),
               (va_app, "expand_variants")]
    saved = [getattr(o, a) for o, a in patched]
    for (o, a), fn in zip(patched, saved):
        setattr(o, a, timed(a, fn))

    def run():
        va_app.main(["-r", fastq, "-b", bam, "-g", draft_fa, "-w",
                     f"tig1:0-{window - 1}", "--consensus", "-o", vcf, "-d",
                     "10", "--device", dev.type])

    try:
        wall, launches, busy_s, top, path_ms = profiled_run(
            run, ("banded_fill", "banded_backtrack", "forward_indexed"))
    finally:
        for (o, a), fn in zip(patched, saved):
            setattr(o, a, fn)

    keys = set()
    for line in open(vcf):
        if not line.startswith("#"):
            f = line.split("\t")
            keys.add((int(f[1]) - 1, f[3], f[4]))
    recovered = sum((p, draft[p], truth[p]) in keys for p in subs)
    elsewhere = len(keys) - recovered
    out = io.StringIO()
    v2f_app.main(["-g", draft_fa, vcf], stdout=out)
    polished = out.getvalue().splitlines()[1]
    diff = sum(a != b for a, b in zip(polished, truth)) \
        if len(polished) == len(truth) else None
    log(f"main path variants --consensus {window} bases, {n_reads} reads x "
        f"{read_len} bases on {dev.type} ({card()}): {wall:.2f} s, "
        f"{window / wall:.1f} bases/s (set-up {setup_s:.1f} s); planted "
        f"substitutions recovered {recovered} of {len(subs)}, calls "
        f"elsewhere {elsewhere}; vcf2fasta: {len(polished)} bases, "
        f"{diff} differ from the truth; stages "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; card "
        f"busy {busy_s:.3f} s (idle share {1 - busy_s / wall:.4f}), by "
        f"kernel {json.dumps(top)}; launches {json.dumps(launches)}; path ms "
        f"{json.dumps(path_ms)}")
    if recovered < len(subs) - 2 or elsewhere > 6:
        fail(f"variants recovered {recovered} of {len(subs)} planted "
             f"substitutions with {elsewhere} calls elsewhere")
    if abs(len(polished) - len(truth)) > elsewhere or \
            (diff is not None and diff > len(subs) - recovered + elsewhere):
        fail(f"vcf2fasta: {len(polished)} bases for a {len(truth)}-base "
             f"truth, {diff} differing")
    return launches, path_ms


def card_busy(averages):
    """Seconds of kernel and copy time on the card in a torch.profiler
    run (CUDA activity only; its key_averages()), and the six largest by
    name."""
    busy = {}
    for ev in averages:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            busy[ev.key] = busy.get(ev.key, 0.0) + us / 1e6
    top = {k: round(v, 4) for k, v in
           sorted(busy.items(), key=lambda kv: -kv[1])[:6]}
    return sum(busy.values()), top


def kernel_device_us(averages):
    """Device microseconds and recorded launches of each port kernel
    (cuda_build.KERNELS) in a torch.profiler run (its key_averages()),
    from the CUDA function names: csrc/<name>.cu defines <name>_kernel,
    <name>_warp_kernel<R> or <name>_block_kernel."""
    import re
    from nanopolish_tpu_torch.utils import cuda_build
    out = {name: (0.0, 0) for name in cuda_build.KERNELS}
    for ev in averages:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        m = re.search(r"(\w+)\s*[<(]",
                      ev.key.replace("(anonymous namespace)::", ""))
        if not (us and m):
            continue
        hits = [n for n in cuda_build.KERNELS if m.group(1).startswith(n + "_")]
        if hits:
            name = max(hits, key=len)
            t, n = out[name]
            out[name] = (t + us, n + ev.count)
    return out


def profiled_run(fn, kernels):
    """timed_run under torch.profiler (CUDA activity only).  Returns (wall
    seconds, launches, card busy seconds, the six largest by name, device
    ms per port kernel)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, launches = timed_run(fn, kernels)
    # key_averages() once: it is slow on a path of many launches
    averages = prof.key_averages()
    busy_s, top = card_busy(averages)
    return wall, launches, busy_s, top, {
        name: us / 1e3 for name, (us, _) in kernel_device_us(averages).items()}


def phase_polya(dev):
    """`polya`, then `detect-polyi`, on POLYA_READS direct-RNA reads
    (tools/perf_e2e_polya.py's corpus: seed 43, a 500-nt transcript, a
    planted 120-nt tail, 30 samples/base, 4 kHz, ~19.5k samples per
    read), each with the launch counts reset before it and read after;
    the card's busy time from torch.profiler.  Returns the polya run's
    launch counts and device ms per kernel."""
    from nanopolish_tpu_torch.apps import detect_polyi as dpi_app
    from nanopolish_tpu_torch.apps import polya as polya_app

    d = os.path.join(WORK, "main_polya")
    t0 = time.perf_counter()
    ref_fa, fastq, bam = build_polya_corpus(d, POLYA_READS, 43, "rna",
                                            blow5=True)
    setup_s = time.perf_counter() - t0
    argv = ["-r", fastq, "-b", bam, "-g", ref_fa, "--device", dev.type]
    kernels = ("seg_viterbi_fill", "seg_backtrack", "banded_fill",
               "banded_backtrack")
    outs = {}
    with rna_reads():
        for name, app in (("polya", polya_app), ("detect-polyi", dpi_app)):
            out = io.StringIO()
            wall, launches, busy_s, top, path_ms = profiled_run(
                lambda: app.main(argv, stdout=out), kernels)
            rows = [ln.split("\t") for ln in out.getvalue().splitlines()[1:]]
            outs[name] = (rows, launches, path_ms)
            passed = [f for f in rows if f[-1] == "PASS"]
            tails = [float(f[8]) for f in passed]
            mean_tail = float(np.mean(tails)) if tails else float("nan")
            extra = ""
            if name == "detect-polyi":
                calls = {}
                for f in passed:
                    calls[f[9]] = calls.get(f[9], 0) + 1
                extra = f"; detected on PASS rows {json.dumps(calls)}"
            log(f"main path {name} {POLYA_READS} direct-RNA reads on "
                f"{dev.type} ({card()}): {len(rows)} rows in {wall:.2f} s "
                f"({POLYA_READS / wall:.1f} reads/s; set-up {setup_s:.1f} s); "
                f"QC PASS {len(passed)}, mean tail {mean_tail:.1f} nt "
                f"(planted {POLYA_NT}){extra}; card busy {busy_s:.4f} s "
                f"(idle share {1 - busy_s / wall:.4f}), by kernel "
                f"{json.dumps(top)}; launches {json.dumps(launches)}; path ms "
                f"{json.dumps(path_ms)}")
            if len(rows) != POLYA_READS or any(
                    not all(math.isfinite(float(v)) for v in f[3:9])
                    for f in rows):
                fail(f"{name}: {len(rows)} rows for {POLYA_READS} reads, or "
                     f"a non-finite field")
            if len(passed) < 0.9 * POLYA_READS or \
                    not 100.0 <= mean_tail <= 140.0:
                fail(f"{name}: {len(passed)} of {POLYA_READS} reads PASS, "
                     f"mean tail {mean_tail:.1f} nt for a {POLYA_NT}-nt tail")
    bad = [f for f in outs["detect-polyi"][0]
           if f[-1] == "PASS" and f[9] not in ("POLYA-ONLY", "NONE")]
    if bad:
        fail(f"detect-polyi called {len(bad)} pure poly(A) tails otherwise, "
             f"e.g. {bad[0]}")
    return outs["polya"][1:]


# ------------------------------------------------------- phase 6: training --

def train_genome() -> str:
    """The 100 kb genome build_pipeline draws first from TRAIN_SEED."""
    from nanopolish_tpu_torch.utils.synthetic import random_sequence
    return random_sequence(np.random.default_rng(TRAIN_SEED), MAIN_GENOME_LEN)


def predicted_trainable(min_events=None, n_reads=None):
    """M-kmers of the training corpus that at least min_events interior
    read positions cover (each read's kmers in its own orientation, five
    rows off either end): a prediction of the kmers methyltrain trains
    before any signal exists, counting one used event per position."""
    from nanopolish_tpu_torch.utils.alphabet import (DNA_ALPHABET,
                                                     METHYL_CPG_ALPHABET)
    min_events = TRAIN_MIN_EVENTS if min_events is None else min_events
    genome = train_genome()
    counts = np.zeros(METHYL_CPG_ALPHABET.num_strings(6), np.int64)
    for _, pos, is_rev in main_plan()[:n_reads]:
        seg = genome[pos:pos + MAIN_READ_LEN]
        read = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
        ranks = METHYL_CPG_ALPHABET.seq_to_kmer_ranks(
            METHYL_CPG_ALPHABET.methylate(read), 6)
        np.add.at(counts, ranks[6:-6], 1)
    is_m = np.array(["M" in k for k in METHYL_CPG_ALPHABET.all_kmers(6)])
    return int(((counts >= min_events) & is_m).sum())


def build_train_corpus(d):
    """MAIN_READS reads x MAIN_READ_LEN bases of cpg-methylated signal from
    the 100 kb genome, the methylated genome as reference, built as
    tests/test_methyltrain_e2e.py:25-80 builds its corpus (signal from the
    true cpg model over the methylated read, no scaling, leader 450,
    trailer 90); the start model is the cpg model with its M-kmer means
    raised by TRAIN_PERTURB, named in a fofn.  Returns (argv of the
    inputs, the true model, the M-kmer mask)."""
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    plan = main_plan()
    ref_fa, fastq, bam = build_pipeline(
        d, MAIN_GENOME_LEN, plan, MAIN_READ_LEN, seed=TRAIN_SEED, shift=0.0,
        scale=1.0, methylated={name for name, _, _ in plan}, sort_bam=True,
        meth_ref=True, leader=450, trailer=90)
    true_cpg = PoreModelSet.instance().get_model(*CPG_KEY)
    is_m = np.array(["M" in true_cpg.alphabet.rank_to_kmer(r, 6)
                     for r in range(true_cpg.num_states)])
    start = true_cpg.level_mean.copy()
    start[is_m] += TRAIN_PERTURB
    model_path = os.path.join(d, "start.model")
    true_cpg.with_states(start, true_cpg.level_stdv.copy()).write(
        model_path, "r9.4_450bps.cpg.6mer.template.start")
    fofn = os.path.join(d, "models.fofn")
    with open(fofn, "w") as fh:
        fh.write(model_path + "\n")
    return (["-r", fastq, "-b", bam, "-g", ref_fa, "-m", fofn],
            true_cpg, is_m)


def run_methyltrain(argv, d, dev_type, fn_wrap=None):
    """methyltrain's main in directory d on dev_type, the pore models reset
    before and after.  Returns (stdout, [(round end time, kmers trained,
    integer columns of every kmer, trained means, trained stdvs)], the
    trained model, the start time, what fn_wrap returned).  fn_wrap(run)
    may wrap the call (the profiled or timed run)."""
    from nanopolish_tpu_torch.apps import methyltrain as mt_app
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    os.makedirs(d, exist_ok=True)
    real = mt_app.retrain_model_from_events
    rounds = []
    out = io.StringIO()
    box = {}

    def retrain(model, summaries, *a, **k):
        res = real(model, summaries, *a, **k)
        if dev_type == "cuda":
            import torch
            torch.cuda.synchronize()
        rounds.append((time.perf_counter(), res[1], np.array(
            [(x.num_matches, x.num_skips, x.num_stays, len(x.events))
             for x in summaries]), res[0].level_mean, res[0].level_stdv))
        return res

    def run():
        box["t0"] = time.perf_counter()
        with contextlib.chdir(d):
            mt_app.main(argv + ["--device", dev_type], stdout=out)

    mt_app.retrain_model_from_events = retrain
    PoreModelSet.reset()
    try:
        wrapped = fn_wrap(run) if fn_wrap is not None else run()
        trained = PoreModelSet.instance().get_model(*CPG_KEY)
    finally:
        mt_app.retrain_model_from_events = real
        PoreModelSet.reset()
    return out.getvalue(), rounds, trained, box["t0"], wrapped


def summary_rows(d):
    with open(os.path.join(d, "methyltrain.summary")) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh][1:]


def phase_methyltrain(dev, inputs, true_cpg, is_m, setup_s):
    """Part 1: methyltrain at full width (15,625 cpg 6-mers, MAX_EVENTS
    1,000) on MAIN_READS reads x 8 kb (build_train_corpus), -c
    --output-scores, TRAIN_ROUNDS rounds, under torch.profiler; the
    recovery rule of tests/test_methyltrain_e2e.py.  Returns the launches
    and device ms per kernel."""
    d = os.path.join(WORK, "train")
    argv = inputs + ["-c", "--output-scores", "--rounds", str(TRAIN_ROUNDS),
                     "--min-events", str(TRAIN_MIN_EVENTS)]
    out, rounds, trained, start, prof = run_methyltrain(
        argv, os.path.join(d, "run"), dev.type,
        lambda run: profiled_run(run, TRAIN_KERNELS))
    wall, launches, busy_s, top, path_ms = prof
    ends = [start] + [r[0] for r in rounds]
    round_s = [round(b - a, 3) for a, b in zip(ends, ends[1:])]
    n_trained = [r[1] for r in rounds]
    rows = summary_rows(os.path.join(d, "run"))
    ranks = [true_cpg.alphabet.kmer_rank(f[1], 6) for f in rows
             if f[6] == "1" and "M" in f[1]]
    err_after = float(np.mean(np.abs(trained.level_mean[ranks] -
                                     true_cpg.level_mean[ranks]))) \
        if ranks else float("nan")
    scores = [ln.split() for ln in out.splitlines()]
    bad = [f for f in scores if len(f) != 6 or
           f[4] not in ("Original", "Rescaled", "Delta")]
    values = np.array([float(f[5]) for f in scores if len(f) == 6])
    m_trained = [int((r[2][is_m, 3] >= TRAIN_MIN_EVENTS).sum())
                 for r in rounds]
    log(f"training path methyltrain {MAIN_READS} reads x {MAIN_READ_LEN} "
        f"bases on {dev.type} ({card()}): {TRAIN_ROUNDS} rounds in "
        f"{wall:.2f} s (set-up {setup_s:.1f} s; under torch.profiler), "
        f"round walls s {json.dumps(round_s)}, reads/s per round "
        f"{json.dumps([round(MAIN_READS / r, 2) for r in round_s])}, "
        f"{TRAIN_ROUNDS / wall:.4f} rounds/s; kmers trained per round "
        f"{json.dumps(n_trained)}, of them M-kmers {json.dumps(m_trained)} "
        f"(predicted {predicted_trainable()} from the corpus); the last "
        f"round's {len(ranks)} M-kmers' mean error {err_after:.3f} pA after "
        f"a {TRAIN_PERTURB} pA perturbation; {len(scores)} score lines, "
        f"{int((~np.isfinite(values)).sum())} of them not finite (reads "
        f"whose recalibration diverged); card busy {busy_s:.4f} s (idle share "
        f"{1 - busy_s / wall:.4f}), by kernel {json.dumps(top)}; launches "
        f"{json.dumps(launches)}; path ms {json.dumps(path_ms)}")
    if len(ranks) < TRAIN_MIN_M_KMERS or \
            not err_after < 0.6 * TRAIN_PERTURB:
        fail(f"methyltrain trained {len(ranks)} M-kmers to a mean error of "
             f"{err_after:.3f} pA (rule: >= {TRAIN_MIN_M_KMERS} kmers, "
             f"< {0.6 * TRAIN_PERTURB} pA)")
    if bad or len(scores) < 3 * TRAIN_ROUNDS * MAIN_READS * 0.9:
        fail(f"methyltrain --output-scores: {len(scores)} lines, "
             f"{len(bad)} malformed")
    for name in TRAIN_KERNELS:
        if not path_ms[name] > 0.0:
            fail(f"torch.profiler shows no device time for {name} on the "
                 f"methyltrain path ({launches[name]} launches)")
    return launches, path_ms


def subset_argv(inputs):
    """methyltrain's arguments for the card-against-cpu subset."""
    return inputs + ["-c", "--output-scores", "--rounds",
                     str(TRAIN_SUBSET_ROUNDS), "--min-events",
                     str(TRAIN_SUBSET_MIN_EVENTS), "--max-reads",
                     str(TRAIN_SUBSET)]


def start_cpu_subset(inputs):
    """Start the subset's --device cpu run in a second process (this
    script with --cpu-subset DIR), so that it runs beside the card's
    phase 6; it is killed if this process exits first."""
    import atexit
    d = os.path.join(WORK, "train_subset")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "argv.json"), "w") as fh:
        json.dump(subset_argv(inputs), fh)
    with open(os.path.join(d, "cpu_run.log"), "w") as logf:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--cpu-subset", d], stdout=logf,
                                stderr=subprocess.STDOUT, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def cpu_subset_run(d) -> int:
    """--cpu-subset DIR: the subset's methyltrain run on the cpu, its
    outputs saved under DIR for the main process."""
    import torch
    sys.path.insert(0, ROOT)
    os.nice(10)
    torch.set_num_threads(CPU_SUBSET_THREADS)
    with open(os.path.join(d, "argv.json")) as fh:
        argv = json.load(fh)
    t0 = time.perf_counter()
    out, rounds, trained, _, _ = run_methyltrain(
        argv, os.path.join(d, "cpu"), "cpu")
    np.savez(os.path.join(d, "cpu_result.npz"),
             n=np.array([r[1] for r in rounds]),
             ints=np.stack([r[2] for r in rounds]),
             mean=np.stack([r[3] for r in rounds]),
             stdv=np.stack([r[4] for r in rounds]),
             final_mean=trained.level_mean, final_stdv=trained.level_stdv,
             seconds=time.perf_counter() - t0)
    with open(os.path.join(d, "cpu_stdout.txt"), "w") as fh:
        fh.write(out)
    return 0


def model_diff(mean_a, stdv_a, mean_b, stdv_b):
    """(max |d mean|, max relative d stdv, means that differ) of two trained
    models; a value that is not finite must be so in both (else inf)."""
    fin = np.isfinite(mean_b) & np.isfinite(stdv_b)
    if not np.array_equal(fin, np.isfinite(mean_a) & np.isfinite(stdv_a)):
        return float("inf"), float("inf"), int((~fin).sum())
    dm = np.abs(mean_a[fin] - mean_b[fin])
    ds = np.abs(stdv_a[fin] - stdv_b[fin]) / stdv_b[fin]
    return (float(dm.max(initial=0.0)), float(ds.max(initial=0.0)),
            int((dm > 0).sum()))


def phase_training_subset(dev, inputs, cpu_proc, ea_corpus):
    """Part 2: methyltrain on TRAIN_SUBSET of the reads, card against
    --device cpu (integer columns identical every round, trained values
    within the EM tolerance, score lines under the printed-output rule);
    train-poremodel-from-basecalls on the card on the eventalign corpus's
    reads and on MAIN_READS short reads of one stretch (its bootstrapped
    levels against the model that made the signal), and on TRAIN_SUBSET
    of the short reads card against cpu (byte-identical models).  Returns
    the eventalign-corpus run's launches and device ms per kernel."""
    from nanopolish_tpu_torch.apps import train_poremodel_from_basecalls as tp
    from nanopolish_tpu_torch.models.pore_model import (PoreModel,
                                                        PoreModelSet)
    d = os.path.join(WORK, "train_subset")
    t0 = time.perf_counter()
    g_out, g_rounds, g_model, _, launches = run_methyltrain(
        subset_argv(inputs), os.path.join(d, dev.type), dev.type,
        lambda run: timed_run(run, TRAIN_KERNELS)[1])
    log(f"methyltrain {TRAIN_SUBSET} reads, {TRAIN_SUBSET_ROUNDS} rounds on "
        f"{dev.type}: {time.perf_counter() - t0:.2f} s, kmers trained "
        f"{json.dumps([r[1] for r in g_rounds])}; launches "
        f"{json.dumps(launches)}")
    t0 = time.perf_counter()
    if cpu_proc.wait() != 0:
        with open(os.path.join(d, "cpu_run.log")) as fh:
            fail(f"the subset's cpu run failed:\n{fh.read()[-4000:]}")
    c = np.load(os.path.join(d, "cpu_result.npz"))
    with open(os.path.join(d, "cpu_stdout.txt")) as fh:
        c_out = fh.read()
    log(f"methyltrain {TRAIN_SUBSET} reads, {TRAIN_SUBSET_ROUNDS} rounds on "
        f"cpu (a second process at nice 10, {CPU_SUBSET_THREADS} torch "
        f"threads, beside the card's phase 6): {float(c['seconds']):.2f} s, "
        f"waited "
        f"{time.perf_counter() - t0:.2f} s for it; kmers trained "
        f"{json.dumps(c['n'].tolist())}")
    if len(g_rounds) != TRAIN_SUBSET_ROUNDS or len(c["n"]) != len(g_rounds):
        fail("methyltrain subset: rounds missing")
    diffs = []
    for r, g in enumerate(g_rounds):
        if not np.array_equal(g[2], c["ints"][r]) or g[1] != c["n"][r]:
            fail(f"methyltrain round {r}: integer columns differ on "
                 f"{int((g[2] != c['ints'][r]).any(1).sum())} kmers, card "
                 f"vs cpu")
        diffs.append(model_diff(g[3], g[4], c["mean"][r], c["stdv"][r]))
    dm, ds, _ = model_diff(g_model.level_mean, g_model.level_stdv,
                           c["final_mean"], c["final_stdv"])
    rep = assert_agree(g_out, c_out, f"methyltrain --output-scores on "
                                     f"{dev.type} vs the cpu")
    log(f"methyltrain subset card vs cpu: integer columns identical in "
        f"{len(g_rounds)} rounds; trained values by round (max |d mean| pA, "
        f"max rel d stdv, means differing) {json.dumps(diffs)}; final model "
        f"{dm:.3g} pA, {ds:.3g}; {rep['rows']} score lines, {rep['differ']} "
        f"differ")
    if dm > EM_MEAN_ATOL or ds > EM_STDV_RTOL or any(
            a > EM_MEAN_ATOL or b > EM_STDV_RTOL for a, b, _ in diffs):
        fail(f"methyltrain trained values differ beyond the EM tolerance "
             f"({EM_MEAN_ATOL} pA, {EM_STDV_RTOL} relative)")
    if rep["rows"] < 3 * TRAIN_SUBSET_ROUNDS * TRAIN_SUBSET * 0.9:
        fail(f"methyltrain subset printed {rep['rows']} score lines")

    # train-poremodel-from-basecalls on the eventalign corpus's reads, and
    # on short reads of one stretch, where its bootstrap takes hold
    d = os.path.join(WORK, "train_poremodel")
    _, short_fastq, _ = build_pipeline(
        os.path.join(d, "short"), TP_SHORT_LEN, tp_short_plan(MAIN_READS),
        TP_SHORT_LEN, seed=99)
    truth = PoreModelSet.instance().get_model(*NUC_KEY)
    for corpus, fastq, bound in (
            (f"{MAIN_READS} reads x {MAIN_READ_LEN} bases (eventalign)",
             ea_corpus[1], None),
            (f"{MAIN_READS} reads x {TP_SHORT_LEN} bases of one stretch",
             short_fastq, TP_LEVEL_MAX)):
        path = os.path.join(d, f"{len(corpus)}.model")
        wall, launches, busy_s, top, path_ms = profiled_run(
            lambda: tp.main(["-r", fastq, "--rounds", str(TP_ROUNDS), "-o",
                             path, "--device", dev.type]),
            ("banded_fill", "banded_backtrack"))
        m = PoreModel.from_file(path)
        upd = m.level_stdv != 2.5
        med = float(np.median(np.abs(m.level_mean[upd] -
                                     truth.level_mean[upd]))) \
            if upd.any() else float("nan")
        log(f"training path train-poremodel-from-basecalls {corpus}, "
            f"{TP_ROUNDS} rounds on {dev.type} ({card()}): {wall:.2f} s "
            f"(under torch.profiler), {TP_ROUNDS / wall:.4f} rounds/s; "
            f"{int(upd.sum())} of {upd.size} kmers updated, median |level - "
            f"builtin| over them {med:.3f} pA (bound {bound} pA); card busy "
            f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.4f}), by kernel "
            f"{json.dumps(top)}; launches {json.dumps(launches)}; path ms "
            f"{json.dumps(path_ms)}")
        for name in ("banded_fill", "banded_backtrack"):
            if not path_ms[name] > 0.0:
                fail(f"torch.profiler shows no device time for {name} on "
                     f"the train-poremodel path")
        if bound is None:
            # on 8 kb reads no read passes the banded QC under the start
            # model, so no kmer updates and the model file is the start
            # model whatever the alignments (as in the JAX app,
            # tools/train_poremodel_levels.py --reads 8 --read-len 8000
            # --genome-len 100000); card and cpu are compared below
            ea_launches, ea_ms = launches, path_ms
            continue
        if not med <= bound or upd.sum() < TP_SHORT_MIN_UPDATED:
            fail(f"train-poremodel updated {int(upd.sum())} kmers, median "
                 f"|level - builtin| {med:.3f} pA (bound {bound} pA)")
        files = {}
        for dt in (dev.type, "cpu"):
            files[dt] = os.path.join(d, f"subset_{len(corpus)}_{dt}.model")
            t0 = time.perf_counter()
            tp.main(["-r", fastq, "--rounds", str(TP_ROUNDS), "--max-reads",
                     str(TRAIN_SUBSET), "-o", files[dt], "--device", dt])
            log(f"train-poremodel {TRAIN_SUBSET} of the {corpus} on {dt}: "
                f"{time.perf_counter() - t0:.2f} s")
        with open(files[dev.type], "rb") as a, open(files["cpu"], "rb") as b:
            if a.read() != b.read():
                fail(f"train-poremodel model files differ, card vs cpu, on "
                     f"{TRAIN_SUBSET} of the {corpus}")
        log(f"train-poremodel {TRAIN_SUBSET} of the {corpus}: model files "
            f"byte-identical, card vs cpu")
    return ea_launches, ea_ms


def tp_short_plan(n):
    """n reads of the whole TP_SHORT_LEN-base genome, random strands (the
    plan of tools/train_poremodel_levels.py at --read-len 400
    --genome-len 400)."""
    rng = np.random.default_rng(2024)
    return [(f"r{i:03d}", int(pos), bool(rng.integers(0, 2)))
            for i, pos in enumerate(rng.integers(0, 1, n))]


EM_SEED = 7


def em_inputs(R=EM_R, N=EM_N, seed=EM_SEED):
    """Full-shape EM inputs as methyltrain makes them: per-kmer event
    counts 1-N (a random mask of tails), levels around each kmer's mean
    with 5% from a component 4 pA lower, scaled read variances 0.9-1.2,
    the second component disabled on every third kmer."""
    rng = np.random.default_rng(seed)
    mu_t = rng.uniform(60, 120, R).astype(np.float32)
    n = rng.integers(1, N + 1, R)
    mask = np.arange(N)[None, :] < n[:, None]
    svar = rng.uniform(0.9, 1.2, (R, N)).astype(np.float32)
    low = rng.random((R, N)) < 0.05
    levels = (mu_t[:, None] - 4.0 * low + rng.standard_normal(
        (R, N), np.float32) * 2.0 * svar).astype(np.float32)
    levels[~mask] = 1.0
    svar[~mask] = 1.0
    logw = np.tile(np.log([0.95, 0.05]).astype(np.float32), (R, 1))
    logw[::3] = (0.0, -np.inf)
    mu0 = np.stack([mu_t + 4.0, mu_t - 4.0], 1).astype(np.float32)
    sd0 = np.tile(np.array([2.0, 2.5], np.float32), (R, 1))
    return levels, svar, mask, logw, mu0, sd0


# f64 operations of one EM iteration per (kmer, event, component), as
# ops/mixture_em.train_gaussian_mixture_batched does them: the component
# width (1), z (2), the log density (a log and four) (5), the weighted
# numerator (1), the logsumexp over components (max, subtract, exp, add,
# and its log and add shared by the components) (5), the responsibility
# (subtract, exp, select) (3), the three sums (3), resp * x (1), the
# deviation (2) and resp * dev * dev (2)
EM_OPS = 1 + 2 + 5 + 1 + 5 + 3 + 3 + 1 + 2 + 2
# H100 SXM fp64 outside the tensor cores (NVIDIA's data sheet)
PEAK_F64_FLOPS = 34e12


def phase_em(dev):
    """Part 3: the mixture EM alone at full shape on the card and on the
    CPU port, the same inputs; its time by CUDA events beside its bound."""
    import torch
    from nanopolish_tpu_torch.ops.mixture_em import \
        train_gaussian_mixture_batched as em
    x = em_inputs()
    R, N = x[0].shape
    t0 = time.perf_counter()
    want = em(*x, device="cpu")
    cpu_s = time.perf_counter() - t0
    xd = [torch.as_tensor(a, device=dev) for a in x]
    ms = cuda_ms(lambda: em(*xd, device=dev))
    got = em(*xd, device=dev)
    dm = float((got.means.cpu() - want.means).abs().max())
    ds = float(((got.stdvs.cpu() - want.stdvs).abs() / want.stdvs).max())
    dw = max_abs_err(got.log_weights.cpu(), want.log_weights)
    same = float((got.means.cpu() == want.means).float().mean())
    nbytes = R * N * (4 + 4 + 1) + 6 * R * 2 * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = EM_OPS * R * N * 2 * 10 / PEAK_F64_FLOPS * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    log(f"mixture EM [{R} kmers x {N} events x 2 components], 10 iterations "
        f"({card()}): card {ms:.3f} ms (CUDA events, mean of 3), cpu "
        f"{cpu_s:.2f} s; bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms "
        f"at {PEAK_BYTES / 1e12} TB/s, f64 operations {t_ops:.4f} ms at "
        f"{PEAK_F64_FLOPS / 1e12} TFLOP/s); card vs cpu max |d mean| {dm:.3g} "
        f"pA, max rel d stdv {ds:.3g}, max |d log weight| {dw:.3g}, means "
        f"bit-identical {same:.6f}")
    if dm > EM_MEAN_ATOL or ds > EM_STDV_RTOL or not math.isfinite(dw) or \
            dw > EM_MEAN_ATOL:
        fail("mixture EM: card and cpu differ beyond the EM tolerance")


# ------------------------------------------------------------------- main --

# ------------------------------------------------------- multi-process --

def table_rows(text: str) -> list:
    return [ln for ln in text.splitlines()[1:] if ln]


def shard_union(texts, want: set, what: str) -> None:
    """Fail unless the shards' rows are the single-process run's rows
    (``want``), with no row in two shards
    (tests/test_distributed.py:102-112's rule)."""
    union = set()
    for t in texts:
        rows = table_rows(t)
        r = set(rows)
        if len(r) != len(rows) or union & r:
            fail(f"{what}: a row repeats within or across shards")
        union |= r
    if union != want:
        fail(f"{what}: the shards hold {len(union)} rows, the "
             f"single-process run {len(want)}; {len(union ^ want)} differ")


def launch_shards(argv, n, d, name):
    """``parallel.launch -n n`` of a subcommand, every child on its own
    ``--shard {i}/{n}`` and stdout file; (wall of launch.main, stdout
    texts)."""
    from nanopolish_tpu_torch.parallel import launch
    pattern = os.path.join(d, f"{name}.{n}.{{i}}.out")
    t0 = time.perf_counter()
    rc = launch.main(["-n", str(n), "--stdout", pattern, "--", *argv,
                      "--shard", "{i}/{n}"], timeout=PAR_CHILD_TIMEOUT)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"parallel.launch -n {n} {name}: a child exited with {rc}")
    return wall, [open(pattern.replace("{i}", str(i))).read()
                  for i in range(n)]


def phase_parallel_serving(dev, meth_corpus, ea_corpus):
    """Sharded call-methylation (N = PAR_CM_PROCS) and eventalign
    --summary (N = PAR_EA_PROCS) through parallel.launch, each child on
    ``dev``, held to phase 6's single-process outputs."""
    ref_fa, fastq, bam = meth_corpus
    d = os.path.join(WORK, "parallel")
    os.makedirs(d, exist_ok=True)
    single = set(table_rows(open(os.path.join(
        WORK, "main_meth", "methylation.tsv")).read()))
    out = {"call-methylation": {}, "eventalign": {}}
    for n in PAR_CM_PROCS:
        wall, texts = launch_shards(
            ["call-methylation", "-r", fastq, "-b", bam, "-g", ref_fa,
             "--device", dev.type], n, d, "call-methylation")
        shard_union(texts, single, f"call-methylation over {n} processes")
        out["call-methylation"][n] = {
            "wall_s": wall, "sites": len(single),
            "sites_per_s": len(single) / wall}
        log(f"parallel call-methylation, {n} process(es) on one card: "
            f"{len(single)} sites in {wall:.2f} s "
            f"({len(single) / wall:.1f} sites/s; the wall of launch.main)")
    ref_fa, fastq, bam = ea_corpus
    single = set(table_rows(open(os.path.join(
        WORK, "main", "eventalign.tsv")).read()))
    single_sum = set(table_rows(open(os.path.join(
        WORK, "main", "summary.tsv")).read()))
    n = PAR_EA_PROCS
    summary = os.path.join(d, f"summary.{n}.{{i}}.tsv")
    wall, texts = launch_shards(
        ["eventalign", "-r", fastq, "-b", bam, "-g", ref_fa, "--device",
         dev.type, "--summary", summary], n, d, "eventalign")
    shard_union(texts, single, f"eventalign over {n} processes")
    shard_union([open(summary.replace("{i}", str(i))).read()
                 for i in range(n)], single_sum,
                f"eventalign --summary over {n} processes")
    out["eventalign"][n] = {"wall_s": wall, "rows": len(single),
                            "rows_per_s": len(single) / wall}
    log(f"parallel eventalign --summary, {n} processes on one card: "
        f"{len(single)} rows in {wall:.2f} s ({len(single) / wall:.0f} "
        f"rows/s; the wall of launch.main)")
    return out


def train_step_batch(ea_corpus, dev, d) -> str:
    """The train step's inputs: the eventalign corpus's reads as ingest
    detects their events, each against its basecall's kmer ranks, and the
    r9.4_450bps nucleotide 6-mer table; saved as d/batch.npz."""
    from nanopolish_tpu_torch.io.readdb import ReadDB
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.models.read_loader import load_squiggle_reads
    from nanopolish_tpu_torch.parallel import TrainBatch, pad_batch_to_multiple
    _, fastq, _ = ea_corpus
    db = ReadDB()
    db.load(fastq)
    names = [name for name, _, _ in main_plan()]
    reads = load_squiggle_reads(names, db, device=dev)
    model = PoreModelSet.instance().get_model(*NUC_KEY)
    events = [reads[n].events[0] if n in reads and reads[n].has_events_for_strand(0)
              else None for n in names]
    ranks = [model.alphabet.seq_to_kmer_ranks(reads[n].read_sequence, model.k)
             if n in reads else np.zeros(0, np.int64) for n in names]
    B = len(names)
    T = max(len(e) for e in events if e is not None)
    K = max(len(r) for r in ranks)
    ev_mean = np.zeros((B, T), np.float32)
    ev_time = np.zeros((B, T), np.float32)
    n_events = np.zeros(B, np.int32)
    rank_mat = np.zeros((B, K), np.int32)
    n_kmers = np.zeros(B, np.int32)
    for b, (e, r) in enumerate(zip(events, ranks)):
        if e is not None:
            n_events[b] = len(e)
            ev_mean[b, :len(e)] = e.mean
            ev_time[b, :len(e)] = e.start_time
        rank_mat[b, :len(r)] = r
        n_kmers[b] = len(r)
    arrays, _ = pad_batch_to_multiple(
        [ev_mean, ev_time, n_events, rank_mat, n_kmers],
        max(dp for dp, _ in PAR_MESHES))
    path = os.path.join(d, "batch.npz")
    np.savez(path, level_mean=model.level_mean.astype(np.float32),
             level_stdv=model.level_stdv.astype(np.float32),
             n_ranks=model.num_states,
             **dict(zip(TrainBatch._fields, arrays)))
    log(f"train step batch: {B} reads, {int(n_events.sum())} events "
        f"(T {T}), {int(n_kmers.sum())} kmers (K {K}), {model.num_states} "
        f"kmer states; {int(np.sum(n_events == 0))} reads without events")
    return path


def train_step_rank(d: str, mp: int, device: str) -> int:
    """--train-step-rank DIR MP DEVICE: one rank of the train step on a
    (n / MP, MP) mesh, n and the rank from the launcher's NPT_* env; one
    process joins a one-rank group itself.  Two steps (the second timed
    with the launch counts set to 0 before it); results under DIR, and
    the one process's Forward inputs and scores of its PAR_FWD_READS
    longest reads (DIR/forward_inputs.npz)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from nanopolish_tpu_torch.parallel import (TrainBatch, make_mesh,
                                               make_train_step, shard_model,
                                               shard_reads)
    from nanopolish_tpu_torch.parallel import train_step as ts
    from nanopolish_tpu_torch.parallel.distributed import (auto_init, join,
                                                           process_env)
    from nanopolish_tpu_torch.utils import cuda_build
    pid, n = process_env()
    if n == 1:
        join(os.environ["NPT_COORDINATOR"], 1, 0, device)
    else:
        auto_init(device=device)
    a = np.load(os.path.join(d, "batch.npz"))
    mesh = make_mesh(mp)
    step = make_train_step(mesh, int(a["n_ranks"]), device=device)
    level_mean, level_stdv = shard_model(mesh, a["level_mean"],
                                         a["level_stdv"])
    batch = TrainBatch(*shard_reads(mesh, *(a[f] for f in
                                            TrainBatch._fields)))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    forward, seen = ts.forward_scores, {}

    def recorded(x):
        seen.update(x, lp=forward(x))
        return seen["lp"]

    ts.forward_scores = recorded
    walls = []
    for _ in range(2):
        dist.barrier()
        sync()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        res = step(level_mean, level_stdv, batch)
        sync()
        walls.append(time.perf_counter() - t0)
    np.savez(os.path.join(d, f"{n // mp}x{mp}.rank{pid}.npz"),
             level_mean=res.level_mean.cpu().numpy(),
             level_stdv=res.level_stdv.cpu().numpy(),
             loss=res.loss.cpu().numpy(), n_scored=res.n_scored.cpu().numpy(),
             model_index=mesh.model_index, walls=np.array(walls),
             backend=dist.get_backend(),
             launches=json.dumps(dict(cuda_build.LAUNCHES)))
    if n == 1:
        idx = torch.argsort(seen["n_events"], descending=True)[:PAR_FWD_READS]
        np.savez(os.path.join(d, "forward_inputs.npz"),
                 **{k: seen[k][idx].cpu().numpy() for k in FWD_ARGS + ("lp",)})
    return 0


def run_train_mesh(d, dp, mp, dev):
    """The train step on a dp x mp mesh of processes (this script with
    --train-step-rank); the ranks' results, each kernel of the step
    launched in every rank."""
    from nanopolish_tpu_torch.parallel.launch import free_port
    n = dp * mp
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for i in range(n):
        env = dict(os.environ, NPT_COORDINATOR=coord, NPT_NUM_PROCS=str(n),
                   NPT_PROC_ID=str(i))
        with open(os.path.join(d, f"{dp}x{mp}.rank{i}.log"), "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--train-step-rank", d, str(mp), dev.type], env=env,
                stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.perf_counter() + PAR_CHILD_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(d, f"{dp}x{mp}.rank{i}.log")) as fh:
                tail = fh.read()[-3000:]
            fail(f"train step {dp}x{mp}: rank {i} exited with "
                 f"{p.returncode}:\n{tail}")
    ranks = [dict(np.load(os.path.join(d, f"{dp}x{mp}.rank{i}.npz")))
             for i in range(n)]
    for i, r in enumerate(ranks):
        launches = json.loads(str(r["launches"]))
        for name in PAR_KERNELS:
            if launches[name] <= 0:
                fail(f"train step {dp}x{mp}: rank {i} launched no {name}")
    return ranks


def mesh_model(ranks, mp):
    """The full table of a mesh's result (data row 0's model shards);
    fail unless every rank of a model column holds the same shard and
    every rank the same loss and n_scored."""
    by_m = {}
    for r in ranks:
        by_m.setdefault(int(r["model_index"]), []).append(r)
    for rows in by_m.values():
        for r in rows[1:]:
            if not (np.array_equal(r["level_mean"], rows[0]["level_mean"])
                    and np.array_equal(r["level_stdv"],
                                       rows[0]["level_stdv"])):
                fail("train step: two data ranks disagree on a model shard")
    for r in ranks:
        if int(r["n_scored"]) != int(ranks[0]["n_scored"]) or \
                float(r["loss"]) != float(ranks[0]["loss"]):
            fail("train step: the ranks disagree on the loss or n_scored")
    return (np.concatenate([by_m[m][0]["level_mean"] for m in range(mp)]),
            np.concatenate([by_m[m][0]["level_stdv"] for m in range(mp)]))


def step_forward_check(d, dev):
    """forward_fill on the 1 x 1 step's own Forward inputs of its
    PAR_FWD_READS longest reads (whole reads, the step's kmer width),
    bit for bit against forward_fill_plain on the same card tensors and
    against the step's scores."""
    import torch
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    a = np.load(os.path.join(d, "forward_inputs.npz"))
    args = [torch.as_tensor(a[k], device=dev) for k in FWD_ARGS]
    got = pf.forward_fill(*args)
    plain_ms, ref = once_ms(lambda: ph.forward_fill_plain(*args))
    kp = args[2].shape[1]
    what = (f"the train step's Forward ({len(got)} whole reads of up to "
            f"{int(a['n_events'].max())} events and {int(a['n_kmers'].max())}"
            f" kmers, kmer width {kp}, {layout_name(kp)})")
    if not bits_equal(got, ref):
        fail(f"forward_fill differs from the plain version on {what}: max "
             f"abs err {max_abs_err(got, ref)} nats")
    if not bits_equal(got.cpu(), torch.as_tensor(a["lp"])):
        fail(f"forward_fill on {what} differs from the step's own scores")
    ms = cuda_ms(lambda: pf.forward_fill(*args))
    log(f"forward on {what}: bit-identical to plain and to the step; kernel "
        f"{ms:.4f} ms (plain {plain_ms:.1f} ms)")
    return {"reads": len(got), "events": int(a["n_events"].max()),
            "kmer_width": kp, "layout": layout_name(kp), "ms": ms,
            "plain_ms": plain_ms}


def phase_parallel_train(dev, ea_corpus):
    """The train step at full table width on each mesh of PAR_MESHES,
    the meshes held to each other."""
    d = os.path.join(WORK, "train_step")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    a = np.load(train_step_batch(ea_corpus, dev, d))
    setup_s = time.perf_counter() - t0
    results = {}
    for dp, mp in PAR_MESHES:
        t0 = time.perf_counter()
        ranks = run_train_mesh(d, dp, mp, dev)
        mean, stdv = mesh_model(ranks, mp)
        results[(dp, mp)] = (ranks, mean, stdv, time.perf_counter() - t0)
    (r1, m1, s1, _), (r2, m2, s2, _) = (results[k] for k in PAR_MESHES)
    trained = np.nonzero(m1 != a["level_mean"])[0]
    rows = len(m1) // max(mp for _, mp in PAR_MESHES)
    if set(trained // rows) != set(range(len(m1) // rows)):
        fail(f"train step: {len(trained)} kmers trained, not in every "
             f"model shard")
    n1, n2 = int(r1[0]["n_scored"]), int(r2[0]["n_scored"])
    d_mean, d_stdv, n_diff = model_diff(m1, s1, m2, s2)
    loss1, loss2 = float(r1[0]["loss"]), float(r2[0]["loss"])
    if n1 != n2 or n1 == 0:
        fail(f"train step: n_scored {n1} on 1x1, {n2} on 2x2")
    if d_mean > EM_MEAN_ATOL or d_stdv > EM_STDV_RTOL:
        fail(f"train step: meshes differ by {d_mean} pA (mean), {d_stdv} "
             f"relative (stdv)")
    if not (math.isfinite(loss1) and abs(loss1 - loss2) <= max(
            PAR_LOSS_ATOL, PAR_LOSS_RTOL * abs(loss1))):
        fail(f"train step: loss {loss1} on 1x1, {loss2} on 2x2")
    out = {"forward_check": step_forward_check(d, dev)}
    for (dp, mp), (ranks, _, _, wall) in results.items():
        out[f"{dp}x{mp}"] = {
            "processes": dp * mp, "backend": str(ranks[0]["backend"]),
            "step_s": [float(max(r["walls"][k] for r in ranks))
                       for k in range(2)],
            "run_s": wall, "n_scored": int(ranks[0]["n_scored"]),
            "loss": float(ranks[0]["loss"]),
            "launches": [{k: v for k, v in json.loads(str(r["launches"]))
                          .items() if k in PAR_KERNELS} for r in ranks]}
    log(f"train step at full width ({len(m1)} kmers, {len(a['n_events'])} "
        f"reads; batch set-up {setup_s:.1f} s): {len(trained)} kmers "
        f"trained, n_scored {n1}, loss {loss1} (1x1) {loss2} (2x2); "
        f"meshes differ by {d_mean} pA, {d_stdv} relative, {n_diff} means")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--cpu-subset"]:
        return cpu_subset_run(sys.argv[2])
    if sys.argv[1:2] == ["--train-step-rank"]:
        return train_step_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, ROOT)
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    shutil.rmtree(WORK, ignore_errors=True)     # inputs are made anew
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    build_s = cuda_build.build_kernels(force=True, verbose=True)
    log(f"kernel build: {build_s:.1f} s (nvcc x{len(cuda_build.KERNELS)} "
        f"in parallel)")
    for name in cuda_build.KERNELS:
        info = [ln.strip() for ln in cuda_build.BUILD_LOG[name].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: {' | '.join(info)}")

    report = {name: {} for name in cuda_build.KERNELS}
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    phase_banded(model, dev, report)
    phase_viterbi(model, dev, report)
    phase_forward(model, dev, report)
    phase_forward_indexed(model, dev, report)
    phase_segmentation(dev, report)
    phase_golden(dev)
    # each kernel's launches and device time are those of its own slice's
    # main path: eventalign (banded, Viterbi), call-methylation (Forward),
    # variants (indexed Forward), polya (segmentation)
    # the training corpus, and the methyltrain subset's cpu run, started
    # now in a second process at low priority so that it runs beside the
    # card's main paths
    t0 = time.perf_counter()
    inputs, true_cpg, is_m = build_train_corpus(os.path.join(WORK, "train"))
    train_setup_s = time.perf_counter() - t0
    cpu_proc = start_cpu_subset(inputs)
    launches, path_ms, ea_corpus = phase_eventalign(dev)
    *cm_path, meth_corpus = phase_call_methylation(dev)
    own = {"forward_fill": cm_path}
    phase_scorereads_phase(dev, ea_corpus)
    own["forward_indexed"] = phase_variants(dev)
    own["seg_viterbi_fill"] = own["seg_backtrack"] = phase_polya(dev)
    # the training paths: methyltrain (banded kernels at ingest, Viterbi
    # every round, Forward for --output-scores), train-poremodel (banded)
    t0 = time.perf_counter()
    mt_launches, mt_ms = phase_methyltrain(dev, inputs, true_cpg, is_m,
                                           train_setup_s)
    phase_em(dev)
    tp_launches, tp_ms = phase_training_subset(dev, inputs, cpu_proc,
                                               ea_corpus)
    log(json.dumps({"training_paths": {
        "methyltrain": {name: {"launches": mt_launches[name],
                               "path_ms": mt_ms[name]}
                        for name in TRAIN_KERNELS},
        "train-poremodel-from-basecalls": {
            name: {"launches": tp_launches[name], "path_ms": tp_ms[name]}
            for name in ("banded_fill", "banded_backtrack")}},
        "seconds": round(time.perf_counter() - t0, 1)}))
    # several processes on the one card: sharded serving, then the
    # sharded train step (its kernels in every rank)
    t0 = time.perf_counter()
    log(f"multi-process phase: {len(os.sched_getaffinity(0))} usable "
        f"cores; {card()}")
    serving = phase_parallel_serving(dev, meth_corpus, ea_corpus)
    train = phase_parallel_train(dev, ea_corpus)
    log(json.dumps({"parallel_paths": {
        "card": card(), "cores": len(os.sched_getaffinity(0)),
        "serving": serving, "train_step": train,
        "seconds": round(time.perf_counter() - t0, 1)}}))
    for name, (path_launches, path_times) in own.items():
        launches[name] = path_launches[name]
        path_ms[name] = path_times[name]
    for name in cuda_build.KERNELS:
        if not path_ms[name] > 0.0:
            fail(f"torch.profiler shows no device time for {name} on its "
                 f"main path ({launches[name]} launches)")

    replaces = {
        "banded_fill": "nanopolish_tpu/ops/pallas_banded_exact.py:210",
        "banded_backtrack": "nanopolish_tpu/ops/pallas_banded_exact.py:441",
        "viterbi_fill": "nanopolish_tpu/ops/pallas_profile_hmm.py:637",
        "viterbi_backtrack": "nanopolish_tpu/ops/pallas_profile_hmm.py:758",
        "forward_fill": "nanopolish_tpu/ops/pallas_profile_hmm.py:97",
        "forward_indexed": "nanopolish_tpu/ops/pallas_profile_hmm.py:987",
        "seg_viterbi_fill": "nanopolish_tpu/ops/pallas_segmentation.py:101",
        "seg_backtrack": "nanopolish_tpu/ops/pallas_segmentation.py:177",
    }
    kernels = []
    for name in cuda_build.KERNELS:
        r = report[name]
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": f"nanopolish_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "path_ms": path_ms[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
