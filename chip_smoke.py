#!/usr/bin/env python3
"""Drive nanopolish_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build the six CUDA kernels from
     nanopolish_tpu_torch/csrc/ (one nvcc per source, all at once);
  2. banded-alignment kernels (fill, backtrack) against their plain
     PyTorch versions on the card, bit for bit, on 32 reads x 2 kb plus
     tiny, garbage, noisy and mixed-length batches; then timing at 256
     reads x 8 kb (2 events/base, r9.4_450bps 6-mer);
  3. profile-HMM Viterbi kernels (fill, backtrack) against their plain
     versions on 512 eventalign-shaped segments with all four soft-clip
     flag combinations (identical traces and tracebacks); then timing;
  4. the profile-HMM Forward kernel against its plain version on 2,048
     call-methylation-shaped segments (17-221 kmers, 30-460 events, all
     four clip flags) and 64 scorereads-shaped ones (501 x 250), within
     2e-3 nats; then timing;
  4b. the indexed Forward kernel (variants' drain) against its plain
     version and against the flat Forward kernel on the same gathered
     inputs, bit for bit: a screening-shaped batch (8,192 segments of 5-32
     kmers and 10-80 events, ~10 sequences per event slice, one warp per
     segment), every width 1-32, and a calling-shaped batch (512 segments
     of 100-256 kmers, one block per segment); then timing;
  5. the goldens on the card through the CLI entry points: the 4-read
     eventalign pipeline of tests/test_golden_outputs.py (byte for byte),
     the 3-read methylation pipeline (TSV and both modbam styles) and the
     12-read consensus pipeline (`variants --consensus`, plain and with
     --fix-homopolymers), the last two under the printed-output rule of
     tests/printed_output.py;
  6. the main paths on the card, each with the launch counts reset just
     before it and read just after: `index` + `eventalign` on 64 reads x
     8 kb from a 100 kb synthetic genome, then `call-methylation` (with a
     modbam) on 64 reads x 8 kb of which half carry cpg-methylated
     signal; then `scorereads` on 8 of the eventalign reads and
     `phase-reads` on a 2-read phased corpus, each held to the port's
     CPU run under the printed-output rule; then `variants --consensus`
     on a 50 kb draft window (250 reads x 2 kb of true signal, depth ~10,
     332 planted substitutions: the corpus of tools/perf_e2e_variants.py
     at NPT_E2E_WINDOW=50000, NPT_E2E_READS=250, NPT_E2E_READLEN=2000,
     seed 41) with wall-clock stage timers and the card's busy time from
     torch.profiler, and `vcf2fasta` on its VCF;
  7. one JSON line describing each kernel, then the result line.

Everything it writes goes under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

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
# the variants main path: a draft window polished by tiled reads
VAR_WINDOW, VAR_READS, VAR_READ_LEN = 50_000, 250, 2000
SUB = {"A": "G", "C": "T", "G": "A", "T": "C"}

# published peaks of one H100 SXM (dense, no sparsity)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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
    bt_ms = cuda_ms(lambda: bx.banded_backtrack(fill[0], fill[1], fill[2],
                                                fill[3], *tail))
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
    log(f"banded bench {B} reads x {K} kmers x {T} events: fill {fill_ms:.3f} ms "
        f"(plain {fill_plain_ms:.1f} ms), backtrack {bt_ms:.3f} ms "
        f"(plain {bt_plain_ms:.1f} ms); {reads_s:.1f} reads/s; "
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


def phase_viterbi(model, dev, report):
    import torch
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv

    S = 512
    lv, nev, mu, sd, nk, epb, flags = viterbi_batch(model, S, seed=7)
    x = pv.prepare_viterbi_inputs(lv, nev, mu, sd, nk, epb, flags, device=dev)
    fargs = (x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
             x["n_kmers"], x["trans"], x["clips"])
    tk = pv.viterbi_fill(*fargs)
    fill_plain_ms, tp = once_ms(lambda: ph.viterbi_fill_plain(*fargs))
    rows = torch.arange(tk.shape[1], device=dev)[None, :, None]
    cols = torch.arange(tk.shape[2], device=dev)[None, None, :]
    live = (rows < x["n_events"][:, None, None].long()) & \
        (cols < x["n_kmers"][:, None, None].long())
    n_diff_cells = int(((tk != tp) & live).sum())
    if n_diff_cells:
        fail(f"viterbi_fill: {n_diff_cells} trace cells differ from plain")
    pk = pv.viterbi_backtrack(tk, x["n_events"], x["n_kmers"])
    bt_plain_ms, pp = once_ms(lambda: ph.viterbi_backtrack_plain(
        tk, x["n_events"], x["n_kmers"]))
    seg_k = ph.paths_to_segments(pk.cpu().numpy())
    seg_p = ph.paths_to_segments(pp.cpu().numpy())
    n_diff = sum(1 for a, b in zip(seg_k, seg_p)
                 if not (np.array_equal(a[0], b[0]) and
                         np.array_equal(a[1], b[1]) and a[2] == b[2]))
    if n_diff:
        fail(f"viterbi_backtrack: {n_diff} of {S} tracebacks differ from plain")
    # the plain version on the card equals the plain version on the CPU
    sub = slice(0, 16)
    xc = pv.prepare_viterbi_inputs(lv[sub], nev[sub], mu[sub], sd[sub],
                                   nk[sub], epb[sub], flags[sub], device="cpu")
    cpu = ph.paths_to_segments(pv.viterbi_paths(xc).numpy())
    for a, b in zip(cpu, seg_k[:16]):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                and a[2] == b[2]):
            fail("viterbi tracebacks differ between the cpu plain path and "
                 "the kernels")
    fill_ms = cuda_ms(lambda: pv.viterbi_fill(*fargs))
    bt_ms = cuda_ms(lambda: pv.viterbi_backtrack(tk, x["n_events"],
                                                 x["n_kmers"]))
    lens = pk[:, 0].double().cpu().numpy()
    cells = float(np.sum(nev.astype(np.float64) * nk))
    fill_bytes = cells + float(np.sum(nev) * 4 + np.sum(nk) * 12 + S * 42)
    bt_bytes = float(np.sum(lens) * 5 + S * 12)
    log(f"viterbi {S} segments (flags 0-3): traces and tracebacks == plain "
        f"(exact-tie differences: 0); fill {fill_ms:.3f} ms (plain "
        f"{fill_plain_ms:.1f} ms), backtrack {bt_ms:.3f} ms (plain "
        f"{bt_plain_ms:.1f} ms)")
    for name, ms, pms, nbytes, flops, err in (
            ("viterbi_fill", fill_ms, fill_plain_ms, fill_bytes, cells * 27,
             max_abs_err(tk[live].float(), tp[live].float())),
            ("viterbi_backtrack", bt_ms, bt_plain_ms, bt_bytes,
             float(np.sum(lens)) * 8, path_max_abs_err(pk, pp))):
        bms, by = bound(nbytes, flops)
        report[name].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                            max_abs_err=err)


# ---------------------------------------------------------------- phase 4 --

def forward_work(nev, nk):
    """Bytes and f32 operations the Forward needs for these segments:
    each level, kmer table entry and score moved once."""
    nev = np.asarray(nev, np.float64)
    nk = np.asarray(nk, np.float64)
    nbytes = float(np.sum(nev * 4 + nk * 12 + 32 + 2 + 8 + 4))
    flops = float(np.sum(nev * nk * FWD_OPS_CELL + nev * FWD_OPS_ROW))
    return nbytes, flops


def phase_forward(model, dev, report):
    import torch
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf

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
    errs, timed = [], None
    for name, (lv, nev_c, mu, sd, nk_c, epb, flags) in cases.items():
        x = pf.prepare_forward_inputs(lv, nev_c, mu, sd, nk_c, epb, flags,
                                      device=dev)
        args = (x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
                x["n_kmers"], x["trans"], x["clips"])
        got = pf.forward_fill(*args)
        plain_ms, ref = once_ms(lambda: ph.forward_fill_plain(*args))
        err = max_abs_err(got, ref)
        same = float((got.view(torch.int32) == ref.view(torch.int32))
                     .float().mean())
        if not err <= 2e-3:
            fail(f"forward_fill differs from the plain version by {err} nats "
                 f"on the {name} batch")
        ms = cuda_ms(lambda: pf.forward_fill(*args))
        nbytes, flops = forward_work(nev_c, nk_c)
        bms, by = bound(nbytes, flops)
        log(f"forward {name}: {len(nk_c)} segments, max_abs_err {err:.3g} "
            f"nats, {same:.1%} bit-identical; kernel {ms:.3f} ms (plain "
            f"{plain_ms:.1f} ms), bound {bms:.4f} ms ({by})")
        errs.append(err)
        if timed is None:                 # the main path's shape
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
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


def phase_forward_indexed(model, dev, report):
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
    }
    errs, timed = [], None
    for name, arrays in cases.items():
        pi.check_indexed(*arrays)
        dts = (torch.float32, torch.int32, torch.float32, torch.int32,
               torch.int32, torch.float32, torch.int32)
        t = [torch.as_tensor(a, dtype=d, device=dev)
             for a, d in zip(arrays, dts)]
        n = t[6].shape[0]
        clips = torch.ones((n, 2), dtype=torch.uint8, device=dev)
        kp = kmer_width(int(arrays[4].max()))
        got = pi.forward_indexed(*t, clips, kp=kp)
        plain_ms, ref = once_ms(lambda: ph.forward_indexed_plain(*t, clips))
        lv, nev, mu, sg, c, nk, tr = ph.gather_indexed(*t)
        pad = kp - mu.shape[1]
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
        ms = cuda_ms(lambda: pi.forward_indexed(*t, clips, kp=kp))
        nbytes, flops = indexed_work(*arrays)
        bms, by = bound(nbytes, flops)
        log(f"forward_indexed {name}: {n} segments, kmer width {kp} "
            f"({'warp' if kp == 32 else 'block'} per segment), "
            f"{len(arrays[1])} event rows, {len(arrays[4])} rank rows; "
            f"max_abs_err {err} vs plain and vs forward_fill, {same:.1%} "
            f"bit-identical; kernel {ms:.3f} ms (plain {plain_ms:.1f} ms), "
            f"bound {bms:.4f} ms ({by})")
        errs.append(err)
        if timed is None:                 # the main path's dominant shape
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    report["forward_indexed"].update(max_abs_err=max(errs), **timed)


# ---------------------------------------------------------------- phase 5 --

def _write_fa(path, name, seq):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _adc(pa):
    return np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)


def build_pipeline(d, genome_len, plan, read_len, seed, shift=1.5,
                   scale=1.01, methylated=(), sort_bam=False):
    """Reference FASTA, basecalls, slow5 signal, readdb index and BAM for
    reads placed at plan = [(name, pos, is_rev)] (the layout of
    tests/test_golden_outputs.py; BAM records in plan order unless
    sort_bam).  Reads named in ``methylated`` carry signal drawn from the
    cpg model over their CpG-methylated basecall."""
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
    _write_fa(ref_fa, "tig1", genome)
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
                    samples_per_base=10.0, leader=400, trailer=100)
            else:
                pa = synthetic_raw_signal(rng, basecall, model, sc,
                                          samples_per_base=10.0, leader=400,
                                          trailer=100)
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

    wall, launches = timed_run(run, ("banded_fill", "banded_backtrack",
                                     "viterbi_fill", "viterbi_backtrack"))
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
        f"{setup_s:.1f} s); launches {json.dumps(launches)}")
    return launches, (ref_fa, fastq, bam)


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

    wall, launches = timed_run(run, ("banded_fill", "banded_backtrack",
                                     "forward_fill"))
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
        f"set-up {setup_s:.1f} s); mean log_lik_ratio {mean_m:.3f} "
        f"methylated, {mean_u:.3f} unmethylated; launches "
        f"{json.dumps(launches)}")
    return launches


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
    """scorereads on 8 eventalign reads and phase-reads on the phased
    corpus, on the card and on the CPU, held to each other under the
    printed-output rule."""
    from nanopolish_tpu_torch.apps import phase_reads as pr_app
    from nanopolish_tpu_torch.apps import scorereads as sc_app

    ref_fa, fastq, bam = ea_corpus
    ref_fa2, fastq2, bam2, vcf = build_phased(os.path.join(WORK, "phase"))
    runs = (("scorereads", sc_app, ["-r", fastq, "-b", bam, "-g", ref_fa,
                                    "--max-reads", "8"], False,
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
    torch.profiler (CUDA activity only).  Returns the launch counts."""
    import torch
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

    acts = [torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            wall, launches = timed_run(run, ("banded_fill", "banded_backtrack",
                                             "forward_indexed"))
    finally:
        for (o, a), fn in zip(patched, saved):
            setattr(o, a, fn)
    busy = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            busy[ev.key] = busy.get(ev.key, 0.0) + us / 1e6
    busy_s = sum(busy.values())
    top = {k: round(v, 4) for k, v in
           sorted(busy.items(), key=lambda kv: -kv[1])[:6]}

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
        f"kernel {json.dumps(top)}; launches {json.dumps(launches)}")
    if recovered < len(subs) - 2 or elsewhere > 6:
        fail(f"variants recovered {recovered} of {len(subs)} planted "
             f"substitutions with {elsewhere} calls elsewhere")
    if abs(len(polished) - len(truth)) > elsewhere or \
            (diff is not None and diff > len(subs) - recovered + elsewhere):
        fail(f"vcf2fasta: {len(polished)} bases for a {len(truth)}-base "
             f"truth, {diff} differing")
    return launches


# ------------------------------------------------------------------- main --

def main() -> int:
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
    phase_golden(dev)
    launches, ea_corpus = phase_eventalign(dev)
    # the Forward kernel's launches are those of its own slice's main path
    launches["forward_fill"] = phase_call_methylation(dev)["forward_fill"]
    phase_scorereads_phase(dev, ea_corpus)
    launches["forward_indexed"] = phase_variants(dev)["forward_indexed"]

    replaces = {
        "banded_fill": "nanopolish_tpu/ops/pallas_banded_exact.py:210",
        "banded_backtrack": "nanopolish_tpu/ops/pallas_banded_exact.py:441",
        "viterbi_fill": "nanopolish_tpu/ops/pallas_profile_hmm.py:637",
        "viterbi_backtrack": "nanopolish_tpu/ops/pallas_profile_hmm.py:758",
        "forward_fill": "nanopolish_tpu/ops/pallas_profile_hmm.py:97",
        "forward_indexed": "nanopolish_tpu/ops/pallas_profile_hmm.py:987",
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
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
