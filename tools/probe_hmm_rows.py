#!/usr/bin/env python3
"""Time one checkout's profile-HMM, banded and segmentation kernels on one card.

    python3 tools/probe_hmm_rows.py [--root DIR] [--json FILE]
                                    [--against FILE] [--sass DIR] [--paths]
                                    [--capture FILE] [--step FILE]
                                    [--cases REGEX] [--wide-cluster N,...]

Builds the kernels of the checkout at --root (default: the one holding
this script) with that checkout's own utils/cuda_build, and drives its
public wrappers (ops/profile_hmm_viterbi.viterbi_fill and
viterbi_backtrack, ops/banded_exact.banded_fill,
ops/profile_hmm_forward.forward_fill,
ops/profile_hmm_indexed.forward_indexed_scores,
ops/segmentation_viterbi.seg_viterbi_fill, ops/banded_exact.banded_backtrack,
ops/segmentation_viterbi.seg_backtrack) on the batches of this checkout's
chip_smoke.py, so that two checkouts run the same inputs:

  vit-check    chip_smoke.py's 512 eventalign-shaped Viterbi segments
  vit-wave     32 of them, a launch of eventalign's wavefront
  vit-bt-check, vit-bt-wave
               the traceback of the same 512 and 32 segments (their
               traces from the checkout's fill)
  banded-check chip_smoke.py's banded fill batch, 256 reads x 8 kb
  banded-ea    the banded fill launch of the eventalign run on
               chip_smoke.py's 64 reads x 8 kb (--capture)
  fwd-check    chip_smoke.py's 2,048 call-methylation-shaped Forward
               segments at one kmer width (256)
  fwd-bucketed the same 2,048 launched as segments.forward_arrays_async
               launches them, one launch per bucket of power-of-two event
               length and kmer width; fwd-<T>x<KP> is each bucket alone
  vit-<kp>, fwd-<kp>
               chip_smoke.py's batch at each width of HMM_WIDTHS
  vit-wide-<kp>, fwd-wide-<kp>
               chip_smoke.py's wide-row batches at each width of
               WIDE_WIDTHS, and vit-wide-<name>, fwd-wide-<name> its
               WIDE_CASES (the train step's kmer width with 1 and 4
               segments; 68 segments at the shared-memory/scratch edge)
  fwd-step     the train step's Forward on its 4 longest reads (--step:
               the forward_inputs.npz chip_smoke.py's phase 6b writes)
  idx-screen, idx-call, idx-wide
               chip_smoke.py's 8,192 screening-shaped and 512
               calling-shaped indexed segments and its 8 of 1,025-3,000
               kmers (the wide row), one flush each
  idx-flush    the largest flush of the 50 kb variants run (--capture),
               and idx-flush-<kp> each of its kmer-width buckets (8, 16,
               32, 64 ... as indexed_width groups them) alone
  seg-check, seg-check-dpi
               chip_smoke.py's 512 reads x 2,000-65,536 samples, polya and
               detect-polyi parameters
  seg-polya    the polya run's segmentation launch (--capture)
  banded-bt-check, banded-bt-ea
               the banded backtrack of banded-check's and banded-ea's
               reads (their trace from the checkout's fill)
  seg-bt-check, seg-bt-check-dpi, seg-bt-polya
               the segmentation backtrack (summary only, as the main path
               calls it) of seg-check's, seg-check-dpi's and seg-polya's
               reads (their backpointers from the checkout's fill)

An indexed case's time is the device time of its forward_indexed kernels
per flush (torch.profiler), since the two checkouts launch a flush
differently; idx cases also report the flush's CUDA-event time with its
uploads and fetch (wall_ms).  The vit-bt, banded and seg-bt cases' times
are the kernel's device time per call too (a ~20 us traceback is shorter
than its wrapper's host work), with the call's CUDA-event time in
wall_ms.  Every other time is a CUDA-event mean over REPS calls after
a warm-up.

--cases REGEX runs only the cases whose names match.  --wide-cluster
N,... also times every wide-row fill case (vit-wide-*, fwd-wide-*,
fwd-step) with profile_hmm_viterbi.WIDE_MAX_CLUSTER set to each N, as
<case>@c<N>, its output held to the case's own (one CTA a segment at
N = 1).

--capture FILE: the idx-flush, seg-polya and banded-ea inputs.  When
FILE does not exist, the run builds chip_smoke.py's eventalign, 50 kb
variants and 512-read polya corpora, runs the three paths (recording the
eventalign ingest's banded fill launch, the largest
forward_indexed_scores flush and the polya segmentation launch) and
writes FILE; later runs read it.  With --paths the run also reports path ms: each kernel's summed
device time on its own main path (chip_smoke phase 6: eventalign,
call-methylation, variants, polya) and its launches.

Prints ptxas's registers and spills, one line per case and one JSON
line: the card's name and power limit, the times (ms) and a sha256 of
each case's output (the trace cells of the live event rows; the scores;
the backpointer bytes and final scores; each traceback's entries up
to its length; the banded fill's five outputs; the banded backtrack's
four; the segmentation backtrack's summary and labels).  --json writes that line to
FILE; --against FILE fails the run unless every output equals FILE's.
With --sass DIR, writes each kernel's SASS (cuobjdump) into DIR and
prints instruction and branch counts per kernel function.

To compare two commits, unpack one with `git archive` into a directory
that .gitignore lists (here P) and run the two in turns in one call:

    python3 tools/probe_hmm_rows.py --root P --capture c.npz --paths --json p1.json
    python3 tools/probe_hmm_rows.py --capture c.npz --paths --against p1.json
    python3 tools/probe_hmm_rows.py --capture c.npz --paths --against p1.json
    python3 tools/probe_hmm_rows.py --root P --capture c.npz --paths --against p1.json
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("banded_fill", "banded_backtrack", "viterbi_fill",
           "viterbi_backtrack", "forward_fill", "forward_indexed",
           "seg_viterbi_fill", "seg_backtrack")
REPS = 10


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sass(cs, out_dir):
    """Write the kernels' SASS into out_dir and log each kernel's
    instruction and branch counts."""
    from nanopolish_tpu_torch.utils import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for name in KERNELS:
        text = subprocess.run([tool, "-sass", cuda_build.lib_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as fh:
            fh.write(text)
        counts, fn = {}, None
        for ln in text.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[1].strip()
                counts[fn] = [0, 0]
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*([^;]+);", ln)
            if fn and m:
                counts[fn][0] += 1
                counts[fn][1] += bool(re.search(r"\bBRA\b", m.group(1)))
        cs.log(f"sass {name}: " + "; ".join(
            f"{fn[-60:]}: {n} instructions, {b} branches"
            for fn, (n, b) in counts.items()))


def fill_cases(cs, model, dev, want, step=None):
    """(case, kernel, [prepared inputs of each launch]) of the two fills,
    those whose names want() takes; step: the train step's Forward
    inputs (an npz of chip_smoke.FWD_ARGS)."""
    import torch
    from nanopolish_tpu_torch.alignment.segments import _bucket_key
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv

    def prep(arrays):
        return pv.prepare_viterbi_inputs(*arrays, device=dev)

    check = cs.viterbi_batch(model, 512, seed=7)
    rng = np.random.default_rng(17)
    nk = rng.integers(17, 222, cs.FWD_SEGMENTS).astype(np.int32)
    nev = np.clip((nk * rng.uniform(1.6, 2.4, cs.FWD_SEGMENTS)
                   ).astype(np.int32), 30, 460).astype(np.int32)
    fwd = cs.hmm_batch(model, nk, nev, rng)
    out = [("vit-check", "viterbi_fill", [prep(check)]),
           ("vit-wave", "viterbi_fill",
            [prep(tuple(v[:32] for v in check))]),
           ("fwd-check", "forward_fill", [prep(fwd)])]
    lv, nev_c, mu, sd, nk_c, epb, flags = fwd
    buckets = {}
    for i, key in enumerate(zip(nev_c.tolist(), nk_c.tolist())):
        buckets.setdefault(_bucket_key(*key), []).append(i)
    xs = []
    for (tp, kp), idx in sorted(buckets.items()):
        ii = np.asarray(idx)
        xs.append(((tp, kp), prep((lv[ii, :tp], nev_c[ii], mu[ii, :kp],
                                   sd[ii, :kp], nk_c[ii], epb[ii],
                                   flags[ii]))))
    out.append(("fwd-bucketed", "forward_fill", [x for _, x in xs]))
    out += [(f"fwd-{tp}x{kp}", "forward_fill", [x]) for (tp, kp), x in xs]
    for kp in cs.HMM_WIDTHS:
        out.append((f"vit-{kp}", "viterbi_fill", [prep(
            cs.width_batch(model, kp, cs.WIDTH_SEGMENTS, seed=kp))]))
        out.append((f"fwd-{kp}", "forward_fill", [prep(
            cs.width_batch(model, kp, cs.WIDTH_SEGMENTS, seed=kp + 1))]))
    # the wide row: chip_smoke phases 3 and 4's batches, seeded alike
    for kp in cs.WIDE_WIDTHS:
        out.append((f"vit-wide-{kp}", "viterbi_fill",
                    [prep(cs.wide_batch(model, kp, seed=kp))]))
        out.append((f"fwd-wide-{kp}", "forward_fill",
                    [prep(cs.wide_batch(model, kp, seed=kp + 1))]))
    for name, shape in cs.WIDE_CASES.items():
        seed = shape[0] + shape[1]
        out.append((f"vit-wide-{name}", "viterbi_fill",
                    [prep(cs.wide_case(model, *shape, seed=seed))]))
        out.append((f"fwd-wide-{name}", "forward_fill",
                    [prep(cs.wide_case(model, *shape, seed=seed + 1))]))
    if step:
        a = np.load(step)
        out.append(("fwd-step", "forward_fill", [
            {k: torch.as_tensor(a[k], device=dev) for k in cs.FWD_ARGS}]))
    return [c for c in out if want(c[0])]


def indexed_cases(cs, model, cap):
    """(case, indexed inputs as numpy, flags) of forward_indexed_scores:
    chip_smoke phase 4b's batches (the same generator calls, in its order)
    and the captured flush, whole and per kmer-width bucket."""
    rng = np.random.default_rng(23)
    screen = cs.indexed_batch(model, rng, cs.IDX_SCREEN, 5, 32, 10, 80,
                              per_ev=10)
    cs.indexed_batch(model, rng, 1024, 1, 32, 10, 80, per_ev=8,
                     widths=np.arange(1, 33))
    call = cs.indexed_batch(model, rng, cs.IDX_CALL, 100, 256, None, None,
                            per_ev=4)
    cs.indexed_batch(model, rng, cs.IDX_CALL, 33, 64, None, None, per_ev=4)
    cs.indexed_batch(model, rng, 64, 257, 1024, 40, 120, per_ev=2)
    wide = cs.short_rows(cs.indexed_batch(model, rng, 8, 1025, 3000, 40, 120,
                                          per_ev=1), 120)
    out = [("idx-screen", screen, 3), ("idx-call", call, 3),
           ("idx-wide", wide, 3)]
    if cap is not None:
        flush = tuple(cap[f"flush{i}"] for i in range(7))
        flags = np.broadcast_to(cap["flush7"], (len(flush[6]),))
        out.append(("idx-flush", flush, flags))
        nk = flush[4][flush[6][:, 2]]
        kp = np.maximum(8, 1 << np.ceil(np.log2(np.maximum(nk, 1)))
                        .astype(np.int64))
        for w in sorted(set(kp.tolist())):
            out.append((f"idx-flush-{w}", flush[:6] + (flush[6][kp == w],),
                        flags[kp == w]))
    return out


def seg_cases(cs, dev, cap):
    """(case, samples, n, scalings, consts) of seg_viterbi_fill."""
    import torch
    from nanopolish_tpu_torch.apps.detect_polyi import DPI_PARAMS
    from nanopolish_tpu_torch.ops import segmentation_hmm as sh
    reads, scal = cs.seg_batches()["mixed"]
    x, n, s = cs.seg_inputs(reads, scal, dev)
    out = [("seg-check", x, n, s, sh.seg_constants(sh.SegmentationParams())),
           ("seg-check-dpi", x, n, s, sh.seg_constants(DPI_PARAMS))]
    if cap is not None:
        out.append(("seg-polya",
                    *(torch.as_tensor(cap[k], device=dev)
                      for k in ("seg_samples", "seg_n", "seg_scal")),
                    cap["seg_consts"]))
    return out


def capture(cs, dev, path):
    """Run the eventalign, variants and polya main paths once, recording
    the eventalign ingest's banded fill launch, the largest
    forward_indexed_scores flush and the polya segmentation launch; write
    them to path (npz).  Returns each path's launches and path ms."""
    from nanopolish_tpu_torch.alignment import segments
    from nanopolish_tpu_torch.apps import variants
    from nanopolish_tpu_torch.ops import banded_exact as bx
    from nanopolish_tpu_torch.ops import segmentation_viterbi as sv
    got = {}
    flush_fn, seg_fn, band_fn = (segments.forward_indexed_scores,
                                 sv.seg_viterbi_fill, bx.banded_fill)
    callers = (segments, variants)           # both flush through it

    def flush_spy(*a, **k):
        if len(a[6]) > len(got.get("flush6", ())):
            got.update({f"flush{i}": np.asarray(v) for i, v in
                        enumerate(a[:8])})
        return flush_fn(*a, **k)

    def seg_spy(x, n, s, consts):
        if "seg_samples" not in got:
            got.update(seg_samples=x.cpu().numpy(), seg_n=n.cpu().numpy(),
                       seg_scal=s.cpu().numpy(), seg_consts=np.asarray(
                           consts, np.float32))
        return seg_fn(x, n, s, consts)

    def band_spy(*a):
        if "band0" not in got:
            got.update({f"band{i}": v.cpu().numpy() for i, v in enumerate(a)})
        return band_fn(*a)

    for mod in callers:
        mod.forward_indexed_scores = flush_spy
    sv.seg_viterbi_fill = seg_spy
    bx.banded_fill = band_spy
    try:
        launches, path_ms, _ = cs.phase_eventalign(dev)
        own = {"forward_indexed": cs.phase_variants(dev),
               "seg_viterbi_fill": cs.phase_polya(dev)}
    finally:
        for mod in callers:
            mod.forward_indexed_scores = flush_fn
        sv.seg_viterbi_fill = seg_fn
        bx.banded_fill = band_fn
    np.savez(path, **got)
    own["seg_backtrack"] = own["seg_viterbi_fill"]
    return (launches, path_ms), own


def backtrack_cases(cs, model, dev):
    """(case, trace, n_events, n_kmers) of viterbi_backtrack: the traces
    of vit-check's and vit-wave's segments from this checkout's fill."""
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    check = cs.viterbi_batch(model, 512, seed=7)
    out = []
    for case, n in (("vit-bt-check", 512), ("vit-bt-wave", 32)):
        x = pv.prepare_viterbi_inputs(*(v[:n] for v in check), device=dev)
        tr = pv.viterbi_fill(x["levels"], x["n_events"], x["mu"], x["sigma"],
                             x["c"], x["n_kmers"], x["trans"], x["clips"])
        out.append((case, tr, x["n_events"], x["n_kmers"]))
    return out


def banded_cases(cs, model, dev, cap):
    """(case, banded_fill arguments) of banded-check (chip_smoke phase 2's
    timed batch) and banded-ea (the captured eventalign launch)."""
    import torch
    from nanopolish_tpu_torch.ops import banded_align as ba
    ev, nev, mu, sigma, nk = cs.banded_case(model, 256, 8000, 16000, seed=3)
    x = ba.prepare_banded_inputs(ev, nev, mu, sigma, np.log(sigma), nk,
                                 device=dev)
    out = [("banded-check", tuple(x[k] for k in (
        "event_mean", "n_events", "mu", "sigma", "c", "n_kmers", "lp_stay",
        "lp_step")))]
    if cap is not None and "band0" in cap:
        out.append(("banded-ea", tuple(torch.as_tensor(cap[f"band{i}"],
                                                       device=dev)
                                       for i in range(8))))
    return out


def fill_digest(name, x, out) -> str:
    """sha256 of one launch's output: the Viterbi's trace cells of the
    live event rows (the rest are never read), the Forward's scores."""
    import torch
    if name == "viterbi_fill":
        rows = torch.arange(out.shape[1], device=out.device)[None, :, None]
        out = out[(rows < x["n_events"][:, None, None].long()).expand(
            out.shape)]
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def path_digest(path) -> str:
    """sha256 of a traceback's entries up to each path's length (the rest
    are unspecified)."""
    import torch
    step = torch.arange(path.shape[1], device=path.device)[None, :]
    return sha(torch.where(step <= path[:, :1], path, 0).cpu().numpy())


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package is driven")
    ap.add_argument("--json", metavar="FILE", help="write the result here")
    ap.add_argument("--against", metavar="FILE",
                    help="fail unless every output equals this result's")
    ap.add_argument("--sass", metavar="DIR",
                    help="write the kernels' SASS into DIR")
    ap.add_argument("--paths", action="store_true",
                    help="also time the kernels on their main paths")
    ap.add_argument("--capture", metavar="FILE",
                    help="the variants flush and polya launch to time "
                         "(made by running both paths when missing)")
    ap.add_argument("--step", metavar="FILE",
                    help="the train step's Forward inputs (chip_smoke "
                         "phase 6b's forward_inputs.npz): case fwd-step")
    ap.add_argument("--cases", metavar="REGEX",
                    help="run only the cases whose names match")
    ap.add_argument("--wide-cluster", metavar="N,...",
                    help="also time the wide-row fill cases at these "
                         "cluster-size limits")
    a = ap.parse_args()

    def want(case):
        return a.cases is None or re.search(a.cases, case) is not None
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this probe needs a GPU")
    sys.path.insert(0, os.path.abspath(a.root))
    import nanopolish_tpu_torch
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    from nanopolish_tpu_torch.ops import profile_hmm_indexed as pi
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    from nanopolish_tpu_torch.ops import segmentation_viterbi as sv
    from nanopolish_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    cs.log(cs.card())
    cs.log(f"package {os.path.dirname(nanopolish_tpu_torch.__file__)}")
    cuda_build.build_kernels(force=True, verbose=True)
    for name in KERNELS:
        cs.log(f"  {name}: " + " | ".join(
            ln.strip() for ln in cuda_build.BUILD_LOG[name].splitlines()
            if "registers" in ln or "spill" in ln))
    if a.sass:
        sass(cs, a.sass)

    result = {"card": cs.card(), "root": os.path.abspath(a.root)}
    own = ea = None
    if a.capture and not os.path.exists(a.capture):
        ea, own = capture(cs, dev, a.capture)
    cap = np.load(a.capture) if a.capture else None
    if a.paths:
        launches, path_ms = ea or cs.phase_eventalign(dev)[:2]
        cm_launches, cm_path_ms = cs.phase_call_methylation(dev)
        if own is None:
            own = {"forward_indexed": cs.phase_variants(dev),
                   "seg_viterbi_fill": cs.phase_polya(dev)}
            own["seg_backtrack"] = own["seg_viterbi_fill"]
        own["forward_fill"] = (cm_launches, cm_path_ms)
        for k, (ln, pm) in own.items():
            launches[k], path_ms[k] = ln[k], pm[k]
        result["path_ms"] = {k: path_ms[k] for k in KERNELS}
        result["path_launches"] = {k: launches[k] for k in KERNELS}

    from nanopolish_tpu_torch.ops import banded_exact as bx
    fill = {"viterbi_fill": pv.viterbi_fill, "forward_fill": pf.forward_fill}
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    times, walls, digests = {}, {}, {}
    for case, name, xs in fill_cases(cs, model, dev, want, a.step):
        args = [(x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
                 x["n_kmers"], x["trans"], x["clips"]) for x in xs]
        digests[case] = [fill_digest(name, x, fill[name](*arg))
                         for x, arg in zip(xs, args)]
        times[case] = cs.cuda_ms(lambda: [fill[name](*arg) for arg in args],
                                 reps=REPS)
        cs.log(f"{case}: {sum(x['mu'].shape[0] for x in xs)} segments in "
               f"{len(xs)} launches, kmer widths "
               f"{sorted({x['mu'].shape[1] for x in xs})}: "
               f"{times[case]:.4f} ms")
        if a.wide_cluster and ("-wide-" in case or case == "fwd-step"):
            default = pv.WIDE_MAX_CLUSTER
            for c in (int(v) for v in a.wide_cluster.split(",")):
                pv.WIDE_MAX_CLUSTER = c
                try:
                    got = [fill_digest(name, x, fill[name](*arg))
                           for x, arg in zip(xs, args)]
                    if got != digests[case]:
                        cs.fail(f"{case} at cluster limit {c} differs from "
                                f"its output at {default}")
                    key = f"{case}@c{c}"
                    times[key] = cs.cuda_ms(
                        lambda: [fill[name](*arg) for arg in args],
                        reps=REPS)
                finally:
                    pv.WIDE_MAX_CLUSTER = default
                cs.log(f"{key}: {times[key]:.4f} ms")
    def family(*names):
        return any(want(c) for c in names)

    bt_cases = backtrack_cases(cs, model, dev) \
        if family("vit-bt-check", "vit-bt-wave") else []
    for case, tr, nev, nk in bt_cases:
        if not want(case):
            continue

        def run():
            return pv.viterbi_backtrack(tr, nev, nk)
        digests[case] = path_digest(run())
        times[case] = cs.kernel_ms(run, "viterbi_backtrack", REPS)
        walls[case] = cs.cuda_ms(run, reps=REPS)
        cs.log(f"{case}: {tr.shape[0]} segments, kmer width {tr.shape[2]}: "
               f"kernel {times[case]:.4f} ms (call {walls[case]:.4f} ms)")
        del tr
    b_cases = banded_cases(cs, model, dev, cap) if family(
        "banded-check", "banded-ea", "banded-bt-check", "banded-bt-ea") \
        else []
    for case, args in b_cases:
        if not (want(case) or want(case.replace("banded-", "banded-bt-"))):
            continue

        def run():
            return bx.banded_fill(*args)
        digests[case] = sha(*(t.cpu().numpy() for t in run()))
        times[case] = cs.kernel_ms(run, "banded_fill", REPS)
        walls[case] = cs.cuda_ms(run, reps=REPS)
        cs.log(f"{case}: {args[0].shape[0]} reads, {args[0].shape[1]} "
               f"events x {args[2].shape[1]} kmers: kernel "
               f"{times[case]:.4f} ms (call {walls[case]:.4f} ms)")
        fill = run()
        tail = (args[0], args[2], args[3], args[4], args[5])

        def run_bt():
            return bx.banded_backtrack(fill[0], fill[1], fill[2], fill[3],
                                       *tail)
        bt = case.replace("banded-", "banded-bt-")
        digests[bt] = sha(*(t.cpu().numpy() for t in run_bt()))
        times[bt] = cs.kernel_ms(run_bt, "banded_backtrack", REPS)
        walls[bt] = cs.cuda_ms(run_bt, reps=REPS)
        cs.log(f"{bt}: kernel {times[bt]:.4f} ms (call {walls[bt]:.4f} ms)")
        del fill
    i_cases = indexed_cases(cs, model, cap) if family(
        "idx-screen", "idx-call", "idx-wide", "idx-flush") else []
    for case, arrays, flags in i_cases:
        if not want(case):
            continue

        def run():
            return pi.forward_indexed_scores(*arrays, flags, device=dev)
        digests[case] = sha(run())
        times[case] = cs.kernel_ms(run, "forward_indexed", REPS)
        walls[case] = cs.cuda_ms(run, reps=REPS)
        cs.log(f"{case}: {len(arrays[6])} segments, kmer counts "
               f"{int(arrays[4][arrays[6][:, 2]].min())}-"
               f"{int(arrays[4][arrays[6][:, 2]].max())}: kernels "
               f"{times[case]:.4f} ms per flush (flush {walls[case]:.4f} ms "
               f"with its uploads and fetch)")
    s_cases = seg_cases(cs, dev, cap) if family(
        "seg-check", "seg-check-dpi", "seg-polya", "seg-bt-check",
        "seg-bt-check-dpi", "seg-bt-polya") else []
    for case, x, n, s, k in s_cases:
        if not (want(case) or want(case.replace("seg-", "seg-bt-"))):
            continue
        bk, vk = sv.seg_viterbi_fill(x, n, s, k)
        digests[case] = sha(bk.contiguous().cpu().numpy(), vk.cpu().numpy())
        del bk, vk
        times[case] = cs.cuda_ms(lambda: sv.seg_viterbi_fill(x, n, s, k),
                                 reps=REPS)
        cs.log(f"{case}: {x.shape[1]} reads, up to {x.shape[0]} samples: "
               f"{times[case]:.4f} ms")
        bk, _ = sv.seg_viterbi_fill(x, n, s, k)

        def run_bt():
            return sv.seg_backtrack(bk, n)
        bt = case.replace("seg-", "seg-bt-")
        summ, lab = sv.seg_backtrack(bk, n, labels=True)
        digests[bt] = sha(summ.cpu().numpy(), lab.cpu().numpy())
        del summ, lab
        times[bt] = cs.kernel_ms(run_bt, "seg_backtrack", REPS)
        walls[bt] = cs.cuda_ms(run_bt, reps=REPS)
        cs.log(f"{bt}: kernel {times[bt]:.4f} ms (call {walls[bt]:.4f} ms)")
        del bk
    result.update(ms=times, wall_ms=walls, sha256=digests)
    print(json.dumps(result), flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(result, fh)
    if a.against:
        with open(a.against) as fh:
            want_sha = json.load(fh)["sha256"]
        differ = [c for c in digests if digests[c] != want_sha.get(c)]
        if differ:
            cs.fail(f"outputs differ from {a.against} in {differ}")
        cs.log(f"every output equals {a.against}'s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
