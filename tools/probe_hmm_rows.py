#!/usr/bin/env python3
"""Time one checkout's profile-HMM fills on one card.

    python3 tools/probe_hmm_rows.py [--root DIR] [--json FILE]
                                    [--against FILE] [--sass DIR] [--paths]

Builds the kernels of the checkout at --root (default: the one holding
this script) with that checkout's own utils/cuda_build, and drives its
public wrappers (ops/profile_hmm_viterbi.viterbi_fill,
ops/profile_hmm_forward.forward_fill) on the batches of this checkout's
chip_smoke.py, so that two checkouts run the same inputs:

  vit-check    chip_smoke.py's 512 eventalign-shaped Viterbi segments
  vit-wave     32 of them, a launch of eventalign's wavefront
  fwd-check    chip_smoke.py's 2,048 call-methylation-shaped Forward
               segments at one kmer width (256)
  fwd-bucketed the same 2,048 launched as segments.forward_arrays_async
               launches them, one launch per bucket of power-of-two event
               length and kmer width; fwd-<T>x<KP> is each bucket alone
  vit-<kp>, fwd-<kp>
               chip_smoke.py's batch at each width of HMM_WIDTHS

With --paths it then runs chip_smoke.py's eventalign and
call-methylation main paths (phase 6) under torch.profiler and reports
each fill's summed device time and launches there (path ms).

Each time is a CUDA-event mean over REPS launches after a warm-up.
Prints ptxas's registers and spills for the two fills, one line per case
and one JSON line: the card's name and power limit, the times (ms) and a
sha256 of each case's output (the trace cells of the live event rows;
the scores).  --json writes that line to FILE; --against FILE fails the
run unless every output equals FILE's.  With --sass DIR, writes the two
fills' SASS (cuobjdump) into DIR and prints their instruction and branch
counts per kernel.

To compare two commits, unpack one with `git archive` into a directory
that .gitignore lists (here P) and run the two in turns in one call:

    python3 tools/probe_hmm_rows.py --root P --json p1.json
    python3 tools/probe_hmm_rows.py --against p1.json
    python3 tools/probe_hmm_rows.py --against p1.json
    python3 tools/probe_hmm_rows.py --root P --against p1.json
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
KERNELS = ("viterbi_fill", "forward_fill")
REPS = 10


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sass(cs, out_dir):
    """Write the two fills' SASS into out_dir and log each kernel's
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


def cases(cs, model, dev):
    """(case, kernel, [prepared inputs of each launch]) in timing order."""
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
    return out


def digest(name, x, out) -> str:
    """sha256 of one launch's output: the Viterbi's trace cells of the
    live event rows (the rest are never read), the Forward's scores."""
    import torch
    if name == "viterbi_fill":
        rows = torch.arange(out.shape[1], device=out.device)[None, :, None]
        out = out[(rows < x["n_events"][:, None, None].long()).expand(
            out.shape)]
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package is driven")
    ap.add_argument("--json", metavar="FILE", help="write the result here")
    ap.add_argument("--against", metavar="FILE",
                    help="fail unless every output equals this result's")
    ap.add_argument("--sass", metavar="DIR",
                    help="write the two fills' SASS into DIR")
    ap.add_argument("--paths", action="store_true",
                    help="also time the fills on their main paths")
    a = ap.parse_args()
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this probe needs a GPU")
    sys.path.insert(0, os.path.abspath(a.root))
    import nanopolish_tpu_torch
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
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

    fill = {"viterbi_fill": pv.viterbi_fill, "forward_fill": pf.forward_fill}
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    times, digests = {}, {}
    for case, name, xs in cases(cs, model, dev):
        args = [(x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
                 x["n_kmers"], x["trans"], x["clips"]) for x in xs]
        digests[case] = [digest(name, x, fill[name](*arg))
                         for x, arg in zip(xs, args)]
        times[case] = cs.cuda_ms(lambda: [fill[name](*arg) for arg in args],
                                 reps=REPS)
        cs.log(f"{case}: {sum(x['mu'].shape[0] for x in xs)} segments in "
               f"{len(xs)} launches, kmer widths "
               f"{sorted({x['mu'].shape[1] for x in xs})}: "
               f"{times[case]:.4f} ms")
    result = {"card": cs.card(), "root": os.path.abspath(a.root),
              "ms": times, "sha256": digests}
    if a.paths:
        launches, path_ms, _ = cs.phase_eventalign(dev)
        cm_launches, cm_path_ms = cs.phase_call_methylation(dev)
        launches["forward_fill"] = cm_launches["forward_fill"]
        path_ms["forward_fill"] = cm_path_ms["forward_fill"]
        result["path_ms"] = {k: path_ms[k] for k in KERNELS}
        result["path_launches"] = {k: launches[k] for k in KERNELS}
    print(json.dumps(result), flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(result, fh)
    if a.against:
        with open(a.against) as fh:
            want = json.load(fh)["sha256"]
        differ = [c for c in digests if digests[c] != want.get(c)]
        if differ:
            cs.fail(f"outputs differ from {a.against} in {differ}")
        cs.log(f"every output equals {a.against}'s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
