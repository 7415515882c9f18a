#!/usr/bin/env python3
"""Where the table-route Forward's time goes on the card.

    python3 tools/probe_forward_table.py [--reps 3]

Builds csrc/forward_table.cu as the port builds it (cuda_build.NVCC_FLAGS)
and three copies of it edited by text substitution, each a diagnostic
that gives wrong scores: ``no-table-load`` reads no logsum table (the
entry becomes the index's bits), ``no-division`` replaces the emission's
IEEE division by a multiply, ``no-k-chain`` sums the K chain's two table
adds with plain adds.  Each is timed (CUDA-event mean of ``--reps``
launches after a warm-up; the variants in the order v, ..., ..., v) on:

  windows-2048   phase 4d's check shapes: 2,048 windows of 16-64 kmers and
                 16-128 events (many warps: issue-bound)
  read-2000      one read of 2,000 kmers x 6,000 events (one warp: the
                 wavefront step's latency)
  read-8000      one read of 8,000 kmers x 15,000 events (the train
                 step's width); the real kernel only

beside the wavefront steps each case takes (ceil(n_kmers / 32) x
(n_events + 31) a segment) and, for the one-warp reads, the cycles a
step at the card's highest SM clock.  The real kernel's scores are held
to forward_table's.  Prints the card's name and power limit, then one
JSON line; needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "no-table-load": [("    const float v = tbl[idx];\n",
                       "    const float v = __int_as_float(idx);\n")],
    "no-division": [(
        "const float em = npt_log_normal(lv, mu_k, sg_k, cc_k);",
        "const float em = __fmaf_rn(npt_mul(-0.5f, npt_mul(npt_sub(lv, mu_k),"
        " sg_k)), npt_sub(lv, mu_k), cc_k);")],
    "no-k-chain": [(
        "                const float c = npt_logsum_table(npt_add(p.lp_mk, Mn),\n"
        "                                                 npt_add(p.lp_b3, Bn),"
        " tbl);\n"
        "                const float K_new = npt_logsum_table(\n"
        "                    c, npt_add(Kn, p.lp_kk), tbl);",
        "                const float c = npt_add(p.lp_mk, Mn);\n"
        "                const float K_new = npt_add(c, Kn);")],
}


def build(name, src, d):
    """Compile src (text of forward_table.cu) into d/lib<name>.so; its
    npt_launch_forward_table under forward_table's ctypes signature."""
    from nanopolish_tpu_torch.utils import cuda_build
    path = os.path.join(d, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(d, f"lib{name}.so")
    subprocess.run([cuda_build._nvcc()] + cuda_build.NVCC_FLAGS +
                   ["-I", cuda_build.CSRC_DIR, "-o", so, path], check=True)
    fn = ctypes.CDLL(so).npt_launch_forward_table
    fn.argtypes = cuda_build._ARGTYPES["forward_table"] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, args):
    """One launch of fn on forward_table's arguments, as its wrapper
    makes it; returns the scores."""
    import torch
    from nanopolish_tpu_torch.ops import profile_hmm as ph
    from nanopolish_tpu_torch.utils.logsum import logsum_table
    lv, nev, mu, sg, c, nk, tr, cl = args
    B, T = lv.shape
    dev = lv.device
    out = torch.empty(B, dtype=torch.float32, device=dev)
    scratch = torch.empty((B, T, 4), dtype=torch.float32, device=dev)
    err = fn(lv.data_ptr(), T, mu.data_ptr(), sg.data_ptr(), c.data_ptr(),
             mu.shape[1], nev.data_ptr(), nk.data_ptr(), tr.data_ptr(),
             cl.data_ptr(), float(np.float32(ph._LOG1M_CLIP)),
             float(np.float32(ph._CLIP_BASE)),
             float(np.float32(ph._CLIP_STEP)), logsum_table(dev).data_ptr(),
             B, out.data_ptr(), scratch.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed (cudaError {err})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    from nanopolish_tpu_torch.utils import cuda_build
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda")
    print(cs.card(), flush=True)
    d = os.path.join(ROOT, "build", "probe_forward_table")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "forward_table.cu")) as fh:
        src = fh.read()
    fns = {"kernel": build("kernel", src, d)}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source changed; edit VARIANTS")
            text = text.replace(old, new)
        fns[name] = build(name.replace("-", "_"), text, d)

    model = PoreModelSet.instance().get_model("r9.4_450bps", "nucleotide",
                                              "template", 6)
    rng = np.random.default_rng(3)
    nk = rng.integers(16, 65, 2048).astype(np.int32)
    nev = rng.integers(16, 129, 2048).astype(np.int32)
    cases = {
        "windows-2048": cs.hmm_batch(model, nk, nev, rng),
        "read-2000": cs.hmm_batch(model, np.array([2000], np.int32),
                                  np.array([6000], np.int32), rng),
        "read-8000": cs.hmm_batch(model, np.array([8000], np.int32),
                                  np.array([15000], np.int32), rng)}
    clk = cs.sm_clock_mhz()
    report = {"card": cs.card(), "sm_clock_mhz": clk, "cases": {}}
    for case, batch in cases.items():
        x = pf.prepare_forward_inputs(*batch, device=dev)
        a = [x[k] for k in cs.FWD_ARGS]
        if not cs.bits_equal(launch(fns["kernel"], a), pf.forward_table(*a)):
            raise SystemExit(f"{case}: the built kernel differs from "
                             f"forward_table")
        steps = int(np.sum(-(-batch[4].astype(np.int64) // 32) *
                           (batch[1].astype(np.int64) + 31)))
        names = ["kernel"] if case == "read-8000" else list(fns)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(cs.cuda_ms(lambda: launch(fns[n], a), args.reps))
        rec = {"steps": steps, "ms": {n: float(np.mean(v))
                                      for n, v in ms.items()}}
        if len(batch[1]) == 1:
            rec["cycles_a_step"] = {n: t * 1e-3 * clk * 1e6 / steps
                                    for n, t in rec["ms"].items()}
        report["cases"][case] = rec
        print(case, json.dumps(rec), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
