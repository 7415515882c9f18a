#!/usr/bin/env python3
"""How close train-poremodel-from-basecalls gets to the model that made
the signal, on a CPU-sized cut of chip_smoke.py's eventalign corpus.

    JAX_PLATFORMS=cpu python3 tools/train_poremodel_levels.py [--reads 16]
        [--read-len 2000] [--genome-len 16000] [--rounds 3]
    JAX_PLATFORMS=cpu python3 tools/train_poremodel_levels.py --reads 8 \
        --read-len 400 --genome-len 400     # chip_smoke's short-read cut

Builds reads the way chip_smoke.build_main_corpus does (r9.4_450bps
nucleotide signal with shift 1.5 pA and scale 1.01, seed 99), runs the JAX
package's app and the port's (``--device cpu``) on them, and prints, for
each, the kmers it updated and the median |level_mean - builtin| over them;
the two model files must be byte-identical.  chip_smoke.TP_LEVEL_MAX, the
bound its 64-read runs on the card are held to, comes from the JAX app's
number here.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reads", type=int, default=16)
    p.add_argument("--read-len", type=int, default=2000)
    p.add_argument("--genome-len", type=int, default=16000)
    p.add_argument("--rounds", type=int, default=3)
    opt = p.parse_args()

    import chip_smoke
    from nanopolish_tpu.apps import train_poremodel_from_basecalls as jax_app
    from nanopolish_tpu_torch.apps import train_poremodel_from_basecalls as tp
    from nanopolish_tpu_torch.models.pore_model import (PoreModel,
                                                        PoreModelSet)

    rng = np.random.default_rng(2024)
    plan = [(f"r{i:03d}", int(pos), bool(rng.integers(0, 2)))
            for i, pos in enumerate(rng.integers(
                0, opt.genome_len - opt.read_len + 1, opt.reads))]
    truth = PoreModelSet.instance().get_model(*chip_smoke.NUC_KEY)
    with tempfile.TemporaryDirectory() as d:
        _, fastq, _ = chip_smoke.build_pipeline(d, opt.genome_len, plan,
                                                opt.read_len, seed=99)
        paths = {}
        for name, run, extra in (("jax", jax_app.main, []),
                                 ("port", tp.main, ["--device", "cpu"])):
            paths[name] = os.path.join(d, f"{name}.model")
            run(["-r", fastq, "--rounds", str(opt.rounds), "-o",
                 paths[name], *extra])
            m = PoreModel.from_file(paths[name])
            upd = m.level_stdv != 2.5
            med = np.median(np.abs(m.level_mean[upd] - truth.level_mean[upd]))
            print(f"{name}: {opt.reads} reads x {opt.read_len} bases, "
                  f"{opt.rounds} rounds: {int(upd.sum())} of {upd.size} kmers "
                  f"updated, median |level - builtin| {med:.3f} pA")
        same = open(paths["jax"], "rb").read() == \
            open(paths["port"], "rb").read()
        print(f"model files byte-identical: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
