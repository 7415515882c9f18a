"""The traffic generator: the same seed gives the same inputs, a mix's
read lengths are its stratified log-normal quantiles in one order along
the region whatever the seed, and a pass holds the configuration's
coverage of its genome."""

import json
import os
from statistics import NormalDist

import numpy as np
import pytest

from conftest import BENCH
from harness import generator

NPZ = os.path.join(os.path.dirname(BENCH), "nanopolish_tpu_torch", "data",
                   "builtin_models.npz")


def _mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        return json.load(fh)


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)


def test_lengths_are_the_mix_quantiles():
    t = _mix("longread")
    for n in (361, 389, 7):
        want = np.clip(np.rint(np.exp(
            np.log(t["median_bases"]) + t["sigma"] * np.array(
                [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]))),
            t["min_bases"], t["max_bases"])
        got = generator.read_lengths(t, n)
        assert sorted(got.tolist()) == sorted(want.astype(int).tolist())
        assert got.tolist() != sorted(got.tolist())


@pytest.mark.parametrize("config,reads,bases", [
    ("r94-ecoli-eventalign", 361, 2_320_016),
    ("r94-na12878-cpg", 389, 2_500_674)])
def test_a_pass_is_the_configurations_coverage(config, reads, bases):
    cfg, t = _config(config), _mix("longread")
    n = generator.reads_per_pass(cfg, t)
    assert n == reads
    lens = generator.read_lengths(t, n)
    # the source's mean read length and read N50 (6.43 kb, 10.6 kb)
    s = np.sort(lens)[::-1]
    n50 = s[np.searchsorted(np.cumsum(s), s.sum() / 2)]
    assert int(lens.sum()) == bases and 10_200 < n50 < 10_800
    assert abs(lens.mean() - 6_430) < 30
    assert abs(lens.sum() / cfg["genome"]["length"] - cfg["coverage"]) < 0.01


def test_same_seed_same_inputs():
    cfg = _config("r94-na12878-cpg")
    cfg["genome"]["length"] = 50_000
    t = dict(_mix("longread"), median_bases=1500, sigma=0.5)
    cfg["coverage"] = 6 * 1500 * np.exp(0.125) / 50_000
    a = generator.synthesize(cfg, t, 2 ** 33 + 1, NPZ)
    b = generator.synthesize(cfg, t, 2 ** 33 + 1, NPZ)
    c = generator.synthesize(cfg, t, 2 ** 33 + 2, NPZ)
    assert a.genome == b.genome and a.genome != c.genome
    for x, y in zip(a.reads, b.reads):
        assert (x.name, x.pos, x.rc, x.basecall, x.bam_index) == \
            (y.name, y.pos, y.rc, y.basecall, y.bam_index)
        assert np.array_equal(x.adc, y.adc)
    assert sum(r.rc for r in a.reads) == 3
    # the same lengths in the same order along the genome: the same chunks
    # of reads in coordinate order, whatever the seed
    def laid_out(ds):
        return [len(r.basecall) for r in sorted(ds.reads,
                                                key=lambda r: r.bam_index)]
    assert laid_out(a) == laid_out(c)
    assert [r.pos for r in a.reads] != [r.pos for r in c.reads]


def test_genome_composition():
    cfg = _config("r94-na12878-cpg")
    cfg["genome"]["length"] = 400_000
    g = generator.make_genome(np.random.default_rng(3), cfg)
    gc = (g.count("G") + g.count("C")) / len(g)
    cpg = g.count("CG") / (len(g) - 1)
    assert abs(gc - 0.41) < 0.01 and abs(cpg - 0.01) < 0.002
