"""The device chain's counts of its work on the CPU (NPT_EA_DEVICE_CHAIN=1,
the plain chain_step): CHAIN_STATS' ``vit_cells``, ``path_steps`` and
``live_windows`` after one eventalign call equal the sums over the plain
reference chain's own windows (``benchmark/reference/eventalign.py``) for
the same reads: each window's events x kmers, its Viterbi path's length
and one; ``slot_rounds`` is the call's slots x its rounds; with fewer
slots than jobs, the same windows run in refilled slots.  The reads are
the benchmark generator's, three of 1-3 kb from one seed."""

import io
import os
import sys

import pytest
import torch

from nanopolish_tpu_torch.alignment import device_chain as dc
from nanopolish_tpu_torch.apps import eventalign as ea_app

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.append(BENCH)

from harness import check, generator, spec  # noqa: E402
from reference import eventalign as ref_ea  # noqa: E402

torch.set_num_threads(2)

SEED = 2 ** 31 + 97
MODELS_NPZ = os.path.join(os.path.dirname(BENCH), "nanopolish_tpu_torch",
                          "data", "builtin_models.npz")


@pytest.fixture(scope="module")
def small_cell():
    cell = spec.load_cell("ea-longread")
    cell.config["genome"]["length"] = 20000
    cell.traffic.update(median_bases=1800, sigma=0.4, min_bases=1000,
                        max_bases=3000)
    mean = 1800 * 2.718281828 ** (0.4 ** 2 / 2)
    cell.config["coverage"] = 3 * mean / 20000
    return cell


def _counts(cell, tmp_path, monkeypatch):
    """CHAIN_STATS of one eventalign call through the chain on the cell's
    reads, and the same counts over the reference chain's windows."""
    ds = generator.synthesize(cell.config, cell.traffic, SEED, MODELS_NPZ)
    assert len(ds.reads) == 3
    assert 1000 <= min(len(r.basecall) for r in ds.reads) and \
        max(len(r.basecall) for r in ds.reads) <= 3000
    paths = generator.write_files(ds, str(tmp_path / "data"))
    monkeypatch.setenv("NPT_EA_DEVICE_CHAIN", "1")
    dc.reset_chain_stats()
    out = io.StringIO()
    ea_app.main(["-r", paths["fastq"], "-b", paths["bam"], "-g",
                 paths["ref_fa"], *cell.config["app"]["flags"],
                 "--device", "cpu"], stdout=out)
    got = dict(dc.CHAIN_STATS)
    assert got["chained"] == 3 and got["aborted"] == got["ineligible"] == 0

    # the reference's chain consumes each of its own windows once (a
    # guessed window off the chain is never consumed)
    want = {"vit_cells": 0, "path_steps": 0, "live_windows": 0}
    consume = ref_ea.consume

    def counted(job, p, res):
        lv, mu = p["seg"][0], p["seg"][1]
        want["vit_cells"] += len(lv) * len(mu)
        want["path_steps"] += len(res[0])
        want["live_windows"] += 1
        return consume(job, p, res)
    monkeypatch.setattr(ref_ea, "consume", counted)
    by_index = {r.bam_index: r.name for r in ds.reads}
    lines = {r.name: [] for r in ds.reads}
    for ln in out.getvalue().splitlines()[1:]:
        lines[cell.app.read_key(ln, by_index)].append(ln)
    ref = check.reference_rows(cell, ds, ds.reads, "cpu", lines)
    assert check.compare(cell.app, lines, ref)["rows_differing"] == 0
    print(f"chain {got}, reference {want}")
    assert want["live_windows"] > 3 * 15
    return got, want


def test_chain_counts_equal_the_reference_chains_windows(
        small_cell, tmp_path, monkeypatch):
    got, want = _counts(small_cell, tmp_path, monkeypatch)
    assert got["slot_rounds"] == 3 * got["rounds"] and got["refills"] == 0
    assert {k: got[k] for k in want} == want


def test_refilled_chain_counts_equal_the_reference_chains_windows(
        small_cell, tmp_path, monkeypatch):
    """Two slots for the three jobs: the third takes the first slot
    freed, and the counts are still the reference's windows."""
    monkeypatch.setattr(dc, "CHAIN_BATCH", 2)
    got, want = _counts(small_cell, tmp_path, monkeypatch)
    assert got["slot_rounds"] == 2 * got["rounds"] and got["refills"] == 1
    assert {k: got[k] for k in want} == want
