"""The readers of ea-longread's device-chain metrics: the three kernels'
roofline shares from the chain's counts (``harness/roofline.py``), the
chain's live-slot share and its wait share; each reads its value from a
traced eventalign run's record, and gives None for call-methylation's and
for a program that counts no chain work.  The reckonings equal
chip_smoke.py's bounds on its Viterbi check batch and a chain round."""

import numpy as np
import pytest

from harness import roofline, spec

CELL = "ea-longread"
CHAIN = {"chained": 361, "ineligible": 0, "aborted": 0, "batches": 2,
         "rounds": 1600, "checks": 50, "vit_cells": 1e9, "path_steps": 3e6,
         "live_windows": 1e4, "slot_rounds": 1e5}
KERNEL_S = {"viterbi_fill_warp_kernel": 0.02,
            "viterbi_fill_block_kernel": 0.01,
            "viterbi_backtrack_kernel": 0.005,
            "chain_step_prepare_kernel": 0.001,
            "chain_step_consume_kernel": 0.002,
            "banded_fill_kernel": 7.0, "Memcpy_DtoH": 3.0}
EXPECTED = {
    # operations bound the fill: 27 a cell at 67 TFLOP/s
    "viterbi_fill_roofline": 100 * 27e9 / 67e12 / 0.03,
    # bytes bound the backtrack: 5 a path step, 12 a window
    "viterbi_backtrack_roofline": 100 * (5 * 3e6 + 12 * 1e4) / 3.35e12
    / 0.005,
    "chain_step_roofline": 100 * 1e4 * 400_784 / 64 / 3.35e12 / 0.003,
    "ea_chain_live_share": 0.1,
    "ea_chain_wait_share": 0.5 / 20.0,
}


def _rec(app="eventalign", chain=CHAIN, scopes=None):
    return dict(app=app, wall_s=20.0, bases=4.6e6, busy_s=1.0,
                kernel_busy_s=0.9, window_s=20.0, kernel_s=dict(KERNEL_S),
                scopes={"ea.chain_check": 0.5, "ea.emit": 4.0}
                if scopes is None else scopes,
                chain=dict(chain), blocked_s=0.4)


@pytest.fixture(scope="module")
def readers():
    return spec.load_cell(CELL).readers


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(readers, name):
    assert readers[name](_rec()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_without_its_input(readers, name):
    read = readers[name]
    cm_chain = {k: 0 for k in CHAIN}
    assert read(_rec("call-methylation", cm_chain)) is None
    assert read(_rec("call-methylation", {})) is None
    if name == "ea_chain_wait_share":
        assert read(_rec(scopes={"ea.emit": 4.0})) is None
    else:
        # a program whose CHAIN_STATS has no work counters
        old = {k: v for k, v in CHAIN.items()
               if k not in ("vit_cells", "path_steps", "live_windows",
                            "slot_rounds")}
        assert read(_rec(chain=old)) is None


def test_roofline_shares_stay_at_or_under_100_at_the_bound(readers):
    """A run whose kernels took exactly their least time reads 100%."""
    rec = _rec()
    rec["kernel_s"] = {
        "viterbi_fill_warp_kernel": roofline.viterbi_fill_s(1e9, 3e6, 1e4),
        "viterbi_backtrack_kernel": roofline.viterbi_backtrack_s(3e6, 1e4),
        "chain_step_prepare_kernel": roofline.chain_step_s(1e4)}
    for name in ("viterbi_fill_roofline", "viterbi_backtrack_roofline",
                 "chain_step_roofline"):
        assert readers[name](rec) == pytest.approx(100.0, rel=1e-12)


def test_reckonings_equal_chip_smokes_bounds():
    """chip_smoke.py's kernel table (PERF.md): viterbi_fill on its 512
    eventalign-shaped check segments 0.00502 ms (operations), a
    chain_step round of 64 windows 0.000120 ms (bytes)."""
    # chip_smoke.viterbi_batch(model, 512, seed=7)'s shapes
    rng = np.random.default_rng(7)
    nk = rng.integers(95, 116, 512).astype(np.float64)
    nev = rng.integers(200, 261, 512).astype(np.float64)
    cells, steps = float(np.sum(nev * nk)), float(np.sum(nev + nk))
    fill_ms = roofline.viterbi_fill_s(cells, steps, 512) * 1e3
    assert round(fill_ms, 5) == 0.00502
    assert fill_ms == pytest.approx(cells * 27 / 67e12 * 1e3, rel=1e-12)
    assert round(roofline.chain_step_s(64) * 1e3, 6) == 0.000120


def test_metrics_are_declared_for_the_cell():
    cell = spec.load_cell(CELL)
    declared = {m["name"]: m for m in cell.per_layer}
    assert set(EXPECTED) | {"viterbi_fill_ms_per_mb",
                            "ea_chain_giveback_share", "ea_emit_share",
                            "ingest_thread_s_per_mb.ea",
                            "device_idle_share.ea",
                            "host_blocked_s_per_mb.ea"} == set(declared)
    for name, m in declared.items():
        assert m["workloads"] == [CELL] and m["moves"] == "card_s_per_mb"
        if name.endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
    assert cell.chips == 1 and cell.config["app"]["flags"] == [
        "--scale-events", "-t", "8"]
