"""The macro profiler (``NPT_PROFILE``) and the sync accounting
(``utils/syncstats``) on an eventalign run, on the CPU.

The corpus is the eventalign golden recipe of
tests/test_torch_eventalign_golden.py.  The profiler must change no byte of
the TSV or the summary, and two identical runs must fetch as often and as
much.
"""

import io
import os

import pytest
import torch

from nanopolish_tpu_torch.alignment.device_chain import (CHAIN_STATS,
                                                         reset_chain_stats)
from nanopolish_tpu_torch.apps import eventalign as ea_app
from nanopolish_tpu_torch.utils import profiler
from nanopolish_tpu_torch.utils.syncstats import SYNC_STATS
from tests.test_torch_eventalign_golden import GOLDEN_DIR
from tests.test_torch_eventalign_golden import ea_pipe  # noqa: F401

torch.set_num_threads(2)


def _run(p, env, monkeypatch, *extra):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    summary = str(p["dir"] / "profile_summary.tsv")
    out = io.StringIO()
    reset_chain_stats()
    ea_app.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"],
                 "--print-read-names", "--summary", summary, "--device",
                 "cpu", *extra], stdout=out)
    return out.getvalue(), open(summary).read(), dict(CHAIN_STATS)


def _golden(name):
    return open(os.path.join(GOLDEN_DIR, name)).read()


@pytest.mark.parametrize("chain", ["0", "1"])
def test_profile_changes_no_output_and_reports_scopes(ea_pipe,  # noqa: F811
                                                      monkeypatch, chain):
    """With the device chain on and off: the goldens with and without
    NPT_PROFILE=1, and the path's scopes counted and reported."""
    plain = _run(ea_pipe, {"NPT_EA_DEVICE_CHAIN": chain}, monkeypatch)
    assert plain[0] == _golden("eventalign.tsv")
    assert plain[1] == _golden("eventalign_summary.tsv")
    before = profiler.snapshot()
    monkeypatch.setenv("NPT_PROFILE", "1")
    profiled = _run(ea_pipe, {"NPT_EA_DEVICE_CHAIN": chain}, monkeypatch)
    assert profiled == plain
    after = profiler.snapshot()
    names = ["read_builder.process_chunk", "ea.emit"]
    if chain == "1":
        names += ["ea.stage_jobs", "ea.chain_build", "ea.chain_unpack"]
    for name in names:
        assert after[name][0] > before.get(name, (0, 0.0))[0], name
    buf = io.StringIO()
    profiler._report(buf)
    assert "[profile] ea.emit: " in buf.getvalue()
    chain_line = [ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("[profile] device chain: ")]
    if chain == "1":
        assert len(chain_line) == 1 and " 0 refills" in chain_line[0]
    else:
        assert not chain_line


def test_sync_counts_are_deterministic(ea_pipe, monkeypatch):  # noqa: F811
    """Two identical runs fetch as often and as much: chain on, one ingest
    fetch, the chain's active-count read and its one fetch of the rows."""
    snaps = []
    for _ in range(2):
        with SYNC_STATS.capture() as snap:
            _run(ea_pipe, {"NPT_EA_DEVICE_CHAIN": "1"}, monkeypatch)
        snaps.append(snap)
    a, b = snaps
    assert a.sync_count == b.sync_count > 0
    assert a.bytes_fetched == b.bytes_fetched > 0
    assert a.blocked_s >= 0.0 and a.host_s > 0.0
