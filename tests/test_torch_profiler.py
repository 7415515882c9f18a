"""The port's opt-in macro profiler and progress bar (utils/profiler.py;
reference: src/common/profiler.h:17-62, src/common/progress.h:16-50) and
its sync accounting (utils/syncstats.py), against the JAX package's
copies: the cases of tests/test_profiler.py on the port, the report lines
in the JAX format for the same scope calls, and timed_fetch's counts."""

import io
import re
import sys
import threading

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.utils import profiler
from nanopolish_tpu_torch.utils import syncstats
from nanopolish_tpu_torch.utils.profiler import (Progress, profile_scope,
                                                 profiled, snapshot)

torch.set_num_threads(2)


def test_profile_scope_disabled_by_default(monkeypatch):
    monkeypatch.delenv("NPT_PROFILE", raising=False)
    before = dict(snapshot())
    with profile_scope("t.disabled"):
        pass
    assert "t.disabled" not in snapshot() or \
        snapshot()["t.disabled"] == before.get("t.disabled")


def test_profile_scope_accumulates(monkeypatch):
    monkeypatch.setenv("NPT_PROFILE", "1")
    for _ in range(3):
        with profile_scope("t.scope"):
            pass
    calls, secs = snapshot()["t.scope"]
    assert calls >= 3 and secs >= 0.0

    @profiled
    def f(x):
        return x + 1

    assert f(1) == 2
    assert any("f" in k for k in snapshot())


def test_progress_bar_renders():
    buf = io.StringIO()
    p = Progress("train", width=10, fp=buf)
    p.update(0.5)
    p.end()
    s = buf.getvalue()
    assert " 50%" in s and "100%" in s and "[train]" in s


def test_progress_bar_matches_jax():
    from nanopolish_tpu.utils.profiler import Progress as JaxProgress
    outs = []
    for cls in (Progress, JaxProgress):
        buf = io.StringIO()
        p = cls("round", width=20, fp=buf)
        for f in (0.0, 0.25, 0.25, 0.5, 1.5):
            p.update(f)
        p.end()
        # elapsed seconds differ between the two runs
        outs.append(re.sub(r"\d+\.\d+s", "Ts", buf.getvalue()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("calls", [{"a.x": (3, 1_500_000), "b.y": (1, 42)},
                                   {"meth.write": (1000, 2_000_000_000)}])
def test_report_lines_are_the_jax_format(monkeypatch, calls):
    """The same scope totals print the same `[profile] name: N calls, S s
    total, M ms/call` lines, slowest first, as the JAX package's."""
    from nanopolish_tpu.utils import profiler as jax_profiler
    out = []
    for mod in (profiler, jax_profiler):
        monkeypatch.setattr(mod, "_scopes",
                            {k: [c, float(ns)] for k, (c, ns) in calls.items()})
        buf = io.StringIO()
        mod._report(buf)
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert out[0].splitlines()[0].startswith(
        f"[profile] {max(calls, key=lambda k: calls[k][1])}: ")


def test_every_print_every_calls_a_line_as_jax(monkeypatch, capsys):
    from nanopolish_tpu.utils import profiler as jax_profiler
    monkeypatch.setenv("NPT_PROFILE", "1")
    lines = []
    for mod in (profiler, jax_profiler):
        monkeypatch.setattr(mod, "_scopes", {})
        monkeypatch.setattr(mod, "PRINT_EVERY", 2)
        for _ in range(4):
            with mod.profile_scope("t.every"):
                pass
        lines.append(re.sub(r"\d+\.\d+ s", "S s",
                            capsys.readouterr().err))
    assert lines[0] == lines[1] == "[profile] t.every: 2 calls, S s\n" \
        "[profile] t.every: 4 calls, S s\n"


def _hammer(work, n):
    """Run work() on n threads at once with a short switch interval (more
    threads than this sandbox's cores, so lost updates would show)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(n)

        def run():
            barrier.wait(timeout=60)
            work()

        threads = [threading.Thread(target=run) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_scopes_are_thread_safe(monkeypatch):
    monkeypatch.setenv("NPT_PROFILE", "1")
    monkeypatch.setattr(profiler, "_scopes", {})

    def work():
        for _ in range(500):
            with profile_scope("t.threads"):
                pass

    _hammer(work, 16)
    assert snapshot()["t.threads"][0] == 8000


def test_timed_fetch_counts_a_cpu_tensor():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with syncstats.SYNC_STATS.capture() as snap:
        a = syncstats.timed_fetch(t)
        b = syncstats.timed_fetch(np.zeros(5, np.int64))
    np.testing.assert_array_equal(a, t.numpy())
    assert b.shape == (5,)
    assert snap.sync_count == 2 and snap.bytes_fetched == 48 + 40
    assert snap.as_dict()["sync_count"] == 2
    assert snap.wall_s >= snap.blocked_s >= 0.0


def test_timed_fetch_is_thread_safe():
    """N threads x M fetches count N * M syncs and their bytes."""
    n, m = 16, 250
    t = torch.ones(16, dtype=torch.int32)

    def work():
        for _ in range(m):
            syncstats.timed_fetch(t)

    with syncstats.SYNC_STATS.capture() as snap:
        _hammer(work, n)
    assert snap.sync_count == n * m
    assert snap.bytes_fetched == n * m * 64


def test_sync_context_records_a_wait():
    with syncstats.SYNC_STATS.capture() as snap:
        with syncstats.SYNC_STATS.sync(nbytes=100):
            pass
    assert (snap.sync_count, snap.bytes_fetched) == (1, 100)


def test_builtin_models_load_once_under_concurrent_first_use():
    """The first lookups of a fresh registry from many threads at once
    (the loader threads' first reads) all find their model: none sees
    the built-in set half loaded."""
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    for _ in range(5):
        pms = PoreModelSet()
        errors = []

        def work():
            try:
                pms.get_model("r9.4_450bps", "cpg", "template", 6)
            except KeyError as e:
                errors.append(e)

        _hammer(work, 16)
        assert not errors and len(pms._models) == 14
