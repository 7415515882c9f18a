"""The port's spans (utils/profiler.py under NPT_PROFILE): start, end,
thread and parent; self time; the ``.self`` keys of ``snapshot()``; the
fetch waits of ``utils/syncstats`` attributed to the innermost span; the
Chrome trace under NPT_PROFILE_TRACE; nothing at all with NPT_PROFILE
unset; and the clock, which must be the one torch.profiler stamps its
events with.

This file imports neither JAX nor the JAX package, so that its
``cuda`` case runs on a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``."""

import json
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from nanopolish_tpu_torch.utils import profiler
from nanopolish_tpu_torch.utils.profiler import profile_scope, snapshot
from nanopolish_tpu_torch.utils.syncstats import SYNC_STATS, timed_fetch

torch.set_num_threads(2)


@pytest.fixture
def fresh(monkeypatch):
    """NPT_PROFILE on, with empty totals and no kept spans."""
    monkeypatch.setenv("NPT_PROFILE", "1")
    monkeypatch.delenv("NPT_PROFILE_TRACE", raising=False)
    for name, value in (("_scopes", {}), ("_self", {}), ("_records", []),
                        ("_epoch_offset", None)):
        monkeypatch.setattr(profiler, name, value)


@pytest.fixture
def clock(monkeypatch):
    """A clock the test sets: now[0] ns."""
    now = [0]
    monkeypatch.setattr(profiler, "_clock", lambda: now[0])
    return now


def _in_thread(fn, name="worker"):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), name=name)
    t.start()
    t.join(timeout=60)
    return out[0]


def test_span_start_end_thread_and_parent(fresh, clock):
    clock[0] = 100
    with profile_scope("t.outer") as outer:
        clock[0] = 110
        with profile_scope("t.inner") as inner:
            with profile_scope("t.leaf") as leaf:
                clock[0] = 140
        with profile_scope("t.after") as after:
            pass

        def worker():
            with profile_scope("t.alone") as alone:
                clock[0] = 150
            with profile_scope("t.remote", parent=outer,
                               chunk=(1, 0)) as remote:
                clock[0] = 190
            return alone, remote

        alone, remote = _in_thread(worker)
        clock[0] = 200
    with profile_scope("t.next") as nxt:
        pass
    assert (outer.start, outer.end) == (100, 200)
    assert (inner.start, inner.end) == (110, 140)
    assert (remote.start, remote.end) == (150, 190)
    assert outer.parent is None and inner.parent is outer
    assert leaf.parent is inner and after.parent is outer
    assert alone.parent is None and nxt.parent is None
    assert remote.parent is outer and remote.chunk == (1, 0)
    assert outer.tid == inner.tid == threading.get_native_id()
    assert remote.tid not in (0, outer.tid)
    assert outer.thread == threading.current_thread().name
    assert remote.thread == alone.thread == "worker"
    assert len({outer.id, inner.id, remote.id}) == 3


def test_self_time_leaves_out_same_thread_children_only(fresh, clock):
    with profile_scope("t.root") as root:
        clock[0] = 10
        with profile_scope("t.child"):
            clock[0] = 40
        clock[0] = 45

        def worker():
            with profile_scope("t.beside", parent=root):
                clock[0] = 95

        _in_thread(worker)
        clock[0] = 100
    assert root.child_ns == 30 and root.self_ns == 70
    snap = snapshot()
    assert snap["t.root"] == (1, 100e-9)
    assert snap["t.root.self"] == (1, pytest.approx(70e-9))
    assert snap["t.child"] == (1, 30e-9) and snap["t.beside"] == (1, 50e-9)
    # names whose spans had no child on their thread have no .self key
    assert "t.child.self" not in snap and "t.beside.self" not in snap


def test_self_time_sums_over_calls_and_totals_are_unchanged(fresh, clock):
    for _ in range(3):
        start = clock[0]
        with profile_scope("t.loop"):
            clock[0] = start + 5
            with profile_scope("t.step"):
                clock[0] = start + 7
            clock[0] = start + 10
    with profile_scope("t.loop"):            # a call with no child
        clock[0] += 4
    snap = snapshot()
    assert snap["t.loop"] == (4, pytest.approx(34e-9))
    assert snap["t.loop.self"] == (4, pytest.approx(28e-9))
    assert snap["t.step"] == (3, pytest.approx(6e-9))
    buf = __import__("io").StringIO()
    profiler._report(buf)
    assert [ln.split(":")[0] for ln in buf.getvalue().splitlines()] == \
        ["[profile] t.loop", "[profile] t.step"]


def test_fetch_waits_go_to_the_innermost_span(fresh):
    before = SYNC_STATS.snapshot()
    with profile_scope("t.outer") as outer:
        with profile_scope("t.inner") as inner:
            SYNC_STATS.record(0.25, 100)
            timed_fetch(torch.zeros(4, dtype=torch.float32))
        SYNC_STATS.record(0.5, 8)
        with SYNC_STATS.sync(3):
            pass
    after = SYNC_STATS.snapshot()
    assert inner.fetch_bytes == 116 and inner.blocked_s >= 0.25
    assert outer.fetch_bytes == 11 and outer.blocked_s >= 0.5
    assert inner.blocked_s < 0.5 and outer.blocked_s < 0.75
    # the global counts are as they were without the spans
    assert after.sync_count - before.sync_count == 4
    assert after.bytes_fetched - before.bytes_fetched == 127
    # a wait on another thread goes to that thread's span alone
    with profile_scope("t.main") as main:
        def worker():
            with profile_scope("t.fetch", parent=main) as f:
                SYNC_STATS.record(1.0, 64)
            return f
        f = _in_thread(worker)
    assert (f.blocked_s, f.fetch_bytes) == (1.0, 64)
    assert (main.blocked_s, main.fetch_bytes) == (0.0, 0)
    SYNC_STATS.record(0.125, 1)               # no span open: counted only


def test_chrome_trace_of_the_kept_spans(fresh, monkeypatch, tmp_path):
    path = tmp_path / "spans.json"
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(path))
    with profile_scope("t.pass") as root:
        with ThreadPoolExecutor(1, thread_name_prefix="loader") as pool:
            def load():
                with profile_scope("t.load", parent=root, chunk=(3, 1)):
                    SYNC_STATS.record(0.5, 10)
            pool.submit(load).result()
        with profile_scope("t.write") as w:
            w.args = {"rows": 7}
    assert profiler.export_trace() == str(path)
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    names = {e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert names == {"main", "loader-0"}
    spans = {e["name"]: e for e in ev if e["ph"] == "X"}
    assert set(spans) == {"t.pass", "t.load", "t.write"}
    p, ld, w = spans["t.pass"], spans["t.load"], spans["t.write"]
    assert ld["args"]["parent"] == p["args"]["id"]
    assert ld["args"]["parent_name"] == "t.pass"
    assert ld["args"]["chunk"] == [3, 1]
    assert ld["args"]["blocked_s"] == 0.5 and ld["args"]["fetch_bytes"] == 10
    assert w["args"]["rows"] == 7 and "parent" not in p["args"]
    assert ld["tid"] != p["tid"] == w["tid"]
    # ts and dur in us on the Unix epoch; children inside their parent
    now_us = time.time_ns() / 1e3
    for e in (p, ld, w):
        assert 0 <= now_us - e["ts"] < 60e6 and e["dur"] >= 0
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
    assert p["args"]["self_s"] <= p["dur"] / 1e6


def test_nothing_without_npt_profile(fresh, monkeypatch, tmp_path):
    monkeypatch.delenv("NPT_PROFILE")
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "never.json"))

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(profiler, "_clock", no_clock)
    scope = profile_scope("t.off")
    assert scope is profile_scope("t.other", chunk=(1, 2))
    tracemalloc.start()
    try:
        first = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profile_scope("t.off") as s:
                assert s is None
        last = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, profiler.__file__)]
    grown = last.filter_traces(here).compare_to(
        first.filter_traces(here), "lineno")
    assert sum(d.size_diff for d in grown) <= 0
    SYNC_STATS.record(0.1, 1)
    assert snapshot() == {} and profiler.spans() == []
    assert profiler.trace_events() == []
    assert not (tmp_path / "never.json").exists()


def _kineto_events(prof):
    return list(prof.profiler.kineto_results.events())


def test_spans_are_on_the_profilers_clock(fresh, monkeypatch, tmp_path):
    """A span opened around a torch op contains the op's interval as the
    profiler recorded it, in the span and in the exported trace."""
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "spans.json"))
    a = torch.randn(256, 256)
    a @ a
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with profile_scope("t.op") as span:
            a @ a
    mm = [e for e in _kineto_events(prof) if e.name() == "aten::mm"]
    assert len(mm) == 1
    op = mm[0]
    start, end = span.epoch()
    assert start <= op.start_ns() <= op.end_ns() <= end
    # the same clock, not another one shifted by less than the span
    assert end - start < 50_000_000
    ev = next(e for e in profiler.trace_events() if e.get("name") == "t.op")
    assert ev["ts"] <= op.start_ns() / 1e3
    assert op.end_ns() / 1e3 <= ev["ts"] + ev["dur"]


@pytest.mark.cuda
def test_a_kernel_lies_within_its_span_on_the_card(fresh):
    """A kernel launched and synchronized inside a span lies within it,
    on the device clock as torch.profiler converts it, to 0.1 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the profiler's device clock)")
    x = torch.randn(4096, 4096, device="cuda")
    (x @ x).sum().item()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profile_scope("t.kernel") as span:
            x @ x
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in _kineto_events(prof)
               if e.device_type() == cuda and e.duration_ns() > 0
               and not e.name().startswith(("Memcpy", "Memset"))]
    assert kernels
    tol = 100_000
    start, end = span.epoch()
    for k in kernels:
        assert start - tol <= k.start_ns(), (k.name(), k.start_ns())
        assert k.end_ns() <= end + tol, (k.name(), k.end_ns())


def test_merged_trace_puts_the_op_inside_its_span(fresh, monkeypatch,
                                                  tmp_path):
    """tools/merge_traces.py: the span export and torch.profiler's
    export_chrome_trace of the same run on one clock."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "merge_traces.py")
    spec = importlib.util.spec_from_file_location("merge_traces", path)
    merge_traces = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(merge_traces)
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "spans.json"))
    a = torch.randn(256, 256)
    a @ a
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with profile_scope("t.merged"):
            a @ a
    prof.export_chrome_trace(str(tmp_path / "device.json"))
    profiler.export_trace()
    n = merge_traces.merge(str(tmp_path / "spans.json"),
                           str(tmp_path / "device.json"),
                           str(tmp_path / "merged.json"))
    ev = json.loads((tmp_path / "merged.json").read_text())["traceEvents"]
    assert n == len(ev)
    span = next(e for e in ev if e.get("name") == "t.merged")
    (mm,) = [e for e in ev if e.get("name") == "aten::mm"]
    assert span["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]
    assert mm["tid"] == span["tid"]


def test_spans_under_contention(fresh, monkeypatch, tmp_path):
    """More threads than cores, a short switch interval: every span kept,
    each name's totals and self time whole, every parent on its thread."""
    import sys
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "spans.json"))
    n_threads, n = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(n_threads)

        def work():
            barrier.wait(timeout=60)
            for _ in range(n):
                with profile_scope("t.outer"):
                    with profile_scope("t.inner"):
                        SYNC_STATS.record(0.0, 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = profiler.spans()
    assert len(spans) == 2 * n_threads * n
    snap = snapshot()
    assert snap["t.outer"][0] == snap["t.outer.self"][0] == n_threads * n
    assert snap["t.inner"][0] == n_threads * n
    outer_ns = sum(s.end - s.start for s in spans if s.name == "t.outer")
    inner_ns = sum(s.end - s.start for s in spans if s.name == "t.inner")
    assert snap["t.outer.self"][1] == pytest.approx((outer_ns - inner_ns)
                                                    / 1e9)
    for s in spans:
        if s.name == "t.inner":
            assert s.parent.name == "t.outer" and s.parent.tid == s.tid
            assert s.fetch_bytes == 1
    rows = [e for e in profiler.trace_events() if e["ph"] == "M"]
    assert len(rows) == n_threads


def test_a_thread_id_given_again_gets_a_row_of_its_own(fresh, monkeypatch,
                                                       tmp_path):
    """Each pass builds new pools, and the system may give a finished
    thread's id to a later thread: the later thread's spans keep their
    own name and export on a row of their own."""
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "spans.json"))
    monkeypatch.setattr(threading, "get_native_id", lambda: 4242)

    def work(name):
        with profile_scope(name):
            pass

    for name in ("loader_0", "fetch_0", "loader_0"):
        _in_thread(lambda: work("t." + name.split("_")[0]), name=name)
    spans = profiler.spans()
    assert [(s.tid, s.thread) for s in spans] == [
        (4242, "loader_0"), (4242, "fetch_0"), (4242, "loader_0")]
    ev = profiler.trace_events()
    rows = {e["args"]["name"]: e["tid"] for e in ev if e["ph"] == "M"}
    assert set(rows) == {"loader-0", "fetch-0"}
    assert rows["loader-0"] == 4242 and rows["fetch-0"] != 4242
    by_name = {}
    for e in ev:
        if e["ph"] == "X":
            by_name.setdefault(e["name"], set()).add(e["tid"])
    assert by_name == {"t.loader": {rows["loader-0"]},
                       "t.fetch": {rows["fetch-0"]}}


def test_a_step_of_the_wall_clock_moves_no_total(fresh, monkeypatch):
    """Durations and self time come from the monotonic clock: the wall
    clock stepping back an hour inside a span changes no total."""
    wall = [time.time_ns()]
    monkeypatch.setattr(time, "time_ns", lambda: wall[0])
    with profile_scope("t.stepped") as span:
        with profile_scope("t.child"):
            wall[0] -= 3600 * 10**9
    snap = snapshot()
    assert 0 <= snap["t.stepped"][1] < 1.0
    assert 0 <= snap["t.stepped.self"][1] <= snap["t.stepped"][1]
    assert 0 <= snap["t.child"][1] <= snap["t.stepped"][1]
    start, end = span.epoch()
    assert end - start == span.end - span.start >= 0
