"""Opt-in macro profiler and progress bars.

Rebuild of the reference's profiling aids:
- `PROFILE_FUNC("name")` accumulates cumulative ns per scope and prints
  every 1000 invocations when compiled in (src/common/profiler.h:17-62).
  Here: `profile_scope(name)` / `@profiled`, enabled by NPT_PROFILE=1
  (off by default; outputs are byte-identical with it on).  The report
  goes to stderr at exit, one `[profile] name: N calls, S s total, M
  ms/call` line a scope, the slowest first.
- `Progress` elapsed-time bars (src/common/progress.h:16-50; used by
  methyltrain rounds, nanopolish_methyltrain.cpp:788,816-818).

The scopes time the host side around the card's work; device time is
read with torch.profiler, and the host's waits for the card with
``utils.syncstats``.  Scope names are the JAX package's:
  read_builder.process_chunk   a chunk of the ingest (issue + fetch)
  ea.stage_jobs, ea.chain_build, ea.chain_unpack, ea.emit
  segments.fa_pack, segments.fa_dispatch   forward_arrays_async's inputs
                               and launches
  meth.collect, meth.drain_prep, meth.drain_dispatch, meth.write
  va.score_ids, var.sbe_screen, var.screen, var.call_group, var.expand
JAX scopes that time TPU-wire work and have no counterpart here:
  fp.build, fp.dispatch        the packed relay wire of forward_packed;
                               the indexed drain uploads its inputs as
                               tensors (va.score_ids, ScoreBatcher.flush)
  segments.forward_pallas_dispatch, segments.forward_pallas_sync
                               forward_segments' Pallas route; the port's
                               forward_segments goes through
                               forward_arrays (segments.fa_*)
  meth.drain_dispatch_w        the TPU's dispatch on the loader threads
                               with one deferred fetch a batch; here each
                               chunk is issued on the main thread and
                               resolved on a fetch thread (meth.drain_*)
"""

from __future__ import annotations

import atexit
import functools
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

PRINT_EVERY = 1000        # invocations, matching profiler.h:49

_scopes: Dict[str, List[float]] = {}    # name -> [calls, total_ns]
_lock = threading.Lock()
_registered = False


def profiling_enabled() -> bool:
    return os.environ.get("NPT_PROFILE", "") not in ("", "0")


def _report(fp=None) -> None:
    fp = fp or sys.stderr
    with _lock:
        items = sorted(_scopes.items(), key=lambda kv: -kv[1][1])
    for name, (calls, ns) in items:
        fp.write(f"[profile] {name}: {int(calls)} calls, "
                 f"{ns / 1e9:.3f} s total, {ns / max(calls, 1) / 1e6:.3f} "
                 f"ms/call\n")


def _ensure_atexit() -> None:
    global _registered
    with _lock:
        if not _registered:
            atexit.register(_report)
            _registered = True


@contextmanager
def profile_scope(name: str):
    """Accumulate wall time under `name`; report every PRINT_EVERY calls
    and at exit.  No-op (single branch) unless NPT_PROFILE is set.
    Thread-safe: the loader and fetch threads open scopes too."""
    if not profiling_enabled():
        yield
        return
    _ensure_atexit()
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        dt = time.perf_counter_ns() - t0
        with _lock:
            cell = _scopes.setdefault(name, [0, 0.0])
            cell[0] += 1
            cell[1] += dt
            calls, ns = cell
        if calls % PRINT_EVERY == 0:
            sys.stderr.write(
                f"[profile] {name}: {int(calls)} calls, {ns / 1e9:.3f} s\n")


def profiled(fn):
    """Decorator form of profile_scope (the PROFILE_FUNC idiom)."""
    name = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrap(*a, **k):
        with profile_scope(name):
            return fn(*a, **k)
    return wrap


def snapshot() -> Dict[str, Tuple[int, float]]:
    """Current {name: (calls, total_seconds)} (for tests/tools)."""
    with _lock:
        return {k: (int(c), ns / 1e9) for k, (c, ns) in _scopes.items()}


class Progress:
    """Elapsed-time progress bar (progress.h:16-50): prints `[### ...] p%`
    with elapsed seconds to stderr, throttled to one update per percent."""

    def __init__(self, label: str, width: int = 50, fp=None):
        self.label = label
        self.width = width
        self.fp = fp or sys.stderr
        self.t0 = time.perf_counter()
        self._last_pct = -1

    def update(self, frac: float) -> None:
        pct = int(min(max(frac, 0.0), 1.0) * 100)
        if pct == self._last_pct:
            return
        self._last_pct = pct
        n = pct * self.width // 100
        bar = "#" * n + " " * (self.width - n)
        self.fp.write(f"\r[{self.label}] [{bar}] {pct:3d}% "
                      f"{time.perf_counter() - self.t0:6.1f}s")
        self.fp.flush()

    def end(self) -> None:
        self.update(1.0)
        self.fp.write("\n")
