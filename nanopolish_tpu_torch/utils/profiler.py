"""Opt-in macro profiler (spans) and progress bars.

Rebuild of the reference's profiling aids:
- `PROFILE_FUNC("name")` accumulates cumulative ns per scope and prints
  every 1000 invocations when compiled in (src/common/profiler.h:17-62).
  Here: `profile_scope(name)` / `@profiled`, enabled by NPT_PROFILE=1
  (off by default; outputs are byte-identical with it on).  The report
  goes to stderr at exit, one `[profile] name: N calls, S s total, M
  ms/call` line a scope, the slowest first, then the banded fill's chain
  bands (utils/cuda_build.CHAIN_BANDS) where it ran.
- `Progress` elapsed-time bars (src/common/progress.h:16-50; used by
  methyltrain rounds, nanopolish_methyltrain.cpp:788,816-818).

With NPT_PROFILE set each scope is a span: its start and end on
``time.perf_counter_ns`` (monotonic: durations and self time do not
move with a step of the wall clock), exported on the Unix-epoch clock
that torch.profiler (Kineto) stamps its events with through one
(perf_counter, epoch) anchor taken when the first span opens, so that a
span and the device operations it issued lie on one time axis; the
thread it ran on (its id and name, read when the span opens); its parent (the innermost span open on the thread, or
the span handed over by the code that queued the work on another thread);
a chunk id (pass, chunk) where one chunk's work crosses threads; and the
seconds and bytes of the device fetches (``utils.syncstats``) made on
the thread while it was the innermost span.  A span's self time is its
duration less what its children on the same thread cover (children on
other threads run beside it).  ``snapshot()`` gives each name's calls
and total seconds, and ``<name>.self`` for a name whose spans had
children on their thread.  With NPT_PROFILE_TRACE=<file> as well, the
spans are kept and written at exit as a Chrome trace (open it in
Perfetto beside a torch.profiler ``export_chrome_trace`` of the same
run); without it no span outlives its scope.  With NPT_PROFILE unset,
``profile_scope`` reads the variable and returns a shared no-op context:
no clock read, no span.

The scopes time the host side around the card's work; device time is
read with torch.profiler, and the host's waits for the card with
``utils.syncstats``.  The JAX package's scope names:
  read_builder.process_chunk   a chunk of the ingest (issue + fetch)
  ea.stage_jobs, ea.chain_build, ea.chain_unpack, ea.emit
  segments.fa_pack, segments.fa_dispatch   forward_arrays_async's inputs
                               and launches
  meth.collect, meth.drain_prep, meth.drain_dispatch, meth.write
  va.score_ids, var.sbe_screen, var.screen, var.call_group, var.expand
The port's own spans:
  meth.pass, ea.pass           one call of the app (the main thread's root)
  meth.open                    call-methylation's readdb, FASTA and BAM
                               opening
  meth.next_batch              a batch of BAM records decoded
  meth.wait_chunk              the main thread waiting on the loaders'
                               next chunk
  meth.drain_wait              the main thread waiting on a fetch thread
  meth.load_chunk              a chunk's loading (the loader thread's root)
  meth.resolve                 a chunk's score fetch and site columns (the
                               fetch thread's root)
  read_loader.load_raw         signal reading and decompression (BLOW5)
  read_builder.detect          host event detection
  read_builder.assemble        the reads' kmer ranks, event tables and
                               chunking
  cuda_build.build, cuda_build.load   the kernels' build and loading
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
import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

PRINT_EVERY = 1000        # invocations, matching profiler.h:49

# spans' start and end; to_epoch_ns() puts them on the Unix epoch, the
# clock of torch.profiler's CPU events and (through CUPTI's conversion)
# of its device events
_clock = time.perf_counter_ns
_epoch_offset: Optional[int] = None     # epoch ns - _clock() ns

_scopes: Dict[str, List[float]] = {}    # name -> [calls, total_ns]
_self: Dict[str, List] = {}             # name -> [self_ns, had children]
_records: List["Span"] = []             # closed spans, under NPT_PROFILE_TRACE
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
_registered = False
_OFF = contextlib.nullcontext()


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
    from .cuda_build import chain_band_lines   # cuda_build imports this
    for ln in chain_band_lines():
        fp.write(ln + "\n")


def _ensure_atexit() -> None:
    global _registered
    with _lock:
        if not _registered:
            atexit.register(_report)
            atexit.register(export_trace)
            _registered = True


def to_epoch_ns(ns: int) -> int:
    """A span's start or end on the Unix epoch (torch.profiler's clock),
    through the anchor taken when the first span opened."""
    global _epoch_offset
    if _epoch_offset is None:
        with _lock:
            if _epoch_offset is None:
                _epoch_offset = time.time_ns() - _clock()
    return ns + _epoch_offset


class Span:
    """One timed scope (see the module's docstring).  ``start``/``end``
    are ``_clock`` ns (``epoch()`` gives them on the Unix epoch), ``tid``
    the native thread id and ``thread`` the thread's name, ``parent`` a
    Span or None, ``blocked_s``/``fetch_bytes`` the SYNC_STATS waits attributed
    to it, ``child_ns`` what its same-thread children cover."""

    __slots__ = ("name", "id", "parent", "chunk", "args", "tid", "thread",
                 "start", "end", "child_ns", "has_child", "blocked_s",
                 "fetch_bytes")

    def __init__(self, name: str, parent: Optional["Span"] = None,
                 chunk=None):
        self.name, self.parent, self.chunk = name, parent, chunk
        self.args: Optional[dict] = None        # extra fields for the export
        self.id = next(_ids)
        self.tid = self.start = self.end = self.child_ns = 0
        self.thread = ""
        self.has_child = False
        self.blocked_s, self.fetch_bytes = 0.0, 0

    @property
    def self_ns(self) -> int:
        return self.end - self.start - self.child_ns

    def epoch(self) -> Tuple[int, int]:
        """(start, end) in Unix-epoch ns."""
        return to_epoch_ns(self.start), to_epoch_ns(self.end)

    def __enter__(self) -> "Span":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self)
        self.tid, self.thread = _tls.tid, _tls.thread
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = _clock()
        stack = _tls.stack
        stack.pop()
        dur = self.end - self.start
        if stack:
            stack[-1].child_ns += dur
            stack[-1].has_child = True
        _close(self, dur)
        return False


def _stack() -> List[Span]:
    try:
        return _tls.stack
    except AttributeError:
        _tls.tid = threading.get_native_id()
        _tls.thread = threading.current_thread().name
        _tls.stack = []
        return _tls.stack


def _close(span: Span, dur: int) -> None:
    keep = bool(os.environ.get("NPT_PROFILE_TRACE"))
    with _lock:
        cell = _scopes.setdefault(span.name, [0, 0.0])
        cell[0] += 1
        cell[1] += dur
        calls, ns = cell
        own = _self.setdefault(span.name, [0, False])
        own[0] += dur - span.child_ns
        own[1] = own[1] or span.has_child
        if keep:
            _records.append(span)
    if calls % PRINT_EVERY == 0:
        sys.stderr.write(
            f"[profile] {span.name}: {int(calls)} calls, {ns / 1e9:.3f} s\n")


def profile_scope(name: str, parent: Optional[Span] = None, chunk=None):
    """Time the enclosed block as a span named `name` (a no-op unless
    NPT_PROFILE is set; then the context's value is the Span, else None).
    `parent` is the span that queued this work on another thread
    (default: the innermost span open on this one); `chunk` an id shared
    by the spans of one chunk's work.  Reports every PRINT_EVERY calls
    and at exit.  Thread-safe: the loader and fetch threads open spans
    too."""
    if not profiling_enabled():
        return _OFF
    if not _registered:
        _ensure_atexit()
        to_epoch_ns(0)                  # the anchor: tracing starts here
    return Span(name, parent, chunk)


def note_wait(blocked_s: float, nbytes: int = 0) -> None:
    """Attribute a device fetch's wait and bytes to this thread's
    innermost open span (SYNC_STATS calls it for every fetch)."""
    stack = getattr(_tls, "stack", None)
    if stack:
        top = stack[-1]
        top.blocked_s += blocked_s
        top.fetch_bytes += nbytes


def profiled(fn):
    """Decorator form of profile_scope (the PROFILE_FUNC idiom)."""
    name = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrap(*a, **k):
        with profile_scope(name):
            return fn(*a, **k)
    return wrap


def snapshot() -> Dict[str, Tuple[int, float]]:
    """Current {name: (calls, total_seconds)}, and {name + ".self":
    (calls, self_seconds)} for each name whose spans had children on
    their own thread (for tests, tools and the benchmark's readers)."""
    with _lock:
        out = {k: (int(c), ns / 1e9) for k, (c, ns) in _scopes.items()}
        for k, (ns, had_children) in _self.items():
            if had_children and k in out:
                out[k + ".self"] = (out[k][0], ns / 1e9)
    return out


def spans() -> List[Span]:
    """The closed spans kept under NPT_PROFILE_TRACE, in closing order."""
    with _lock:
        return list(_records)


def _thread_label(name: str) -> str:
    """main, loader-N, fetch-N: the export's name of a thread."""
    return "main" if name == "MainThread" else name.replace("_", "-")


def trace_events() -> List[dict]:
    """The kept spans as Chrome trace events: one "X" event a span (ts
    and dur in us on the Unix epoch, args: id, parent, chunk, self and
    blocked seconds, fetch bytes) and a thread_name event a thread row.
    A row is a (native id, name) pair: a thread whose id the system gave
    again to a later thread of another name (a later pass's pool) gets a
    row of its own, numbered above the ids the system hands out."""
    pid = os.getpid()
    with _lock:
        recs = list(_records)
    rows: Dict[Tuple[int, str], int] = {}
    for s in recs:
        if (s.tid, s.thread) not in rows:
            used = sum(1 for tid, _ in rows if tid == s.tid)
            rows[s.tid, s.thread] = s.tid + (used << 32)
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": row,
            "args": {"name": _thread_label(name)}}
           for (_, name), row in sorted(rows.items(), key=lambda kv: kv[1])]
    for s in recs:
        args = {"id": s.id, "self_s": s.self_ns / 1e9,
                "blocked_s": s.blocked_s, "fetch_bytes": s.fetch_bytes}
        if s.parent is not None:
            args.update(parent=s.parent.id, parent_name=s.parent.name)
        if s.chunk is not None:
            args["chunk"] = list(s.chunk)
        if s.args:
            args.update(s.args)
        out.append({"name": s.name, "cat": "npt", "ph": "X",
                    "ts": to_epoch_ns(s.start) / 1e3,
                    "dur": (s.end - s.start) / 1e3,
                    "pid": pid, "tid": rows[s.tid, s.thread], "args": args})
    return out


def export_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the kept spans to `path` (default: NPT_PROFILE_TRACE) as a
    Chrome trace-event JSON; returns the path written, or None."""
    path = path or os.environ.get("NPT_PROFILE_TRACE")
    if not path:
        return None
    with open(path, "w") as fh:
        json.dump({"traceEvents": trace_events(),
                   "displayTimeUnit": "ms"}, fh)
    return path


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
