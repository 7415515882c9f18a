"""Device-sync accounting: how often, and how long, the host waits for the card.

A run's wall splits into host work and waits at device-to-host fetches:

  blocked_s = seconds spent blocked inside fetches (the device work still
              queued ahead of the fetch, plus the copy), summed over every
              thread that fetches
  host_s    = wall_s - blocked_s
  sync_count, bytes_fetched

blocked_s is a sum over threads, not a share of the wall: where several
threads fetch (call-methylation's fetch and loader threads) their waits
overlap each other and the main thread's work, and host_s says little.
Only on a path whose fetches all come from the calling thread (eventalign,
scorereads, variants, methyltrain) is host_s the host's own work
(geometry, packing, formatting).

The card is idle most of every main path's wall, so host work and its
waits set the walls; torch.profiler sees the kernels, not these waits.
Every device-to-host fetch on the package's main paths goes through
``timed_fetch`` (or ``SYNC_STATS.sync()`` around a wait that is not a
tensor copy, such as the pinned ingest copy's event).  A fetch of a CPU
tensor counts too, so the counts of a ``--device cpu`` run are those of
the same run on the card.

Usage:
    from nanopolish_tpu_torch.utils.syncstats import SYNC_STATS, timed_fetch
    with SYNC_STATS.capture() as snap:
        run_app()
    print(snap.sync_count, snap.blocked_s, snap.bytes_fetched)

Under NPT_PROFILE each wait is also attributed to the innermost span
open on the thread that waited (``utils.profiler.note_wait``): a span's
``blocked_s`` and ``fetch_bytes``; the counts here stay global.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from .profiler import note_wait


@dataclass
class SyncSnapshot:
    sync_count: int = 0
    blocked_s: float = 0.0
    bytes_fetched: int = 0

    def as_dict(self):
        return {"sync_count": self.sync_count,
                "blocked_s": round(self.blocked_s, 4),
                "bytes_fetched": self.bytes_fetched}


class SyncStats:
    """Process-global sync accounting.  Thread-safe: the loader and fetch
    threads of the pipelined apps fetch too."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._blocked = 0.0
        self._bytes = 0

    def record(self, blocked_s: float, nbytes: int = 0) -> None:
        with self._lock:
            self._count += 1
            self._blocked += blocked_s
            self._bytes += nbytes
        note_wait(blocked_s, nbytes)

    @contextmanager
    def sync(self, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0, nbytes)

    def snapshot(self) -> SyncSnapshot:
        with self._lock:
            return SyncSnapshot(self._count, self._blocked, self._bytes)

    @contextmanager
    def capture(self):
        """Yields a SyncSnapshot that is filled with the deltas of the
        enclosed region when the block exits (plus ``wall_s`` and
        ``host_s``)."""
        before = self.snapshot()
        snap = SyncSnapshot()
        t0 = time.perf_counter()
        try:
            yield snap
        finally:
            after = self.snapshot()
            snap.sync_count = after.sync_count - before.sync_count
            snap.blocked_s = after.blocked_s - before.blocked_s
            snap.bytes_fetched = after.bytes_fetched - before.bytes_fetched
            snap.wall_s = time.perf_counter() - t0
            snap.host_s = snap.wall_s - snap.blocked_s


SYNC_STATS = SyncStats()


def timed_fetch(t) -> np.ndarray:
    """The numpy array of tensor ``t`` (a CUDA tensor is copied to the
    host, which waits for the stream's work ahead of it), with the whole
    wait and the bytes recorded."""
    t0 = time.perf_counter()
    out = t.detach().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)
    SYNC_STATS.record(time.perf_counter() - t0, out.nbytes)
    return out
