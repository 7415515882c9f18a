"""Progress bars.

`Progress` is the reference's elapsed-time bar (src/common/progress.h:
16-50), used around methyltrain's rounds (nanopolish_methyltrain.cpp:788,
816-818).  Device time is read with torch.profiler, not here.
"""

from __future__ import annotations

import sys
import time


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
