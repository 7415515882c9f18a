"""The measured window: a closed loop of passes, and its rate.

A pass starts while fewer than ``seconds`` have passed since the window
opened; the window closes at the end of the last pass, so every pass it
counts is whole and the rate is the work of all of them over all of the
window's time.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def run(one_pass: Callable[[int], None], seconds: float,
        clock=time.perf_counter) -> Tuple[float, List[float]]:
    """(window start, each pass's end), both on ``clock``."""
    t0 = clock()
    ends: List[float] = []
    while clock() - t0 < seconds:
        one_pass(len(ends))
        ends.append(clock())
    return t0, ends


def rate(units_per_pass: float, t0: float, ends: List[float]) -> float:
    """Units of every completed pass over the window's length."""
    return len(ends) * units_per_pass / (ends[-1] - t0)
