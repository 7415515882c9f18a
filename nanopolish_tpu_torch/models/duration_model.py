"""DurationModel: gamma model of per-kmer dwell time.

Rebuild of src/hmm/nanopolish_duration_model.{h,cpp}: Viterbi-align events
to a sequence, sum event durations per kmer position, and score total
durations under a closed-form gamma-sum log pdf.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
from scipy.special import gammaln

MIN_DURATION = 0.00025
GAMMA_SHAPE = 2.461964     # duration_model.cpp:44-46
GAMMA_RATE = 587.2858


def durations_from_alignment(backtrack: Tuple[np.ndarray, np.ndarray, str],
                             event_start_idx: int, event_stride: int,
                             durations: np.ndarray, n_kmers: int) -> np.ndarray:
    """Sum durations per kmer position from a Viterbi backtrack
    (generate_aligned_durations, duration_model.cpp:17-40)."""
    evs, kms, states = backtrack
    out = np.zeros(n_kmers)
    emit = np.frombuffer(states.encode(), np.uint8) != ord("K")
    if emit.any():
        event_idx = event_start_idx + np.asarray(evs)[emit] * event_stride
        np.add.at(out, np.asarray(kms)[emit], durations[event_idx])
    return out


def log_gamma_sum(x: float, n: float, shape: float = GAMMA_SHAPE,
                  rate: float = GAMMA_RATE) -> float:
    """log pdf of the sum of n gamma observations (duration_model.cpp:52-57)."""
    na = n * shape
    return (na * math.log(rate)) - float(gammaln(na)) \
        + (na - 1) * math.log(x) - rate * x


def gamma_fit(values: Sequence[float],
              shape: float = GAMMA_SHAPE) -> Tuple[float, float]:
    """Fit (shape, rate) with the known shape (duration_model.cpp:60-76)."""
    n = len(values)
    sigma = sum(values) / (shape * n)
    return shape, 1.0 / sigma
