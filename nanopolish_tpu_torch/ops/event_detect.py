"""Raw signal -> event table (scrappie-style event detection) + MAD trimming.

Behavioral rebuild of reference src/thirdparty/scrappie/event_detection.c
and scrappie_common.c (trim_raw_by_mad / trim_and_segment_raw).

The t-statistics are O(n) prefix-sum work and vectorize trivially; the
short/long dual peak detector is an inherently sequential per-sample state
machine, so it runs on the host: a native C++ implementation
(csrc/signal_ops.cpp, loaded via ctypes) with a NumPy/Python fallback.
Batches of reads are dispatched across host threads by the read builder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..utils.native import get_native_lib


@dataclass(frozen=True)
class DetectorParams:
    window_length1: int
    window_length2: int
    threshold1: float
    threshold2: float
    peak_height: float


# event_detection.h:15-29
EVENT_DETECTION_DEFAULTS = DetectorParams(3, 6, 1.4, 9.0, 0.2)
EVENT_DETECTION_RNA = DetectorParams(7, 14, 2.5, 9.0, 1.0)


def compute_sum_sumsq(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative sum / sum-of-squares, element i = sum over data[:i]."""
    d = data.astype(np.float64)
    sums = np.concatenate([[0.0], np.cumsum(d)])
    sumsqs = np.concatenate([[0.0], np.cumsum(d * d)])
    return sums, sumsqs


def compute_tstat(sums: np.ndarray, sumsqs: np.ndarray, d_length: int, w_length: int) -> np.ndarray:
    """Windowed Welch t-statistic between adjacent windows
    (event_detection.c:60-115). float32 to match the reference exactly."""
    tstat = np.zeros(d_length, dtype=np.float32)
    if d_length < 2 * w_length or w_length < 2:
        return tstat
    eta = np.float32(np.finfo(np.float32).tiny)
    wf = np.float32(w_length)

    # i runs w_length .. d_length - w_length inclusive; every gather below
    # is a contiguous slice of the prefix arrays (no fancy indexing)
    w, n = w_length, d_length
    mid = sums[w:n - w + 1]
    midsq = sumsqs[w:n - w + 1]
    sum1 = mid.copy()
    sumsq1 = midsq.copy()
    # at i == w_length the reference keeps the raw prefix (no left window
    # subtracted); for i > w_length it subtracts sums[i - w_length]
    sum1[1:] -= sums[1:n - 2 * w + 1]
    sumsq1[1:] -= sumsqs[1:n - 2 * w + 1]
    sum2 = (sums[2 * w:n + 1] - mid).astype(np.float32)
    sumsq2 = (sumsqs[2 * w:n + 1] - midsq).astype(np.float32)
    mean1 = (sum1 / wf).astype(np.float32)
    mean2 = sum2 / wf
    combined_var = (sumsq1 / wf).astype(np.float32) - mean1 * mean1 + sumsq2 / wf - mean2 * mean2
    combined_var = np.maximum(combined_var, eta)
    delta_mean = mean2 - mean1
    vals = np.abs(delta_mean) / np.sqrt(combined_var / wf)
    # the reference zeroes the w_length-sized boundaries FIRST, then its main
    # loop writes i in [w_length, d_length - w_length] inclusive, so the
    # value at i == d_length - w_length is the computed one
    tstat[w:n - w + 1] = vals
    return tstat


def _peak_detect_py(tstat1, tstat2, p: DetectorParams) -> np.ndarray:
    """Dual short/long-window peak detector (event_detection.c:122-198).
    Returns peak positions (sorted, possibly with leading zeros skipped)."""
    n = len(tstat1)
    sig = (tstat1, tstat2)
    thresh = (p.threshold1, p.threshold2)
    wlen = (p.window_length1, p.window_length2)
    masked_to = [0, 0]
    peak_pos = [-1, -1]
    peak_value = [np.float32(np.finfo(np.float32).max)] * 2
    valid_peak = [False, False]
    peaks = []
    ph = np.float32(p.peak_height)
    for i in range(n):
        for k in range(2):
            if masked_to[k] >= i:
                continue
            current_value = sig[k][i]
            if peak_pos[k] == -1:
                if current_value < peak_value[k]:
                    peak_value[k] = current_value
                elif current_value - peak_value[k] > ph:
                    peak_value[k] = current_value
                    peak_pos[k] = i
            else:
                if current_value > peak_value[k]:
                    peak_value[k] = current_value
                    peak_pos[k] = i
                if k == 0:
                    if peak_value[0] > thresh[0]:
                        masked_to[1] = peak_pos[0] + wlen[0]
                        peak_pos[1] = -1
                        peak_value[1] = np.float32(np.finfo(np.float32).max)
                        valid_peak[1] = False
                if peak_value[k] - current_value > ph and peak_value[k] > thresh[k]:
                    valid_peak[k] = True
                if valid_peak[k] and (i - peak_pos[k]) > wlen[k] // 2:
                    peaks.append(peak_pos[k])
                    peak_pos[k] = -1
                    peak_value[k] = current_value
                    valid_peak[k] = False
    return np.array(peaks, dtype=np.int64)


def _peak_detect(tstat1, tstat2, p: DetectorParams) -> np.ndarray:
    lib = get_native_lib()
    if lib is not None:
        return lib.peak_detect(tstat1, tstat2,
                               p.window_length1, p.window_length2,
                               p.threshold1, p.threshold2, p.peak_height)
    return _peak_detect_py(tstat1, tstat2, p)


@dataclass
class EventTableRaw:
    """Detected events over the (trimmed) raw signal."""

    start: np.ndarray    # [N] int64 sample index (relative to trimmed signal)
    length: np.ndarray   # [N] float32, samples
    mean: np.ndarray     # [N] float32
    stdv: np.ndarray     # [N] float32

    def __len__(self):
        return int(self.mean.shape[0])


def create_events(peaks: np.ndarray, sums: np.ndarray, sumsqs: np.ndarray, nsample: int) -> EventTableRaw:
    """Events between consecutive peak boundaries (event_detection.c:200-266).

    The reference counts nonzero in-range peak entries from its zero-padded
    array; here ``peaks`` is the compact emitted list, so the equivalent
    filter is peaks > 0 and < nsample."""
    valid = peaks[(peaks > 0) & (peaks < nsample)]
    bounds = np.concatenate([[0], valid, [nsample]]).astype(np.int64)
    starts = bounds[:-1]
    ends = bounds[1:]
    lengths = (ends - starts).astype(np.float32)
    means = ((sums[ends] - sums[starts]) / lengths).astype(np.float32)
    deltasqr = (sumsqs[ends] - sumsqs[starts]).astype(np.float32)
    var = deltasqr / lengths - means * means
    stdvs = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
    return EventTableRaw(start=starts, length=lengths, mean=means, stdv=stdvs)


def detect_events(raw: np.ndarray, params: DetectorParams = EVENT_DETECTION_DEFAULTS) -> EventTableRaw:
    """Full pipeline: prefix sums -> two t-stats -> dual peak detect -> events."""
    raw = np.ascontiguousarray(raw, dtype=np.float32)
    n = len(raw)
    sums, sumsqs = compute_sum_sumsq(raw)
    tstat1 = compute_tstat(sums, sumsqs, n, params.window_length1)
    tstat2 = compute_tstat(sums, sumsqs, n, params.window_length2)
    peaks = _peak_detect(tstat1, tstat2, params)
    return create_events(peaks, sums, sumsqs, n)


# --- trimming (scrappie_common.c) ----------------------------------------

def quantilef(x: np.ndarray, p: float) -> float:
    """Linear-interpolated quantile matching scrappie's quantilef
    (scrappie_common.c:32-70)."""
    xs = np.sort(np.asarray(x, dtype=np.float32))
    nx = len(xs)
    idx = int(p * (nx - 1))
    remf = p * (nx - 1) - idx
    if idx < nx - 1:
        return float((1.0 - remf) * xs[idx] + remf * xs[idx + 1])
    return float(xs[idx])


def medianf(x: np.ndarray) -> float:
    return quantilef(x, 0.5)


def madf(x: np.ndarray, med: Optional[float] = None) -> float:
    """Median absolute deviation * 1.4826 (scrappie_common.c:96-119)."""
    if len(x) == 1:
        return 0.0
    m = medianf(x) if med is None else med
    return medianf(np.abs(np.asarray(x, dtype=np.float32) - np.float32(m))) * 1.4826


def _row_quantilef(sorted_rows: np.ndarray, p: float) -> np.ndarray:
    """quantilef applied per row of a pre-sorted float32 matrix, with the
    exact interpolation arithmetic of the scalar version (float64 mix of
    float32 elements, same expression order)."""
    nx = sorted_rows.shape[1]
    idx = int(p * (nx - 1))
    remf = p * (nx - 1) - idx
    if idx < nx - 1:
        return (1.0 - remf) * sorted_rows[:, idx] + remf * sorted_rows[:, idx + 1]
    return sorted_rows[:, idx].astype(np.float64)


def trim_raw_by_mad(raw: np.ndarray, start: int, end: int, chunk_size: int, perc: float):
    """Trim low-variation leader/trailer chunks by thresholding per-chunk MAD
    (scrappie_common.c:156-190). Returns (start, end) sample bounds."""
    nsample = end - start
    nchunk = nsample // chunk_size
    end = nchunk * chunk_size
    if nchunk == 0:
        # signal shorter than one chunk: nothing to threshold (the
        # quantile of an empty mads array would raise)
        return start, end
    x = np.asarray(raw, dtype=np.float32)
    if chunk_size >= 2 and nchunk > 0:
        # one sorted-matrix pass over all chunks instead of a per-chunk
        # madf() loop; bit-identical to the scalar path (same float64
        # interpolation of float32 order statistics, median cast to
        # float32 before the deviation subtraction, result stored float32)
        chunks = x[start:start + nchunk * chunk_size].reshape(nchunk, chunk_size)
        meds = _row_quantilef(np.sort(chunks, axis=1), 0.5).astype(np.float32)
        dev = np.abs(chunks - meds[:, None])
        mads = (_row_quantilef(np.sort(dev, axis=1), 0.5) * 1.4826).astype(np.float32)
    else:
        mads = np.empty(nchunk, dtype=np.float32)
        for i in range(nchunk):
            mads[i] = madf(x[start + i * chunk_size : start + (i + 1) * chunk_size])
    thresh = quantilef(mads, perc)
    for i in range(nchunk):
        if mads[i] > thresh:
            break
        start += chunk_size
    for i in range(nchunk, 0, -1):
        if mads[i - 1] > thresh:
            break
        end -= chunk_size
    return start, end


def trim_and_segment_raw(raw: np.ndarray, trim_start: int = 200, trim_end: int = 10,
                         varseg_chunk: int = 100, varseg_thresh: float = 0.0):
    """scrappie_common.c:122-137; returns (start, end) or None if fully trimmed."""
    start, end = trim_raw_by_mad(raw, 0, len(raw), varseg_chunk, varseg_thresh)
    start += trim_start
    end -= trim_end
    if start >= end:
        return None
    return start, end
