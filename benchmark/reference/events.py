"""Raw signal -> events, as nanopolish's scrappie detector does it
(src/thirdparty/scrappie/event_detection.c, scrappie_common.c): the
leader and trailer trimmed by the chunks' MAD, two windowed t-statistics,
the dual peak detector, events between the peaks.  NumPy, with the peak
detector as a plain Python loop in float32 semantics."""

from __future__ import annotations

import numpy as np

# event_detection.h: window lengths, thresholds, peak height (DNA)
WINDOWS = (3, 6)
THRESHOLDS = (np.float32(1.4), np.float32(9.0))
PEAK_HEIGHT = np.float32(0.2)


def _quantile(xs_sorted, p):
    nx = xs_sorted.shape[-1]
    idx = int(p * (nx - 1))
    remf = p * (nx - 1) - idx
    if idx < nx - 1:
        return (1.0 - remf) * xs_sorted[..., idx] + remf * xs_sorted[..., idx + 1]
    return xs_sorted[..., idx].astype(np.float64)


def trim(raw: np.ndarray, chunk: int = 100, perc: float = 0.0,
         trim_start: int = 200, trim_end: int = 10):
    """(start, end) of the signal kept, or None (trim_and_segment_raw)."""
    x = np.asarray(raw, np.float32)
    nchunk = len(x) // chunk
    start, end = 0, nchunk * chunk
    if nchunk > 0:
        c = x[:nchunk * chunk].reshape(nchunk, chunk)
        med = _quantile(np.sort(c, axis=1), 0.5).astype(np.float32)
        dev = np.abs(c - med[:, None])
        mads = (_quantile(np.sort(dev, axis=1), 0.5) * 1.4826
                ).astype(np.float32)
        srt = np.sort(mads)
        nx = len(srt)
        idx = int(perc * (nx - 1))
        remf = perc * (nx - 1) - idx
        thresh = ((1.0 - remf) * srt[idx] + remf * srt[idx + 1]
                  if idx < nx - 1 else float(srt[idx]))
        for i in range(nchunk):
            if mads[i] > thresh:
                break
            start += chunk
        for i in range(nchunk, 0, -1):
            if mads[i - 1] > thresh:
                break
            end -= chunk
    start += trim_start
    end -= trim_end
    return None if start >= end else (start, end)


def _tstat(sums, sumsqs, n, w):
    t = np.zeros(n, np.float32)
    if n < 2 * w or w < 2:
        return t
    eta = np.float32(np.finfo(np.float32).tiny)
    wf = np.float32(w)
    mid = sums[w:n - w + 1]
    midsq = sumsqs[w:n - w + 1]
    sum1 = mid.copy()
    sumsq1 = midsq.copy()
    sum1[1:] -= sums[1:n - 2 * w + 1]
    sumsq1[1:] -= sumsqs[1:n - 2 * w + 1]
    sum2 = (sums[2 * w:n + 1] - mid).astype(np.float32)
    sumsq2 = (sumsqs[2 * w:n + 1] - midsq).astype(np.float32)
    mean1 = (sum1 / wf).astype(np.float32)
    mean2 = sum2 / wf
    var = (sumsq1 / wf).astype(np.float32) - mean1 * mean1 + \
        sumsq2 / wf - mean2 * mean2
    var = np.maximum(var, eta)
    t[w:n - w + 1] = np.abs(mean2 - mean1) / np.sqrt(var / wf)
    return t


def _gt_after_f32_sub(ph: np.float32):
    """A test of fl32(a - b) > ph on the exact float64 difference a - b of
    two float32 values: the difference rounds above ph iff it passes the
    midpoint between ph and the next float32 (a tie goes to the even one)."""
    nxt = np.nextafter(ph, np.float32(np.inf))
    mid = (float(ph) + float(nxt)) / 2.0
    tie_up = (int(np.asarray(nxt).view(np.int32)) & 1) == 0
    if tie_up:
        return lambda d: d >= mid
    return lambda d: d > mid


def _peaks(t1: np.ndarray, t2: np.ndarray) -> list:
    sig = (t1.astype(np.float64).tolist(), t2.astype(np.float64).tolist())
    thr = (float(THRESHOLDS[0]), float(THRESHOLDS[1]))
    half = (WINDOWS[0] // 2, WINDOWS[1] // 2)
    over = _gt_after_f32_sub(PEAK_HEIGHT)
    fmax = float(np.finfo(np.float32).max)
    masked = [0, 0]
    pos = [-1, -1]
    val = [fmax, fmax]
    valid = [False, False]
    peaks = []
    for i in range(len(sig[0])):
        for k in (0, 1):
            if masked[k] >= i:
                continue
            cur = sig[k][i]
            if pos[k] == -1:
                if cur < val[k]:
                    val[k] = cur
                elif over(cur - val[k]):
                    val[k] = cur
                    pos[k] = i
            else:
                if cur > val[k]:
                    val[k] = cur
                    pos[k] = i
                if k == 0 and val[0] > thr[0]:
                    masked[1] = pos[0] + WINDOWS[0]
                    pos[1] = -1
                    val[1] = fmax
                    valid[1] = False
                if over(val[k] - cur) and val[k] > thr[k]:
                    valid[k] = True
                if valid[k] and (i - pos[k]) > half[k]:
                    peaks.append(pos[k])
                    pos[k] = -1
                    val[k] = cur
                    valid[k] = False
    return peaks


def detect(raw: np.ndarray):
    """Events over a trimmed signal: (start sample, length, mean, stdv),
    lengths in samples, all float32 but the starts."""
    x = np.ascontiguousarray(raw, np.float32)
    n = len(x)
    d = x.astype(np.float64)
    sums = np.concatenate([[0.0], np.cumsum(d)])
    sumsqs = np.concatenate([[0.0], np.cumsum(d * d)])
    peaks = np.asarray(_peaks(_tstat(sums, sumsqs, n, WINDOWS[0]),
                              _tstat(sums, sumsqs, n, WINDOWS[1])), np.int64)
    peaks = peaks[(peaks > 0) & (peaks < n)]
    b = np.concatenate([[0], peaks, [n]]).astype(np.int64)
    s, e = b[:-1], b[1:]
    length = (e - s).astype(np.float32)
    mean = ((sums[e] - sums[s]) / length).astype(np.float32)
    var = (sumsqs[e] - sumsqs[s]).astype(np.float32) / length - mean * mean
    stdv = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
    return s, length, mean, stdv
