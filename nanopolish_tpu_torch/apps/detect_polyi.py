"""`detect-polyi` subcommand: nano-COP poly(I)/poly(A) tail detection.

Rebuild of src/nanopolish_detect_polyi.cpp: the DPI segmentation HMM (the
polya HMM with a two-Gaussian POLYA mixture, on the card) followed by a
2-state Bernoulli HMM on the host classifying the tail region into
poly(I) then poly(A) stretches via discretized log-likelihood ratios.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import List, Optional, TextIO, Tuple

import numpy as np

from ..ops.segmentation_hmm import SegmentationParams
from ..utils.device import resolve_device
from .polya import TSV_HEADER, add_common_args, row_prefix, segmented_batches

DPI_PARAMS = SegmentationParams(
    p_emission=(108.883, 3.257),
    p1_emission=(108.498, 5.257),
    p0_coeff=0.5,
    p1_coeff=0.5,
)

# Bernoulli HMM constants (nanopolish_detect_polyi.cpp:550-572)
BERN_TRANS = ((0.90, 0.10), (0.00, 1.00))
PI_GAUSS = (108.498, 5.257)
PA_GAUSS = (108.883, 3.257)
GLOBAL_MEAN = 108.0
PI_BERNOULLI = 0.72304
PA_BERNOULLI = 0.92154


def _log_normal_pdf(x, mu, sd):
    z = (x - mu) / sd
    return -0.5 * z * z - math.log(sd) - 0.5 * math.log(2 * math.pi)


def bernoulli_segmentation(samples: np.ndarray, shift: float, scale: float,
                           start: int, stop: int) -> Tuple[int, int]:
    """detect_polyi.cpp:642-760: returns (last poly(I) idx, first poly(A)
    idx) within [start, stop), -1 when absent."""
    if stop - start < 100:
        return -1, -1
    sig = (samples[start:stop].astype(np.float64) - shift) / scale
    mean = sig.mean()
    s = np.where((sig > 200.0) | (sig < 40.0), 100.0, sig) - (mean - GLOBAL_MEAN)
    s = np.where((s > 200.0) | (s < 40.0), 100.0, s)
    ll_pi = _log_normal_pdf(s, *PI_GAUSS)
    ll_pa = _log_normal_pdf(s, *PA_GAUSS)
    with np.errstate(divide="ignore", invalid="ignore"):
        bern = ((ll_pi / ll_pa) > 1.0).astype(np.int8)

    lt = [[math.log(p) if p > 0 else -1e30 for p in row] for row in BERN_TRANS]
    lp1 = (math.log(PI_BERNOULLI), math.log(PA_BERNOULLI))
    lp0 = (math.log(1 - PI_BERNOULLI), math.log(1 - PA_BERNOULLI))
    n = len(bern)
    v_i = lp1[0] if bern[0] else lp0[0]
    v_a = -1e30
    bptr = np.zeros((n, 2), np.int8)
    for i in range(1, n):
        e_i = lp1[0] if bern[i] else lp0[0]
        e_a = lp1[1] if bern[i] else lp0[1]
        i2i = v_i + lt[0][0]
        i2a = v_i + lt[0][1]
        a2a = v_a + lt[1][1]
        nv_i = i2i + e_i
        nv_a = max(i2a, a2a) + e_a
        bptr[i, 0] = 0
        bptr[i, 1] = 1 if i2a < a2a else 0
        v_i, v_a = nv_i, nv_a

    labels = np.zeros(n, np.int8)
    labels[n - 1] = 1 if v_i < v_a else 0
    for j in range(n - 2, 0, -1):
        labels[j] = bptr[j][labels[j + 1]]

    polyi = -1
    polya = -1
    ii = np.nonzero(labels == 0)[0]
    aa = np.nonzero(labels == 1)[0]
    if ii.size:
        polyi = int(ii[-1])
    if aa.size:
        polya = int(aa[0])
    return polyi, polya


def post_boolhmm_detection_qc(polyi: int, polya: int, region_length: int) -> str:
    """detect_polyi.cpp:973-997."""
    cutoff = 200
    polyi_found = polyi > cutoff
    polya_found = (polya > 0) and (region_length - polya > cutoff)
    if polyi_found and polya_found:
        return "A+I"
    if polya_found:
        return "POLYA-ONLY"
    if polyi_found:
        return "POLYI-ONLY"
    return "NONE"


def make_parser() -> argparse.ArgumentParser:
    return add_common_args(argparse.ArgumentParser(
        prog="nanopolish_tpu_torch detect-polyi",
        description="detect poly-I tails in direct RNA reads"))


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout
    device = resolve_device(opt.device)
    out.write(TSV_HEADER + "\tdetected\tqc_tag\n")
    for rows in segmented_batches(opt, device, out, params=DPI_PARAMS):
        for rec, ref_name, sr, seg, qc, read_rate, polya_length in rows:
            polyi, polya = bernoulli_segmentation(
                sr.samples, sr.scalings[0].shift, sr.scalings[0].scale,
                seg.adapter + 1, seg.polya)
            detected = post_boolhmm_detection_qc(
                polyi, polya, seg.polya - (seg.adapter + 1))
            out.write(row_prefix(rec, ref_name, seg, read_rate, polya_length)
                      + f"\t{detected}\t{qc}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
