"""Emission distributions for the HMMs, as batched PyTorch ops.

Rebuild of reference src/hmm/nanopolish_emissions.h.  All functions are
elementwise over arbitrary leading batch dims of torch tensors.

``fma32`` is the one non-obvious helper: where the reference's compiled
f32 expressions fuse ``a*b + c`` into a single fused multiply-add (one
rounding), the port has to round the same way to reproduce its bits.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))


def fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 fused multiply-add ``a*b + c`` with a single rounding.

    The f32 product is exact in f64 and the f64 sum is computed with
    round-to-odd (a TwoSum error term decides the last bit), which makes
    the final f64 -> f32 rounding equal to one correctly rounded f32
    fma (Boldo & Melquiond: 53 >= 2*24 + 2)."""
    def f64(x):
        if torch.is_tensor(x):
            return x.to(torch.float64)
        return torch.tensor(float(np.float32(x)), dtype=torch.float64,
                            device=a.device)

    p = a.to(torch.float64) * f64(b)
    c64 = f64(c)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(fix, (bits + step).view(torch.float64), s)
    return s.to(torch.float32)


def log_normal_pdf(x, mean, stdv, log_stdv):
    """log N(x; mean, stdv) with a precomputed log stdv
    (nanopolish_emissions.h:51-55)."""
    a = (x - mean) / stdv
    return LOG_INV_SQRT_2PI - log_stdv + (-0.5 * a * a)


def log_normal_fused(x, mean, stdv, c):
    """log N(x; mean, stdv) as the compiled DP fills evaluate it:
    ``c = f32(LOG_INV_SQRT_2PI) - log(stdv)`` precomputed on the host and
    the quadratic term fused, ``fma(-0.5*a, a, c)``."""
    a = (x - mean) / stdv
    return fma32(-0.5 * a, a, c)


def scaled_gaussian(level_mean, level_stdv, level_log_stdv, shift, scale, var, log_var):
    """Fold per-read scalings into model Gaussians
    (nanopolish_squiggle_read.h:216-226): mean' = scale*mu + shift,
    stdv' = sigma * var."""
    mean = scale * level_mean + shift
    stdv = level_stdv * var
    log_stdv = level_log_stdv + log_var
    return mean, stdv, log_stdv


def log_probability_match_r9(drift_scaled_level, level_mean, level_stdv,
                             level_log_stdv, shift, scale, var, log_var):
    """log P(event level | kmer), r9 emission (nanopolish_emissions.h:57-68).

    ``drift_scaled_level`` is event_mean - t*drift; the model gaussian is
    scaled by shift/scale/var.
    """
    mean, stdv, log_stdv = scaled_gaussian(
        level_mean, level_stdv, level_log_stdv, shift, scale, var, log_var)
    return log_normal_pdf(drift_scaled_level, mean, stdv, log_stdv)


def z_score(drift_scaled_level, level_mean, level_stdv, shift, scale, var):
    """Standardized level vs the scaled model (nanopolish_emissions.h:32-41)."""
    mean = scale * level_mean + shift
    stdv = level_stdv * var
    return (drift_scaled_level - mean) / stdv
