"""Log-space addition for the Forward recurrences.

The JAX package adds log-probabilities with ``jnp.logaddexp``
(``lax.other.logaddexp``): ``max(x, y) + log1p(exp(-|x - y|))``, and
``x + y`` where ``x - y`` is NaN (both arguments -inf, or infinities of one
sign).  ``add_logs_exact`` spells out the same formula in torch, so the
plain Forward and the CUDA kernel (which evaluates it with ``expf`` and
``log1pf``, the functions ``torch.exp`` and ``torch.log1p`` call on the
card) round alike.

The reference's hmmer3 lookup table (``p7_FLogsum``, src/common/
logsum.{h,cpp}: log(1 + e^-d) in 16,000 steps of 0.001 nats, clamped at
15.7 nats) is here as ``add_logs_np(..., table=True)``, a host function:
the legacy R7 scorer (``ops.profile_hmm_r7``) sums with it.  The R9
Forward on the card has no table route.
"""

from __future__ import annotations

import numpy as np
import torch

P7_LOGSUM_TBL = 16000
P7_LOGSUM_SCALE = 1000.0

_table_np = None


def _logsum_table_np() -> np.ndarray:
    global _table_np
    if _table_np is None:
        # flogsum_lookup[i] = log(1 + exp(-i/scale)) computed in float64,
        # stored float32 (logsum.cpp:50-65)
        i = np.arange(P7_LOGSUM_TBL, dtype=np.float64)
        _table_np = np.log(1.0 + np.exp(-i / P7_LOGSUM_SCALE)).astype(np.float32)
    return _table_np


def add_logs_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log(e^x + e^y) in jnp.logaddexp's operation order; -inf safe."""
    delta = x - y
    amax = torch.maximum(x, y)
    out = amax + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), x + y, out)


def add_logs_np(a, b, table: bool = False):
    """NumPy (host) version, scalar or array; ``table`` emulates
    p7_FLogsum bit for bit (logsum.h:55-67)."""
    if not table:
        return np.logaddexp(a, b)
    tbl = _logsum_table_np()
    mx = np.maximum(a, b)
    mn = np.minimum(a, b)
    with np.errstate(invalid="ignore"):
        d = np.where(mn == -np.inf, np.inf, mx - mn)   # -inf-(-inf) is nan
        idx = np.clip((d * P7_LOGSUM_SCALE).astype(np.int64), 0,
                      P7_LOGSUM_TBL - 1)
    return np.where((mn == -np.inf) | (d >= 15.7), mx, mx + tbl[idx])
