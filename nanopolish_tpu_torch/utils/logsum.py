"""Log-space addition for the Forward recurrences.

The JAX package adds log-probabilities with ``jnp.logaddexp``
(``lax.other.logaddexp``): ``max(x, y) + log1p(exp(-|x - y|))``, and
``x + y`` where ``x - y`` is NaN (both arguments -inf, or infinities of one
sign).  ``add_logs_exact`` spells out the same formula in torch, so the
plain Forward and the CUDA kernel (which evaluates it with ``expf`` and
``log1pf``, the functions ``torch.exp`` and ``torch.log1p`` call on the
card) round alike.  The reference's hmmer3 lookup table
(``NPT_LOGSUM=table`` in the JAX package) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def add_logs_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log(e^x + e^y) in jnp.logaddexp's operation order; -inf safe."""
    delta = x - y
    amax = torch.maximum(x, y)
    out = amax + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), x + y, out)


def add_logs_np(a, b):
    """NumPy (host) version, scalar or array."""
    return np.logaddexp(a, b)
