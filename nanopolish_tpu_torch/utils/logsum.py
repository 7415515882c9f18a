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
15.7 nats) is ``add_logs_table`` on tensors and ``add_logs_np(...,
table=True)`` on the host (the legacy R7 scorer, ``ops.profile_hmm_r7``,
sums with the latter).  ``NPT_LOGSUM=table`` (``logsum_mode``) makes every
R9 Forward sum with it, as the JAX package's scan does: the plain table
route of ``ops.profile_hmm.forward_fill_plain`` and, on the card,
``csrc/forward_table.cu``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

P7_LOGSUM_TBL = 16000
P7_LOGSUM_SCALE = 1000.0
NEG_INF = float("-inf")
# p7_FLogsum returns max(x, y) alone from this difference on (logsum.h:62)
P7_LOGSUM_CLAMP = float(np.float32(15.7))

_table_np = None
_tables: dict = {}


def _logsum_table_np() -> np.ndarray:
    global _table_np
    if _table_np is None:
        # flogsum_lookup[i] = log(1 + exp(-i/scale)) computed in float64,
        # stored float32 (logsum.cpp:50-65)
        i = np.arange(P7_LOGSUM_TBL, dtype=np.float64)
        _table_np = np.log(1.0 + np.exp(-i / P7_LOGSUM_SCALE)).astype(np.float32)
    return _table_np


def logsum_mode() -> str:
    """The Forward's log-space addition, read from ``NPT_LOGSUM`` at each
    call as the JAX package reads it: ``"table"`` for the reference's
    quantized table, ``"exact"`` for any other value or none."""
    return "table" if os.environ.get("NPT_LOGSUM", "exact") == "table" \
        else "exact"


def logsum_table(device) -> torch.Tensor:
    """``_logsum_table_np`` as a tensor on ``device``, uploaded once (never
    computed there: the card's log and exp are not the host's)."""
    dev = torch.device(device)
    t = _tables.get(dev)
    if t is None:
        t = _tables[dev] = torch.from_numpy(_logsum_table_np()).to(dev)
    return t


def add_logs_table(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """p7_FLogsum (logsum.h:55-67) as the JAX package's add_logs_table
    evaluates it in f32: d = max - min, the table entry trunc(d * 1000)
    clamped to the table, and max alone where min is -inf or d >= 15.7.
    ``keep = d < 15.7`` is that mask's complement (min = -inf makes d inf,
    or NaN when both are -inf), taken before the index, so an inf or NaN d
    never indexes."""
    mx = torch.maximum(x, y)
    d = mx - torch.minimum(x, y)
    keep = d < P7_LOGSUM_CLAMP
    idx = torch.where(keep, d * P7_LOGSUM_SCALE, 0.0).to(torch.int64)
    idx = idx.clamp_(0, P7_LOGSUM_TBL - 1)
    return torch.where(keep, mx + torch.take(logsum_table(x.device), idx), mx)


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
