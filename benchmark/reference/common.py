"""Shared pieces of the plain reference: the pore models (read from the
raw model file), kmer ranks, CpG methylation of a sequence and its
site-aware reverse complement, and the f32 arithmetic the comparisons
need to reproduce (a fused multiply-add with one rounding, the row sums'
order, a 2 x 2 solve).

Imports NumPy and PyTorch only.  ``Precision`` says whether the reference
computes in float32, as the configurations state, or is the control: the
same arithmetic with every quantity of the signal path (event levels, the
scalings, the model's Gaussians, each emission) rounded to bfloat16 where
it is made.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))
NUC = "ACGT"
CPG = "ACGMT"


@dataclass(frozen=True)
class Precision:
    control: bool = False

    def q(self, x):
        """x as the control holds it: rounded to bfloat16 (float32 kept
        as the container); unchanged for the reference."""
        if not self.control:
            return x
        if torch.is_tensor(x):
            return x.to(torch.bfloat16).to(x.dtype)
        a = np.asarray(x, np.float32)
        t = torch.from_numpy(a.reshape(-1).copy()).to(torch.bfloat16)
        out = t.to(torch.float32).numpy().reshape(a.shape)
        return out if a.ndim else np.float32(out[()])


F32 = Precision(False)
CONTROL = Precision(True)


class PoreModel:
    def __init__(self, npz: str, name: str, bases: str, k: int):
        with np.load(npz, allow_pickle=False) as z:
            p = z[f"{name}:params"]
        self.level_mean = p[:, 0].copy()
        self.level_stdv = p[:, 1].copy()
        self.bases = bases
        self.k = k


def kmer_ranks(seq: str, bases: str, k: int) -> np.ndarray:
    lut = np.zeros(256, np.int64)
    for r, b in enumerate(bases):
        lut[ord(b)] = r
    br = lut[np.frombuffer(seq.encode("ascii"), np.uint8)]
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    acc = np.zeros(n, np.int64)
    for j in range(k):
        acc = acc * len(bases) + br[j:j + n]
    return acc


_COMP = str.maketrans("ACGTM", "TGCAG")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def methylate_cpg(s: str) -> str:
    """Every CG -> MG, left to right."""
    return s.replace("CG", "MG")


def revcomp_cpg(s: str) -> str:
    """Reverse complement that keeps methylated CpG sites methylated on the
    other strand: a full MG stays MG; an M cut off at the end of s
    complements to G (nanopolish_alphabet's site-aware rule for cpg)."""
    out = []
    i, n = 0, len(s)
    while i < n:
        if s.startswith("MG", i):
            out.append("GM")
            i += 2
        else:
            out.append(s[i].translate(_COMP))
            i += 1
    return "".join(out)[::-1]


def fma32(a, b, c):
    """f32 a * b + c with one rounding (round-to-odd in float64)."""
    p = np.asarray(a, np.float32).astype(np.float64) * \
        np.asarray(b, np.float32).astype(np.float64)
    c64 = np.asarray(c, np.float32).astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = np.asarray(s, np.float64).view(np.int64)
    with np.errstate(invalid="ignore"):
        fix = (err != 0) & ((bits & 1) == 0) & np.isfinite(s)
        step = np.where((err > 0) == (s > 0), 1, -1)
    s = np.where(fix, (bits + step).view(np.float64), s)
    return s.astype(np.float32)


def ordered_sum(x: np.ndarray) -> np.float32:
    """f32 sum of a vector in the compiled reductions' order: zero-padded
    to a multiple of 32 (the padding split before and after), windows of
    32 summed left to right, repeated until at most 32 remain."""
    x = np.asarray(x, np.float32)
    N = len(x)
    if N <= 32:
        acc = np.float32(0.0)
        for v in x:
            acc = np.float32(acc + v)
        return acc
    n = -(-N // 32) * 32
    lo = (n - N) // 2
    xp = np.zeros(n, np.float32)
    xp[lo:lo + N] = x
    w = xp.reshape(n // 32, 32)
    acc = np.zeros(n // 32, np.float32)
    for j in range(32):
        acc = acc + w[:, j]
    return ordered_sum(acc)


def solve2(A, b):
    """2 x 2 solve in the operation order of LAPACK's pivoted LU."""
    f = np.float32
    a00, a01, a10, a11 = (f(A[0][0]), f(A[0][1]), f(A[1][0]), f(A[1][1]))
    b0, b1 = f(b[0]), f(b[1])
    if abs(a10) > abs(a00):
        p00, p01, r10, r11, c0, c1 = a10, a11, a00, a01, b1, b0
    else:
        p00, p01, r10, r11, c0, c1 = a00, a01, a10, a11, b0, b1
    inv_p = f(f(1.0) / p00)
    l10 = f(r10 * inv_p)
    u11 = f(r11 - f(l10 * p01))
    y1 = fma32(-l10, c0, c1)
    x1 = f(y1 * f(f(1.0) / u11))
    x0 = f(fma32(-p01, x1, c0) * inv_p)
    return x0, x1


def emission_constant(sigma: np.ndarray) -> np.ndarray:
    return np.float32(LOG_INV_SQRT_2PI) - np.log(np.asarray(sigma,
                                                            np.float32))


NEG_INF = float("-inf")
LP_TRIM = math.log(0.01)
LP_SKIP = math.log(1e-10)
