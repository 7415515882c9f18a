"""nanopolish's R9 profile HMM (src/hmm/nanopolish_profile_hmm_r9.inl):
the Viterbi alignment of a segment's events to its kmers, and the Forward
log-likelihood, in plain PyTorch, one Python step per event row,
vectorised over segments and kmers.

A frozen copy of the plain versions the port keeps beside its kernels
(``ops/profile_hmm.py``: the K chain on the pairwise tree of an
associative scan, the reference's last-equal tie-break, the clip flanks),
so that on the card it rounds as the kernels do.  ``Precision`` rounds
each emission to bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import F32, Precision, emission_constant

FROM_SAME_M, FROM_PREV_M, FROM_SAME_B, FROM_PREV_B, FROM_PREV_K, \
    FROM_SOFT = range(6)
KMER_SKIP, BAD_EVENT, MATCH = 0, 1, 2
PRE_CLIP, POST_CLIP = 1, 2
NEG_INF = float("-inf")

_LOG1M_CLIP = math.log(1.0 - 0.5)
_CLIP_BASE = math.log(0.5) + -3.0 + math.log(1.0 - 0.9)
_CLIP_STEP = math.log(0.9) + -3.0


def transitions(epb: np.ndarray, p_skip=0.0025, p_bad=0.001,
                p_skip_self=0.3) -> np.ndarray:
    """[B, 8] f32: mk, mb, mm_self, mm_next, bb, b3, kk, km (r9.inl:17-76)."""
    epb = np.maximum(1.25, np.asarray(epb, np.float64).reshape(-1))
    p_stay = 1.0 - 1.0 / epb
    p_mm_next = 1.0 - p_stay - p_skip - p_bad
    one = np.ones_like(p_stay)
    cols = [one * np.log(p_skip), one * np.log(p_bad), np.log(p_stay),
            np.log(p_mm_next), one * np.log(p_bad),
            one * np.log((1.0 - p_bad) / 3.0), one * np.log(p_skip_self),
            one * np.log(1 - p_skip_self)]
    return np.stack(cols, axis=1).astype(np.float32)


def _fma32(a, b, c):
    """f32 a * b + c with one rounding (round-to-odd in float64)."""
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


def _emission(x, mu, sigma, c, prec):
    a = (x - mu) / sigma
    return prec.q(_fma32(-0.5 * a, a, c))


def _flank(i_f):
    base = _fma32(i_f - 1.0, float(np.float32(_CLIP_STEP)),
                  float(np.float32(_CLIP_BASE)))
    return torch.where(i_f == 0, float(np.float32(_LOG1M_CLIP)), base)


def _prev(x):
    return torch.cat([torch.full_like(x[:, :1], NEG_INF), x[:, :-1]], dim=1)


def _chain(c, lp_kk, op):
    """K[k] = op(c[k], K[k-1] + lp_kk) on the pairwise scan tree."""
    def scan(v, a):
        n = v.shape[1]
        if n < 2:
            return v
        red = op(v[:, 0:-1:2] + a, v[:, 1::2])
        odd = scan(red, a + a)
        tail = odd if n % 2 else odd[:, :-1]
        even = op(tail + a, v[:, 2::2])
        out = torch.empty_like(v)
        out[:, 0] = v[:, 0]
        out[:, 2::2] = even
        out[:, 1::2] = odd
        return out
    return scan(c, lp_kk[:, None])


def logaddexp(x, y):
    delta = x - y
    amax = torch.maximum(x, y)
    out = amax + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), x + y, out)


def pack(levels, mu, sigma, epb, flags, device):
    """Lists of per-segment arrays -> padded tensors: levels [B, T], mu,
    sigma, c [B, K] (padding mu 0, sigma 1), n_events, n_kmers, the
    transition table and the clip flags."""
    B = len(levels)
    T = max(1, max(len(x) for x in levels))
    K = max(1, max(len(x) for x in mu))
    lv = np.zeros((B, T), np.float32)
    m = np.zeros((B, K), np.float32)
    s = np.ones((B, K), np.float32)
    for i in range(B):
        lv[i, :len(levels[i])] = levels[i]
        m[i, :len(mu[i])] = mu[i]
        s[i, :len(sigma[i])] = sigma[i]
    c = emission_constant(s)
    fl = np.asarray(flags, np.int64)
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa
    return dict(levels=t(lv, torch.float32), mu=t(m, torch.float32),
                sigma=t(s, torch.float32), c=t(c, torch.float32),
                n_events=t(np.array([len(x) for x in levels]), torch.int64),
                n_kmers=t(np.array([len(x) for x in mu]), torch.int64),
                trans=t(transitions(epb), torch.float32),
                pre=t((fl & PRE_CLIP) > 0, torch.bool),
                post=t((fl & POST_CLIP) > 0, torch.bool))


def viterbi(x, prec: Precision = F32):
    """Fill and traceback; returns per segment (event offsets, kmer
    indices, states as 'K'/'B'/'M' bytes) in forward order."""
    levels, mu, sigma, c = x["levels"], x["mu"], x["sigma"], x["c"]
    B, T = levels.shape
    K = mu.shape[1]
    dev = levels.device
    tr = x["trans"]
    mk, mb, mms, mmn, bb, b3, kk, km = (tr[:, i:i + 1] for i in range(8))
    lp_kk = tr[:, 6]
    nev = x["n_events"]
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)  # noqa
    trace = torch.zeros((B, T, K), dtype=torch.uint8, device=dev)
    M = torch.full((B, K), NEG_INF, device=dev)
    Bs = torch.full_like(M, NEG_INF)
    Ks = torch.full_like(M, NEG_INF)
    k0 = (torch.arange(K, device=dev) == 0)[None, :]
    for t in range(1, int(nev.max()) + 1):
        em = _emission(levels[:, t - 1:t], mu, sigma, c, prec)
        soft_ok = x["pre"] | (t == 1)
        pre_val = _flank(torch.full((B,), float(t - 1), device=dev))
        s_soft = torch.where(k0 & (soft_ok & (t <= nev))[:, None],
                             pre_val[:, None], NEG_INF)
        x0 = mms + M
        x1 = mmn + _prev(M)
        x2 = b3 + Bs
        x3 = b3 + _prev(Bs)
        x4 = km + _prev(Ks)
        m_in = torch.maximum(torch.maximum(torch.maximum(x0, x1),
                                           torch.maximum(x2, x3)),
                             torch.maximum(x4, s_soft))
        trM = torch.zeros((B, K), dtype=torch.uint8, device=dev)
        for idx, v in ((FROM_PREV_M, x1), (FROM_SAME_B, x2),
                       (FROM_PREV_B, x3), (FROM_PREV_K, x4),
                       (FROM_SOFT, s_soft)):
            trM = torch.where(v == m_in, u8(idx), trM)
        M_new = m_in + em
        b0 = mb + M
        b2 = bb + Bs
        B_new = torch.maximum(b0, b2)
        trB = (b2 == B_new).to(torch.uint8)
        cM = mk + _prev(M_new)
        cB = b3 + _prev(B_new)
        K_new = _chain(torch.maximum(cM, cB), lp_kk, torch.maximum)
        kk_prev = _prev(K_new) + lp_kk[:, None]
        trK = torch.full((B, K), FROM_PREV_M, dtype=torch.uint8, device=dev)
        trK = torch.where(cB == K_new, u8(FROM_PREV_B), trK)
        trK = torch.where(kk_prev == K_new, u8(FROM_PREV_K), trK)
        trace[:, t - 1, :] = trM | (trB << 3) | (trK << 4)
        M, Bs, Ks = M_new, B_new, K_new
    return _backtrack(trace, nev, x["n_kmers"])


def _backtrack(trace, n_events, n_kmers):
    B, T, K = trace.shape
    dev = trace.device
    rows = torch.arange(B, device=dev)
    row = n_events.clone()
    ki = n_kmers - 1
    st = torch.full((B,), MATCH, dtype=torch.int64, device=dev)
    done = row <= 0
    steps = []
    for _ in range(T + K):
        act = ~done
        if not bool(act.any()):
            break
        steps.append(torch.stack([torch.where(act, row - 1, -1), ki, st]))
        byte = trace[rows, (row - 1).clamp(0, T - 1),
                     ki.clamp(0, K - 1)].to(torch.int64)
        mv = torch.where(st == MATCH, byte & 7,
                         torch.where(st == BAD_EVENT,
                                     torch.where((byte >> 3) & 1 > 0,
                                                 FROM_SAME_B, FROM_SAME_M),
                                     (byte >> 4) & 7))
        soft = act & (mv == FROM_SOFT)
        on = act & ~soft
        prev_k = (mv == FROM_PREV_M) | (mv == FROM_PREV_B) | \
            (mv == FROM_PREV_K)
        nxt = torch.where((mv == FROM_SAME_M) | (mv == FROM_PREV_M), MATCH,
                          torch.where((mv == FROM_SAME_B) |
                                      (mv == FROM_PREV_B), BAD_EVENT,
                                      KMER_SKIP))
        row = torch.where(on & (st != KMER_SKIP), row - 1, row)
        ki = torch.where(on & prev_k, ki - 1, ki)
        st = torch.where(on, nxt, st)
        done = done | soft | (row <= 0) | (ki < 0)
    if not steps:
        return [(np.zeros(0, np.int64),) * 2 + (b"",) for _ in range(B)]
    cells = torch.stack(steps, dim=2).cpu().numpy()      # [3, B, L]
    chars = np.frombuffer(b"KBM", np.uint8)
    out = []
    for b in range(B):
        ev = cells[0, b]
        n = int((ev >= 0).sum())
        ev = ev[:n][::-1]
        out.append((ev.astype(np.int64), cells[1, b, :n][::-1].astype(np.int64),
                    chars[cells[2, b, :n][::-1]].tobytes()))
    return out


def forward(x, prec: Precision = F32) -> np.ndarray:
    """The Forward log-likelihood of each segment, [B] f32."""
    levels, mu, sigma, c = x["levels"], x["mu"], x["sigma"], x["c"]
    B, T = levels.shape
    K = mu.shape[1]
    dev = levels.device
    tr = x["trans"]
    mk, mb, mms, mmn, bb, b3, kk, km = (tr[:, i:i + 1] for i in range(8))
    lp_kk = tr[:, 6]
    nev = x["n_events"]
    nev_f = nev.to(torch.float32)
    last = (x["n_kmers"] - 1).clamp(0, K - 1)[:, None]
    M = torch.full((B, K), NEG_INF, device=dev)
    Bs = torch.full_like(M, NEG_INF)
    Ks = torch.full_like(M, NEG_INF)
    lp_end = torch.full((B,), NEG_INF, device=dev)
    k0 = (torch.arange(K, device=dev) == 0)[None, :]
    add = logaddexp
    for t in range(1, int(nev.max()) + 1):
        em = _emission(levels[:, t - 1:t], mu, sigma, c, prec)
        soft_ok = x["pre"] | (t == 1)
        pre_val = _flank(torch.full((B,), float(t - 1), device=dev))
        s_soft = torch.where(k0 & (soft_ok & (t <= nev))[:, None],
                             pre_val[:, None], NEG_INF)
        m_in = add(add(add(add(add(mms + M, mmn + _prev(M)), b3 + Bs),
                           b3 + _prev(Bs)), km + _prev(Ks)), s_soft)
        M_new = m_in + em
        B_new = add(mb + M, bb + Bs)
        cM = mk + _prev(M_new)
        cB = b3 + _prev(B_new)
        K_new = _chain(add(cM, cB), lp_kk, add)
        s3 = add(add(M_new.gather(1, last)[:, 0], B_new.gather(1, last)[:, 0]),
                 K_new.gather(1, last)[:, 0])
        cand = s3 + _flank(nev_f - float(t))
        allowed = torch.where(x["post"], t <= nev, t == nev)
        lp_end = torch.where(allowed, add(lp_end, cand), lp_end)
        M, Bs, Ks = M_new, B_new, K_new
    return lp_end.cpu().numpy()


def run_batched(fn, segs, device, batch: int = 4096, prec: Precision = F32):
    """fn (viterbi or forward) over segments given as (levels, mu, sigma,
    epb, flags) tuples, in batches of similar event counts; results in
    the input order."""
    order = sorted(range(len(segs)), key=lambda i: len(segs[i][0]))
    out = [None] * len(segs)
    for lo in range(0, len(order), batch):
        idx = order[lo:lo + batch]
        x = pack([segs[i][0] for i in idx], [segs[i][1] for i in idx],
                 [segs[i][2] for i in idx], [segs[i][3] for i in idx],
                 [segs[i][4] for i in idx], device)
        x["levels"] = prec.q(x["levels"])
        x["mu"] = prec.q(x["mu"])
        x["sigma"] = prec.q(x["sigma"])
        res = fn(x, prec)
        for j, i in enumerate(idx):
            out[i] = res[j]
        del x
    return out
