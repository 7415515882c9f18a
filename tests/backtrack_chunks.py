"""NumPy models of csrc/seg_backtrack.cu's map scan and of
csrc/banded_backtrack.cu's chunked walk.

Segmentation (``scan_backtrack``): a backpointer byte is a map of the six
states to their predecessors, six 5-bit fields in one word (field s at bit
5 s holds 5 x the predecessor of s).  One block of THREADS threads walks a
read in tiles from its end, each thread a 16-byte group that follows the
row's alignment in memory; each thread composes its group's maps, the
block scans them (a Kogge-Stone warp scan of shuffles, then each warp
applies the earlier warps' totals), each thread replays its group from
the state it enters with and keeps its own summary, and the block reduces
the summaries with max and +.  The model follows those steps over arrays
of the threads.

Banded (``chunked_walk``): the walk visits only the bands it steps on,
carrying its cell's offset in the band (``off = ll_e(bi) - ei``) from each
band's word of offset changes (``move_word``), in chunks of CH bands from
the first band it visits, the chunks that cannot reach the read's ends or
leave the band without the end tests and the clamp; each chunk's path is
its moves, from which the lanes rebuild every visit's event, kmer and row
(prefix counts, the kernel's ballots); then they compute the emissions
from a 32-entry window taken at the chunk's first visit, the summed
emission in walk order, the kmer-skip runs (carried across chunks) and
the base->event writes (the first and last map-valid lane of each kmer
in the chunk, the last map-valid kmer carried).
"""

import numpy as np
import torch

from nanopolish_tpu_torch.ops.emissions import log_normal_fused

# ------------------------------------------------------------ segmentation

S, L, A, P, C, T = range(6)
THREADS, SPT = 256, 16                    # csrc/seg_backtrack.cu
WARPS = THREADS // 32
IDENT = sum((5 * s) << (5 * s) for s in range(6))


def decode(byte: int, state: int) -> int:
    """The predecessor of ``state`` under one backpointer byte (the
    kernel's decode)."""
    if state == L:
        return L if byte & 1 else S
    if state == A:
        return A if byte & 2 else L
    if state == P:
        code = (byte >> 2) & 3
        return P if code == 0 else (A if code == 1 else C)
    if state == C:
        return C if byte & 16 else P
    if state == T:
        return T if byte & 32 else P
    return S


def map_table() -> np.ndarray:
    """[64] int64: each byte's map, field s at bit 5 s holding 5 x its
    predecessor of s."""
    return np.array([sum((5 * decode(v, s)) << (5 * s) for s in range(6))
                     for v in range(64)], np.int64)


def apply(m, x5):
    """The state (times 5) that map m sends x5 to."""
    return (m >> x5) & 31


def compose(a, b):
    """The map "first a, then b"."""
    return sum(apply(b, (a >> (5 * s)) & 31) << (5 * s) for s in range(6))


def _warp_scan(f):
    """Inclusive Kogge-Stone scan of [WARPS, 32] maps, lane 0 first."""
    lane = np.arange(32)[None, :]
    inc = f.copy()
    d = 1
    while d < 32:
        o = np.concatenate([inc[:, :d], inc[:, :-d]], axis=1)
        inc = np.where(lane >= d, compose(o, inc), inc)
        d *= 2
    return inc


def scan_walk(row: np.ndarray, n: int, align: int):
    """One read's summary (5 ints) and labels [len(row)] (T past n), its
    bytes ``row`` starting ``align`` bytes past a 16-byte boundary."""
    tab = map_table()
    N = len(row)
    labels = np.full(N, T, np.uint8)
    idx = np.full((4, THREADS), -1, np.int64)       # s_l, l_a, a_p, p_t
    cliffs = np.zeros(THREADS, np.int64)
    x5 = 5 * T
    if n >= 3:
        g_hi, g_lo = (n - 2 + align) >> 4, (1 + align) >> 4
        tid = np.arange(THREADS)
        k = 0
        while g_hi - k * THREADS >= g_lo:
            g = g_hi - k * THREADS - tid                     # [THREADS]
            t = 16 * g[:, None] - align + np.arange(SPT)[None, :]
            live = (g[:, None] >= g_lo) & (t >= 1) & (t <= n - 2)
            byte = row[np.clip(t, 0, N - 1)].astype(np.int64) & 63
            m = np.where(live, tab[byte], IDENT)            # [THREADS, SPT]
            f = np.tile(5 * np.arange(6), (THREADS, 1))
            for i in range(SPT - 1, -1, -1):
                f = apply(m[:, i:i + 1], f)
            inc = _warp_scan(sum(f[:, s] << (5 * s) for s in range(6))
                             .reshape(WARPS, 32))
            exc = np.concatenate([np.full((WARPS, 1), IDENT), inc[:, :-1]],
                                 axis=1).reshape(-1)
            tot = inc[:, 31]
            ys = [x5]
            for v in range(WARPS):
                ys.append(apply(tot[v], ys[-1]))
            y5 = apply(exc, np.repeat(ys[:WARPS], 32))
            for i in range(SPT - 1, -1, -1):
                lab5 = apply(m[:, i], y5)
                ok = live[:, i]
                for j, (a, b) in enumerate(((S, L), (L, A), (A, P), (P, T))):
                    hit = ok & (lab5 == 5 * a) & (y5 == 5 * b)
                    idx[j] = np.where(hit, np.maximum(idx[j], t[:, i]),
                                      idx[j])
                cliffs += ok & (lab5 == 5 * C)
                labels[t[ok, i]] = (lab5[ok] * 13) >> 6
                y5 = lab5
            x5 = int(ys[WARPS])
            k += 1
    s_l, l_a, a_p, p_t = (int(v.max()) for v in idx)
    if n >= 1:
        labels[n - 1] = T
    if n >= 2:
        labels[0] = S
        if x5 == 5 * L:
            s_l = max(s_l, 0)
    return (s_l, l_a, a_p, p_t, int(cliffs.sum())), labels


def scan_backtrack(bptr: np.ndarray, n_samples, aligns=None):
    """scan_walk over a batch of backpointers [N, B] uint8: (summary
    [B, 5] int32, labels [N, B] uint8).  Read b's row starts (b * N) mod
    16 bytes past a boundary, as in the kernel's read-major copy of the
    bytes, unless ``aligns`` gives each read's."""
    N, B = bptr.shape
    n = np.minimum(np.asarray(n_samples, np.int64), N)
    if aligns is None:
        aligns = [(b * N) % 16 for b in range(B)]
    summ = np.zeros((B, 5), np.int32)
    labels = np.full((N, B), T, np.uint8)
    for b in range(B):
        summ[b], labels[:, b] = scan_walk(bptr[:, b], int(n[b]), aligns[b])
    return summ, labels


# ------------------------------------------------------------------ banded

CH = 32                                   # csrc/banded_backtrack.cu
LANES = 128
FROM_D, FROM_U, FROM_L = 0, 1, 2
INT32_MAX = 2147483647


def move_word(moves, band: int) -> int:
    """Band ``band``'s four bytes: the change of the walk's offset, plus
    one, for each move out of it (D, U, L, none).  d(x) = 1 - move[x] is
    how far ll_e falls from band x to x - 1 (0 below band 0)."""
    d0 = 1 - int(moves[band])
    d1 = 1 - int(moves[band - 1]) if band >= 1 else 0
    return (2 - d0 - d1) | (2 - d0) << 8 | (1 - d0) << 16 | 1 << 24


def _exclusive(x):
    return np.cumsum(x) - x


def chunked_walk(trace, moves, lle, best_e, ev, mu, sigma, c, nk):
    """One read's walk as the kernel makes it.  trace [n_bands, 32] uint8,
    moves [n_bands] uint8, ev [T] f32, mu/sigma/c [K] f32.  Returns
    (b2e_start [K], b2e_stop [K], sum_em f32, stats [5], counts) with
    counts the chunks walked, those walked without the end tests and the
    offset clamp ("far"), the visits and the D moves that jump over the
    first band of the next chunk."""
    n_bands = trace.shape[0]
    T_, K = len(ev), len(mu)
    sb = np.full(K, -1, np.int64)
    tb = np.full(K, -1, np.int64)
    ki, ei = int(nk) - 1, int(best_e)
    bi0 = ei + ki + 2
    sum_em = np.float32(0.0)
    n_pairs = cur_gap = max_gap = 0
    min_ev, max_ev, last_ki, last_map_k = INT32_MAX, -1, -1, -1
    counts = {"chunks": 0, "far": 0, "visits": 0, "d_over_edge": 0}
    if 0 <= bi0 < n_bands:
        off = int(lle) - int((1 - moves[bi0 + 1:].astype(np.int64)).sum()) - ei
        hi, nrows, rb = bi0, min(CH, bi0 + 1), 0
        while True:
            counts["chunks"] += 1
            ei0, ki0 = ei, ki
            j = np.arange(CH)
            ew = ev[np.clip(ei0 - j, 0, T_ - 1)]
            kw = np.clip(ki0 - j, 0, K - 1)
            rows = trace[hi - np.arange(nrows)]
            words = [move_word(moves, hi - i) for i in range(nrows)]
            hi_n = hi - nrows
            nrows_n = min(CH, hi_n + 1)
            far = ei0 >= CH and ki0 >= CH and CH <= off < LANES - CH
            counts["far"] += far
            # the walk: the chain carries the offset and the row (and, for
            # the end tests, the event and kmer); lane j keeps move j
            path = []
            o_, r_, e_, k_ = off, rb, ei, ki
            alive = r_ < nrows
            while alive:
                if far:
                    assert 0 <= o_ < LANES          # no clamp needed
                o = min(max(o_, 0), LANES - 1)
                mv = (int(rows[r_, o >> 2]) >> ((o & 3) * 2)) & 3
                path.append(mv)
                term = k_ < (mv != FROM_U) or e_ < (mv != FROM_L)
                assert not (far and term)           # no end test needed
                stop = mv == 3 or term
                e_ -= mv < 2
                k_ -= not mv & 1
                o_ += ((words[r_] >> (8 * mv)) & 255) - 1
                r_ += 1 + (mv == FROM_D)
                counts["d_over_edge"] += mv == FROM_D and r_ == nrows + 1
                alive = not stop and r_ < nrows
            nv = len(path)
            counts["visits"] += nv
            # each visit's event, kmer and row from the moves (ballots)
            pm = np.array(path, np.int64)
            dei, dki, dd = pm < 2, (pm & 1) == 0, pm == FROM_D
            pe = ei0 - _exclusive(dei)
            pk = ki0 - _exclusive(dki)
            pr = rb + np.arange(nv) + _exclusive(dd)
            off += sum(((words[r] >> (8 * m)) & 255) - 1
                       for r, m in zip(pr, pm))
            ei, ki = ei0 - int(dei.sum()), ki0 - int(dki.sum())
            rb += nv + int(dd.sum())
            assert (off, rb, ei, ki) == (o_, r_, e_, k_)
            rb -= nrows
            term = nv > 0 and (pk[-1] < (pm[-1] != FROM_U)
                               or pe[-1] < (pm[-1] != FROM_L))
            done = (nv > 0 and (term or pm[-1] == 3)) or hi_n < 0
            if nv:
                je, jk = ei0 - pe, kw[ki0 - pk]
                lp = log_normal_fused(torch.from_numpy(ew[je]),
                                      torch.from_numpy(mu[jk]),
                                      torch.from_numpy(sigma[jk]),
                                      torch.from_numpy(c[jk])).numpy()
                for x in lp:                            # walk order
                    sum_em = np.float32(sum_em + x)
                is_l = pm == FROM_L
                gaps = []
                for v in range(nv):                     # the ballot's rule
                    non_l = [u for u in range(v + 1) if not is_l[u]]
                    gaps.append(v - non_l[-1] if non_l else cur_gap + v + 1)
                max_gap = max(max_gap, max(gaps))
                cur_gap = gaps[-1]
                ok = ~is_l
                ok[-1] |= term
                kc = np.clip(pk, 0, K - 1)
                lanes = np.flatnonzero(ok)
                for i, v in enumerate(lanes):
                    prev = kc[lanes[i - 1]] if i else last_map_k
                    if kc[v] != prev:
                        tb[kc[v]] = pe[v]
                    if i + 1 == len(lanes) or kc[lanes[i + 1]] != kc[v]:
                        sb[kc[v]] = pe[v]
                if len(lanes):
                    last_map_k = int(kc[lanes[-1]])
                n_pairs += nv
                last_ki = int(pk[-1])
                min_ev = min(min_ev, int(pe[-1]))
                max_ev = max(max_ev, ei0)
            if done:
                break
            hi, nrows = hi_n, nrows_n
    stats = np.array([n_pairs, max_gap, last_ki, min_ev, max_ev], np.int64)
    return sb, tb, sum_em, stats, counts


def chunked_backtrack(trace, moves, ll_e_last, best_e, event_mean, mu,
                      sigma, c, n_kmers):
    """chunked_walk over a batch, on banded_backtrack_plain's arguments and
    with its outputs (b2e_start, b2e_stop [B, K] i32, sum_em [B] f32,
    stats [B, 5] i32), plus the summed counts."""
    a = [t.cpu().numpy() for t in (trace, moves, ll_e_last, best_e,
                                   event_mean, mu, sigma, c, n_kmers)]
    res = [chunked_walk(a[0][b], a[1][b], a[2][b], a[3][b], a[4][b],
                        a[5][b], a[6][b], a[7][b], a[8][b])
           for b in range(a[0].shape[0])]
    counts = {k: sum(r[4][k] for r in res) for k in res[0][4]}
    return (torch.from_numpy(np.stack([r[0] for r in res]).astype(np.int32)),
            torch.from_numpy(np.stack([r[1] for r in res]).astype(np.int32)),
            torch.from_numpy(np.array([r[2] for r in res], np.float32)),
            torch.from_numpy(np.stack([r[3] for r in res]).astype(np.int32)),
            counts)
