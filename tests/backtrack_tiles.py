"""NumPy model of csrc/viterbi_backtrack.cu's staged walk and its decode.

The kernel walks a segment's trace [T, KP] from shared memory: it stages
a tile of ``rows`` trace rows x a ``window`` of kmers that ends at the
walk's kmer (rounded up to its 16-byte group), prefetches the tile of the
rows below into a second buffer, and stages a tile at once where a K-state
run leaves the window.  ``tiled_walk`` follows the same rules on one
segment, reading every trace byte from the tile it staged (an index
outside the tile raises) and decoding it as the kernel does (a nibble
of MOVES), and returns the path in
``viterbi_backtrack_plain``'s layout with the number of tiles staged and
of those staged because the walk left the window.
"""

import numpy as np

ST_K, ST_B, ST_M = 0, 1, 2
# the kernel's decode (csrc/viterbi_backtrack.cu MOVES): a move as a nibble
# of MOVES, next state in bits 0-1, "one kmer lower" in bit 2, "soft
# clip" in bit 3; the state's move field is (byte >> sh) & msk, shifted
# left by msh to a nibble's bit offset
MOVES = 0x845162
FIELD = {ST_M: (0, 7, 2), ST_B: (3, 1, 3), ST_K: (4, 7, 2)}   # sh, msk, msh


def _stage(tr, KP, rows, window, r, ki):
    r_lo = max(0, r - rows + 1)
    k_lo = max(0, min(KP, (ki | 15) + 1) - window)
    assert k_lo % 16 == 0 and k_lo + window <= KP
    return r_lo, r, k_lo, tr[r_lo:r + 1, k_lo:k_lo + window].copy()


def _inside(tile, r, ki):
    return tile is not None and tile[0] <= r <= tile[1] and ki >= tile[2]


def tiled_walk(tr, n_events, n_kmers, rows, window):
    """One segment's path [1 + T + KP] int64 (event << 32 | kmer << 2 |
    state, entry 0 its length), tiles staged, refills forced by the
    window."""
    T, KP = tr.shape
    L = T + KP
    out = np.zeros(1 + L, np.int64)
    row, ki, st, n = int(n_events), int(n_kmers) - 1, ST_M, 0
    staged = forced = 0
    cur = nxt = None
    if row > 0 and ki >= 0:
        cur = _stage(tr, KP, rows, window, row - 1, ki)
        staged += 1
        if cur[0] > 0:
            nxt = _stage(tr, KP, rows, window, cur[0] - 1, ki)
            staged += 1
    while row > 0 and n < L:
        r = row - 1
        out[1 + n] = (r << 32) | (ki << 2) | st
        n += 1
        if not _inside(cur, r, ki):
            if not _inside(nxt, r, ki):
                nxt = _stage(tr, KP, rows, window, r, ki)
                staged += 1
                forced += 1
            cur, nxt = nxt, None
            if cur[0] > 0:
                nxt = _stage(tr, KP, rows, window, cur[0] - 1, ki)
                staged += 1
        r_lo, _, k_lo, buf = cur
        byte = int(buf[r - r_lo, ki - k_lo])
        sh, msk, msh = FIELD[st]
        info = (MOVES >> (((byte >> sh) & msk) << msh)) & 15
        if info & 8:
            break
        if st != ST_K:
            row -= 1
        ki -= (info >> 2) & 1
        st = info & 3
        if ki < 0:
            break
    out[0] = n
    return out, staged, forced


def tiled_paths(trace, n_events, n_kmers, rows, window):
    """tiled_walk over a batch: paths [B, 1 + T + KP], tiles staged and
    forced refills per segment."""
    res = [tiled_walk(trace[b], n_events[b], n_kmers[b], rows, window)
           for b in range(trace.shape[0])]
    return (np.stack([p for p, _, _ in res]),
            np.array([s for _, s, _ in res]), np.array([f for _, _, f in res]))
