"""call-methylation's rows for one read, as nanopolish's
calculate_methylation_for_read and the TSV writer make them
(src/nanopolish_call_methylation.cpp:532-550, src/basemods/
nanopolish_basemods.cpp:273-380): CpG sites grouped where they lie within
10 bases, a window of 10 flanking bases, the events the read's alignment
puts in it, and the Forward log-likelihood of the window unmethylated and
with every CpG methylated, under the cpg pore model."""

from __future__ import annotations

from typing import List

import numpy as np

from . import hmm
from .common import (CPG, F32, Precision, kmer_ranks, methylate_cpg,
                     revcomp, revcomp_cpg)
from .ingest import IngestedRead

K = 6
MIN_SEPARATION = 10
MIN_FLANK = 10
MAX_EVENT_TO_BP = 20
FLAGS = 3                     # pre- and post-clip allowed


def closest_event_table(b2e: np.ndarray) -> np.ndarray:
    """The nearest mapped kmer's event within 1,000 kmers for every kmer,
    the one at or before first."""
    n = b2e.shape[0]
    idx = np.arange(n)
    mapped = b2e[:, 0] != -1
    last_le = np.maximum.accumulate(np.where(mapped, idx, -1))
    first_ge = np.minimum.accumulate(np.where(mapped, idx, 2 * n)[::-1])[::-1]
    before = np.where((last_le >= 0) & (idx - last_le <= 1000),
                      b2e[np.maximum(last_le, 0), 0], -1)
    after = np.where((first_ge < 2 * n) & (first_ge - idx <= 1000),
                     b2e[np.minimum(first_ge, n - 1), 0], -1)
    return np.where(before != -1, before, after).astype(np.int64)


def aligned_events(read: IngestedRead, rc: bool, pos: int, L: int):
    """(ref position, event) of every aligned base kept by the record
    builder (alignment_db.cpp:55-91)."""
    j = np.arange(L)
    j = j[(j >= K) & (j + K < L)]
    closest = closest_event_table(read.b2e)
    kp = (L - j - K) if rc else j
    kp = np.clip(kp, 0, len(closest) - 1)
    al = np.stack([pos + j, closest[kp]], axis=1)
    if al.shape[0] and al[0, 1] == al[-1, 1]:
        al = al[:0]
    return al


def _bounds(pairs, lo, hi):
    """find_by_ref_bounds for arrays of bounds (alignment_db.cpp:688-731)."""
    n = pairs.shape[0]
    refs = pairs[:, 0]
    i1 = np.searchsorted(refs, lo, side="left")
    i2 = np.searchsorted(refs, hi, side="left")
    inb = (i1 < n) & (i2 < n)
    a = np.minimum(i1, n - 1)
    b = np.minimum(i2, n - 1)
    left = (refs[a] <= lo) | ((i1 > 0) & (refs[np.maximum(i1 - 1, 0)] <= lo))
    right = (refs[b] >= hi) | ((i2 + 1 < n) &
                               (refs[np.minimum(i2 + 1, n - 1)] >= lo))
    return pairs[a, 1], pairs[b, 1], inb & left & right


def groups(read: IngestedRead, rc: bool, pos: int, L: int, genome: str,
           cpg_mean, cpg_stdv):
    """The read's scored groups: (site metadata, unmethylated segment,
    methylated segment)."""
    if not read.ok:
        return []
    ref = genome[pos:pos + L + 1]
    n_ref = len(ref)
    motifs = np.array([i for i in range(n_ref - 1) if ref[i] == "C"
                       and ref[i + 1] == "G"], np.int64)
    if len(motifs) == 0:
        return []
    al = aligned_events(read, rc, pos, L)
    if al.shape[0] == 0:
        return []
    brk = np.flatnonzero(np.diff(motifs) > MIN_SEPARATION)
    gs = np.concatenate([[0], brk + 1])
    ge = np.concatenate([brk + 1, [len(motifs)]])
    first, last = motifs[gs], motifs[ge - 1]
    ss, se = first - MIN_FLANK, last + MIN_FLANK
    ok = (ss > MIN_SEPARATION) & (last - first <= 200) & (se < n_ref)
    e1, e2, okb = _bounds(al, ss + pos, se + pos)
    d = np.abs(e2 - e1)
    ratio = d / np.maximum(se - ss, 1)
    ok &= okb & (d > 10) & ~(ratio > MAX_EVENT_TO_BP)
    mu_tab = (read.scale * cpg_mean + read.shift).astype(np.float32)
    sig_tab = (cpg_stdv * read.var).astype(np.float32)
    lev = read.events.mean
    out = []
    for g in np.flatnonzero(ok).tolist():
        sub = ref[ss[g]:se[g] + 1]
        msub = methylate_cpg(sub)
        if rc:
            ru = kmer_ranks(revcomp(sub), CPG, K)[::-1]
            rm = kmer_ranks(revcomp_cpg(msub), CPG, K)[::-1]
        else:
            ru = kmer_ranks(sub, CPG, K)
            rm = kmer_ranks(msub, CPG, K)
        step = 1 if e2[g] >= e1[g] else -1
        lv = lev[e1[g] + np.arange(d[g] + 1) * step]
        epb = read.events_per_base
        meta = dict(pos=int(first[g] + pos), end=int(last[g] + pos),
                    n_motif=int(ge[g] - gs[g]),
                    seq=ref[first[g] - K + 1:last[g] + K])
        out.append((meta, (lv, mu_tab[ru], sig_tab[ru], epb, FLAGS),
                    (lv, mu_tab[rm], sig_tab[rm], epb, FLAGS)))
    return out


def score(per_read: dict, device, prec: Precision = F32) -> dict:
    """per_read[name] = groups(...); returns name -> [(meta, ll_u, ll_m)]
    with the two Forwards of every group of every read in one batch."""
    segs, where = [], []
    for name, gl in per_read.items():
        for gi, (_, su, sm) in enumerate(gl):
            segs += [su, sm]
            where.append((name, gi))
    lls = hmm.run_batched(hmm.forward, segs, device, prec=prec) if segs \
        else []
    out = {name: [None] * len(gl) for name, gl in per_read.items()}
    for j, (name, gi) in enumerate(where):
        meta = per_read[name][gi][0]
        out[name][gi] = (meta, float(lls[2 * j]), float(lls[2 * j + 1]))
    return out


def render(sites: List[tuple], contig: str, name: str, rc: bool):
    """(text line, exact log-likelihood ratio) per site, position order."""
    out = []
    for meta, u, m in sorted(sites, key=lambda s: s[0]["pos"]):
        line = (f"{contig}\t{'-' if rc else '+'}\t{meta['pos']}\t"
                f"{meta['end']}\t{name}\t{m - u:.2f}\t{m:.2f}\t{u:.2f}\t1\t"
                f"{meta['n_motif']}\t{meta['seq']}")
        out.append((line, m - u))
    return out
