"""eventalign's rows for one read, as nanopolish's align_read_to_ref and
emit_event_alignment_tsv write them (src/alignment/
nanopolish_eventalign.cpp:612-827, :398-484, with --scale-events).

The chain: each segment spans about 100 reference bases from where the
last one stopped; its events are Viterbi-aligned to its kmers, the first
50 kept rows are output and the next segment starts at the last of them.
``align`` computes that chain from each read's own start, every segment
from the reference's own previous one.  To batch the Viterbi it may be
handed guesses of the hand-offs (the benchmark passes the program's
printed rows): the guessed segments are computed together, and a guess
is used only where the reference's own previous segment ends exactly on
it.  Where one differs, the read's chain goes on one segment at a time
until it meets a guessed start again.  The rows are the same whatever
the guesses; only the time differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import hmm
from .common import F32, NUC, Precision, kmer_ranks, revcomp
from .ingest import IngestedRead

ALIGN_STRIDE = 100
OUTPUT_STRIDE = 50
K = 6


@dataclass
class Job:
    read: IngestedRead
    name: str
    bam_index: int
    rc: bool
    pos: int
    ref_seq: str
    rc_ref_seq: str
    wr_fwd: np.ndarray
    wr_rc: np.ndarray
    pairs: np.ndarray
    mu_tab: np.ndarray
    sig_tab: np.ndarray
    levels: np.ndarray
    last_event: int = 0
    forward: bool = True
    rows: List[tuple] = field(default_factory=list)   # (ref_pos, ev, state)


def closest_event(b2e: np.ndarray, k_idx: int) -> int:
    """get_closest_event_to (squiggle_read.cpp:174-186)."""
    n = b2e.shape[0]

    def nxt(start, stop, stride):
        i = start
        while i != stop:
            if b2e[i, 0] != -1:
                return int(b2e[i, 0])
            i += stride
        return -1
    before = nxt(k_idx, max(0, k_idx - 1000), -1)
    after = nxt(k_idx, min(k_idx + 1000, n - 1), 1)
    return after if before == -1 else before


def end_pair(pairs: np.ndarray, ref_max: int, idx: int) -> int:
    n = pairs.shape[0]
    i = max(idx, int(np.searchsorted(pairs[:, 0], ref_max, side="right")))
    return n - 1 if i >= n else i - 1


def make_job(read: IngestedRead, name, bam_index, rc, pos, length, genome,
             level_mean, level_stdv) -> Optional[Job]:
    if not read.ok:
        return None
    ref_seq = genome[pos:pos + length + 1]
    rc_ref = revcomp(ref_seq)
    L = length
    pairs = np.stack([pos + np.arange(L), np.arange(L)], axis=1)
    pairs = pairs[pairs[:, 1] <= L - K]
    mu_tab = (read.scale * level_mean + read.shift).astype(np.float32)
    sig_tab = (level_stdv * read.var).astype(np.float32)
    job = Job(read=read, name=name, bam_index=bam_index, rc=rc, pos=pos,
              ref_seq=ref_seq, rc_ref_seq=rc_ref,
              wr_fwd=kmer_ranks(ref_seq, NUC, K),
              wr_rc=kmer_ranks(rc_ref, NUC, K), pairs=pairs,
              mu_tab=mu_tab, sig_tab=sig_tab, levels=read.events.mean)
    ks = L - K if rc else 0
    ke = 0 if rc else L - K
    first = closest_event(read.b2e, ks)
    last = closest_event(read.b2e, ke)
    if first == -1 or last == -1:
        return None
    job.last_event = last
    job.forward = first < last
    job._start = (first, int(pairs[0, 0]), 0)
    return job


def prepare(job: Job, cse: int, csr: int, pidx: int):
    """The segment starting at event cse and reference csr, or None where
    the job ends (eventalign.cpp:691-760)."""
    if not ((job.forward and cse < job.last_event) or
            (not job.forward and cse > job.last_event)):
        return None
    pairs = job.pairs
    ep = end_pair(pairs, csr + ALIGN_STRIDE, pidx)
    cer = int(pairs[ep, 0])
    cerd = int(pairs[ep, 1])
    L = len(job.read.b2e) + K - 1
    if job.rc:
        cerd = L - cerd - K
    if cerd < 0:
        return None
    s = csr - job.pos
    l = cer - csr + 1
    if l < 2 * K:
        return None
    stop = closest_event(job.read.b2e, cerd)
    if abs(cse - stop) < 2:
        return None
    nkr = l - K + 1
    nseq = len(job.ref_seq)
    if job.rc:
        r0 = nseq - s - l
        ranks = job.wr_rc[r0:r0 + nkr][::-1]
    else:
        ranks = job.wr_fwd[s:s + nkr]
    step = 1 if stop >= cse else -1
    end = stop + step
    lv = job.levels[cse:(None if end < 0 else end):step]
    return dict(cse=cse, csr=csr, pidx=pidx, stop=stop,
                last=ep == pairs.shape[0] - 1,
                seg=(lv, job.mu_tab[ranks], job.sig_tab[ranks],
                     job.read.events_per_base, 0))


def consume(job: Job, p: dict, res):
    """Kept rows of one segment and the next start (or None)."""
    evs, kms, st = res
    st = np.frombuffer(st, np.uint8)
    stride = 1 if p["cse"] <= p["stop"] else -1
    ev_abs = p["cse"] + evs * stride
    kept = np.flatnonzero((st != ord("K")) & (ev_abs != p["cse"]))
    if not p["last"]:
        kept = kept[:OUTPUT_STRIDE]
    if kept.size == 0:
        return [], None
    ref = p["csr"] + kms[kept]
    rows = list(zip(ref.tolist(), ev_abs[kept].tolist(),
                    st[kept].tolist()))
    cse, csr = int(ev_abs[kept[-1]]), int(ref[-1])
    return rows, (cse, csr, end_pair(job.pairs, csr, p["pidx"]))


def align(jobs: List[Job], guesses: dict, device,
          prec: Precision = F32) -> None:
    """Fill each job's rows with its sequential chain.  guesses[name] are
    (ref_pos, event) rows of that read, in order, whose every 50th is
    tried as a hand-off (see the module's docstring)."""
    known = []                       # per job: start -> (segment, result)
    flat = []
    for job in jobs:
        prog = guesses.get(job.name, [])
        state, starts = job._start, []
        for i in range(0, len(prog) + 1, OUTPUT_STRIDE):
            p = prepare(job, *state)
            if p is None:
                break
            starts.append((state, p))
            if p["last"] or i + OUTPUT_STRIDE > len(prog):
                break
            r, e = prog[i + OUTPUT_STRIDE - 1]
            state = (e, r, end_pair(job.pairs, r, state[2]))
        known.append(starts)
        flat += [p for _, p in starts]
    res = iter(hmm.run_batched(hmm.viterbi, [p["seg"] for p in flat],
                               device, prec=prec) if flat else [])
    known = [{st: (p, next(res)) for st, p in starts} for starts in known]

    def walk(job, seen, state):
        """Follow the chain through segments already computed; the next
        one to compute, or None where the chain ends."""
        while state is not None:
            hit = seen.pop(state, None)
            if hit is None:
                return prepare(job, *state)
            rows, state = consume(job, *hit)
            job.rows.append(rows)
        return None

    pending = [(job, seen, q) for job, seen in zip(jobs, known)
               for q in [walk(job, seen, job._start)] if q is not None]
    while pending:
        res = hmm.run_batched(hmm.viterbi, [q["seg"] for _, _, q in pending],
                              device, prec=prec)
        nxt = []
        for (job, seen, q), r in zip(pending, res):
            rows, state = consume(job, q, r)
            job.rows.append(rows)
            q = walk(job, seen, state)
            if q is not None:
                nxt.append((job, seen, q))
        pending = nxt
    for job in jobs:
        job.rows = [r for block in job.rows for r in block]


def render(job: Job, contig: str, level_mean, level_stdv) -> List[tuple]:
    """(text line, exact scaled level) per row, as the TSV prints them."""
    rd = job.read
    ev = rd.events
    f32 = np.float32
    sqrt_var = math.sqrt(rd.var)
    nseq = len(job.ref_seq)
    out = []
    for rp, e, st in job.rows:
        p = rp - job.pos
        ref_kmer = job.ref_seq[p:p + K]
        is_b = st == ord("B")
        if is_b:
            model_kmer = "N" * K
            mm = ms = f32(0.0)
        else:
            if job.rc:
                model_kmer = job.rc_ref_seq[nseq - p - K:nseq - p]
                rank = job.wr_rc[nseq - K - p]
            else:
                model_kmer = ref_kmer
                rank = job.wr_fwd[p]
            mm = f32(level_mean[rank])
            ms = f32(level_stdv[rank])
        lvl = f32((ev.mean[e] - f32(rd.shift)) / f32(rd.scale))
        den = f32(float(sqrt_var) * float(ms))
        if ms > 0:
            sd = f32((lvl - mm) / den)
        else:
            sd = f32(np.inf) if lvl > mm else (f32(-np.inf) if lvl < mm
                                               else f32(np.nan))
        line = (f"{contig}\t{rp}\t{ref_kmer}\t{job.bam_index}\tt\t{e}\t"
                f"{float(lvl):.2f}\t{float(ev.stdv[e]):.3f}\t"
                f"{float(ev.duration[e]):.5f}\t{model_kmer}\t"
                f"{float(mm):.2f}\t{float(ms):.2f}\t{float(sd):.2f}")
        out.append((line, float(lvl)))
    return out
