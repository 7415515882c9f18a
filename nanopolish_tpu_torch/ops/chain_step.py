"""eventalign's segment chain, one round at a time, on the card.

Counterpart of the loop body of ``nanopolish_tpu/alignment/device_chain.py``
(``_chain_program``'s ``body``, :226-377): the per-round host steps of the
wavefront (``alignment/eventalign._prepare`` and ``_consume``) as two entry
points of the hand-written CUDA kernel ``csrc/chain_step.cu``, one warp per
job slot:

  * ``chain_prepare``: the loop condition, the end pair (the semantics of
    ``alignment/anchor.get_end_pair`` from the job's pair hint), the QC stops,
    the window's shape and its Viterbi inputs, written in place into the
    slot's row of the round's ``[S, TP]`` / ``[S, KP]`` tensors.  A slot
    whose job has no window this round (it ended, or never started) takes
    the next job from the head of the queue, and so on until one has a
    window or the queue is empty;
  * ``chain_consume``: ``_consume``'s kept-row rule on the round's traceback
    (``viterbi_backtrack``'s layout), each kept row written at the job's
    cursor, then the re-anchoring.

A call's J jobs live in flat ragged tensors (``alignment/device_chain``
builds them), in queue order, and run in S <= J slots:

  meta [J, N_META] i32       per job: offsets and lengths of its rows in the
                             flat tensors, last event, direction, ref offset,
                             k, and its output rows' offset and capacity
  state [J, N_STATE] i32     the chain: start event and ref, pair hint,
                             status, cursor; this round's stride (0: no
                             window) and last-section flag; and the work
                             of the job's windows so far: windows, DP
                             cells (n_events x n_kmers, in two columns:
                             below and above 2^30) and traceback path
                             steps
  pairs_ref, pairs_read i32  the aligned pairs (read side flipped for
                             reverse records), refs ascending
  closest i32                ``closest_event_array`` of the job's b2e map
  levels_all f32             the drift-corrected event levels
  tabs [3, n_tab] f32        mu, sigma, c at every kmer of the job's window
  trans_all [J, 8] f32       each job's transitions; ``trans [S, 8]`` holds
                             the slots' jobs' rows for the Viterbi fill
  sched [1 + S] i32          the queue's head (the next job to take) and
                             the job in each slot (-1: none)
  rows [3, n_rows] i32       output: absolute event, absolute ref, state
                             byte ('M' 77, 'B' 66)

A job is aborted once it has had ``budget`` windows.  Which slot takes which
job may follow the order in which the kernel's warps reach the queue's head;
the jobs taken in a round, and each job's ``state`` and kept rows, do not
(the plain version hands jobs out in slot order).

Each wrapper takes tensors on one device.  For CPU tensors it runs the plain
version below; for CUDA tensors it launches the kernel (building it at first
use) or raises.  Both write the same values, bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .profile_hmm import MAX_KMERS, PAD_C, PATH_EVENT_SHIFT, PATH_KMER_SHIFT

ALIGN_STRIDE = 100   # ref bases per window (eventalign.cpp:668)
OUTPUT_STRIDE = 50   # rows kept per window but the last (eventalign.cpp:669)

# meta columns
(M_POFF, M_NPAIRS, M_LOFF, M_NLEV, M_ROFF, M_NRANK, M_COFF, M_NCLOSE,
 M_LAST, M_FWD, M_REFOFF, M_K, M_OOFF, M_OCAP) = range(14)
N_META = 14
# state columns; the last four count the work of every round in which the
# job has a window (stride != 0), aborted jobs up to their abort: the
# windows, the fill's DP cells (n_events x n_kmers) as lo + hi * 2^30, and
# the backtrack's path steps (the path's length, K cells included)
(S_EV, S_REF, S_PAIR, S_STATUS, S_CURSOR, S_STRIDE, S_LAST, S_WINDOWS,
 S_CELLS, S_CELLS_HI, S_STEPS) = range(11)
N_STATE = 11
CELLS_CARRY = 1 << 30
# job status
ACTIVE, DONE, ABORTED = 0, 1, 2
# C entry point's operation
_OP_PREPARE, _OP_CONSUME = 0, 1
_BIG = 1 << 30


def _check_batch(meta, state, pairs_ref, sched, S, dev):
    J = state.shape[0]
    i32 = torch.int32
    cuda_build.check_tensor("meta", meta, i32, (J, N_META), dev)
    cuda_build.check_tensor("state", state, i32, (J, N_STATE), dev)
    cuda_build.check_tensor("pairs_ref", pairs_ref, i32, pairs_ref.shape, dev)
    if pairs_ref.dim() != 1:
        raise ValueError("pairs_ref: must be one flat row")
    if not 0 < S <= J:
        raise ValueError(f"{S} slots for {J} jobs")
    cuda_build.check_tensor("sched", sched, i32, (1 + S,), dev)


def chain_prepare(meta, state, pairs_ref, pairs_read, closest, levels_all,
                  tabs, trans_all, budget, trans, sched, levels, mu, sigma, c,
                  n_events, n_kmers):
    """One round's setup for every slot: updates ``state`` and ``sched``
    and writes the Viterbi inputs in place: ``levels[s, :n_events[s]]``
    and the whole ``mu``/``sigma``/``c`` rows (kmers past ``n_kmers[s]``
    padded with 0, 1 and ``PAD_C``) of each slot whose job has a window
    this round, and ``trans[s]`` where the slot took a new job; a slot
    left without a job gets ``n_events = n_kmers = 1`` and its rows are
    left as they are.  A job with a window adds 1 to its ``S_WINDOWS``
    and n_events x n_kmers to its cells (``S_CELLS`` + ``S_CELLS_HI`` x
    ``CELLS_CARRY``); a job that has had ``budget`` windows is aborted."""
    if state.device.type == "cpu":
        return chain_prepare_plain(meta, state, pairs_ref, pairs_read,
                                   closest, levels_all, tabs, trans_all,
                                   budget, trans, sched, levels, mu, sigma,
                                   c, n_events, n_kmers)
    cuda_build.require_cuda(state)
    dev = state.device
    J = state.shape[0]
    S, TP = levels.shape
    KP = mu.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check_batch(meta, state, pairs_ref, sched, S, dev)
    cuda_build.check_tensor("pairs_read", pairs_read, i32, pairs_ref.shape,
                            dev)
    cuda_build.check_tensor("closest", closest, i32, closest.shape, dev)
    cuda_build.check_tensor("levels_all", levels_all, f32, levels_all.shape,
                            dev)
    cuda_build.check_tensor("tabs", tabs, f32, (3, tabs.shape[1]), dev)
    cuda_build.check_tensor("trans_all", trans_all, f32, (J, 8), dev)
    cuda_build.check_tensor("trans", trans, f32, (S, 8), dev)
    cuda_build.check_tensor("levels", levels, f32, (S, TP), dev)
    for nm, t in (("mu", mu), ("sigma", sigma), ("c", c)):
        cuda_build.check_tensor(nm, t, f32, (S, KP), dev)
    cuda_build.check_tensor("n_events", n_events, i32, (S,), dev)
    cuda_build.check_tensor("n_kmers", n_kmers, i32, (S,), dev)
    cuda_build.launch(
        "chain_step", _OP_PREPARE, meta.data_ptr(), state.data_ptr(),
        pairs_ref.data_ptr(), pairs_read.data_ptr(), closest.data_ptr(),
        levels_all.data_ptr(), tabs.data_ptr(), tabs.shape[1], J, S,
        int(budget), TP, KP, PAD_C, trans_all.data_ptr(), trans.data_ptr(),
        sched.data_ptr(), levels.data_ptr(), mu.data_ptr(),
        sigma.data_ptr(), c.data_ptr(), n_events.data_ptr(),
        n_kmers.data_ptr(), None, 0, None, 0)
    cuda_build.count_launch("chain_step")


def chain_consume(meta, state, pairs_ref, sched, path, rows):
    """Apply one round's tracebacks (``path`` [S, 1 + T + KP] int64, the
    layout of ``viterbi_backtrack``, a row a slot): write each slot's
    job's kept rows into ``rows`` at its cursor and re-anchor its chain,
    updating ``state``.  A job with a window adds its path's length to
    ``S_STEPS``."""
    if state.device.type == "cpu":
        return chain_consume_plain(meta, state, pairs_ref, sched, path, rows)
    cuda_build.require_cuda(state)
    dev = state.device
    J = state.shape[0]
    S = path.shape[0]
    _check_batch(meta, state, pairs_ref, sched, S, dev)
    cuda_build.check_tensor("path", path, torch.int64, (S, path.shape[1]),
                            dev)
    cuda_build.check_tensor("rows", rows, torch.int32, (3, rows.shape[1]),
                            dev)
    cuda_build.launch(
        "chain_step", _OP_CONSUME, meta.data_ptr(), state.data_ptr(),
        pairs_ref.data_ptr(), None, None, None, None, 0, J, S, 0, 0, 0, 0.0,
        None, None, sched.data_ptr(), None, None, None, None, None, None,
        path.data_ptr(), path.shape[1], rows.data_ptr(), rows.shape[1])
    cuda_build.count_launch("chain_step")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _take(flat, idx):
    """flat[idx] with idx clamped into the row (the values taken for jobs
    that do not use them are never read)."""
    return flat[idx.clamp(0, max(flat.shape[-1] - 1, 0))]


def end_pair(pairs_ref, m, q, hint):
    """``get_end_pair(pairs, q, hint)`` of every job over its ascending
    refs: the first index from ``hint`` whose ref exceeds q, minus one
    (``hint - 1`` when the hint's own ref does), else the last pair.  A
    binary search, as the kernel's."""
    n = m[:, M_NPAIRS]
    off = m[:, M_POFF]
    at_hint = _take(pairs_ref, off + hint.clamp(max=n - 1)).to(torch.int64)
    lo, hi = hint.clone(), n.clone()
    for _ in range(31):
        go = lo < hi
        mid = (lo + hi) >> 1
        gt = _take(pairs_ref, off + mid).to(torch.int64) > q
        hi = torch.where(go & gt, mid, hi)
        lo = torch.where(go & ~gt, mid + 1, lo)
    ep = lo - 1
    ep = torch.where((hint < n) & (at_hint > q), hint - 1, ep)
    return torch.where(hint >= n, n - 1, ep)


def _plan(m, s, budget, pairs_ref, pairs_read, closest, TP, KP):
    """The round's window of each job (its meta rows ``m`` and state rows
    ``s``, int64): (status, stride, last, nev, nkr, sidx), with stride 0
    where the job has none and status saying why."""
    start_ev, start_ref = s[:, S_EV], s[:, S_REF]
    status = s[:, S_STATUS]
    # a job that has had its budget of windows goes back to the host path
    status = torch.where((status == ACTIVE) & (s[:, S_WINDOWS] >= budget),
                         ABORTED, status)
    act = status == ACTIVE
    # the loop condition (eventalign.cpp:689-690)
    more = torch.where(m[:, M_FWD] > 0, start_ev < m[:, M_LAST],
                       start_ev > m[:, M_LAST])
    status = torch.where(act & ~more, DONE, status)
    act = act & more
    ep = end_pair(pairs_ref, m, start_ref + ALIGN_STRIDE, s[:, S_PAIR])
    # an end pair before the first (impossible with ascending refs)
    status = torch.where(act & (ep < 0), ABORTED, status)
    act = act & (ep >= 0)
    gi = m[:, M_POFF] + ep
    end_ref = _take(pairs_ref, gi).to(torch.int64)
    end_read = _take(pairs_read, gi).to(torch.int64)
    k = m[:, M_K]
    ln = end_ref - start_ref + 1
    stop = (end_read < 0) | (ln < 2 * k)
    status = torch.where(act & stop, DONE, status)
    act = act & ~stop
    ev_stop = _take(closest, m[:, M_COFF] + torch.minimum(
        end_read, m[:, M_NCLOSE] - 1)).to(torch.int64)
    d = ev_stop - start_ev
    stop = d.abs() < 2                              # eventalign.cpp:744
    status = torch.where(act & stop, DONE, status)
    act = act & ~stop
    nev = d.abs() + 1
    nkr = ln - k + 1
    sidx = start_ref - m[:, M_REFOFF]
    # windows the padded shapes, the events or the window's kmers cannot
    # hold go back to the host path
    over = (nev > TP) | (nkr > KP) | (start_ev < 0) | \
        (start_ev >= m[:, M_NLEV]) | (ev_stop < 0) | \
        (ev_stop >= m[:, M_NLEV]) | (sidx < 0) | (sidx + nkr > m[:, M_NRANK])
    status = torch.where(act & over, ABORTED, status)
    act = act & ~over
    stride = torch.where(act, torch.where(d >= 0, 1, -1), 0)
    last = act & (ep == m[:, M_NPAIRS] - 1)
    return torch.stack([status, stride, last.to(torch.int64), nev, nkr, sidx],
                       dim=1)


def chain_prepare_plain(meta, state, pairs_ref, pairs_read, closest,
                        levels_all, tabs, trans_all, budget, trans, sched,
                        levels, mu, sigma, c, n_events, n_kmers):
    """``chain_prepare`` in PyTorch ops, vectorized over slots: the slots'
    jobs first, then the queue's jobs, to the slots left without a window
    in slot order (the k-th such slot takes the k-th job from the head
    that has a window)."""
    dev = state.device
    i64 = torch.int64
    J = state.shape[0]
    S, TP = levels.shape
    KP = mu.shape[1]

    def plan(jobs):
        """The jobs' windows; a job without one records why in its state
        and leaves its slot."""
        p = _plan(meta[jobs].to(i64), state[jobs].to(i64), budget,
                  pairs_ref, pairs_read, closest, TP, KP)
        gone = p[:, 1] == 0
        state[jobs[gone], S_STATUS] = p[gone, 0].to(torch.int32)
        state[jobs[gone], S_STRIDE] = 0
        state[jobs[gone], S_LAST] = 0
        return p, ~gone

    job = sched[1:].to(i64)
    win = torch.zeros((S, 6), dtype=i64, device=dev)
    fresh = torch.zeros(S, dtype=torch.bool, device=dev)
    held = (job >= 0).nonzero()[:, 0]
    p, has = plan(job[held])
    win[held[has]] = p[has]
    job[held[~has]] = -1
    head = int(sched[0])
    free = (job < 0).nonzero()[:, 0]
    while len(free) and head < J:
        take = torch.arange(head, min(head + len(free), J), device=dev)
        head += len(take)
        p, has = plan(take)
        to = free[:int(has.sum())]
        free = free[len(to):]
        job[to] = take[has]
        win[to] = p[has]
        fresh[to] = True
    sched[0] = head
    sched[1:] = job.to(torch.int32)

    act = job >= 0
    _, stride, last, nev, nkr, sidx = win.unbind(1)
    nev = torch.where(act, nev, 1)
    nkr = torch.where(act, nkr, 1)
    jb = job.clamp(min=0)
    m = meta[jb].to(i64)
    s = state[jb].to(i64)
    t = torch.arange(TP, device=dev)[None, :]
    tmask = act[:, None] & (t < nev[:, None])
    lv = _take(levels_all, m[:, M_LOFF, None] + s[:, S_EV, None]
               + t * stride[:, None])
    levels.copy_(torch.where(tmask, lv, levels))
    kk = torch.arange(KP, device=dev)[None, :]
    kin = kk < nkr[:, None]
    kidx = m[:, M_ROFF, None] + sidx[:, None] + kk
    row = act[:, None]
    for plane, out, pad in ((0, mu, 0.0), (1, sigma, 1.0), (2, c, PAD_C)):
        vals = torch.where(kin, _take(tabs[plane], kidx),
                           torch.tensor(pad, dtype=torch.float32, device=dev))
        out.copy_(torch.where(row, vals, out))
    trans.copy_(torch.where(fresh[:, None], trans_all[jb], trans))
    n_events.copy_(nev.to(torch.int32))
    n_kmers.copy_(nkr.to(torch.int32))
    w, s = job[act], s[act]
    state[w, S_STRIDE] = stride[act].to(torch.int32)
    state[w, S_LAST] = last[act].to(torch.int32)
    cells = s[:, S_CELLS] + nev[act] * nkr[act]
    carry = cells >= CELLS_CARRY
    state[w, S_WINDOWS] = (s[:, S_WINDOWS] + 1).to(torch.int32)
    state[w, S_CELLS] = torch.where(carry, cells - CELLS_CARRY, cells).to(
        torch.int32)
    state[w, S_CELLS_HI] = (s[:, S_CELLS_HI] + carry.to(i64)).to(torch.int32)


def chain_consume_plain(meta, state, pairs_ref, sched, path, rows):
    """``chain_consume`` in PyTorch ops, vectorized over slots."""
    dev = state.device
    i64 = torch.int64
    job = sched[1:].to(i64)
    jb = job.clamp(min=0)
    m = meta[jb].to(i64)
    s = state[jb].to(i64)
    stride = torch.where(job >= 0, s[:, S_STRIDE], 0)
    go = stride != 0
    start_ev, start_ref, cursor = s[:, S_EV], s[:, S_REF], s[:, S_CURSOR]
    W = path.shape[1]
    n = path[:, 0]
    i = torch.arange(W - 1, device=dev)[None, :]
    valid = go[:, None] & (i < n[:, None])
    # forward order: the traceback's cells reversed
    col = (n[:, None] - 1 - i).clamp(0, W - 2) + 1
    cell = path.gather(1, col)
    off = cell >> PATH_EVENT_SHIFT
    km = (cell >> PATH_KMER_SHIFT) & (MAX_KMERS - 1)
    st = cell & 3
    keep = valid & (st != 0) & (off != 0)      # no K row, no re-emitted anchor
    order = torch.cumsum(keep.to(i64), dim=1) - 1
    limit = torch.where(s[:, S_LAST] > 0, _BIG, OUTPUT_STRIDE)
    keep = keep & (order < limit[:, None])
    kept = keep.sum(dim=1)
    ev = start_ev[:, None] + off * stride[:, None]
    ref = start_ref[:, None] + km
    pos = cursor[:, None] + order
    cap = m[:, M_OCAP]
    put = keep & (pos < cap[:, None])
    at = (m[:, M_OOFF, None] + pos)[put]
    rows[0, at] = ev[put].to(torch.int32)
    rows[1, at] = ref[put].to(torch.int32)
    rows[2, at] = torch.where(st == 2, 77, 66)[put].to(torch.int32)
    t_last = torch.where(keep, i, -1).max(dim=1).values.clamp(min=0)
    last_ev = ev.gather(1, t_last[:, None])[:, 0]
    last_ref = ref.gather(1, t_last[:, None])[:, 0]
    hint = end_pair(pairs_ref, m, last_ref, s[:, S_PAIR])
    status = s[:, S_STATUS]
    done = go & (kept == 0)
    over = go & ~done & ((cursor + kept > cap) | (hint < 0))
    upd = go & ~done & ~over
    status = torch.where(done, DONE, torch.where(over, ABORTED, status))
    w = job[go]
    for col, val in (
            (S_STATUS, status),
            (S_EV, torch.where(upd, last_ev, start_ev)),
            (S_REF, torch.where(upd, last_ref, start_ref)),
            (S_PAIR, torch.where(upd, hint, s[:, S_PAIR])),
            (S_CURSOR, torch.where(upd, cursor + kept, cursor)),
            (S_STEPS, s[:, S_STEPS] + n)):
        state[w, col] = val[go].to(torch.int32)
