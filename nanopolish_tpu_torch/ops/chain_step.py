"""eventalign's segment chain, one round at a time, on the card.

Counterpart of the loop body of ``nanopolish_tpu/alignment/device_chain.py``
(``_chain_program``'s ``body``, :226-377): the per-round host steps of the
wavefront (``alignment/eventalign._prepare`` and ``_consume``) as two entry
points of the hand-written CUDA kernel ``csrc/chain_step.cu``, one warp per
job:

  * ``chain_prepare``: the loop condition, the end pair (the semantics of
    ``alignment/anchor.get_end_pair`` from the job's pair hint), the QC stops,
    the window's shape and its Viterbi inputs, written in place into the
    round's ``[B, TP]`` / ``[B, KP]`` tensors;
  * ``chain_consume``: ``_consume``'s kept-row rule on the round's traceback
    (``viterbi_backtrack``'s layout), each kept row written at the job's
    cursor, then the re-anchoring.

A batch of jobs lives in flat ragged tensors (``alignment/device_chain``
builds them):

  meta [B, N_META] i32       per job: offsets and lengths of its rows in the
                             flat tensors, last event, direction, ref offset,
                             k, and its output rows' offset and capacity
  state [B, N_STATE] i32     the chain: start event and ref, pair hint,
                             status, cursor; this round's stride (0: no
                             window) and last-section flag
  pairs_ref, pairs_read i32  the aligned pairs (read side flipped for
                             reverse records), refs ascending
  closest i32                ``closest_event_array`` of the job's b2e map
  levels_all f32             the drift-corrected event levels
  tabs [3, n_tab] f32        mu, sigma, c at every kmer of the job's window
  rows [3, n_rows] i32       output: absolute event, absolute ref, state
                             byte ('M' 77, 'B' 66)

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
# state columns
S_EV, S_REF, S_PAIR, S_STATUS, S_CURSOR, S_STRIDE, S_LAST = range(7)
N_STATE = 8
# job status
ACTIVE, DONE, ABORTED = 0, 1, 2
# C entry point's operation
_OP_PREPARE, _OP_CONSUME = 0, 1
_BIG = 1 << 30


def _check_batch(meta, state, pairs_ref, dev):
    B = state.shape[0]
    i32 = torch.int32
    cuda_build.check_tensor("meta", meta, i32, (B, N_META), dev)
    cuda_build.check_tensor("state", state, i32, (B, N_STATE), dev)
    cuda_build.check_tensor("pairs_ref", pairs_ref, i32, pairs_ref.shape, dev)
    if pairs_ref.dim() != 1:
        raise ValueError("pairs_ref: must be one flat row")


def chain_prepare(meta, state, pairs_ref, pairs_read, closest, levels_all,
                  tabs, levels, mu, sigma, c, n_events, n_kmers):
    """One round's setup for every job: updates ``state`` and writes the
    Viterbi inputs in place: ``levels[b, :n_events[b]]`` and the whole
    ``mu``/``sigma``/``c`` rows (kmers past ``n_kmers[b]`` padded with 0, 1
    and ``PAD_C``) of each job that has a window this round; a job without
    one gets ``n_events = n_kmers = 1`` and its rows are left as they are."""
    if state.device.type == "cpu":
        return chain_prepare_plain(meta, state, pairs_ref, pairs_read,
                                   closest, levels_all, tabs, levels, mu,
                                   sigma, c, n_events, n_kmers)
    cuda_build.require_cuda(state)
    dev = state.device
    B = state.shape[0]
    TP = levels.shape[1]
    KP = mu.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check_batch(meta, state, pairs_ref, dev)
    cuda_build.check_tensor("pairs_read", pairs_read, i32, pairs_ref.shape,
                            dev)
    cuda_build.check_tensor("closest", closest, i32, closest.shape, dev)
    cuda_build.check_tensor("levels_all", levels_all, f32, levels_all.shape,
                            dev)
    cuda_build.check_tensor("tabs", tabs, f32, (3, tabs.shape[1]), dev)
    cuda_build.check_tensor("levels", levels, f32, (B, TP), dev)
    for nm, t in (("mu", mu), ("sigma", sigma), ("c", c)):
        cuda_build.check_tensor(nm, t, f32, (B, KP), dev)
    cuda_build.check_tensor("n_events", n_events, i32, (B,), dev)
    cuda_build.check_tensor("n_kmers", n_kmers, i32, (B,), dev)
    cuda_build.launch(
        "chain_step", _OP_PREPARE, meta.data_ptr(), state.data_ptr(),
        pairs_ref.data_ptr(), pairs_read.data_ptr(), closest.data_ptr(),
        levels_all.data_ptr(), tabs.data_ptr(), tabs.shape[1], B, TP, KP,
        PAD_C, levels.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
        c.data_ptr(), n_events.data_ptr(), n_kmers.data_ptr(), None, 0,
        None, 0)
    cuda_build.count_launch("chain_step")


def chain_consume(meta, state, pairs_ref, path, rows):
    """Apply one round's tracebacks (``path`` [B, 1 + T + KP] int64, the
    layout of ``viterbi_backtrack``): write each job's kept rows into
    ``rows`` at its cursor and re-anchor its chain, updating ``state``."""
    if state.device.type == "cpu":
        return chain_consume_plain(meta, state, pairs_ref, path, rows)
    cuda_build.require_cuda(state)
    dev = state.device
    B = state.shape[0]
    _check_batch(meta, state, pairs_ref, dev)
    cuda_build.check_tensor("path", path, torch.int64, (B, path.shape[1]),
                            dev)
    cuda_build.check_tensor("rows", rows, torch.int32, (3, rows.shape[1]),
                            dev)
    cuda_build.launch(
        "chain_step", _OP_CONSUME, meta.data_ptr(), state.data_ptr(),
        pairs_ref.data_ptr(), None, None, None, None, 0, B, 0, 0, 0.0,
        None, None, None, None, None, None, path.data_ptr(), path.shape[1],
        rows.data_ptr(), rows.shape[1])
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


def chain_prepare_plain(meta, state, pairs_ref, pairs_read, closest,
                        levels_all, tabs, levels, mu, sigma, c, n_events,
                        n_kmers):
    """``chain_prepare`` in PyTorch ops, vectorized over jobs."""
    dev = state.device
    i64 = torch.int64
    TP, KP = levels.shape[1], mu.shape[1]
    m = meta.to(i64)
    s = state.to(i64)
    start_ev, start_ref = s[:, S_EV], s[:, S_REF]
    status = s[:, S_STATUS]
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
    end_ref = _take(pairs_ref, gi).to(i64)
    end_read = _take(pairs_read, gi).to(i64)
    k = m[:, M_K]
    ln = end_ref - start_ref + 1
    stop = (end_read < 0) | (ln < 2 * k)
    status = torch.where(act & stop, DONE, status)
    act = act & ~stop
    ev_stop = _take(closest, m[:, M_COFF] + torch.minimum(
        end_read, m[:, M_NCLOSE] - 1)).to(i64)
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
    nev = torch.where(act, nev, 1)
    nkr = torch.where(act, nkr, 1)

    t = torch.arange(TP, device=dev)[None, :]
    tmask = act[:, None] & (t < nev[:, None])
    lv = _take(levels_all, m[:, M_LOFF, None] + start_ev[:, None]
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
    n_events.copy_(nev.to(torch.int32))
    n_kmers.copy_(nkr.to(torch.int32))
    state[:, S_STATUS] = status.to(torch.int32)
    state[:, S_STRIDE] = stride.to(torch.int32)
    state[:, S_LAST] = last.to(torch.int32)


def chain_consume_plain(meta, state, pairs_ref, path, rows):
    """``chain_consume`` in PyTorch ops, vectorized over jobs."""
    dev = state.device
    i64 = torch.int64
    m = meta.to(i64)
    s = state.to(i64)
    stride = s[:, S_STRIDE]
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
    state[:, S_STATUS] = status.to(torch.int32)
    state[:, S_EV] = torch.where(upd, last_ev, start_ev).to(torch.int32)
    state[:, S_REF] = torch.where(upd, last_ref, start_ref).to(torch.int32)
    state[:, S_PAIR] = torch.where(upd, hint, s[:, S_PAIR]).to(torch.int32)
    state[:, S_CURSOR] = torch.where(upd, cursor + kept, cursor).to(
        torch.int32)
