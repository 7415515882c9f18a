"""eventalign's segment chain on the card: no host step per round.

The reference's align_read_to_ref chains ~100-base Viterbi windows, each
anchored by the previous window's last kept row
(src/alignment/nanopolish_eventalign.cpp:612-827).  The host wavefront
(``alignment/eventalign._run_wavefront``) does each round's setup and
bookkeeping in Python and fetches every round's paths.  Here a round is
four launches on the stream, with nothing fetched in between:

  ``chain_prepare`` -> ``viterbi_fill`` -> ``viterbi_backtrack`` ->
  ``chain_consume``

on tensors allocated once per batch (``ops/chain_step.py``,
``csrc/chain_step.cu``).  The host reads the number of active jobs only
every ``CHECK_EVERY`` rounds (a blocking read of one number), and
fetches the kept rows once, when the batch is done.

Counterpart of ``nanopolish_tpu/alignment/device_chain.py``, whose chain
is one jitted while_loop.  Its relay workarounds (the packed f32 input
wire, the broadcast compare-sum search, the top_k compaction and tail
buffer, the post-loop gather) have no reason to exist on a GPU: the
kernel binary-searches the pairs, ballots the kept rows and writes them
at the job's cursor.

Exactness: every Viterbi input is the value the host path uploads (the
window's levels are slices of ``segments.read_drift_levels``; mu, sigma
and c are copied from whole-window rows built with the host path's numpy
functions; the transitions are ``make_transitions(epb)``), and the kept-row
rule is ``_consume``'s.  The K chain's value at a kmer depends only on the
kmers before it, so the chain's kmer width (``KP`` 128, where the host
path pads a window of <= 64 kmers to 64) changes no path.

Jobs the chain cannot express go back to the host wavefront, which also
runs on the card: spliced (multi-segment) alignments and reads whose
closest-event map has holes (``stage_job`` declines them), windows the
padded shape cannot hold and chains that outrun the round budget (aborted,
found when the batch is unpacked).  ``CHAIN_STATS`` counts each.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.banded_align import emission_constant
from ..ops.chain_step import (ACTIVE, DONE, M_COFF, M_FWD, M_K,
                              M_LAST, M_LOFF, M_NCLOSE, M_NLEV, M_NPAIRS,
                              M_NRANK, M_OCAP, M_OOFF, M_POFF, M_REFOFF,
                              M_ROFF, N_META, N_STATE, PAD_C, S_CURSOR, S_EV,
                              S_REF, S_STATUS, chain_consume, chain_prepare)
from ..ops.profile_hmm import make_transitions
from ..ops.profile_hmm_viterbi import viterbi_backtrack, viterbi_fill
from ..utils.device import resolve_device
from .anchor import start_segment
from .segments import _model_tables, read_drift_levels

TP = 512             # padded event rows of a window
KP = 128             # padded kmers of a window (l <= 101, so nk <= 96)
CHECK_EVERY = 32     # rounds between reads of the active count
CHAIN_BATCH = 256    # jobs per batch: a 64 KiB trace each
ROWS_SLACK = 64      # output rows a job may hold beyond its event range

# how many jobs the chain took and sent back to the host wavefront, and
# why; the batches, rounds and active-count reads it made
CHAIN_STATS = {"chained": 0, "ineligible": 0, "aborted": 0, "batches": 0,
               "rounds": 0, "checks": 0}


def reset_chain_stats() -> None:
    for k in CHAIN_STATS:
        CHAIN_STATS[k] = 0


def closest_event_array(b2e: np.ndarray) -> np.ndarray:
    """get_closest_event_to for every k-mer index, vectorized with the
    scalar's exact quirks (squiggle.py get_closest_event_to /
    get_next_event): the backward scan covers stop_before < j <= k and
    the forward scan k <= j < stop_after, both boundary-EXCLUSIVE."""
    m = b2e[:, 0].astype(np.int64)
    n = len(m)
    idx = np.arange(n)
    has = m != -1
    # last mapped index <= k
    prev_i = np.maximum.accumulate(np.where(has, idx, -1))
    # first mapped index >= k
    next_i = np.minimum.accumulate(np.where(has, idx, n)[::-1])[::-1]
    stop_before = np.maximum(0, idx - 1000)
    stop_after = np.minimum(idx + 1000, n - 1)
    prev_ok = (prev_i >= 0) & (prev_i > stop_before)
    next_ok = (next_i < n) & (next_i < stop_after)
    out = np.where(prev_ok, m[np.clip(prev_i, 0, n - 1)],
                   np.where(next_ok, m[np.clip(next_i, 0, n - 1)], -1))
    return out.astype(np.int32)


class DeviceJob:
    """Host-side staging for one (read, strand) chain job."""

    __slots__ = ("job", "pairs_ref", "pairs_read", "levels", "closest",
                 "tabs", "epb", "start_ev", "start_ref", "last_event",
                 "forward", "ref_offset", "max_range")

    def __init__(self, job, pairs_ref, pairs_read, levels, closest, tabs,
                 epb, start_ev, start_ref, last_event, forward, ref_offset,
                 max_range):
        self.job = job
        self.pairs_ref = pairs_ref
        self.pairs_read = pairs_read
        self.levels = levels
        self.closest = closest
        self.tabs = tabs
        self.epb = epb
        self.start_ev = start_ev
        self.start_ref = start_ref
        self.last_event = last_event
        self.forward = forward
        self.ref_offset = ref_offset
        self.max_range = max_range


def stage_job(job) -> Optional[DeviceJob]:
    """Build a DeviceJob from a host _Job, or None if ineligible (the
    caller keeps it on the host wavefront).  Precomputes, once per job:
    the pairs (read side flipped for reverse records), the drift-corrected
    levels and, from the ranks of the whole window, its mu, sigma and c
    rows (``[3, n_ranks]``, what ``make_segment`` and
    ``prepare_viterbi_inputs`` would compute for any slice of it)."""
    if job.done or len(job.pair_segments) != 1:
        return None
    read = job.read
    k = job.model.k
    # the chain's start state (the host helper; the host path would do the
    # same initialization)
    if job.pairs is None:
        if not start_segment(job):
            return None                  # nothing to align: already done
    pairs = job.pairs
    do_base_rc = job.record.is_reverse
    reads_col = pairs[:, 1].astype(np.int64)
    if do_base_rc:
        reads_col = len(read.read_sequence) - reads_col - k
    closest = closest_event_array(read.base_to_event_map[job.strand])
    if (closest < 0).any():
        return None                      # holes: the host path takes those
    input_rc = (do_base_rc, not do_base_rc)[job.strand]
    ranks = job.wranks_rc[::-1] if input_rc else job.wranks_fwd
    mu_tab, sig_tab = _model_tables(read, job.strand, job.model)
    sig = sig_tab[ranks]
    tabs = np.stack([mu_tab[ranks], sig, emission_constant(np.log(sig))])
    job._input_rc = input_rc             # the columns carry it
    return DeviceJob(
        job, pairs[:, 0].astype(np.int32), reads_col.astype(np.int32),
        read_drift_levels(read, job.strand), closest, tabs,
        float(read.events_per_base[job.strand]),
        int(job.curr_start_event), int(job.curr_start_ref),
        int(job.last_event), bool(job.forward), int(job.ref_offset),
        abs(int(job.last_event) - int(job.curr_start_event)) + 1)


class _Wire:
    """The batch's inputs as one int32 host array (floats by their bits),
    uploaded in one copy and cut into views on the device."""

    def __init__(self):
        self.parts, self.at, self.n = [], {}, 0

    def add(self, name, arr):
        a = np.ascontiguousarray(arr)
        if a.dtype == np.float32:
            a = a.view(np.int32)
        a = a.astype(np.int32, copy=False).reshape(-1)
        self.at[name] = (self.n, self.n + a.size)
        self.parts.append(a)
        self.n += a.size

    def upload(self, dev):
        flat = torch.from_numpy(np.concatenate(self.parts)).to(dev)
        return {name: flat[lo:hi] for name, (lo, hi) in self.at.items()}


def _flat(arrs):
    """Concatenation, start offsets and lengths of per-job arrays."""
    lens = np.array([len(a) for a in arrs], np.int64)
    return np.concatenate(arrs), np.cumsum(lens) - lens, lens


def round_budget(max_range: int) -> int:
    """Rounds a batch may take before its unfinished chains go back to
    the host path (the JAX chain's budget)."""
    return max_range // 20 + 32


def run_device_chain(djobs: List[DeviceJob], device=None) -> List[bool]:
    """Run the staged jobs' chains on ``device`` (``cuda`` unless ``cpu``
    is asked; the CPU runs the plain versions), in batches of
    CHAIN_BATCH; fill each underlying host _Job's output columns and mark
    it done.  Returns per-job success flags (False: the caller re-runs
    that job on the host wavefront)."""
    dev = resolve_device(device)
    ok: List[bool] = []
    for lo in range(0, len(djobs), CHAIN_BATCH):
        batch = ChainBatch(djobs[lo:lo + CHAIN_BATCH], dev)
        batch.run()
        ok += batch.unpack()
    return ok


class ChainBatch:
    """One batch of staged jobs on ``dev``: its inputs, uploaded in one
    copy, the chains' state and kept rows, and one round's tensors,
    allocated once (``ops/chain_step.py`` documents the layout)."""

    def __init__(self, djobs: List[DeviceJob], dev):
        self.djobs = djobs
        B = self.B = len(djobs)
        pairs_ref, p_off, n_pairs = _flat([d.pairs_ref for d in djobs])
        pairs_read = np.concatenate([d.pairs_read for d in djobs])
        closest, c_off, n_close = _flat([d.closest for d in djobs])
        levels, l_off, n_lev = _flat([d.levels for d in djobs])
        tabs, r_off, n_rank = _flat([d.tabs.T for d in djobs])
        caps = np.array([d.max_range + ROWS_SLACK for d in djobs], np.int64)
        self.o_off = np.concatenate([[0], np.cumsum(caps)[:-1]])
        self.n_rows = int(caps.sum())
        if max(len(pairs_ref), len(levels), len(tabs), self.n_rows) >= 1 << 31:
            raise ValueError("a chain batch holds more than 2^31 rows")
        meta = np.zeros((B, N_META), np.int64)
        for col, vals in ((M_POFF, p_off), (M_NPAIRS, n_pairs),
                          (M_LOFF, l_off), (M_NLEV, n_lev), (M_ROFF, r_off),
                          (M_NRANK, n_rank), (M_COFF, c_off),
                          (M_NCLOSE, n_close), (M_OOFF, self.o_off),
                          (M_OCAP, caps)):
            meta[:, col] = vals
        meta[:, M_LAST] = [d.last_event for d in djobs]
        meta[:, M_FWD] = [d.forward for d in djobs]
        meta[:, M_REFOFF] = [d.ref_offset for d in djobs]
        meta[:, M_K] = [d.job.model.k for d in djobs]
        state = np.zeros((B, N_STATE), np.int64)
        state[:, S_EV] = [d.start_ev for d in djobs]
        state[:, S_REF] = [d.start_ref for d in djobs]
        state[:, S_STATUS] = ACTIVE
        wire = _Wire()
        wire.add("meta", meta)
        wire.add("state", state)
        wire.add("pairs_ref", pairs_ref)
        wire.add("pairs_read", pairs_read)
        wire.add("closest", closest)
        wire.add("levels", np.asarray(levels, np.float32))
        wire.add("tabs", np.ascontiguousarray(np.asarray(tabs, np.float32).T))
        wire.add("trans", make_transitions(
            np.array([d.epb for d in djobs], np.float32)))
        x = wire.upload(dev)
        f32 = torch.float32
        self.meta = x["meta"].view(B, N_META)
        self.state = x["state"].view(B, N_STATE)
        self.statics = (x["pairs_ref"], x["pairs_read"], x["closest"],
                        x["levels"].view(f32), x["tabs"].view(f32).view(3, -1))
        self.trans = x["trans"].view(f32).view(B, 8)
        # the round's tensors (values in the rows of jobs without a window
        # are never read back)
        self.levels = torch.zeros((B, TP), dtype=f32, device=dev)
        self.mu = torch.zeros((B, KP), dtype=f32, device=dev)
        self.sigma = torch.ones((B, KP), dtype=f32, device=dev)
        self.c = torch.full((B, KP), PAD_C, dtype=f32, device=dev)
        self.n_events = torch.ones(B, dtype=torch.int32, device=dev)
        self.n_kmers = torch.ones(B, dtype=torch.int32, device=dev)
        self.clips = torch.zeros((B, 2), dtype=torch.uint8, device=dev)
        self.trace = torch.empty((B, TP, KP), dtype=torch.uint8, device=dev)
        self.path = torch.empty((B, 1 + TP + KP), dtype=torch.int64,
                                device=dev)
        self.rows = torch.zeros((3, self.n_rows), dtype=torch.int32,
                                device=dev)
        self.max_rounds = round_budget(max(d.max_range for d in djobs))

    def prepare(self):
        chain_prepare(self.meta, self.state, *self.statics, self.levels,
                      self.mu, self.sigma, self.c, self.n_events,
                      self.n_kmers)

    def viterbi(self):
        viterbi_fill(self.levels, self.n_events, self.mu, self.sigma, self.c,
                     self.n_kmers, self.trans, self.clips, out=self.trace)
        viterbi_backtrack(self.trace, self.n_events, self.n_kmers,
                          out=self.path)

    def consume(self):
        chain_consume(self.meta, self.state, self.statics[0], self.path,
                      self.rows)

    def n_active(self) -> int:
        """The chains still active: one blocking read of the device's
        state (the host waits for the rounds issued so far)."""
        CHAIN_STATS["checks"] += 1
        return int((self.state[:, S_STATUS] == ACTIVE).sum())

    def run(self) -> int:
        """Rounds until every chain has ended (read every CHECK_EVERY
        rounds) or the budget is spent; returns the rounds run."""
        rnd = 0
        while rnd < self.max_rounds:
            self.prepare()
            self.viterbi()
            self.consume()
            rnd += 1
            if rnd % CHECK_EVERY == 0 and self.n_active() == 0:
                break
        CHAIN_STATS["batches"] += 1
        CHAIN_STATS["rounds"] += rnd
        return rnd

    def unpack(self) -> List[bool]:
        """One fetch of the chains' state and kept rows; each finished
        chain's rows go to its _Job, which is marked done.  Returns
        per-job success flags."""
        B = self.B
        flat = torch.cat([self.state.reshape(-1),
                          self.rows.reshape(-1)]).cpu().numpy()
        st = flat[:B * N_STATE].reshape(B, N_STATE)
        out = flat[B * N_STATE:].reshape(3, self.n_rows)
        ok = []
        for i, d in enumerate(self.djobs):
            n = int(st[i, S_CURSOR])             # rows kept
            lo = int(self.o_off[i])
            st_bytes = out[2, lo:lo + n]
            # a chain still active ran out of the round budget
            if st[i, S_STATUS] != DONE or not (
                    (st_bytes == 77) | (st_bytes == 66)).all():
                CHAIN_STATS["aborted"] += 1
                ok.append(False)
                continue
            CHAIN_STATS["chained"] += 1
            job = d.job
            job.out_ev.append(out[0, lo:lo + n].astype(np.int64))
            job.out_ref.append(out[1, lo:lo + n].astype(np.int64))
            job.out_st.append(st_bytes.astype(np.uint8))
            job.done = True
            ok.append(True)
        return ok
