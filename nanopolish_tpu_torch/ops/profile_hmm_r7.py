"""Profile HMM for legacy R7 chemistry (Forward / Viterbi + backtrack).

Behavioral spec: src/hmm/nanopolish_profile_hmm_r7.{h,cpp,inl}.  R7 differs
from R9 in its state space (3 states per k-mer block: K=kmer-skip,
E=event-split, M=match) and in where transitions come from: instead of
fixed constants, the skip probability between adjacent k-mers is looked up
from the per-strand trained `TransitionParameters` table, binned by the
|delta| of the *scaled* expected levels (r7.inl:9-24), and the M->E / E->E
rates are the kit-trained `trans_m_to_e_not_k` / `trans_e_to_e`.  The
event-split state emits with the match gaussian widened by 1.75x
(nanopolish_emissions.h:86-96).

R7 is a retired chemistry whose only workload here is the reference's
golden HMM test (src/test/nanopolish_test.cpp:389-455) against the one
real FAST5 checked into the reference repo — so this is a plain NumPy
host module optimized for exactness, with no device work: it exists to
pin the numerics to the reference's recorded golden values on real
signal data.  (The R9 path, which all supported workflows use, runs on
the card.)  Forward sums use the hmmer3 table-driven logsum, the same
approximation the reference's add_logs compiles to
(src/common/nanopolish_common.h:100-104, logsum.h:20-27).
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.logsum import add_logs_np

# state slots within a block (profile_hmm_r7.h:52-58)
PSR7_KMER_SKIP, PSR7_EVENT_SPLIT, PSR7_MATCH = 0, 1, 2
PSR7_NUM_STATES = 3
PSR7_PRE_SOFT = 4
_PS2CHAR = {PSR7_KMER_SKIP: "K", PSR7_EVENT_SPLIT: "E", PSR7_MATCH: "M",
            PSR7_PRE_SOFT: "S"}

HAF_ALLOW_PRE_CLIP = 1 << 0
HAF_ALLOW_POST_CLIP = 1 << 1

LOG_INV_SQRT_2PI = math.log(0.3989422804014327)
EVENT_SPLIT_SCALE = 1.75       # emissions.h:86-96
LOG_BG = -3.0                  # log_probability_background (emissions.h:98-103)


def _log_normal(x, mean, stdv):
    a = (x - mean) / stdv
    return LOG_INV_SQRT_2PI - math.log(stdv) + (-0.5 * a * a)


class R7Scorer:
    """Scores one (sequence, strand-data) pair the R7 way.

    `strand` is an io.fast5_legacy.LegacyStrandData; `params` a
    models.transition_parameters.TransitionParameters initialized for the
    read's kit; `hmm_seq` a models.hmm_input.HMMInputSequence.
    """

    def __init__(self, strand, params, hmm_seq, rc: bool,
                 event_start: int, event_stop: int, logsum_table=True):
        self.sd = strand
        self.params = params
        self.seq = hmm_seq
        self.rc = rc
        self.e_start = int(event_start)
        self.e_stop = int(event_stop)
        self.stride = 1 if event_stop >= event_start else -1
        self.n_events = abs(self.e_stop - self.e_start) + 1
        self.logsum_table = logsum_table

    # -- emissions ---------------------------------------------------------
    def _emissions(self, ranks):
        """[n_events, n_kmers] match and event-split log emissions."""
        ev_idx = self.e_start + np.arange(self.n_events) * self.stride
        level = self.sd.drift_scaled_level(ev_idx).astype(np.float32)
        mean, stdv = self.sd.scaled_gaussian(np.asarray(ranks))
        mean = mean.astype(np.float32)[None, :]
        stdv = stdv.astype(np.float32)[None, :]
        x = level.astype(np.float32)[:, None]
        a = (x - mean) / stdv
        lp_m = (LOG_INV_SQRT_2PI - np.log(stdv) + (-0.5 * a) * a)
        a2 = (x - mean) / (stdv * EVENT_SPLIT_SCALE)
        lp_e = (LOG_INV_SQRT_2PI - np.log(stdv * EVENT_SPLIT_SCALE)
                + (-0.5 * a2) * a2)
        return lp_m.astype(np.float32), lp_e.astype(np.float32)

    # -- transitions (calculate_transitions_r7, r7.inl:26-68) --------------
    def _transitions(self, ranks):
        n_kmers = len(ranks)
        mean, _ = self.sd.scaled_gaussian(np.asarray(ranks))
        p_skip = np.zeros(n_kmers)
        for ki in range(1, n_kmers):
            p_skip[ki] = self.params.get_skip_probability(
                float(mean[ki - 1]), float(mean[ki]))
        p_me = (1 - p_skip) * self.params.trans_m_to_e_not_k
        p_mm = 1.0 - p_me - p_skip
        with np.errstate(divide="ignore"):
            return dict(
                lp_me=np.log(p_me).astype(np.float32),
                lp_mk=np.log(p_skip).astype(np.float32),
                lp_mm=np.log(p_mm).astype(np.float32),
                lp_ee=np.float32(math.log(self.params.trans_e_to_e)),
                lp_em=np.float32(math.log(1 - self.params.trans_e_to_e)),
                lp_kk=np.log(p_skip).astype(np.float32),
                lp_km=np.log(1 - p_skip).astype(np.float32),
            )

    # -- flanks (r7.inl:195-260) -------------------------------------------
    def _flanks(self):
        p = self.params
        n = self.n_events
        pre = np.zeros(n + 1, np.float32)
        pre[0] = math.log(1 - p.trans_start_to_clip)
        if n >= 1:
            pre[1] = (math.log(p.trans_start_to_clip) + LOG_BG
                      + math.log(1 - p.trans_clip_self))
        for i in range(2, n + 1):
            pre[i] = math.log(p.trans_clip_self) + LOG_BG + pre[i - 1]
        post = np.zeros(n, np.float32)
        post[n - 1] = math.log(1 - p.trans_start_to_clip)
        if n > 1:
            post[n - 2] = (math.log(p.trans_start_to_clip) + LOG_BG
                           + math.log(1 - p.trans_clip_self))
            for i in range(n - 3, -1, -1):
                post[i] = math.log(p.trans_clip_self) + LOG_BG + post[i + 1]
        return pre, post

    # -- fill (profile_hmm_fill_generic_r7, r7.inl:263-419) -----------------
    def _fill(self, flags: int, viterbi: bool):
        k = self.sd.k
        n_kmers = len(self.seq.seq) - k + 1
        ranks = np.array([self.seq.get_kmer_rank(i, k, self.rc)
                          for i in range(n_kmers)])
        lp_m, lp_e = self._emissions(ranks)
        bt = self._transitions(ranks)
        pre, post = self._flanks()

        n_rows = self.n_events + 1
        ncols = PSR7_NUM_STATES * (n_kmers + 2)
        fm = np.full((n_rows, ncols), -np.inf, np.float32)
        bm = np.zeros((n_rows, ncols), np.uint8)
        last_row = n_rows - 1
        last_kmer = n_kmers - 1

        if viterbi:
            def update(row, col, m, e, kk, s, emit):
                vals = (m, e, kk, s)
                mx = max(vals)
                fm[row, col] = np.float32(mx + emit)
                if mx == m:
                    frm = PSR7_MATCH
                elif mx == e:
                    frm = PSR7_EVENT_SPLIT
                elif mx == kk:
                    frm = PSR7_KMER_SKIP
                else:
                    frm = PSR7_PRE_SOFT
                bm[row, col] = frm
        else:
            def update(row, col, m, e, kk, s, emit):
                s1 = add_logs_np(np.float32(m), np.float32(e),
                                 table=self.logsum_table)
                s2 = add_logs_np(np.float32(kk), np.float32(s),
                                 table=self.logsum_table)
                fm[row, col] = np.float32(
                    add_logs_np(s1, s2, table=self.logsum_table) + emit)

        lp_end = -np.inf
        end_cell = (0, 0)
        for row in range(1, n_rows):
            for block in range(1, n_kmers + 1):
                ki = block - 1
                po = PSR7_NUM_STATES * (block - 1)
                co = PSR7_NUM_STATES * block
                em_m = lp_m[row - 1, ki]
                em_e = lp_e[row - 1, ki]
                event_idx = self.e_start + (row - 1) * self.stride

                m_m = bt["lp_mm"][ki] + fm[row - 1, po + PSR7_MATCH]
                m_e = bt["lp_em"] + fm[row - 1, po + PSR7_EVENT_SPLIT]
                m_k = bt["lp_km"][ki] + fm[row - 1, po + PSR7_KMER_SKIP]
                m_s = (pre[row - 1] if ki == 0 and
                       (event_idx == self.e_start or
                        (flags & HAF_ALLOW_PRE_CLIP)) else -np.inf)
                update(row, co + PSR7_MATCH, m_m, m_e, m_k, m_s, em_m)

                e_m = bt["lp_me"][ki] + fm[row - 1, co + PSR7_MATCH]
                e_e = bt["lp_ee"] + fm[row - 1, co + PSR7_EVENT_SPLIT]
                update(row, co + PSR7_EVENT_SPLIT, e_m, e_e, -np.inf,
                       -np.inf, em_e)

                k_m = bt["lp_mk"][ki] + fm[row, po + PSR7_MATCH]
                k_k = bt["lp_kk"][ki] + fm[row, po + PSR7_KMER_SKIP]
                update(row, co + PSR7_KMER_SKIP, k_m, -np.inf, k_k,
                       -np.inf, 0.0)

                if ki == last_kmer and ((flags & HAF_ALLOW_POST_CLIP)
                                        or row == last_row):
                    for slot in (PSR7_MATCH, PSR7_EVENT_SPLIT,
                                 PSR7_KMER_SKIP):
                        v = fm[row, co + slot] + post[row - 1]
                        if viterbi:
                            if v > lp_end:
                                lp_end = v
                                end_cell = (row, co + slot)
                        else:
                            lp_end = add_logs_np(
                                np.float32(lp_end), np.float32(v),
                                table=self.logsum_table)
        return fm, bm, float(lp_end), end_cell, n_kmers

    # -- public API ---------------------------------------------------------
    def score(self, flags: int = 0) -> float:
        """profile_hmm_score_r7 (r7.cpp:40-70): Forward log-likelihood."""
        _, _, lp_end, _, _ = self._fill(flags, viterbi=False)
        return lp_end

    def align(self, flags: int = 0):
        """profile_hmm_align_r7 (r7.cpp:78-204): Viterbi alignment.

        Returns (states string, kmer_idxs, event_idxs, l_fm of the first
        emitted record == the alignment's final cell value)."""
        fm, bm, _, _, n_kmers = self._fill(flags, viterbi=True)
        n_rows = self.n_events + 1
        row = n_rows - 1
        col = PSR7_NUM_STATES * n_kmers + PSR7_MATCH

        states, kis, eis, fms = [], [], [], []
        while row > 0:
            event_idx = self.e_start + (row - 1) * self.stride
            block = col // PSR7_NUM_STATES
            kmer_idx = block - 1
            curr = col % PSR7_NUM_STATES
            states.append(_PS2CHAR[curr])
            kis.append(kmer_idx)
            eis.append(event_idx)
            fms.append(float(fm[row, col]))
            nxt = int(bm[row, col])
            if nxt == PSR7_PRE_SOFT:
                break
            if curr == PSR7_MATCH:
                row -= 1
                kmer_idx -= 1
            elif curr == PSR7_EVENT_SPLIT:
                row -= 1
            else:
                kmer_idx -= 1
            col = PSR7_NUM_STATES * (kmer_idx + 1) + nxt
        states.reverse()
        kis.reverse()
        eis.reverse()
        fms.reverse()
        return "".join(states), np.array(kis), np.array(eis), np.array(fms)
