"""TransitionParameters: trainable HMM transition statistics.

Rebuild of src/hmm/nanopolish_transition_parameters.{h,cpp}: per-strand
counts of M/E/K state transitions plus a skip-probability table binned by
|delta expected level|, re-estimated by train() with pseudocounts.

The reference ships kit-specific initialization tables for the legacy R7
chemistries (initialize_sqkmap005/6/7); the R9 profile HMM uses fixed
transitions instead (r9.inl:17-76), so training here starts from a flat
prior and the trained table is what scorereads --train-transitions prints.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

_STATES = "MEK"


def _state_index(c: str) -> int:
    return {"M": 0, "E": 1, "B": 1, "K": 2}[c]


@dataclass
class TransitionParameters:
    skip_bin_width: float = 0.5
    n_bins: int = 30
    trans_m_to_e_not_k: float = 0.15
    trans_e_to_e: float = 0.33
    # soft-clip transitions, fixed across kits
    # (transition_parameters.cpp:42-43)
    trans_start_to_clip: float = 0.5
    trans_clip_self: float = 0.90

    def __post_init__(self):
        self.skip_probabilities = np.full(self.n_bins, 0.1)
        # state_transitions[from 3][to*2 + kmer_move 6]
        self.state_transitions = np.zeros((3, 6), np.int64)
        self.kmer_transitions: List[Tuple[float, float, str]] = []
        self.n_matches = 0
        self.n_merges = 0
        self.n_skips = 0

    # ------------------------------------------------------------------
    # kit-trained initialization tables for the legacy R7 chemistries
    # (transition_parameters.cpp:76-155); the values are the reference's
    # trained constants.  R9 uses fixed transitions instead (r9.inl:17-76).
    @classmethod
    def for_kit(cls, kit: str, strand_idx: int = 0) -> "TransitionParameters":
        tp = cls()
        if kit == "sqkmap005":
            tp.trans_m_to_e_not_k, tp.trans_e_to_e = 0.15, 0.33
            tp.skip_probabilities = np.array([
                0.51268137, 0.47243219, 0.42888741, 0.34932588, 0.27427068,
                0.22297225, 0.17585147, 0.14705882, 0.12183525, 0.11344997,
                0.10069393, 0.09153005, 0.08765206, 0.08491435, 0.08272553,
                0.07747396, 0.08439116, 0.07819045, 0.07337461, 0.07020490,
                0.06869961, 0.06576609, 0.06923376, 0.06239092, 0.06586513,
                0.07372986, 0.07050360, 0.07228916, 0.05855856, 0.06842737])
        elif kit == "sqkmap006" and strand_idx == 0:
            tp.trans_m_to_e_not_k, tp.trans_e_to_e = 0.17, 0.55
            tp.skip_probabilities = np.array([
                0.487, 0.412, 0.311, 0.229, 0.174, 0.134, 0.115, 0.103,
                0.096, 0.092, 0.088, 0.087, 0.084, 0.085, 0.083, 0.082,
                0.085, 0.083, 0.084, 0.082, 0.080, 0.085, 0.088, 0.086,
                0.087, 0.089, 0.085, 0.090, 0.087, 0.096])
        elif kit == "sqkmap006":
            tp.trans_m_to_e_not_k, tp.trans_e_to_e = 0.14, 0.49
            tp.skip_probabilities = np.array([
                0.531, 0.478, 0.405, 0.327, 0.257, 0.207, 0.172, 0.154,
                0.138, 0.132, 0.127, 0.123, 0.117, 0.115, 0.113, 0.113,
                0.115, 0.109, 0.109, 0.107, 0.104, 0.105, 0.108, 0.106,
                0.111, 0.114, 0.118, 0.119, 0.110, 0.119])
        else:
            raise ValueError(f"unknown legacy kit {kit!r}")
        return tp

    # ------------------------------------------------------------------
    def get_skip_bin(self, level1: float, level2: float) -> int:
        d = abs(level1 - level2)
        return min(int(d / self.skip_bin_width),
                   len(self.skip_probabilities) - 1)

    def get_skip_probability(self, level1: float, level2: float) -> float:
        return float(self.skip_probabilities[self.get_skip_bin(level1, level2)])

    def add_transition_observation(self, state_from: str, state_to: str,
                                   kmer_move: bool):
        f = _state_index(state_from)
        t = 2 * _state_index(state_to) + int(kmer_move)
        self.state_transitions[f, t] += 1

    # ------------------------------------------------------------------
    def add_training_from_alignment(self, sr, strand: int, model,
                                    hmm_sequence, rc: bool, alignment,
                                    ignore_edge_length: int = 5):
        """transition_parameters.cpp:295-368 over a backtrack alignment
        (list of (event_idx, kmer_idx, state))."""
        if len(alignment) <= ignore_edge_length:
            return
        k = model.k
        prev_s = "M"
        s = sr.scalings[strand]
        for pi, (ei, ki, state) in enumerate(alignment):
            kmer_move = pi == 0 or alignment[pi - 1][1] != ki
            self.add_transition_observation(prev_s, state, kmer_move)
            if ignore_edge_length < pi < len(alignment) - ignore_edge_length:
                if state != "B":
                    t_from = alignment[pi - 1][1]
                    t_to = ki
                    if state == "K" and prev_s == "M":
                        t_from = alignment[pi - 1][1]
                        t_to = t_from + 1
                    rank1 = hmm_sequence.get_kmer_rank(t_from, k, rc)
                    rank2 = hmm_sequence.get_kmer_rank(t_to, k, rc)
                    l1 = s.scale * model.level_mean[rank1] + s.shift
                    l2 = s.scale * model.level_mean[rank2] + s.shift
                    self.kmer_transitions.append((float(l1), float(l2), state))
                self.add_transition_observation(prev_s, state, kmer_move)
            prev_s = state
            self.n_matches += state == "M"
            self.n_merges += state == "E"
            self.n_skips += state == "K"

    def train(self, pseudocount: float = 100.0):
        """transition_parameters.cpp:370-440."""
        skip_obs = self.skip_probabilities * pseudocount
        total_obs = np.full_like(skip_obs, pseudocount)
        for l1, l2, state in self.kmer_transitions:
            b = self.get_skip_bin(l1, l2)
            skip_obs[b] += state == "K"
            total_obs[b] += 1
        self.skip_probabilities = skip_obs / total_obs

    # ------------------------------------------------------------------
    def print(self, fp=None) -> str:
        import sys
        fp = fp or sys.stderr
        lines = ["TRANSITIONS"]
        for i, c in enumerate("MBK"):
            lines.append("\t%c: %s" % (c, " ".join(
                str(v) for v in self.state_transitions[i])))
        lines.append("SKIP_TABLE\t" + " ".join(
            f"{p:.4f}" for p in self.skip_probabilities))
        lines.append(f"SUMMARY\tmatches={self.n_matches} "
                     f"merges={self.n_merges} skips={self.n_skips}")
        out = "\n".join(lines)
        print(out, file=fp)
        return out
