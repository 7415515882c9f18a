"""Variant groups + combination enumeration.

Rebuild of src/nanopolish_variant_db.{h,cpp}: the Combinations enumerator
(with/without replacement) and VariantGroup, which tracks variant
combinations and the per-(combination, read) HMM score matrix filled by
batched device scoring.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.vcf import Variant

CO_WITHOUT_REPLACEMENT = 0
CO_WITH_REPLACEMENT = 1


def combinations(n: int, r: int, mode: int = CO_WITHOUT_REPLACEMENT):
    """Index combinations in the reference's enumeration order
    (variant_db.h:33-74)."""
    rng = range(n)
    if mode == CO_WITH_REPLACEMENT:
        return [list(c) for c in
                itertools.combinations_with_replacement(rng, r)]
    return [list(c) for c in itertools.combinations(rng, r)]


def nchoosek(n: int, k: int) -> int:
    return math.comb(n, k)


class VariantGroup:
    """A set of nearby variants with scored combinations
    (variant_db.h:76-152)."""

    def __init__(self, group_id: int, variants: Sequence[Variant]):
        self.group_id = group_id
        self.variants: List[Variant] = list(variants)
        self.combinations: List[List[int]] = []
        # (vc_idx, read_id) -> score
        self._scores: Dict[Tuple[int, str], float] = {}
        self._read_strand: Dict[str, bool] = {}

    def get(self, vi: int) -> Variant:
        return self.variants[vi]

    def get_num_variants(self) -> int:
        return len(self.variants)

    def get_variants(self, vc: List[int]) -> List[Variant]:
        return [self.variants[i] for i in vc]

    def add_combination(self, vc: List[int]) -> int:
        self.combinations.append(list(vc))
        return len(self.combinations) - 1

    def get_combination(self, idx: int) -> List[int]:
        return self.combinations[idx]

    def get_num_combinations(self) -> int:
        return len(self.combinations)

    def set_combination_read_score(self, vc_idx: int, read_id: str,
                                   score: float):
        self._scores[(vc_idx, read_id)] = score

    def get_combination_read_score(self, vc_idx: int, read_id: str) -> float:
        return self._scores[(vc_idx, read_id)]

    def set_read_strand(self, read_id: str, rc: bool):
        self._read_strand[read_id] = rc

    def is_read_rc(self, read_id: str) -> bool:
        return self._read_strand.get(read_id, False)

    def get_read_ids(self) -> List[str]:
        return list(self._read_strand)

    def get_read_sum_scores(self) -> List[Tuple[str, float]]:
        """Per-read logsumexp over all combinations
        (variant_db.cpp get_read_sum_scores)."""
        out = []
        for read_id in self._read_strand:
            vals = [self._scores[(ci, read_id)]
                    for ci in range(len(self.combinations))
                    if (ci, read_id) in self._scores]
            if not vals:
                continue
            m = max(vals)
            s = m + math.log(sum(math.exp(v - m) for v in vals))
            out.append((read_id, s))
        return out


class VariantDB:
    def __init__(self):
        self.groups: List[VariantGroup] = []

    def add_new_group(self, variants: Sequence[Variant]) -> int:
        self.groups.append(VariantGroup(len(self.groups), variants))
        return len(self.groups) - 1

    def get_group(self, idx: int) -> VariantGroup:
        return self.groups[idx]

    def get_num_groups(self) -> int:
        return len(self.groups)
