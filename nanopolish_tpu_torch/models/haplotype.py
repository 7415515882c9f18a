"""Haplotype: a reference sequence with applied variants + coordinate map.

Faithful port of the semantics of src/nanopolish_haplotype.{h,cpp}:
apply_variant edits the derived sequence and coordinate map (inserted
bases get INSERTED_POSITION), substr_by_reference subsets by reference
coordinates bumping out to non-inserted bases, and the range helpers feed
variant calling.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..io.vcf import Variant

INSERTED_POSITION = -1


class Haplotype:
    def __init__(self, ref_name: str, ref_position: int, ref_sequence: str):
        self.ref_name = ref_name
        self.ref_position = ref_position
        self.reference = ref_sequence
        self.sequence = ref_sequence
        self.coordinate_map: List[int] = list(
            range(ref_position, ref_position + len(ref_sequence)))
        self.variants: List[Variant] = []

    # -- queries ------------------------------------------------------------
    def get_sequence(self) -> str:
        return self.sequence

    def get_reference(self) -> str:
        return self.reference

    def get_reference_end(self) -> int:
        return self.ref_position + len(self.reference)

    def get_variants(self) -> List[Variant]:
        return list(self.variants)

    def get_reference_position_for_haplotype_base(self, i: int) -> Optional[int]:
        p = self.coordinate_map[i]
        return None if p == INSERTED_POSITION else p

    def _find_derived_index_by_ref_lower_bound(self, ref_index: int) -> int:
        for i, p in enumerate(self.coordinate_map):
            if p != INSERTED_POSITION and p >= ref_index:
                return i
        return len(self.coordinate_map)

    # -- mutation -----------------------------------------------------------
    def apply_variant(self, v: Variant) -> bool:
        """haplotype.cpp:33-76."""
        di = self._find_derived_index_by_ref_lower_bound(v.ref_position)
        if di == len(self.coordinate_map) or \
                self.coordinate_map[di] != v.ref_position:
            return False
        rl = len(v.ref_seq)
        al = len(v.alt_seq)
        if self.sequence[di:di + rl] != v.ref_seq:
            return False
        self.sequence = self.sequence[:di] + v.alt_seq + self.sequence[di + rl:]
        self.coordinate_map = (self.coordinate_map[:di]
                               + [INSERTED_POSITION] * al
                               + self.coordinate_map[di + rl:])
        assert len(self.coordinate_map) == len(self.sequence)
        self.variants.append(v)
        return True

    def apply_variants(self, variants: List[Variant]) -> bool:
        good = True
        for v in variants:
            good = good and self.apply_variant(v)
        return good

    # -- subsetting ---------------------------------------------------------
    def substr_by_reference(self, start: int, end: int) -> "Haplotype":
        """haplotype.cpp:88-133 (end inclusive)."""
        assert start >= self.ref_position
        assert end <= self.ref_position + len(self.reference)
        dbs = self._find_derived_index_by_ref_lower_bound(start)
        dbe = self._find_derived_index_by_ref_lower_bound(end)
        while dbs > 0 and (self.coordinate_map[dbs] > start or
                           self.coordinate_map[dbs] == INSERTED_POSITION):
            dbs -= 1
        assert dbe != len(self.coordinate_map)
        start = self.coordinate_map[dbs]
        end = self.coordinate_map[dbe]
        ret = Haplotype(self.ref_name, start,
                        self.reference[start - self.ref_position:
                                       end - self.ref_position + 1])
        ret.sequence = self.sequence[dbs:dbe + 1]
        ret.coordinate_map = self.coordinate_map[dbs:dbe + 1]
        assert ret.coordinate_map[0] == start
        assert ret.coordinate_map[-1] == end
        assert len(ret.coordinate_map) == len(ret.sequence)
        return ret

    def get_enclosing_reference_range_for_haplotype_range(
            self, hap_lower: int, hap_upper: int
    ) -> Optional[Tuple[int, int, int, int]]:
        """haplotype.cpp:141-159; returns (hap_lower, hap_upper, ref_lower,
        ref_upper) or None."""
        cm = self.coordinate_map
        while hap_lower > 0 and cm[hap_lower] == INSERTED_POSITION:
            hap_lower -= 1
        while hap_upper < len(cm) and cm[hap_upper] == INSERTED_POSITION:
            hap_upper += 1
        if hap_lower == 0 or hap_upper >= len(cm):
            return None
        return hap_lower, hap_upper, cm[hap_lower], cm[hap_upper]
