"""Alphabets for nanopore signal analysis (DNA, RNA, methylation-aware).

TPU-first rebuild of the reference alphabet family
(reference: src/common/nanopolish_alphabet.{h,cpp}).

Design notes
------------
Unlike the reference's virtual-dispatch C++ classes, an Alphabet here is a
plain dataclass holding numpy lookup tables so that k-mer ranking of whole
sequences is a vectorized gather + matvec (host-side, feeding int32 rank
arrays to the device).  String-space operations (methylate / unmethylate /
reverse_complement / disambiguate) remain host string ops - they run once
per window, never in a hot loop.

Rank semantics match the reference exactly:
  * ``kmer_rank`` is lexicographic with the *last* base minor
    (nanopolish_alphabet.h:78-89).
  * methylation-aware reverse_complement transfers the methyl mark to the
    opposite strand via recognition sites (nanopolish_alphabet.h:118-150).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .iupac import IUPAC_POSSIBLE, UNAMBIGUOUS

METHYLATED_SYMBOL = "M"

_POWERS_CACHE: Dict[Tuple[int, int], np.ndarray] = {}
_ALL_KMERS_CACHE: Dict[str, dict] = {}


def _rank_powers(size: int, k: int) -> np.ndarray:
    key = (size, k)
    p = _POWERS_CACHE.get(key)
    if p is None:
        p = size ** np.arange(k - 1, -1, -1, dtype=np.int64)
        _POWERS_CACHE[key] = p
    return p


@dataclass(frozen=True)
class RecognitionMatch:
    offset: int
    length: int
    covers_methylated_site: bool


def _match_to_site(s: str, i: int, recognition: str) -> RecognitionMatch:
    """Check whether a recognition site (partially) matches ``s`` at ``i``.

    Mirrors match_to_site (nanopolish_alphabet.h:28-56): either the whole
    string is a substring of the recognition site (only considered at i==0),
    or a suffix of ``s`` starting at ``i`` is a prefix of the site.
    """
    offset = 0
    length = 0
    rl = len(recognition)
    p = recognition.find(s) if s else -1
    if i == 0 and p != -1:
        offset = p
        length = len(s)
    else:
        cl = min(rl, len(s) - i)
        if s[i : i + cl] == recognition[:cl]:
            offset = 0
            length = cl
    covers = length > 0 and METHYLATED_SYMBOL in s[i : i + length]
    return RecognitionMatch(offset, length, covers)


@dataclass(frozen=True)
class Alphabet:
    """A sequence alphabet with optional methylation recognition sites."""

    name: str
    bases: str                       # e.g. "ACGT" or "ACGMT"
    complements: str                 # complement of bases[i], position-matched
    recognition_sites: Tuple[str, ...] = ()
    recognition_sites_methylated: Tuple[str, ...] = ()
    recognition_sites_methylated_complement: Tuple[str, ...] = ()
    # derived lookup tables
    _rank_lut: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        lut = np.zeros(256, dtype=np.uint8)
        for r, b in enumerate(self.bases):
            lut[ord(b)] = r
        object.__setattr__(self, "_rank_lut", lut)
        # byte translation table mirroring complements[_rank_lut[c]] for
        # every input byte — the exact per-char complement map, C-speed
        comp = bytes(ord(self.complements[lut[c]]) for c in range(256))
        object.__setattr__(self, "_comp_table", comp)

    _comp_table: bytes = field(init=False, repr=False, compare=False)

    # --- basic ---------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.bases)

    def rank(self, b: str) -> int:
        return int(self._rank_lut[ord(b)])

    def base(self, r: int) -> str:
        return self.bases[r]

    def complement(self, b: str) -> str:
        return self.complements[self.rank(b)]

    @property
    def recognition_length(self) -> int:
        return len(self.recognition_sites[0]) if self.recognition_sites else 0

    def num_strings(self, l: int) -> int:
        return self.size ** l

    # --- k-mer ranking ---------------------------------------------------
    def kmer_rank(self, kmer: str, k: Optional[int] = None) -> int:
        """Lexicographic rank with last base minor (nanopolish_alphabet.h:78)."""
        if k is None:
            k = len(kmer)
        r = 0
        for i in range(k):
            r = r * self.size + self.rank(kmer[i])
        return r

    def seq_to_base_ranks(self, seq: str) -> np.ndarray:
        """Per-base ranks of a sequence as uint8 via a vectorized LUT gather."""
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        return self._rank_lut[raw]

    def seq_to_kmer_ranks(self, seq: str, k: int) -> np.ndarray:
        """Ranks of all overlapping k-mers, vectorized (int32, shape [len-k+1])."""
        base_ranks = self.seq_to_base_ranks(seq).astype(np.int64)
        n = len(seq) - k + 1
        if n <= 0:
            return np.zeros((0,), dtype=np.int32)
        powers = _rank_powers(self.size, k)
        # k strided adds instead of sliding_window_view + matmul: the
        # window view costs ~30 us of setup, which dominates for the
        # short variant-screening windows (thousands per region)
        acc = base_ranks[:n] * powers[0]
        for j in range(1, k):
            acc += base_ranks[j:j + n] * powers[j]
        return acc.astype(np.int32)

    def rank_to_kmer(self, rank: int, k: int) -> str:
        out = []
        for _ in range(k):
            out.append(self.bases[rank % self.size])
            rank //= self.size
        return "".join(reversed(out))

    def all_kmers(self, k: int) -> list:
        """All size**k kmers in rank order, memoized (per-round consumers
        like methyltrain enumerate the full table every round)."""
        cache = _ALL_KMERS_CACHE.setdefault(self.name, {})
        got = cache.get(k)
        if got is None:
            got = cache[k] = [self.rank_to_kmer(r, k)
                              for r in range(self.size ** k)]
        return got

    def lexicographic_next(self, kmer: str) -> str:
        """The next k-mer in lexicographic order (wraps like the reference)."""
        chars = list(kmer)
        carry = 1
        i = len(chars) - 1
        while carry > 0 and i >= 0:
            r = self.rank(chars[i]) + carry
            chars[i] = self.base(r % self.size)
            carry = r // self.size
            i -= 1
        return "".join(chars)

    def enumerate_kmers(self, k: int):
        kmer = self.bases[0] * k
        for _ in range(self.num_strings(k)):
            yield kmer
            kmer = self.lexicographic_next(kmer)

    # --- methylation-aware string ops ------------------------------------
    def reverse_complement(self, s: str) -> str:
        if not self.recognition_sites or METHYLATED_SYMBOL not in s:
            # the site-preserving branch below only diverges from the
            # plain per-char complement when a match COVERS a methylated
            # symbol in s, so an M-free string takes the byte-translate
            # fast path (exact same complements[_rank_lut[c]] map)
            return s.encode("latin-1").translate(
                self._comp_table)[::-1].decode("latin-1")
        n = len(s)
        rl = self.recognition_length
        if n > 2 * rl:
            # vectorized equivalent of the scan below: away from the
            # string tail a site match must be FULL (cl == rl) and a
            # full match of a methylated pattern always covers its M, so
            # the walk is: greedy left-to-right full matches (patched
            # over a byte-translate complement), then the original
            # partial-match scan over the last rl-1 positions
            pre = bytearray(s.encode("latin-1").translate(self._comp_table))
            sites_m = self.recognition_sites_methylated
            if len(sites_m) == 1:
                # single-pattern greedy scan via str.find (C speed; the
                # start=p+rl restart is exactly the loop's stride)
                site_m = sites_m[0]
                comp = self.recognition_sites_methylated_complement[0] \
                    .encode("latin-1")
                p = s.find(site_m)
                nxt = 0
                while p != -1 and p <= n - rl:
                    pre[p:p + rl] = comp
                    nxt = p + rl
                    p = s.find(site_m, nxt)
            else:
                raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
                win = np.lib.stride_tricks.sliding_window_view(raw, rl)
                site_idx = np.full(win.shape[0], -1, np.int32)
                for j in reversed(range(len(sites_m))):
                    pat = np.frombuffer(sites_m[j].encode("ascii"),
                                        dtype=np.uint8)
                    site_idx = np.where((win == pat).all(axis=1), j, site_idx)
                nxt = 0
                for p in np.nonzero(site_idx >= 0)[0].tolist():
                    if p < nxt:
                        continue
                    comp_site = self.recognition_sites_methylated_complement[
                        int(site_idx[p])]
                    pre[p:p + rl] = comp_site.encode("latin-1")
                    nxt = p + rl
            i = max(nxt, n - rl + 1)
            while i < n:
                stride = 1
                for kk, site_m in enumerate(sites_m):
                    cl = n - i
                    if s[i:i + cl] == site_m[:cl] and \
                            METHYLATED_SYMBOL in s[i:i + cl]:
                        comp_site = \
                            self.recognition_sites_methylated_complement[kk]
                        pre[i:i + cl] = comp_site[:cl].encode("latin-1")
                        stride = cl
                        break
                i += stride
            return bytes(pre)[::-1].decode("latin-1")
        out = ["A"] * len(s)
        i = 0
        j = len(s) - 1
        while i < len(s):
            ridx = -1
            match = None
            for kk, site_m in enumerate(self.recognition_sites_methylated):
                m = _match_to_site(s, i, site_m)
                if m.length > 0 and m.covers_methylated_site:
                    ridx = kk
                    match = m
                    break
            if ridx != -1:
                comp_site = self.recognition_sites_methylated_complement[ridx]
                for kk in range(match.offset, match.offset + match.length):
                    out[j] = comp_site[kk]
                    j -= 1
                    i += 1
            else:
                assert s[i] != METHYLATED_SYMBOL
                out[j] = self.complement(s[i])
                j -= 1
                i += 1
        return "".join(out)

    def disambiguate(self, s: str) -> str:
        """Uppercase + replace IUPAC ambiguity codes by their first symbol,
        leaving methylated recognition sites intact."""
        su = s.upper()
        # pure-base fast path: every char maps to itself whether or not
        # it sits in a recognition site
        if not (set(su) - UNAMBIGUOUS):
            return su
        out = list(su)
        i = 0
        n = len(out)
        while i < n:
            stride = 1
            is_site = False
            # matching inspects positions >= i only (plus the i==0
            # whole-string branch), which out never modifies before
            # reaching them — so match against the unmodified string
            # instead of re-joining out every position
            for site_m in self.recognition_sites_methylated:
                m = _match_to_site(su, i, site_m)
                if m.length > 0:
                    stride = m.length
                    is_site = True
                    break
            if not is_site:
                out[i] = IUPAC_POSSIBLE.get(out[i], "A")[0]
                stride = 1
            i += stride
        return "".join(out)

    def methylate(self, s: str) -> str:
        """Replace fully-matched recognition sites by their methylated
        version (left-to-right, skipping the site length on a match —
        the scan of the original loop, vectorized: full matches are
        found against the ORIGINAL string with a windowed compare, then
        applied greedily)."""
        rl = self.recognition_length
        if rl == 0 or len(s) < rl:
            return s
        if len(self.recognition_sites) == 1:
            site = self.recognition_sites[0]
            # str.replace scans left-to-right and skips the match length,
            # which equals the original loop's greedy stride when the
            # site cannot overlap itself (no proper prefix == suffix)
            if not any(site[:i] == site[-i:] for i in range(1, rl)):
                return s.replace(site, self.recognition_sites_methylated[0])
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        win = np.lib.stride_tricks.sliding_window_view(raw, rl)
        site_idx = np.full(win.shape[0], -1, np.int32)
        for j in reversed(range(len(self.recognition_sites))):
            pat = np.frombuffer(self.recognition_sites[j].encode("ascii"),
                                dtype=np.uint8)
            site_idx = np.where((win == pat).all(axis=1), j, site_idx)
        pos = np.nonzero(site_idx >= 0)[0]
        if pos.size == 0:
            return s
        out = list(s)
        nxt = 0
        for p in pos.tolist():
            if p < nxt:
                continue
            out[p:p + rl] = self.recognition_sites_methylated[int(site_idx[p])]
            nxt = p + rl
        return "".join(out)

    def unmethylate(self, s: str) -> str:
        """Remove methyl marks (including partial site matches at the ends)."""
        out = list(s)
        i = 0
        n = len(out)
        while i < n:
            stride = 1
            # matching inspects positions >= i only, which this loop
            # never modifies before reaching them — match against the
            # original string instead of re-joining out every position
            for j, site_m in enumerate(self.recognition_sites_methylated):
                m = _match_to_site(s, i, site_m)
                if m.length > 0:
                    site = self.recognition_sites[j]
                    out[i : i + m.length] = site[m.offset : m.offset + m.length]
                    stride = m.length
                    break
            i += stride
        return "".join(out)

    def is_motif_match(self, s: str, i: int) -> bool:
        rl = self.recognition_length
        for site in self.recognition_sites:
            if _match_to_site(s, i, site).length == rl:
                return True
        return False

    def contains_all(self, bases: str) -> bool:
        return all(b in self.bases for b in bases)

    def motif_positions(self, s: str) -> np.ndarray:
        """All positions where a recognition site fully matches (vectorized)."""
        rl = self.recognition_length
        if rl == 0 or len(s) < rl:
            return np.zeros((0,), dtype=np.int64)
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        win = np.lib.stride_tricks.sliding_window_view(raw, rl)
        hit = np.zeros(win.shape[0], dtype=bool)
        for site in self.recognition_sites:
            pat = np.frombuffer(site.encode("ascii"), dtype=np.uint8)
            hit |= (win == pat).all(axis=1)
        return np.nonzero(hit)[0]


# --- concrete alphabets (tables match nanopolish_alphabet.cpp) ------------

DNA_ALPHABET = Alphabet(name="nucleotide", bases="ACGT", complements="TGCA")

U_TO_T_RNA_ALPHABET = Alphabet(name="u_to_t_rna", bases="ACGT", complements="TGCA")

METHYL_CPG_ALPHABET = Alphabet(
    name="cpg",
    bases="ACGMT",
    complements="TGCGA",
    recognition_sites=("CG",),
    recognition_sites_methylated=("MG",),
    recognition_sites_methylated_complement=("GM",),
)

METHYL_GPC_ALPHABET = Alphabet(
    name="gpc",
    bases="ACGMT",
    complements="TGCGA",
    recognition_sites=("GC",),
    recognition_sites_methylated=("GM",),
    recognition_sites_methylated_complement=("MG",),
)

METHYL_DAM_ALPHABET = Alphabet(
    name="dam",
    bases="ACGMT",
    complements="TGCTA",
    recognition_sites=("GATC",),
    recognition_sites_methylated=("GMTC",),
    recognition_sites_methylated_complement=("CTMG",),
)

METHYL_DCM_ALPHABET = Alphabet(
    name="dcm",
    bases="ACGMT",
    complements="TGCGA",
    recognition_sites=("CCAGG", "CCTGG"),
    recognition_sites_methylated=("CMAGG", "CMTGG"),
    recognition_sites_methylated_complement=("GGTMC", "GGAMC"),
)

ALPHABETS: Dict[str, Alphabet] = {
    a.name: a
    for a in (
        DNA_ALPHABET,
        U_TO_T_RNA_ALPHABET,
        METHYL_CPG_ALPHABET,
        METHYL_GPC_ALPHABET,
        METHYL_DAM_ALPHABET,
        METHYL_DCM_ALPHABET,
    )
}


def get_alphabet_by_name(name: str) -> Alphabet:
    try:
        return ALPHABETS[name]
    except KeyError:
        raise KeyError(f"unknown alphabet: {name!r} (have {sorted(ALPHABETS)})")


def best_alphabet(bases: str) -> Optional[Alphabet]:
    """First alphabet (in the reference's fixed order) containing all of
    ``bases`` (nanopolish_alphabet.cpp: get_alphabet_list + best_alphabet)."""
    for name in ("nucleotide", "cpg", "gpc", "dam", "dcm", "u_to_t_rna"):
        a = ALPHABETS[name]
        if a.contains_all(bases):
            return a
    return None
