"""HMMInputSequence: fwd + reverse-complement sequence pair over an alphabet.

Rebuild of src/hmm/nanopolish_hmm_input_sequence.h:20-98.  The rank arrays
are precomputed as vectors so a window's kmer gaussians gather in one shot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.alphabet import Alphabet, DNA_ALPHABET


class HMMInputSequence:
    def __init__(self, fwd: str, rc: Optional[str] = None,
                 alphabet: Alphabet = DNA_ALPHABET):
        self.alphabet = alphabet
        self.seq = fwd
        self.rc_seq = rc if rc is not None else alphabet.reverse_complement(fwd)
        assert len(self.seq) == len(self.rc_seq)
        # (k, do_rc) -> int rank vector.  READ-ONLY CONTRACT: entries may
        # be views into larger shared arrays (callers pre-seed slices of
        # whole-reference rank arrays, e.g. apps/call_methylation.py's
        # collect_read_tasks); consumers must never mutate them in place.
        self._rank_cache = {}

    def __len__(self) -> int:
        return len(self.seq)

    def swap(self):
        self.seq, self.rc_seq = self.rc_seq, self.seq
        self._rank_cache.clear()

    def get_kmer(self, i: int, k: int, do_rc: bool) -> str:
        if not do_rc:
            return self.seq[i:i + k]
        n = len(self.rc_seq)
        return self.rc_seq[n - i - k: n - i]

    def get_kmer_rank(self, i: int, k: int, do_rc: bool) -> int:
        return int(self.kmer_ranks(k, do_rc)[i])

    def kmer_ranks(self, k: int, do_rc: bool) -> np.ndarray:
        """Rank of kmer i for i in [0, len-k] — for do_rc, the rank of the
        reverse-complement of the i-th kmer (hmm_input_sequence.h:74-91:
        rc ranks come from the rc sequence read at mirrored offsets)."""
        key = (k, do_rc)
        r = self._rank_cache.get(key)
        if r is None:
            if not do_rc:
                r = self.alphabet.seq_to_kmer_ranks(self.seq, k)
            else:
                r = self.alphabet.seq_to_kmer_ranks(self.rc_seq, k)[::-1].copy()
            self._rank_cache[key] = r
        return r
