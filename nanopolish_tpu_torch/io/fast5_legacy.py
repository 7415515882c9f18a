"""Legacy (2014-era) 2D basecalled FAST5 reading for R7 chemistry.

These files carry no raw signal: the per-strand *basecalled event tables*
(mean/start/stdv/length, start in seconds), the basecaller's embedded
per-strand 5-mer pore models, and the per-read scalings
(shift/scale/drift/var/scale_sd/var_sd as Model attributes) are the read.
This is the format of the one real signal file checked into the reference
(test/data/LomanLabz_PC_Ecoli_K12_R7.3_..._strand.fast5), consumed by the
reference's golden HMM test (src/test/nanopolish_test.cpp:389-455).

The modern reference only ingests raw-signal files
(src/nanopolish_squiggle_read.cpp:143-149 skips rawless files as
`g_bad_fast5_file`); this loader exists so the R7 profile HMM
(ops/profile_hmm_r7.py) can be validated against the reference's recorded
golden values on real data.  ``h5py`` is imported inside the loader,
so nothing else of the package needs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

T_IDX, C_IDX = 0, 1
_STRAND_GROUP = {0: "template", 1: "complement"}


@dataclass
class LegacyStrandData:
    """One strand of a 2D read: basecalled events + embedded pore model +
    per-read scalings (SquiggleScalings.set6 fields)."""

    mean: np.ndarray          # [n] f64 event current level (pA)
    stdv: np.ndarray          # [n]
    start: np.ndarray         # [n] seconds (absolute)
    length: np.ndarray        # [n] seconds
    # embedded 5-mer model (lexicographic kmer order)
    level_mean: np.ndarray    # [4^k]
    level_stdv: np.ndarray
    sd_mean: np.ndarray
    sd_stdv: np.ndarray
    k: int
    # scalings
    shift: float
    scale: float
    drift: float
    var: float
    scale_sd: float
    var_sd: float
    sequence: str             # strand fastq sequence

    def drift_scaled_level(self, event_idx) -> np.ndarray:
        """get_drift_scaled_level (squiggle_read.h:149-155): level minus
        drift * (start - start of the strand's first event)."""
        t = self.start[event_idx] - self.start[0]
        return self.mean[event_idx] - t * self.drift

    def scaled_gaussian(self, rank):
        """get_scaled_gaussian_from_pore_model_state (squiggle_read.h:216-226)."""
        mean = self.scale * self.level_mean[rank] + self.shift
        stdv = self.level_stdv[rank] * self.var
        return mean, stdv


@dataclass
class Legacy2DRead:
    read_name: str
    strands: Dict[int, LegacyStrandData]
    twod_sequence: Optional[str]


def _first_group(f, pattern: str):
    import re

    hits = [g for g in f["Analyses"] if re.match(pattern, g)]
    return f["Analyses"][sorted(hits)[0]] if hits else None


def load_legacy_2d(path: str) -> Legacy2DRead:
    """Load a legacy 2D basecalled FAST5 (events-only, R7)."""
    import h5py

    with h5py.File(path, "r") as f:
        bc = _first_group(f, r"Basecall_2D_\d+")
        if bc is None:
            raise ValueError(f"{path}: no Basecall_2D group (not a legacy "
                             "2D fast5)")
        strands: Dict[int, LegacyStrandData] = {}
        for sidx, sname in _STRAND_GROUP.items():
            g = bc.get(f"BaseCalled_{sname}")
            if g is None or "Events" not in g or "Model" not in g:
                continue
            ev = g["Events"][:]
            model = g["Model"][:]
            attrs = dict(g["Model"].attrs)
            fastq = bytes(np.asarray(g["Fastq"])).decode()
            seq = fastq.split("\n")[1]
            k = len(model["kmer"][0])
            # model rows are lexicographically sorted kmers; verify
            order = np.argsort(model["kmer"])
            model = model[order]
            strands[sidx] = LegacyStrandData(
                mean=np.asarray(ev["mean"], np.float64),
                stdv=np.asarray(ev["stdv"], np.float64),
                start=np.asarray(ev["start"], np.float64),
                length=np.asarray(ev["length"], np.float64),
                level_mean=np.asarray(model["level_mean"], np.float64),
                level_stdv=np.asarray(model["level_stdv"], np.float64),
                sd_mean=np.asarray(model["sd_mean"], np.float64),
                sd_stdv=np.asarray(model["sd_stdv"], np.float64),
                k=k,
                shift=float(attrs["shift"]), scale=float(attrs["scale"]),
                drift=float(attrs["drift"]), var=float(attrs["var"]),
                scale_sd=float(attrs["scale_sd"]),
                var_sd=float(attrs["var_sd"]),
                sequence=seq,
            )
        twod = None
        g2 = bc.get("BaseCalled_2D")
        if g2 is not None and "Fastq" in g2:
            twod = bytes(np.asarray(g2["Fastq"])).decode().split("\n")[1]
        return Legacy2DRead(read_name=path.rsplit("/", 1)[-1],
                            strands=strands, twod_sequence=twod)
