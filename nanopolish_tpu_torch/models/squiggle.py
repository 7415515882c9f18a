"""SquiggleRead: the central in-memory read object, as struct-of-arrays.

TPU-first rebuild of the reference SquiggleRead
(reference: src/nanopolish_squiggle_read.{h,cpp}).

Differences from the reference by design:
  * events are parallel numpy arrays (mean/stdv/start_time/duration), not an
    array-of-structs, so batches of reads pad/stack directly into device
    arrays;
  * the ingest pipeline (event detection -> MoM scaling -> banded alignment
    -> recalibration) is batched over many reads and executed by the ops/
    kernels; see models/read_builder.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .pore_model import PoreModel

# QC thresholds (nanopolish_squiggle_read.cpp:36, :320-336)
MIN_CALIBRATION_VAR = 2.5
MAX_EVENTS_PER_BASE = 5.0

# read-type / nucleotide-type enums (nanopolish_squiggle_read.h:24-43)
SRNT_DNA = 0
SRNT_RNA = 1

T_IDX = 0  # template strand index
C_IDX = 1  # complement strand index (legacy R7 2D reads only)

# flags (nanopolish_squiggle_read.h:96-103)
SRF_NO_MODEL = 1
SRF_LOAD_RAW_SAMPLES = 2


@dataclass
class SquiggleScalings:
    """Per-read, per-strand scaling: event_level ~ scale*model_mean + shift
    + drift*t, stdv scaled by var (nanopolish_squiggle_read.h:53-93)."""

    shift: float = 0.0
    scale: float = 1.0
    drift: float = 0.0
    var: float = 1.0
    scale_sd: float = 1.0
    var_sd: float = 1.0

    @classmethod
    def from4(cls, shift, scale, drift, var):
        return cls(shift=float(shift), scale=float(scale), drift=float(drift), var=float(var))

    @property
    def log_var(self) -> float:
        return math.log(self.var)


@dataclass
class EventTable:
    """Events of one strand as parallel arrays."""

    mean: np.ndarray          # [N] float32, pA
    stdv: np.ndarray          # [N] float32
    start_time: np.ndarray    # [N] float32, seconds from first event
    duration: np.ndarray      # [N] float32, seconds

    def __len__(self):
        return int(self.mean.shape[0])

    @property
    def log_stdv(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.log(self.stdv)


@dataclass
class SquiggleRead:
    read_name: str = ""
    read_sequence: str = ""
    nucleotide_type: int = SRNT_DNA
    fast5_path: str = ""
    sample_rate: float = 0.0
    channel_id: int = 0
    sample_start_time: int = 0

    events: list = field(default_factory=lambda: [None, None])        # EventTable per strand
    scalings: list = field(default_factory=lambda: [SquiggleScalings(), SquiggleScalings()])
    base_model: list = field(default_factory=lambda: [None, None])    # PoreModel per strand
    events_per_base: list = field(default_factory=lambda: [0.0, 0.0])

    # base_to_event_map[strand]: int32 [n_kmers, 2] of (start,stop) event
    # indices per read k-mer, -1 where no events (EventRangeForBase)
    base_to_event_map: list = field(default_factory=lambda: [None, None])

    samples: Optional[np.ndarray] = None   # raw pA samples (if SRF_LOAD_RAW_SAMPLES)

    # --- accessors matching the reference fold-in semantics ---------------
    def has_events_for_strand(self, strand: int) -> bool:
        return self.events[strand] is not None and len(self.events[strand]) > 0

    def get_time(self, event_idx, strand: int):
        ev = self.events[strand]
        return ev.start_time[event_idx] - ev.start_time[0]

    def get_unscaled_level(self, event_idx, strand: int):
        return self.events[strand].mean[event_idx]

    def get_drift_scaled_level(self, event_idx, strand: int):
        """level - drift * t (nanopolish_squiggle_read.h:149-155)."""
        s = self.scalings[strand]
        return self.get_unscaled_level(event_idx, strand) - self.get_time(event_idx, strand) * s.drift

    def get_fully_scaled_level(self, event_idx, strand: int):
        s = self.scalings[strand]
        return (self.get_drift_scaled_level(event_idx, strand) - s.shift) / s.scale

    def get_duration(self, event_idx, strand: int):
        return self.events[strand].duration[event_idx]

    def get_stdv(self, event_idx, strand: int):
        return self.events[strand].stdv[event_idx]

    def get_model_k(self, strand: int) -> int:
        return self.base_model[strand].k

    def get_model_kit_name(self, strand: int) -> str:
        return self.base_model[strand].kit

    def get_model_strand_name(self, strand: int) -> str:
        return self.base_model[strand].strand

    def get_model(self, strand: int, alphabet_name: str) -> PoreModel:
        from .pore_model import PoreModelSet
        return PoreModelSet.instance().get_model(
            self.get_model_kit_name(strand), alphabet_name,
            self.get_model_strand_name(strand), self.get_model_k(strand))

    def get_scaled_gaussian(self, pore_model: PoreModel, strand: int, rank):
        """(mean, stdv) of the read-scaled Gaussian for a kmer rank
        (nanopolish_squiggle_read.h:216-226)."""
        s = self.scalings[strand]
        mean = s.scale * pore_model.level_mean[rank] + s.shift
        stdv = pore_model.level_stdv[rank] * s.var
        return mean, stdv

    def flip_k_strand(self, k_idx: int, k: int) -> int:
        return len(self.read_sequence) - k_idx - k

    # --- event<->kmer map helpers -----------------------------------------
    def get_next_event(self, start: int, stop: int, stride: int, strand: int) -> int:
        b2e = self.base_to_event_map[strand]
        i = start
        while i != stop:
            ei = b2e[i, 0]
            if ei != -1:
                return int(ei)
            i += stride
        return -1

    def get_closest_event_to(self, k_idx: int, strand: int) -> int:
        """Nearest mapped event to a k-mer index, searching +-1000 k-mers
        (nanopolish_squiggle_read.cpp:174-186)."""
        b2e = self.base_to_event_map[strand]
        n = b2e.shape[0]
        stop_before = max(0, k_idx - 1000)
        stop_after = min(k_idx + 1000, n - 1)
        ev_before = self.get_next_event(k_idx, stop_before, -1, strand)
        ev_after = self.get_next_event(k_idx, stop_after, 1, strand)
        return ev_after if ev_before == -1 else ev_before

    def get_event_sample_idx(self, strand: int, event_idx: int):
        """(start, end) sample indices of an event (squiggle_read.cpp:419-428)."""
        ev = self.events[strand]
        start_t = float(ev.start_time[event_idx])
        dur = float(ev.duration[event_idx])
        start = int(start_t * self.sample_rate) - int(self.sample_start_time)
        end = int((start_t + dur) * self.sample_rate) - int(self.sample_start_time)
        return start, end

    def get_scaled_samples_for_event(self, strand: int, event_idx: int) -> np.ndarray:
        """Shift/drift/scale-corrected raw samples of an event
        (squiggle_read.cpp:399-417)."""
        s = self.scalings[strand]
        start, end = self.get_event_sample_idx(strand, event_idx)
        idx = np.arange(start, end)
        t = (self.sample_start_time + idx) / self.sample_rate \
            - self.sample_start_time / self.sample_rate
        scaled = (self.samples[start:end] - s.shift - t * s.drift) / s.scale
        return scaled.astype(np.float32)
