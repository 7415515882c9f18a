"""Pore models: k-mer Gaussian emission tables + registry.

TPU-first rebuild of the reference pore model layer
(reference: src/pore_model/nanopolish_poremodel.{h,cpp},
 src/pore_model/nanopolish_pore_model_set.{h,cpp}).

A PoreModel here is a struct-of-arrays: per-kmer-rank float32 numpy arrays
(level_mean, level_stdv, sd_mean, sd_stdv + derived level_log_stdv,
sd_lambda, sd_log_lambda), ready to be shipped to the device as dense HBM
tables and gathered by rank.  The 14 built-in models are stored in
``nanopolish_tpu_torch/data/builtin_models.npz`` (generated by
tools/import_models.py from the published ONT model tables).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..utils.alphabet import Alphabet, best_alphabet, get_alphabet_by_name

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
BUILTIN_NPZ = os.path.join(_DATA_DIR, "builtin_models.npz")


@dataclass
class PoreModel:
    """k-mer -> Gaussian current model. Arrays are indexed by kmer rank."""

    kit: str
    strand: str                      # "template" | "complement.pop1" | "complement.pop2"
    k: int
    alphabet: Alphabet
    level_mean: np.ndarray           # [R] float64
    level_stdv: np.ndarray
    sd_mean: np.ndarray
    sd_stdv: np.ndarray
    name: str = ""
    model_filename: str = ""
    # derived
    level_log_stdv: np.ndarray = field(default=None, repr=False)
    sd_lambda: np.ndarray = field(default=None, repr=False)
    sd_log_lambda: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.update_derived()

    def update_derived(self):
        # sd_lambda = sd_mean^3 / sd_stdv^2 (nanopolish_poremodel.h:53-56)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.sd_lambda = self.sd_mean ** 3 / self.sd_stdv ** 2
            self.level_log_stdv = np.log(self.level_stdv)
            self.sd_log_lambda = np.log(self.sd_lambda)

    @property
    def num_states(self) -> int:
        return int(self.level_mean.shape[0])

    @property
    def strand_idx(self) -> int:
        return 0 if self.strand == "template" else 1

    def key(self) -> Tuple[str, str, str, int]:
        return (self.kit, self.alphabet.name, self.strand, self.k)

    # --- I/O ----------------------------------------------------------------
    @classmethod
    def from_file(cls, filename: str, alphabet: Optional[Alphabet] = None) -> "PoreModel":
        """Parse a `.model` TSV with #kit/#strand/#alphabet headers
        (format per nanopolish_poremodel.cpp:26-119)."""
        name = ""
        kit = ""
        strand = ""
        alpha = alphabet
        kmers: Dict[str, Tuple[float, float, float, float]] = {}
        bases_seen = set()
        k = None
        with open(filename) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("#"):
                    fields = line.split()
                    tag = fields[0]
                    if tag in ("#model_name", "#ont_model_name") and len(fields) > 1:
                        name = fields[1]
                    elif tag == "#kit" and len(fields) > 1:
                        kit = fields[1]
                    elif tag == "#strand" and len(fields) > 1:
                        strand = fields[1]
                    elif tag == "#alphabet" and len(fields) > 1:
                        alpha = get_alphabet_by_name(fields[1])
                    continue
                if line.startswith("kmer"):
                    continue
                fields = line.split()
                kmer = fields[0]
                kmers[kmer] = tuple(float(x) for x in fields[1:5])
                bases_seen.update(kmer)
                if k is None:
                    k = len(kmer)
        if alpha is None:
            alpha = best_alphabet("".join(sorted(bases_seen)))
        assert alpha is not None
        R = alpha.num_strings(k)
        arrs = np.zeros((R, 4), dtype=np.float64)
        for kmer, params in kmers.items():
            arrs[alpha.kmer_rank(kmer, k)] = params
        if len(kmers) != R:
            raise ValueError(f"model {filename}: expected {R} kmers, got {len(kmers)}")
        return cls(
            kit=kit, strand=strand or "template", k=k, alphabet=alpha,
            level_mean=arrs[:, 0].copy(), level_stdv=arrs[:, 1].copy(),
            sd_mean=arrs[:, 2].copy(), sd_stdv=arrs[:, 3].copy(),
            name=name, model_filename=filename,
        )

    def write(self, filename: str, model_name: str = "") -> None:
        """Write in the reference's `.model` TSV format."""
        out_name = model_name or self.name
        with open(filename, "w") as fh:
            fh.write(f"#model_name\t{out_name}\n")
            fh.write(f"#kit\t{self.kit}\n")
            fh.write(f"#strand\t{self.strand}\n")
            fh.write(f"#k\t{self.k}\n")
            fh.write(f"#alphabet\t{self.alphabet.name}\n")
            if self.model_filename:
                fh.write(f"#original_file\t{self.model_filename}\n")
            fh.write("kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\n")
            for rank, kmer in enumerate(self.alphabet.enumerate_kmers(self.k)):
                fh.write(
                    f"{kmer}\t{self.level_mean[rank]:f}\t{self.level_stdv[rank]:f}"
                    f"\t{self.sd_mean[rank]:f}\t{self.sd_stdv[rank]:f}\n"
                )

    def with_states(self, level_mean, level_stdv, sd_mean=None, sd_stdv=None) -> "PoreModel":
        """Copy of this model with replaced emission parameters."""
        return PoreModel(
            kit=self.kit, strand=self.strand, k=self.k, alphabet=self.alphabet,
            level_mean=np.asarray(level_mean, dtype=np.float64),
            level_stdv=np.asarray(level_stdv, dtype=np.float64),
            sd_mean=np.asarray(sd_mean if sd_mean is not None else self.sd_mean, dtype=np.float64),
            sd_stdv=np.asarray(sd_stdv if sd_stdv is not None else self.sd_stdv, dtype=np.float64),
            name=self.name, model_filename=self.model_filename,
        )


_BUILTIN_LOCK = threading.Lock()


class PoreModelSet:
    """Registry of pore models keyed by (kit, alphabet, strand, k).

    Reference: src/pore_model/nanopolish_pore_model_set.{h,cpp}.  The 14
    built-in models ship in data/builtin_models.npz and are lazily loaded.
    """

    _instance: Optional["PoreModelSet"] = None

    def __init__(self):
        self._models: Dict[Tuple[str, str, str, int], PoreModel] = {}
        self._builtin_loaded = False

    @classmethod
    def instance(cls) -> "PoreModelSet":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    def _ensure_builtin(self):
        # loader threads can make the first lookup together: the flag goes
        # up only once every built-in model is in, under a lock, so none of
        # them sees a half-filled registry
        if self._builtin_loaded:
            return
        with _BUILTIN_LOCK:
            if not self._builtin_loaded:
                self._load_builtin()
                self._builtin_loaded = True

    def _load_builtin(self):
        if not os.path.exists(BUILTIN_NPZ):
            return
        data = np.load(BUILTIN_NPZ, allow_pickle=False)
        names = [n for n in data.files if n.endswith(":params")]
        for pname in names:
            tag = pname[: -len(":params")]
            meta = str(data[f"{tag}:meta"])
            kit, alphabet_name, strand, k = meta.split("|")
            params = data[pname]
            model = PoreModel(
                kit=kit, strand=strand, k=int(k),
                alphabet=get_alphabet_by_name(alphabet_name),
                level_mean=params[:, 0].copy(), level_stdv=params[:, 1].copy(),
                sd_mean=params[:, 2].copy(), sd_stdv=params[:, 3].copy(),
                name=tag, model_filename=f"builtin:{tag}",
            )
            self._models.setdefault(model.key(), model)

    def register_model(self, model: PoreModel) -> PoreModel:
        self._ensure_builtin()
        self._models[model.key()] = model
        return model

    def add_model(self, model: PoreModel) -> PoreModel:
        return self.register_model(model)

    def initialize(self, fofn: str) -> List["PoreModel"]:
        """Import extra models listed one-per-line in a file-of-filenames.
        Returns the imported models (PoreModelSet::initialize)."""
        base = os.path.dirname(os.path.abspath(fofn))
        imported: List[PoreModel] = []
        with open(fofn) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                path = line if os.path.isabs(line) else os.path.join(base, line)
                model = PoreModel.from_file(path)
                # fofn-imported models REPLACE builtins (methyltrain seeds
                # training from them)
                self.add_model(model)
                imported.append(model)
        return imported

    def has_model(self, kit: str, alphabet: str, strand: str, k: int) -> bool:
        self._ensure_builtin()
        return (kit, alphabet, strand, k) in self._models

    def get_model(self, kit: str, alphabet: str, strand: str, k: int) -> PoreModel:
        self._ensure_builtin()
        key = (kit, alphabet, strand, k)
        try:
            return self._models[key]
        except KeyError:
            raise KeyError(
                f"no pore model for {key}; available: {sorted(self._models)}"
            )

    def get_models_by_kit(self, kit: str) -> List[PoreModel]:
        self._ensure_builtin()
        return [m for key, m in self._models.items() if key[0] == kit]


def get_model(kit: str, alphabet: str, strand: str, k: int) -> PoreModel:
    return PoreModelSet.instance().get_model(kit, alphabet, strand, k)


def pore_model_from_numpy(arrays: dict) -> PoreModel:
    """Build a PoreModel from another package's model handed over as plain
    values: ``kit``, ``strand``, ``k``, ``alphabet`` (its name) and the
    four per-rank arrays ``level_mean``, ``level_stdv``, ``sd_mean``,
    ``sd_stdv``; ``name`` and ``model_filename`` are optional.  The
    derived arrays are recomputed, so both packages hold identical
    emission tables for the same inputs."""
    return PoreModel(
        kit=str(arrays["kit"]), strand=str(arrays["strand"]),
        k=int(arrays["k"]),
        alphabet=get_alphabet_by_name(str(arrays["alphabet"])),
        level_mean=np.asarray(arrays["level_mean"], np.float64).copy(),
        level_stdv=np.asarray(arrays["level_stdv"], np.float64).copy(),
        sd_mean=np.asarray(arrays["sd_mean"], np.float64).copy(),
        sd_stdv=np.asarray(arrays["sd_stdv"], np.float64).copy(),
        name=str(arrays.get("name", "")),
        model_filename=str(arrays.get("model_filename", "")))
