"""ReadDB: read_id -> {sequence, signal path} database + `index` builder.

Format-compatible rebuild of the reference ReadDB
(reference: src/nanopolish_read_db.{h,cpp}:33-115 and
src/nanopolish_index.cpp:61-135,343-413):

  <reads>.index          bgzipped fasta of all read sequences
  <reads>.index.fai      faidx of the above
  <reads>.index.gzi      bgzf block index
  <reads>.index.readdb   TSV read_id -> signal file path ("*" -> slow5 file)
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator, List, Optional, Tuple

from .fasta import FastaIndex, read_fastx, write_bgzf_fasta

GZIPPED_READS_SUFFIX = ".index"
READ_DB_SUFFIX = ".index.readdb"


class ReadDB:
    def __init__(self):
        self._data: Dict[str, str] = {}       # read_id -> signal path
        self._reads_path: Optional[str] = None
        self._fai: Optional[FastaIndex] = None
        self._slow5_path: Optional[str] = None

    # ---------------- construction (index subcommand) ----------------
    def build(self, reads_path: str):
        """Import fasta/fastq, write the bgzipped .index + faidx."""
        self._reads_path = reads_path
        out = reads_path + GZIPPED_READS_SUFFIX

        def records():
            for name, seq, _ in read_fastx(reads_path):
                self._data.setdefault(name, "")
                yield name, seq

        write_bgzf_fasta(records(), out)
        self._fai = FastaIndex(out)

    def add_signal_path(self, read_id: str, path: str):
        if read_id in self._data:
            self._data[read_id] = path

    def import_signal_map(self, paths: Dict[str, str]):
        for rid, p in paths.items():
            self.add_signal_path(rid, p)

    def set_slow5_mode(self, slow5_path: str):
        """slow5 single-file mode: one '*' -> file mapping
        (src/nanopolish_index.cpp:404-410)."""
        self._slow5_path = slow5_path

    def save(self):
        assert self._reads_path is not None
        with open(self._reads_path + READ_DB_SUFFIX, "w") as out:
            if self._slow5_path is not None:
                out.write(f"*\t{self._slow5_path}\n")
            else:
                for rid, path in self._data.items():
                    out.write(f"{rid}\t{path}\n")

    # ---------------- loading ----------------
    def load(self, reads_path: str):
        self._reads_path = reads_path
        self._fai = FastaIndex(reads_path + GZIPPED_READS_SUFFIX)
        with open(reads_path + READ_DB_SUFFIX) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) == 2:
                    if f[0] == "*":
                        self._slow5_path = f[1]
                    else:
                        self._data[f[0]] = f[1]

    # ---------------- queries (nanopolish_read_db.h:23-98) ----------------
    def get_read_sequence(self, read_id: str) -> str:
        if self._fai is None or read_id not in self._fai.entries:
            return ""
        return self._fai.fetch(read_id)

    def get_signal_path(self, read_id: str) -> str:
        if self._slow5_path is not None:
            return self._slow5_path
        return self._data.get(read_id, "")

    def has_read(self, read_id: str) -> bool:
        return self._fai is not None and read_id in self._fai.entries

    def is_slow5_mode(self) -> bool:
        return self._slow5_path is not None

    def get_all_read_names(self) -> List[str]:
        return self._fai.names() if self._fai else []

    def get_num_reads(self) -> int:
        return len(self._fai.entries) if self._fai else 0

    def print_stats(self, file=sys.stderr):
        with_path = sum(1 for v in self._data.values() if v)
        print(f"[readdb] num reads: {self.get_num_reads()}, "
              f"num reads with path to signal file: "
              f"{self.get_num_reads() if self._slow5_mode_count() else with_path}",
              file=file)

    def _slow5_mode_count(self):
        return self._slow5_path is not None


def find_signal_files(dirs: List[str], recursive: bool = True) -> List[str]:
    """Walk directories for .fast5/.slow5/.blow5 files
    (src/nanopolish_index.cpp:61-135)."""
    out: List[str] = []
    for d in dirs:
        if os.path.isfile(d):
            out.append(d)
            continue
        for root, subdirs, files in os.walk(d):
            for f in files:
                if f.endswith((".fast5", ".slow5", ".blow5")):
                    out.append(os.path.join(root, f))
            if not recursive:
                subdirs.clear()
    return out


def index_signal_files(db: ReadDB, paths: List[str], progress: bool = False):
    """Map read_id -> signal path by opening each fast5."""
    from .fast5 import Fast5File

    import sys

    for p in paths:
        if p.endswith((".slow5", ".blow5")):
            db.set_slow5_mode(p)
            continue
        try:
            with Fast5File(p) as f:
                names = f.read_names()
                if not names:
                    # legacy (pre-raw-signal) fast5 layouts yield no
                    # indexable reads — say so instead of skipping silently
                    print(f"[readdb] warning: no raw reads in {p} "
                          f"(legacy events-only fast5?)", file=sys.stderr)
                for rid in names:
                    db.add_signal_path(rid, p)
        except Exception as e:
            print(f"[readdb] warning: could not open {p}: {e}",
                  file=sys.stderr)
            continue


def parse_sequencing_summary(path: str) -> Dict[str, str]:
    """sequencing_summary.txt: filename + read_id columns
    (src/nanopolish_index.cpp:137-195)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        try:
            fn_idx = header.index("filename")
            id_idx = header.index("read_id")
        except ValueError:
            return out
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) > max(fn_idx, id_idx):
                out[f[id_idx]] = f[fn_idx]
    return out
