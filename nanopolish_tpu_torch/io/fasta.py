"""FASTA/FASTQ parsing and faidx-style random access.

htslib-equivalent subset used by the reference: kseq fastq parsing
(reference: src/nanopolish_index.cpp), `fai_build`/`faidx_fetch_seq`
(reference: src/alignment/nanopolish_eventalign.cpp:208-221) and the
bgzipped read fasta of ReadDB (src/nanopolish_read_db.cpp:33-115).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BgzfReader, BgzfWriter, is_bgzf


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int       # file offset of first base (uncompressed coords)
    line_bases: int
    line_width: int


def read_fastx(path: str) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (name, sequence, quality|None) from fasta/fastq, plain or
    gzip/bgzf compressed."""
    opener = _text_opener(path)
    with opener() as fh:
        first = fh.readline()
        while first and not first.strip():
            first = fh.readline()
        if not first:
            return
        if first.startswith(">"):
            name = first[1:].split()[0]
            seq: List[str] = []
            for line in fh:
                if line.startswith(">"):
                    yield name, "".join(seq), None
                    name = line[1:].split()[0]
                    seq = []
                else:
                    seq.append(line.strip())
            yield name, "".join(seq), None
        elif first.startswith("@"):
            while first:
                name = first[1:].split()[0]
                seq = fh.readline().strip()
                fh.readline()                 # '+'
                qual = fh.readline().strip()
                yield name, seq, qual
                first = fh.readline()
        else:
            raise ValueError(f"{path}: not fasta/fastq")


def _text_opener(path: str):
    if is_bgzf(path):
        def op():
            return _TextBgzf(BgzfReader.open(path))
        return op
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        def op():
            return gzip.open(path, "rt")
        return op
    return lambda: open(path, "rt")


class _TextBgzf:
    def __init__(self, r: BgzfReader):
        self._r = r

    def readline(self) -> str:
        return self._r.readline().decode()

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._r.close()


def build_fai(path: str, out_path: Optional[str] = None) -> Dict[str, FaiEntry]:
    """Build a .fai index for a (plain or bgzipped) fasta; offsets are in
    uncompressed coordinates, as samtools faidx does.  Also writes the
    companion .gzi block index for bgzf inputs."""
    entries: Dict[str, FaiEntry] = {}
    bgzf = is_bgzf(path)
    raw = BgzfReader.open(path) if bgzf else open(path, "rb")
    gzi_blocks: List[Tuple[int, int]] = []
    try:
        offset = 0
        name = None
        length = 0
        line_bases = line_width = 0
        seq_off = 0
        first_lines = True
        while True:
            line = raw.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries[name] = FaiEntry(name, length, seq_off,
                                             line_bases, line_width)
                name = line[1:].split()[0].decode()
                offset += len(line)
                seq_off = offset
                length = 0
                line_bases = line_width = 0
                first_lines = True
            else:
                bases = len(line.rstrip(b"\r\n"))
                if first_lines and bases:
                    line_bases = bases
                    line_width = len(line)
                    first_lines = False
                length += bases
                offset += len(line)
        if name is not None:
            entries[name] = FaiEntry(name, length, seq_off, line_bases, line_width)
    finally:
        raw.close()
    out_path = out_path or path + ".fai"
    with open(out_path, "w") as out:
        for e in entries.values():
            out.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}\t{e.line_width}\n")
    if bgzf:
        _build_gzi(path)
    return entries


def _build_gzi(path: str):
    """Block index (compressed offset, uncompressed offset) pairs."""
    import struct
    pairs = []
    with open(path, "rb") as fh:
        coff, uoff = 0, 0
        while True:
            hdr = fh.read(18)
            if len(hdr) < 18:
                break
            xlen = struct.unpack("<H", hdr[10:12])[0]
            extra = hdr[12:18] + fh.read(xlen - 6)
            bsize = None
            i = 0
            while i + 4 <= len(extra):
                if extra[i] == 66 and extra[i + 1] == 67:
                    bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                    break
                i += 4 + struct.unpack("<H", extra[i + 2:i + 4])[0]
            fh.seek(coff + bsize - 4)
            isize = struct.unpack("<I", fh.read(4))[0]
            coff += bsize
            uoff += isize
            if isize:
                pairs.append((coff, uoff))
            fh.seek(coff)
    with open(path + ".gzi", "wb") as out:
        import struct as s
        out.write(s.pack("<Q", max(0, len(pairs) - 1)))
        for c, u in pairs[:-1] if pairs else []:
            out.write(s.pack("<QQ", c, u))


class FastaIndex:
    """faidx-equivalent random access over plain or bgzf fasta.

    Thread-safe (the reference wraps faidx in a mutex,
    src/alignment/nanopolish_eventalign.cpp:208-221).
    """

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path)
        self.entries: Dict[str, FaiEntry] = {}
        with open(fai) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                self.entries[f[0]] = FaiEntry(f[0], int(f[1]), int(f[2]),
                                              int(f[3]), int(f[4]))
        self._bgzf = is_bgzf(path)
        self._lock = threading.Lock()
        self._fh = BgzfReader.open(path) if self._bgzf else open(path, "rb")
        self._ubounds: List[int] = []
        self._cbounds: List[int] = []
        if self._bgzf:
            self._load_gzi()

    def _load_gzi(self):
        import struct
        gzi = self.path + ".gzi"
        if not os.path.exists(gzi):
            _build_gzi(self.path)
        self._cbounds = [0]
        self._ubounds = [0]
        if os.path.exists(gzi):
            with open(gzi, "rb") as fh:
                (n,) = struct.unpack("<Q", fh.read(8))
                for _ in range(n):
                    c, u = struct.unpack("<QQ", fh.read(16))
                    self._cbounds.append(c)
                    self._ubounds.append(u)

    def _read_at(self, uoffset: int, n: int) -> bytes:
        if not self._bgzf:
            self._fh.seek(uoffset)
            return self._fh.read(n)
        import bisect
        i = bisect.bisect_right(self._ubounds, uoffset) - 1
        self._fh.seek(self._cbounds[i] << 16)
        self._fh.read(uoffset - self._ubounds[i])
        return self._fh.read(n)

    def names(self) -> List[str]:
        return list(self.entries)

    def length(self, name: str) -> int:
        return self.entries[name].length

    def fetch(self, name: str, start: int = 0, end: Optional[int] = None) -> str:
        """0-based [start, end) subsequence."""
        e = self.entries[name]
        start = max(0, start)
        end = e.length if end is None else min(end, e.length)
        if start >= end:
            return ""
        first_line = start // e.line_bases
        last_line = (end - 1) // e.line_bases
        u0 = e.offset + first_line * e.line_width + start % e.line_bases
        u1 = e.offset + last_line * e.line_width + (end - 1) % e.line_bases + 1
        with self._lock:
            raw = self._read_at(u0, u1 - u0)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def close(self):
        self._fh.close()


def write_bgzf_fasta(records: Iterator[Tuple[str, str]], out_path: str,
                     line_width: int = 60):
    """Write records as a bgzipped fasta (ReadDB's .index file format)."""
    with BgzfWriter.open(out_path) as w:
        for name, seq in records:
            w.write(f">{name}\n".encode())
            for i in range(0, len(seq), line_width):
                w.write(seq[i:i + line_width].encode() + b"\n")
