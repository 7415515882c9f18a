"""BAM/SAM reading and writing (htslib-equivalent subset).

The reference uses htslib's sam_read1/sam_itr_querys plus the BAI index
for region iteration (reference: src/alignment/nanopolish_alignment_db.cpp,
src/common/nanopolish_bam_processor.cpp).  This module provides the same
capability surface natively: BAM record decode, BAI region queries, SAM
text emit, and BAM writing for modbam output.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

# flags (sam spec)
BAM_FPAIRED = 1
BAM_FUNMAP = 4
BAM_FREVERSE = 16
BAM_FSECONDARY = 256
BAM_FQCFAIL = 512
BAM_FDUP = 1024
BAM_FSUPPLEMENTARY = 2048

CIGAR_OPS = "MIDNSHP=X"
# ops that consume query / reference
_CONSUMES_QUERY = {0: 1, 1: 1, 3: 0, 4: 1, 7: 1, 8: 1, 2: 0, 5: 0, 6: 0}
_CONSUMES_REF = {0: 1, 2: 1, 3: 1, 7: 1, 8: 1, 1: 0, 4: 0, 5: 0, 6: 0}

_SEQ_DEC = "=ACMGRSVTWYHKDBN"
_SEQ_ENC = {c: i for i, c in enumerate(_SEQ_DEC)}


@dataclass
class BamRecord:
    qname: str = ""
    flag: int = 0
    tid: int = -1
    pos: int = -1          # 0-based leftmost
    mapq: int = 0
    cigar: List[Tuple[int, int]] = field(default_factory=list)  # (op, len)
    mtid: int = -1
    mpos: int = -1
    tlen: int = 0
    seq: str = ""
    qual: Optional[np.ndarray] = None      # uint8 phred, None if absent
    tags: Dict[str, Tuple[str, object]] = field(default_factory=dict)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & BAM_FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & BAM_FREVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & BAM_FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & BAM_FSUPPLEMENTARY)

    def reference_length(self) -> int:
        return sum(l for op, l in self.cigar if _CONSUMES_REF[op])

    def reference_end(self) -> int:
        return self.pos + self.reference_length()

    def query_length(self) -> int:
        return sum(l for op, l in self.cigar if _CONSUMES_QUERY[op])

    def cigar_string(self) -> str:
        return "".join(f"{l}{CIGAR_OPS[op]}" for op, l in self.cigar) or "*"

    def to_sam(self, ref_names: List[str]) -> str:
        rname = ref_names[self.tid] if self.tid >= 0 else "*"
        mrname = ("=" if self.mtid == self.tid else ref_names[self.mtid]) \
            if self.mtid >= 0 else "*"
        if self.qual is None:
            q = "*"
        else:
            q = "".join(chr(v + 33) for v in self.qual)
        fields = [self.qname or "*", str(self.flag), rname,
                  str(self.pos + 1), str(self.mapq), self.cigar_string(),
                  mrname, str(self.mpos + 1), str(self.tlen),
                  self.seq or "*", q]
        for key, (typ, val) in self.tags.items():
            if typ in "cCsSiI":
                fields.append(f"{key}:i:{val}")
            elif typ in "fd":
                fields.append(f"{key}:f:{val:g}")
            elif typ == "A":
                fields.append(f"{key}:A:{val}")
            elif typ == "B":
                code, arr = val
                fields.append(f"{key}:B:{code}," + ",".join(str(x) for x in arr))
            else:
                fields.append(f"{key}:{typ}:{val}")
        return "\t".join(fields)


def _decode_record(data: bytes) -> BamRecord:
    (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    qname = data[off:off + l_read_name - 1].decode()
    off += l_read_name
    cig = struct.unpack_from(f"<{n_cigar}I", data, off)
    off += 4 * n_cigar
    cigar = [(c & 0xF, c >> 4) for c in cig]
    nb = (l_seq + 1) // 2
    seq_bytes = data[off:off + nb]
    off += nb
    chars = []
    for i in range(l_seq):
        b = seq_bytes[i >> 1]
        chars.append(_SEQ_DEC[(b >> 4) if i % 2 == 0 else (b & 0xF)])
    seq = "".join(chars)
    qual = np.frombuffer(data[off:off + l_seq], np.uint8).copy()
    off += l_seq
    if l_seq and qual.size and qual[0] == 0xFF:
        qual = None
    tags = _decode_tags(data, off)
    return BamRecord(qname=qname, flag=flag, tid=tid, pos=pos, mapq=mapq,
                     cigar=cigar, mtid=mtid, mpos=mpos, tlen=tlen, seq=seq,
                     qual=qual, tags=tags)


_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I",
            "f": "<f", "d": "<d"}


def _decode_tags(data: bytes, off: int) -> Dict[str, Tuple[str, object]]:
    tags: Dict[str, Tuple[str, object]] = {}
    n = len(data)
    while off + 3 <= n:
        key = data[off:off + 2].decode()
        typ = chr(data[off + 2])
        off += 3
        if typ in _TAG_FMT:
            fmt = _TAG_FMT[typ]
            val = struct.unpack_from(fmt, data, off)[0]
            off += struct.calcsize(fmt)
        elif typ == "A":
            val = chr(data[off]); off += 1
        elif typ in "ZH":
            end = data.index(0, off)
            val = data[off:end].decode()
            off = end + 1
        elif typ == "B":
            code = chr(data[off])
            cnt = struct.unpack_from("<I", data, off + 1)[0]
            fmt = _TAG_FMT[code]
            sz = struct.calcsize(fmt)
            arr = list(struct.unpack_from(f"<{cnt}{fmt[1]}", data, off + 5))
            off += 5 + cnt * sz
            val = (code, arr)
        else:
            raise ValueError(f"unknown tag type {typ!r}")
        tags[key] = (typ, val)
    return tags


class BaiIndex:
    """BAI binning index: per-tid bins -> chunks + 16kb linear index."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("not a BAI file")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[List[int]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bd[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.bins.append(bd)
            self.linear.append(ioff)

    @staticmethod
    def region_bins(beg: int, end: int) -> List[int]:
        end -= 1
        out = [0]
        out += list(range(1 + (beg >> 26), 2 + (end >> 26)))
        out += list(range(9 + (beg >> 23), 10 + (end >> 23)))
        out += list(range(73 + (beg >> 20), 74 + (end >> 20)))
        out += list(range(585 + (beg >> 17), 586 + (end >> 17)))
        out += list(range(4681 + (beg >> 14), 4682 + (end >> 14)))
        return out

    def chunks(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if tid < 0 or tid >= len(self.bins):
            return []
        min_off = 0
        lin = self.linear[tid]
        w = beg >> 14
        if lin:
            min_off = lin[min(w, len(lin) - 1)] if w < len(lin) else lin[-1]
        raw = []
        for b in self.region_bins(beg, end):
            for c in self.bins[tid].get(b, ()):
                if c[1] > min_off:
                    raw.append(c)
        raw.sort()
        merged: List[Tuple[int, int]] = []
        for c in raw:
            if merged and c[0] <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
            else:
                merged.append(c)
        return merged


class BamReader:
    """BAM file reader with optional BAI region queries."""

    def __init__(self, path: str):
        self.path = path
        self._r = BgzfReader.open(path)
        magic = self._r.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._r.read(4))
        self.header_text = self._r.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._r.read(4))
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._r.read(4))
            name = self._r.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._r.read(4))
            self.references.append(name)
            self.lengths.append(l_ref)
        self._data_start = self._r.tell()
        self._index: Optional[BaiIndex] = None

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tid(self, name: str) -> int:
        try:
            return self.references.index(name)
        except ValueError:
            return -1

    def _read_record(self) -> Optional[BamRecord]:
        sz = self._r.read(4)
        if len(sz) < 4:
            return None
        (block_size,) = struct.unpack("<i", sz)
        data = self._r.read(block_size)
        if len(data) < block_size:
            return None
        return _decode_record(data)

    def __iter__(self) -> Iterator[BamRecord]:
        self._r.seek(self._data_start)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def _load_index(self) -> Optional[BaiIndex]:
        if self._index is None:
            for cand in (self.path + ".bai",
                         os.path.splitext(self.path)[0] + ".bai"):
                if os.path.exists(cand):
                    self._index = BaiIndex(cand)
                    break
        return self._index

    def fetch(self, contig: str, start: int = 0,
              end: Optional[int] = None) -> Iterator[BamRecord]:
        """Records overlapping [start, end) of contig (0-based)."""
        tid = self.tid(contig)
        if tid < 0:
            return
        if end is None:
            end = self.lengths[tid]
        idx = self._load_index()
        if idx is not None:
            chunk_list = idx.chunks(tid, start, end)
        else:
            chunk_list = [(self._data_start, 1 << 62)]  # full scan fallback
        for beg, stop in chunk_list:
            self._r.seek(beg)
            while self._r.tell() < stop:
                rec = self._read_record()
                if rec is None:
                    break
                if rec.tid != tid:
                    if rec.tid > tid or rec.tid == -1:
                        break
                    continue
                if rec.pos >= end:
                    break
                if rec.is_unmapped or rec.reference_end() <= start:
                    continue
                yield rec


def aligned_pairs(rec: BamRecord) -> List[Tuple[int, int]]:
    """(read_pos, ref_pos) pairs for M/=/X ops (CIGAR walk; spec:
    src/alignment/nanopolish_anchor.cpp:20-88)."""
    out = []
    rp = rec.pos
    qp = 0
    for op, l in rec.cigar:
        if op in (0, 7, 8):
            for i in range(l):
                out.append((qp + i, rp + i))
            qp += l
            rp += l
        elif op in (1, 4):
            qp += l
        elif op in (2, 3):
            rp += l
    return out


class BamWriter:
    """BAM writer (for modbam output and tests)."""

    def __init__(self, path: str, header_text: str, references: List[str],
                 lengths: List[int]):
        self._w = BgzfWriter.open(path)
        self.references = references
        payload = header_text.encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(payload)) + payload)
        self._w.write(struct.pack("<i", len(references)))
        for name, ln in zip(references, lengths):
            nb = name.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))

    def write(self, rec: BamRecord):
        data = self._encode(rec)
        self._w.write(struct.pack("<i", len(data)) + data)

    def _encode(self, rec: BamRecord) -> bytes:
        qname = rec.qname.encode() + b"\x00"
        l_seq = len(rec.seq)
        parts = [struct.pack("<iiBBHHHiiii", rec.tid, rec.pos, len(qname),
                             rec.mapq, _reg2bin(rec.pos, rec.reference_end() or rec.pos + 1),
                             len(rec.cigar), rec.flag, l_seq, rec.mtid,
                             rec.mpos, rec.tlen), qname]
        parts.append(struct.pack(f"<{len(rec.cigar)}I",
                                 *[(l << 4) | op for op, l in rec.cigar]))
        sb = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(rec.seq):
            v = _SEQ_ENC.get(c.upper(), 15)
            sb[i >> 1] |= v << 4 if i % 2 == 0 else v
        parts.append(bytes(sb))
        if rec.qual is None:
            parts.append(b"\xff" * l_seq)
        else:
            parts.append(bytes(bytearray(rec.qual)))
        for key, (typ, val) in rec.tags.items():
            parts.append(_encode_tag(key, typ, val))
        return b"".join(parts)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _encode_tag(key: str, typ: str, val) -> bytes:
    head = key.encode() + typ.encode()
    if typ in _TAG_FMT:
        return head + struct.pack(_TAG_FMT[typ], val)
    if typ == "A":
        return head + val.encode()
    if typ in "ZH":
        return head + str(val).encode() + b"\x00"
    if typ == "B":
        code, arr = val
        fmt = _TAG_FMT[code]
        return (head + code.encode() + struct.pack("<I", len(arr))
                + struct.pack(f"<{len(arr)}{fmt[1]}", *arr))
    raise ValueError(f"unknown tag type {typ!r}")


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


# ---- SAM text parsing (the read half of sam_read1; used by watch mode to
# ingest an external mapper's output, call_methylation.cpp:213-530) ----

def _parse_sam_record(line: str, tid_of: Dict[str, int]) -> BamRecord:
    import re as _re

    f = line.split("\t")
    qname, flag, rname, pos, mapq, cigar_s = f[:6]
    rnext, pnext, tlen, seq, qual = f[6:11]
    cigar = [(CIGAR_OPS.index(op), int(n))
             for n, op in _re.findall(r"(\d+)([MIDNSHP=X])", cigar_s)] \
        if cigar_s != "*" else []
    tags: Dict[str, Tuple[str, object]] = {}
    for t in f[11:]:
        key, typ, val = t.split(":", 2)
        if typ == "i":
            tags[key] = ("i", int(val))
        elif typ == "f":
            tags[key] = ("f", float(val))
        elif typ == "B":
            sub, *items = val.split(",")
            cast = int if sub in "cCsSiI" else float
            tags[key] = ("B", (sub, [cast(x) for x in items]))
        else:                                   # A, Z, H
            tags[key] = (typ, val)
    tid = tid_of.get(rname, -1)
    mtid = tid if rnext == "=" else tid_of.get(rnext, -1)
    qual_arr = None if qual == "*" else \
        (np.frombuffer(qual.encode(), np.uint8) - 33)
    return BamRecord(qname=("" if qname == "*" else qname), flag=int(flag),
                     tid=tid, pos=int(pos) - 1, mapq=int(mapq), cigar=cigar,
                     mtid=mtid, mpos=int(pnext) - 1, tlen=int(tlen),
                     seq=("" if seq == "*" else seq), qual=qual_arr,
                     tags=tags)


def parse_sam(path: str):
    """SAM text file -> (header_text, references, lengths, records)."""
    header_lines: List[str] = []
    references: List[str] = []
    lengths: List[int] = []
    body: List[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                header_lines.append(line)
                if line.startswith("@SQ"):
                    d = dict(p.split(":", 1) for p in line.split("\t")[1:]
                             if ":" in p)
                    references.append(d.get("SN", ""))
                    lengths.append(int(d.get("LN", "0")))
            else:
                body.append(line)
    tid_of = {n: i for i, n in enumerate(references)}
    recs = [_parse_sam_record(l, tid_of) for l in body]
    header = "\n".join(header_lines) + ("\n" if header_lines else "")
    return header, references, lengths, recs


def sam_to_bam(sam_path: str, bam_path: str) -> int:
    """Convert a SAM file to BAM (records kept in file order); returns the
    number of records written."""
    header, references, lengths, recs = parse_sam(sam_path)
    w = BamWriter(bam_path, header, references, lengths)
    n = 0
    for rec in recs:
        w.write(rec)
        n += 1
    w.close()
    return n
