"""SLOW5/BLOW5 signal file reading (slow5lib-equivalent subset).

The reference reads SLOW5 via slow5lib with an index
(reference: src/nanopolish_read_db.cpp:75-101, src/nanopolish_index.cpp
slow5 branch; Makefile:111-115).  BLOW5 is the preferred bulk signal format
for streaming to TPU hosts: record-compressed (zlib/zstd), indexable,
HDF5-free.

Format (slow5 spec v1.0):
  BLOW5 header: magic "BLOW5\\x01" (8 bytes incl version+flags), attributes
  as a zlib'd TSV header block; records: [u32 record_len][record bytes],
  each optionally zlib/zstd compressed; signal either plain int16 or
  svb-zd (StreamVByte + zig-zag delta) compressed — both supported here
  (see ``_svb_decode``).
"""

from __future__ import annotations

import struct
import warnings as _warnings
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .fast5 import ChannelParams, Fast5Data


@dataclass
class Slow5Record:
    read_id: str
    read_group: int
    digitisation: float
    offset: float
    range: float
    sampling_rate: float
    len_raw_signal: int
    raw_signal: np.ndarray       # int16 ADC
    aux: Dict[str, object]

    def to_pa(self) -> np.ndarray:
        return ((self.raw_signal.astype(np.float32) + self.offset)
                * (self.range / self.digitisation))

    def to_fast5_data(self, kit: str = "", experiment_type: str = "dna") -> Fast5Data:
        ch = ChannelParams(self.digitisation, self.offset, self.range,
                           self.sampling_rate)
        channel = self.aux.get("channel_number", 0)
        try:
            channel = int(channel)
        except (TypeError, ValueError):
            channel = 0
        return Fast5Data(True, self.read_id, kit, experiment_type, ch,
                         self.to_pa(), channel_id=channel,
                         start_time=int(self.aux.get("start_time", 0) or 0))


_PRIMARY = ["read_id", "read_group", "digitisation", "offset", "range",
            "sampling_rate", "len_raw_signal", "raw_signal"]

_AUX_STRUCT = {
    "int8_t": "b", "uint8_t": "B", "int16_t": "h", "uint16_t": "H",
    "int32_t": "i", "uint32_t": "I", "int64_t": "q", "uint64_t": "Q",
    "float": "f", "double": "d", "char": "c",
}


class Slow5File:
    """Reader for ASCII .slow5 and binary .blow5 with optional .idx."""

    def __init__(self, path: str):
        self.path = path
        self.header_attrs: Dict[str, List[str]] = {}
        self.aux_names: List[str] = []
        self.aux_types: List[str] = []
        self._index: Optional[Dict[str, Tuple[int, int]]] = None
        with open(path, "rb") as fh:
            magic = fh.read(8)
        self._binary = magic[:5] == b"BLOW5"
        if self._binary:
            self._parse_blow5_header()
        else:
            self._parse_slow5_header()

    # ---------------- BLOW5 ----------------
    def _parse_blow5_header(self):
        fh = open(self.path, "rb")
        self._fh = fh
        magic = fh.read(8)
        assert magic[:5] == b"BLOW5"
        fh.read(2)  # version minor/patch already in bytes 5..7; layout: 5,1,0
        (self.compression,) = struct.unpack("<B", fh.read(1))
        (self.signal_compression,) = struct.unpack("<B", fh.read(1))
        (self.n_read_groups,) = struct.unpack("<I", fh.read(4))
        fh.read(4)  # padding
        (hdr_len,) = struct.unpack("<I", fh.read(4))
        hdr = fh.read(hdr_len)
        if hdr[:2] == b"\x78\x9c" or self.compression:
            try:
                hdr = zlib.decompress(hdr)
            except zlib.error:
                pass
        self._parse_header_text(hdr.decode(errors="replace"))
        self._data_start = fh.tell()

    def _parse_header_text(self, text: str):
        for line in text.splitlines():
            if line.startswith("@"):
                f = line[1:].split("\t")
                self.header_attrs[f[0]] = f[1:]
            elif line.startswith("#char*") or line.startswith("#read_id"):
                f = line[1:].split("\t")
                if f[0] in ("read_id", "char*"):
                    if line.startswith("#read_id"):
                        names = f
                        if names[:len(_PRIMARY)] == _PRIMARY:
                            self.aux_names = names[len(_PRIMARY):]
                    else:
                        types = f
                        self.aux_types = types[len(_PRIMARY):]

    # ---------------- SLOW5 ASCII ----------------
    def _parse_slow5_header(self):
        self._fh = open(self.path, "rb")
        pos = 0
        for raw in self._fh:
            line = raw.decode(errors="replace").rstrip("\n")
            if line.startswith("@"):
                f = line[1:].split("\t")
                self.header_attrs[f[0]] = f[1:]
            elif line.startswith("#") and "read_id" in line:
                names = line[1:].split("\t")
                if names[:len(_PRIMARY)] == _PRIMARY:
                    self.aux_names = names[len(_PRIMARY):]
            elif line.startswith("#"):
                types = line[1:].split("\t")
                self.aux_types = types[len(_PRIMARY):]
            else:
                break
            pos = self._fh.tell()
        self._data_start = pos
        self._fh.seek(pos)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------- record decode ----------------
    def _decode_binary_record(self, data: bytes) -> Slow5Record:
        if self.compression == 1:       # zlib
            data = zlib.decompress(data)
        elif self.compression == 2:     # zstd
            import zstandard
            data = zstandard.ZstdDecompressor().decompress(
                data, max_output_size=1 << 30)
        off = 0
        (rid_len,) = struct.unpack_from("<H", data, off); off += 2
        read_id = data[off:off + rid_len].decode(); off += rid_len
        (read_group,) = struct.unpack_from("<I", data, off); off += 4
        dig, offs, rng, rate = struct.unpack_from("<dddd", data, off); off += 32
        (n_sig,) = struct.unpack_from("<Q", data, off); off += 8
        if self.signal_compression == 0:
            sig = np.frombuffer(data, "<i2", count=n_sig, offset=off)
            off += 2 * n_sig
        else:
            sig, off = _svb_decode(data, off, n_sig, self.signal_compression)
        aux: Dict[str, object] = {}
        for name, typ in zip(self.aux_names, self.aux_types):
            if off >= len(data):
                break
            if typ.endswith("*"):       # array/string
                (ln,) = struct.unpack_from("<Q", data, off); off += 8
                base = typ[:-1]
                if base == "char":
                    aux[name] = data[off:off + ln].decode(errors="replace")
                    off += ln
                else:
                    code = _AUX_STRUCT[base]
                    sz = struct.calcsize(code)
                    aux[name] = list(struct.unpack_from(f"<{ln}{code}", data, off))
                    off += ln * sz
            else:
                code = _AUX_STRUCT.get(typ)
                if code is None:
                    break
                v = struct.unpack_from("<" + code, data, off)[0]
                off += struct.calcsize(code)
                aux[name] = v.decode() if isinstance(v, bytes) else v
        return Slow5Record(read_id, read_group, dig, offs, rng, rate,
                           n_sig, np.asarray(sig), aux)

    def _decode_ascii_record(self, line: str) -> Slow5Record:
        f = line.rstrip("\n").split("\t")
        if f[7] and f[7] != ".":
            try:
                # C-speed text parse (~5x the split+array path); numpy 2
                # still supports the sep= text mode of fromstring
                with _warnings.catch_warnings():
                    _warnings.simplefilter("ignore", DeprecationWarning)
                    sig = np.fromstring(f[7], dtype=np.int16, sep=",")
            except (ValueError, AttributeError):
                sig = np.array(f[7].split(","), dtype=np.int16)
        else:
            sig = np.zeros(0, np.int16)
        aux = dict(zip(self.aux_names, f[8:]))
        return Slow5Record(f[0], int(f[1]), float(f[2]), float(f[3]),
                           float(f[4]), float(f[5]), int(f[6]), sig, aux)

    # ---------------- iteration / random access ----------------
    def __iter__(self) -> Iterator[Slow5Record]:
        self._fh.seek(self._data_start)
        if self._binary:
            while True:
                hdr = self._fh.read(4)
                if len(hdr) < 4:
                    return
                (rlen,) = struct.unpack("<I", hdr)
                if rlen == 0xFFFFFFFF:  # EOF marker "5WOLB"
                    return
                data = self._fh.read(rlen)
                if len(data) < rlen:
                    return
                try:
                    yield self._decode_binary_record(data)
                except Exception:
                    return
        else:
            for raw in self._fh:
                line = raw.decode(errors="replace")
                if line.strip():
                    yield self._decode_ascii_record(line)

    def build_index(self) -> Dict[str, Tuple[int, int]]:
        """read_id -> (file offset, record length). Written as .idx-like TSV."""
        idx: Dict[str, Tuple[int, int]] = {}
        self._fh.seek(self._data_start)
        if self._binary:
            while True:
                pos = self._fh.tell()
                hdr = self._fh.read(4)
                if len(hdr) < 4:
                    break
                (rlen,) = struct.unpack("<I", hdr)
                if rlen == 0xFFFFFFFF:
                    break
                data = self._fh.read(rlen)
                if len(data) < rlen:
                    break
                try:
                    rec = self._decode_binary_record(data)
                except Exception:
                    break
                idx[rec.read_id] = (pos, rlen + 4)
        else:
            while True:
                pos = self._fh.tell()
                raw = self._fh.readline()
                if not raw:
                    break
                line = raw.decode(errors="replace")
                if line.strip():
                    rid = line.split("\t", 1)[0]
                    idx[rid] = (pos, len(raw))
        self._index = idx
        return idx

    def get_read(self, read_id: str) -> Optional[Slow5Record]:
        if self._index is None:
            self.build_index()
        loc = self._index.get(read_id)
        if loc is None:
            return None
        self._fh.seek(loc[0])
        if self._binary:
            (rlen,) = struct.unpack("<I", self._fh.read(4))
            return self._decode_binary_record(self._fh.read(rlen))
        return self._decode_ascii_record(self._fh.read(loc[1]).decode())


def _svb_decode(data: bytes, off: int, n: int, mode: int):
    """StreamVByte + zigzag + delta decode (signal compression 1 = svb-zd)."""
    key_len = (n + 3) // 4
    keys = data[off:off + key_len]
    p = off + key_len
    out = np.empty(n, np.int64)
    for i in range(n):
        code = (keys[i >> 2] >> ((i & 3) * 2)) & 3
        nb = code + 1
        v = int.from_bytes(data[p:p + nb], "little")
        p += nb
        out[i] = v
    # zigzag decode then cumulative delta
    out = (out >> 1) ^ -(out & 1)
    out = np.cumsum(out)
    return out.astype(np.int16), p


class Blow5Writer:
    """Binary BLOW5 writer (the production bulk-signal format: binary
    records decode with one np.frombuffer instead of per-sample text
    parsing — ~20x faster signal loads than ASCII .slow5).  Matches
    this module's reader layout: 24-byte preamble, zlib'd TSV header
    block, [u32 len][record] stream, 0xFFFFFFFF EOF marker.  Aux
    columns mirror Slow5Writer (start_time uint64, channel_number
    int32)."""

    def __init__(self, path: str, record_compression: int = 0):
        assert record_compression in (0, 1)      # none | zlib
        self._comp = record_compression
        self._fh = open(path, "wb")
        hdr_text = ("#slow5_version\t2.0.0\n"
                    "#num_read_groups\t1\n"
                    "@asic_id\t0\n"
                    "#" + "\t".join(["char*", "uint32_t", "double",
                                     "double", "double", "double",
                                     "uint64_t", "int16_t*", "uint64_t",
                                     "int32_t"]) + "\n"
                    "#" + "\t".join(_PRIMARY + ["start_time",
                                                "channel_number"]) + "\n")
        hdr = zlib.compress(hdr_text.encode("ascii"))
        # 8-byte magic block + 2 version bytes (reader preamble layout)
        self._fh.write(b"BLOW5\x01\x00\x00" + b"\x00\x00")
        self._fh.write(struct.pack("<BBI4xI", self._comp, 0, 1, len(hdr)))
        self._fh.write(hdr)

    def write(self, read_id: str, raw_adc: np.ndarray, digitisation: float,
              offset: float, range_: float, sampling_rate: float,
              start_time: int = 0, channel: int = 0):
        rid = read_id.encode("ascii")
        sig = np.ascontiguousarray(raw_adc, "<i2")
        rec = (struct.pack("<H", len(rid)) + rid
               + struct.pack("<Idddd Q".replace(" ", ""), 0, digitisation,
                             offset, range_, sampling_rate, len(sig))
               + sig.tobytes()
               + struct.pack("<Qi", start_time, channel))
        if self._comp == 1:
            rec = zlib.compress(rec)
        self._fh.write(struct.pack("<I", len(rec)))
        self._fh.write(rec)

    def close(self):
        self._fh.write(struct.pack("<I", 0xFFFFFFFF))  # EOF marker
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Slow5Writer:
    """ASCII slow5 writer (for tests and interchange)."""

    def __init__(self, path: str, sample_rate: float = 4000.0,
                 digitisation: float = 8192.0):
        self._fh = open(path, "w")
        self._fh.write("#slow5_version\t2.0.0\n")
        self._fh.write("#num_read_groups\t1\n")
        self._fh.write("@asic_id\t0\n")
        self._fh.write("#" + "\t".join(["char*", "uint32_t", "double", "double",
                                        "double", "double", "uint64_t",
                                        "int16_t*", "uint64_t", "int32_t"]) + "\n")
        self._fh.write("#" + "\t".join(_PRIMARY + ["start_time",
                                                   "channel_number"]) + "\n")

    def write(self, read_id: str, raw_adc: np.ndarray, digitisation: float,
              offset: float, range_: float, sampling_rate: float,
              start_time: int = 0, channel: int = 0):
        sig = ",".join(map(str, np.asarray(raw_adc).astype(int).tolist()))
        self._fh.write(f"{read_id}\t0\t{digitisation}\t{offset}\t{range_}\t"
                       f"{sampling_rate}\t{len(raw_adc)}\t{sig}\t{start_time}\t{channel}\n")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
