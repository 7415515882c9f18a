"""BGZF (blocked gzip) reader/writer.

The reference links htslib for bgzf (reference: Makefile:90-99; used for
BAM and the bgzipped read fasta of ReadDB, src/nanopolish_read_db.cpp).
This is a standalone implementation: BGZF is a gzip stream made of
independent <=64 KiB deflate blocks, each carrying its compressed size in
the BSIZE extra field, addressable by virtual offsets
(coffset << 16 | uoffset).
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Optional

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<4BI2BH")          # magic/flags/mtime/xfl/os/xlen


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seek/tell."""

    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self._block: bytes = b""
        self._block_coffset = 0          # file offset of current block
        self._within = 0                 # uncompressed offset within block
        self._next_coffset = 0

    @classmethod
    def open(cls, path: str) -> "BgzfReader":
        return cls(open(path, "rb"))

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- block machinery ---------------------------------------------------
    def _load_block(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        hdr = self._fh.read(18)
        if len(hdr) < 18:
            self._block = b""
            self._block_coffset = coffset
            self._within = 0
            return False
        magic1, magic2, _, flg, _, _, _, xlen = _HDR.unpack(hdr[:12])
        if magic1 != 0x1F or magic2 != 0x8B or not (flg & 4):
            raise ValueError("not a BGZF block")
        extra = hdr[12:18] + self._fh.read(xlen - 6)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF BSIZE field missing")
        cdata = self._fh.read(bsize - xlen - 20)
        self._fh.read(8)  # crc32 + isize
        self._block = zlib.decompress(cdata, -15)
        self._block_coffset = coffset
        self._next_coffset = coffset + bsize
        self._within = 0
        return True

    # --- public API --------------------------------------------------------
    def tell(self) -> int:
        """Virtual offset of the next byte to be read."""
        if self._within == len(self._block) and self._block:
            return self._next_coffset << 16
        return (self._block_coffset << 16) | self._within

    def seek(self, voffset: int):
        coffset, within = voffset >> 16, voffset & 0xFFFF
        if coffset != self._block_coffset or not self._block:
            if not self._load_block(coffset):
                return
        self._within = within

    def read(self, n: int = -1) -> bytes:
        out = []
        if not self._block and not self._load_block(self._next_coffset):
            return b""
        while n != 0:
            avail = len(self._block) - self._within
            if avail == 0:
                if not self._load_block(self._next_coffset):
                    break
                if not self._block:   # EOF block
                    continue
                avail = len(self._block)
            take = avail if n < 0 else min(avail, n)
            out.append(self._block[self._within:self._within + take])
            self._within += take
            if n > 0:
                n -= take
        return b"".join(out)

    def readline(self) -> bytes:
        out = []
        while True:
            if self._within == len(self._block):
                if not self._load_block(self._next_coffset) or not self._block:
                    break
            nl = self._block.find(b"\n", self._within)
            if nl == -1:
                out.append(self._block[self._within:])
                self._within = len(self._block)
            else:
                out.append(self._block[self._within:nl + 1])
                self._within = nl + 1
                break
        return b"".join(out)


class BgzfWriter:
    def __init__(self, fh: BinaryIO, level: int = 6):
        self._fh = fh
        self._level = level
        self._buf = bytearray()

    @classmethod
    def open(cls, path: str, level: int = 6) -> "BgzfWriter":
        return cls(open(path, "wb"), level)

    def tell(self) -> int:
        return (self._fh.tell() << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf.extend(data)
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, chunk):
        chunk = bytes(chunk)
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 26        # 12 hdr + 6 extra + cdata + 8 tail
        hdr = struct.pack("<4BI2BH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<2BHH", 66, 67, 2, bsize - 1)
        tail = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
        self._fh.write(hdr + extra + cdata + tail)

    def flush(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()

    def close(self):
        self.flush()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        hdr = fh.read(18)
    if len(hdr) < 18 or hdr[0] != 0x1F or hdr[1] != 0x8B:
        return False
    return (hdr[3] & 4) != 0 and hdr[12:14] == b"BC"
