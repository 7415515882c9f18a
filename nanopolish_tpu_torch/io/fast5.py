"""FAST5 signal loading via HDF5 (h5py on the host).

Equivalent of the reference's fast5 I/O stack
(reference: src/io/nanopolish_fast5_io.cpp, nanopolish_fast5_loader.h:18-31):
opens single- or multi-read fast5, reads channel parameters, converts raw
ADC samples to picoamps with (raw + offset) * range / digitisation
(src/io/nanopolish_fast5_io.cpp:163-165).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class ChannelParams:
    digitisation: float
    offset: float
    range: float
    sample_rate: float


@dataclass
class Fast5Data:
    """Mirror of Fast5Data (io/nanopolish_fast5_loader.h:18-31)."""

    is_valid: bool
    read_name: str
    sequencing_kit: str
    experiment_type: str
    channel_params: ChannelParams
    rt: np.ndarray              # raw samples in pA, float32
    channel_id: int = 0
    start_time: int = 0


def _decode(v) -> str:
    if isinstance(v, bytes):
        return v.decode()
    return str(v)


class Fast5File:
    """One fast5 file; handles single-read and multi-read layouts."""

    def __init__(self, path: str):
        import h5py
        self.path = path
        self._h5 = h5py.File(path, "r")
        self._multi = any(k.startswith("read_") for k in self._h5.keys())

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_names(self) -> List[str]:
        if self._multi:
            return [k[5:] for k in self._h5.keys() if k.startswith("read_")]
        raw = self._h5.get("/Raw/Reads")
        if raw is None:
            return []
        out = []
        for k in raw.keys():
            rid = raw[k].attrs.get("read_id")
            if rid is not None:
                out.append(_decode(rid))
        return out

    def _group_for(self, read_name: Optional[str]):
        if self._multi:
            if read_name is None:
                names = self.read_names()
                read_name = names[0] if names else None
            g = self._h5.get(f"read_{read_name}")
            if g is None:
                return None, read_name
            return g, read_name
        return self._h5, read_name

    def load_read(self, read_name: Optional[str] = None) -> Fast5Data:
        g, read_name = self._group_for(read_name)
        if g is None:
            return Fast5Data(False, read_name or "", "", "",
                             ChannelParams(1, 0, 1, 4000), np.zeros(0, np.float32))
        try:
            ch = g["channel_id"].attrs if self._multi else \
                g["/UniqueGlobalKey/channel_id"].attrs
            params = ChannelParams(
                digitisation=float(ch["digitisation"]),
                offset=float(ch["offset"]),
                range=float(ch["range"]),
                sample_rate=float(ch["sampling_rate"]))
            channel_number = int(ch.get("channel_number", 0))

            ctx = g["context_tags"].attrs if self._multi and "context_tags" in g \
                else (g.get("/UniqueGlobalKey/context_tags").attrs
                      if not self._multi and "/UniqueGlobalKey/context_tags" in g else {})
            kit = _decode(ctx.get("sequencing_kit", ""))
            exp = _decode(ctx.get("experiment_type", "dna"))

            if self._multi:
                rgrp = g["Raw"]
                sig = rgrp["Signal"][:]
                rid = _decode(rgrp.attrs.get("read_id", read_name or ""))
                start_time = int(rgrp.attrs.get("start_time", 0))
            else:
                reads = g["/Raw/Reads"]
                key = None
                for k in reads.keys():
                    if read_name is None or \
                            _decode(reads[k].attrs.get("read_id", "")) == read_name:
                        key = k
                        break
                if key is None:
                    raise KeyError(read_name)
                rgrp = reads[key]
                sig = rgrp["Signal"][:]
                rid = _decode(rgrp.attrs.get("read_id", ""))
                start_time = int(rgrp.attrs.get("start_time", 0))

            pa = ((sig.astype(np.float32) + params.offset)
                  * (params.range / params.digitisation))
            return Fast5Data(True, rid, kit, exp, params, pa,
                             channel_id=channel_number, start_time=start_time)
        except Exception:
            return Fast5Data(False, read_name or "", "", "",
                             ChannelParams(1, 0, 1, 4000), np.zeros(0, np.float32))


def load_read(path: str, read_name: Optional[str] = None) -> Fast5Data:
    """Fast5Loader::load_read equivalent."""
    try:
        with Fast5File(path) as f:
            return f.load_read(read_name)
    except Exception:
        return Fast5Data(False, read_name or "", "", "",
                         ChannelParams(1, 0, 1, 4000), np.zeros(0, np.float32))
