"""ctypes loader for the native host helpers of the port.

Three host-sequential routines are shared with the JAX package as C++
sources in the repository's ``csrc/``: the scrappie-style peak detector
(``csrc/signal_ops.cpp``), the printf-exact eventalign and
call-methylation TSV row formatters (``csrc/tsv_format.cpp``) and the
per-read call-methylation task geometry (``csrc/meth_geometry.cpp``).
This module compiles exactly those three files with ``g++`` into
``build/nanopolish_tpu_torch/`` at first use and loads the result.  It never touches the JAX package's own library.
If no compiler is available, callers use their NumPy/Python paths (same
semantics, slower).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)
_CSRC_DIR = os.path.join(_REPO_DIR, "csrc")
_SOURCES = ("signal_ops.cpp", "tsv_format.cpp", "meth_geometry.cpp")
BUILD_DIR = os.path.join(_REPO_DIR, "build", "nanopolish_tpu_torch")
_LIB_PATH = os.path.join(BUILD_DIR, "libnpt_host.so")

_lock = threading.Lock()
_lib_wrapper = None
_load_attempted = False


class NativeLib:
    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        f = cdll.npt_peak_detect
        f.restype = ctypes.c_int64
        f.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int64),
        ]
        i64_ = ctypes.c_int64
        p64_ = ctypes.POINTER(ctypes.c_int64)
        pf_ = ctypes.POINTER(ctypes.c_float)
        pu8_ = ctypes.POINTER(ctypes.c_uint8)
        fe = cdll.npt_format_eventalign_rows
        fe.restype = i64_
        fe.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char,
            ctypes.c_char_p, i64_, ctypes.c_char_p, i64_, i64_,
            p64_, p64_, p64_, pu8_,
            pf_, pf_, pf_, pf_, pf_, pf_,
            i64_, ctypes.c_char_p, i64_,
        ]
        pd_ = ctypes.POINTER(ctypes.c_double)
        p32_ = ctypes.POINTER(ctypes.c_int32)
        fm = cdll.npt_format_methylation_rows
        fm.restype = i64_
        fm.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_char_p,
            ctypes.c_char_p,
            p64_, p64_, pd_, pd_, p64_, p64_, p64_, p64_,
            i64_, ctypes.c_char_p, i64_,
        ]
        m = cdll.npt_meth_geometry
        m.restype = i64_
        m.argtypes = [
            ctypes.c_char_p, i64_,                  # ref_seq
            p64_, i64_,                             # pairs
            i64_, i64_, i64_,                       # ref_start/region
            i64_, i64_, i64_, i64_,                 # sep/flank/k/rc
            ctypes.c_double,                        # max_ratio
            ctypes.c_char_p, i64_, ctypes.c_char_p,  # bases/size/compl
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            i64_, i64_,                             # n_sites, rl
            i64_, i64_,                             # cap_groups, k_cap
            p64_, p64_, p64_, p64_,                 # e1/estep/nev/nk
            p32_, p32_,                             # ranks_u/m
            p64_, p64_, p64_, p64_, p64_,           # positions/meta
        ]

    def format_methylation_rows(self, chrom: str, orientation: str,
                                qname: str, ref_seq: str, cols
                                ) -> Optional[str]:
        """Native call-methylation TSV row formatter (csrc/tsv_format.cpp);
        byte-identical to write_read_sites_cols' f-strings."""
        n = len(cols["pos"])
        max_seq = int((cols["seq_hi"] - cols["seq_lo"]).max()) if n else 0
        cap = n * (64 + max_seq + len(chrom) + len(qname)) + 1024
        out = ctypes.create_string_buffer(cap)
        P64 = ctypes.POINTER(ctypes.c_int64)
        PD = ctypes.POINTER(ctypes.c_double)
        a64 = lambda a: np.ascontiguousarray(a, np.int64).ctypes.data_as(P64)  # noqa: E731
        ad = lambda a: np.ascontiguousarray(a, np.float64).ctypes.data_as(PD)  # noqa: E731
        wrote = self._lib.npt_format_methylation_rows(
            chrom.encode(), ctypes.c_char(orientation.encode()),
            qname.encode(), ref_seq.encode(),
            a64(cols["pos"]), a64(cols["end"]),
            ad(cols["sum_u"]), ad(cols["sum_m"]),
            a64(cols["strands"]), a64(cols["n_motif"]),
            a64(cols["seq_lo"]), a64(cols["seq_hi"]),
            n, out, cap)
        if wrote < 0:
            return None
        return out.raw[:wrote].decode("ascii")

    def meth_geometry(self, ref_seq: str, pairs: np.ndarray,
                      ref_start_pos: int, region_start: int, region_end: int,
                      min_separation: int, min_flank: int, k: int, rc: bool,
                      max_ratio: float, alphabet, k_cap: int = 256):
        """One-call per-(read, strand) methylation task geometry
        (csrc/meth_geometry.cpp).  Returns a dict of group arrays with
        zero-padded [ng, k_cap] rank matrices, or None when the native
        routine declines (capacity exceeded) — callers then use the
        Python array path."""
        n_ref = len(ref_seq)
        pairs = np.ascontiguousarray(pairs, dtype=np.int64)
        cap = n_ref // (min_separation + 1) + 2
        # one int64 block for the 9 scalar outputs; two rank matrices
        meta = np.empty((9, cap), np.int64)
        ranks_u = np.empty((cap, k_cap), np.int32)
        ranks_m = np.empty((cap, k_cap), np.int32)
        spec = (alphabet.bases.encode("ascii"), len(alphabet.bases),
                alphabet.complements.encode("ascii"),
                "".join(alphabet.recognition_sites).encode("ascii"),
                "".join(alphabet.recognition_sites_methylated
                        ).encode("ascii"),
                "".join(alphabet.recognition_sites_methylated_complement
                        ).encode("ascii"),
                len(alphabet.recognition_sites),
                alphabet.recognition_length)
        P64 = ctypes.POINTER(ctypes.c_int64)
        P32 = ctypes.POINTER(ctypes.c_int32)
        base = meta.ctypes.data

        def mrow(i):
            return ctypes.cast(base + i * cap * 8, P64)

        ng = self._lib.npt_meth_geometry(
            ref_seq.encode("ascii"), n_ref,
            pairs.ctypes.data_as(P64), pairs.shape[0],
            ref_start_pos, region_start, region_end,
            min_separation, min_flank, k, int(rc),
            float(max_ratio), *spec, cap, k_cap,
            mrow(0), mrow(1), mrow(2), mrow(3),
            ranks_u.ctypes.data_as(P32), ranks_m.ctypes.data_as(P32),
            mrow(4), mrow(5), mrow(6), mrow(7), mrow(8))
        if ng < 0:
            return None
        return {"ng": int(ng), "e1": meta[0, :ng], "estep": meta[1, :ng],
                "nev": meta[2, :ng], "nk": meta[3, :ng],
                "ranks_u": ranks_u[:ng], "ranks_m": ranks_m[:ng],
                "start_pos": meta[4, :ng], "end_pos": meta[5, :ng],
                "n_motif": meta[6, :ng], "seq_lo": meta[7, :ng],
                "seq_hi": meta[8, :ng], "k_cap": k_cap}

    def format_eventalign_rows(self, ref_name: str, who: str,
                               strand_ch: str, seq: str, rcq: str, rc: bool,
                               k: int, rp, pos0, ev, is_b, em, es, ed,
                               mm, ms, sd) -> Optional[str]:
        """Native eventalign TSV row formatter (csrc/tsv_format.cpp);
        byte-identical to the Python f-string emitter."""
        fn = self._lib.npt_format_eventalign_rows
        n = len(rp)
        cap = n * (64 + 2 * k + len(ref_name) + len(who)) + 1024
        out = ctypes.create_string_buffer(cap)
        P64 = ctypes.POINTER(ctypes.c_int64)
        PF = ctypes.POINTER(ctypes.c_float)
        P8 = ctypes.POINTER(ctypes.c_uint8)
        a64 = lambda a: np.ascontiguousarray(a, np.int64).ctypes.data_as(P64)  # noqa: E731
        af = lambda a: np.ascontiguousarray(a, np.float32).ctypes.data_as(PF)  # noqa: E731
        wrote = fn(ref_name.encode(), who.encode(),
                   ctypes.c_char(strand_ch.encode()),
                   seq.encode(), len(seq),
                   rcq.encode() if rcq else b"", int(rc), k,
                   a64(rp), a64(pos0), a64(ev),
                   np.ascontiguousarray(is_b, np.uint8).ctypes.data_as(P8),
                   af(em), af(es), af(ed), af(mm), af(ms), af(sd),
                   n, out, cap)
        if wrote < 0:
            return None
        return out.raw[:wrote].decode("ascii")

    def peak_detect(self, tstat1: np.ndarray, tstat2: np.ndarray,
                    wl1: int, wl2: int, th1: float, th2: float,
                    peak_height: float) -> np.ndarray:
        t1 = np.ascontiguousarray(tstat1, dtype=np.float32)
        t2 = np.ascontiguousarray(tstat2, dtype=np.float32)
        n = len(t1)
        out = np.empty(n, dtype=np.int64)
        cnt = self._lib.npt_peak_detect(
            t1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, wl1, wl2, th1, th2, peak_height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out[:cnt]


def _stale() -> bool:
    """The library is missing, or older than a source or than this module
    (which lists the sources and their entry points)."""
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    deps = [os.path.join(_CSRC_DIR, s) for s in _SOURCES] + [__file__]
    return any(os.path.getmtime(d) > built for d in deps)


def _build() -> bool:
    """g++ the host sources into a private temp file, then rename it
    into place, so concurrent processes never load a half-written
    library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp] + \
        [os.path.join(_CSRC_DIR, s) for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_native_lib() -> Optional[NativeLib]:
    global _lib_wrapper, _load_attempted
    if _lib_wrapper is not None or _load_attempted:
        return _lib_wrapper
    with _lock:
        if _lib_wrapper is not None or _load_attempted:
            return _lib_wrapper
        _load_attempted = True
        if _stale() and os.path.isdir(_CSRC_DIR):
            _build()
        if os.path.exists(_LIB_PATH):
            _lib_wrapper = NativeLib(ctypes.CDLL(_LIB_PATH))
    return _lib_wrapper
