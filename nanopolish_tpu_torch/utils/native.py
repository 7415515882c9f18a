"""ctypes loader for the native host helpers of the port.

Two host-sequential routines are shared with the JAX package as C++
sources in the repository's ``csrc/``: the scrappie-style peak detector
(``csrc/signal_ops.cpp``) and the printf-exact eventalign TSV row
formatter (``csrc/tsv_format.cpp``).  This module compiles exactly those
two files with ``g++`` into ``build/nanopolish_tpu_torch/`` at first use
and loads the result.  It never touches the JAX package's own library.
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
_SOURCES = ("signal_ops.cpp", "tsv_format.cpp")
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
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_CSRC_DIR, s)) > built
               for s in _SOURCES)


def _build() -> bool:
    """g++ the two host sources into a private temp file, then rename it
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
