"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C entry point
(``npt_launch_<name>``), loaded with ``ctypes``.  All sources are
compiled concurrently (one ``nvcc`` each) at first use, into
``build/nanopolish_tpu_torch/`` at the repository root, and rebuilt when a
source is newer than its library.  A failed build raises with the
compiler's output; nothing falls back to another implementation.

``LAUNCHES`` holds one plain integer per kernel.  Each wrapper adds one
(``count_launch``, under a lock: loader threads launch kernels too) where
it launches its kernel and nowhere else, so a run can show which kernels
its main path went through.  ``CHAIN_BANDS`` counts, for the banded
fill, the serial bands each launch runs: its launches, its chains (each
launch's n_bands, the length of its longest read's band loop at most)
and its read bands (B x n_bands), from the shapes on the host with no
device sync; with the kernel's device seconds they give ns per chain
band.  The NPT_PROFILE report prints them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

from .profiler import profile_scope

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "nanopolish_tpu_torch")
KERNELS = ("banded_fill", "banded_backtrack", "viterbi_fill",
           "viterbi_backtrack", "forward_fill", "forward_indexed",
           "seg_viterbi_fill", "seg_backtrack", "chain_step",
           "forward_table")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# [launches, chain bands, read bands] of the kernels with a band chain
CHAIN_BANDS: Dict[str, List[int]] = {"banded_fill": [0, 0, 0]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the npt_launch_* entry points, without the trailing stream
_ARGTYPES = {
    "banded_fill": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _F, _F, _I, _I,
                    _P, _P, _P, _P, _P],
    "banded_backtrack": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I,
                         _P, _P, _P, _P],
    "viterbi_fill": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F,
                     _F, _F, _I, _P, _P],
    "viterbi_backtrack": [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    "forward_fill": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F,
                     _F, _F, _I, _P, _P],
    "forward_indexed": [_P, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _F,
                        _F, _F, _F, _I, _I, _I, _I, _I, _P, _P, _I, _I],
    "seg_viterbi_fill": [_P, _I, _I, _P, _P, _P, _P, _P],
    "seg_backtrack": [_P, _I, _I, _P, _P, _P],
    "forward_table": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _F, _F, _F,
                      _P, _I, _P, _P],
    "chain_step": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                   _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for c in CHAIN_BANDS.values():
            c[:] = [0, 0, 0]


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def count_chain_bands(name: str, n_bands: int, B: int) -> None:
    """One launch of a band-chain kernel: n_bands serial bands on each
    of B reads."""
    with _count_lock:
        c = CHAIN_BANDS[name]
        c[0] += 1
        c[1] += n_bands
        c[2] += B * n_bands


def chain_band_lines() -> List[str]:
    """The NPT_PROFILE report's lines of CHAIN_BANDS (none unused)."""
    with _count_lock:
        return [f"[profile] {name} chain: {n} launches, {chain} chain "
                f"bands, {reads} read bands"
                for name, (n, chain, reads) in CHAIN_BANDS.items() if n]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of nanopolish_tpu_torch are built at first use")
    return found


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    srcs = [os.path.join(CSRC_DIR, f"{name}.cu")] + [
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")]
    return any(os.path.getmtime(s) > built for s in srcs)


def build_kernels(force: bool = False, verbose: bool = False) -> float:
    """Compile every stale kernel source, all nvcc processes at once.
    Returns the wall seconds spent; raises RuntimeError on any failure.
    With ``verbose`` the ptxas resource usage lands in BUILD_LOG."""
    with profile_scope("cuda_build.build") as span:
        todo = [n for n in KERNELS if force or _stale(n)]
        if span:
            span.args = {"kernels": todo}
        return _build(todo, verbose) if todo else 0.0


def _build(todo, verbose: bool) -> float:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) + \
            ["-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def kernel_fn(name: str):
    """The ctypes entry point ``npt_launch_<name>`` (building on first use)."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            build_kernels()
            with profile_scope("cuda_build.load"):
                for n in KERNELS:
                    f = getattr(ctypes.CDLL(lib_path(n)),
                                f"npt_launch_{n}")
                    f.argtypes = _ARGTYPES[n] + [_P]          # + stream
                    f.restype = ctypes.c_int
                    _fns[n] = f
    return _fns[name]


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point on the current stream; raise if the
    launch was refused (its cudaGetLastError is not 0)."""
    import torch

    err = kernel_fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless t has the dtype, shape and device a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_cuda(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}; "
                         "use a CUDA or CPU tensor")
