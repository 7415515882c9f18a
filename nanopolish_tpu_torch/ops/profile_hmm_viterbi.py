"""Profile-HMM Viterbi alignment on the card.

Counterpart of the Viterbi half of ``nanopolish_tpu/ops/pallas_profile_hmm.py``
(``_vit_kernel``, ``_vit_backtrack_kernel``, ``_expand_backtrack``): the
hand-written CUDA kernels ``csrc/viterbi_fill.cu`` and
``csrc/viterbi_backtrack.cu``, returning the same per-segment
``(event_offsets, kmer_idxs, state_string)``.

Each wrapper takes tensors on one device.  For CPU tensors it runs its
kernel's plain version from ``ops/profile_hmm.py``; for CUDA tensors it
launches the kernel (building it at first use) or raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import resolve_device
from .banded_align import emission_constant
from .profile_hmm import (_CLIP_BASE, _CLIP_STEP, _LOG1M_CLIP,
                          HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP,
                          make_transitions, paths_to_segments,
                          viterbi_backtrack_plain, viterbi_fill_plain)


def kmer_width(n_kmers_max: int) -> int:
    """The profile-HMM kernels' kmer width (Viterbi and Forward): the
    smallest power of two >= 32 that holds n_kmers_max kmers."""
    kp = 32
    while kp < n_kmers_max:
        kp *= 2
    return kp


# widest row the warp kernels hold: 32 lanes x 8 kmers
ROW_WARP_MAX = 256
# widest row the block kernels hold: one thread per kmer
ROW_BLOCK_MAX = 1024
# the wide row (csrc/profile_hmm_wide.cuh): at most WIDE_MAX_THREADS
# kmer threads a CTA (beside its tree warp) and WIDE_MAX_CLUSTER CTAs a
# segment (16: a non-portable cluster size, which an H100 places; faster
# on the train step's reads than 8: PERF.md §6, tools/probe_hmm_rows.py
# --wide-cluster), at least WIDE_MIN_CTA_KMERS kmers a CTA; the fixed
# shared memory of a CTA ahead of its row buffer (NPT_WIDE_FIXED_BYTES)
WIDE_MAX_THREADS = 512
WIDE_MAX_CLUSTER = 16
WIDE_MIN_CTA_KMERS = 256
WIDE_FIXED_BYTES = 1024
# shared memory of one block on sm_90 (227 KB)
SMEM_BLOCK_MAX = 232448
# SMs of an H100 SXM (the wide row's default; the wrappers read the card's)
H100_SMS = 132
# the backtrack's staged trace tile (csrc/viterbi_backtrack.cu TILE_BYTES)
# and its widest kmer window
BT_TILE_BYTES = 8192
BT_WINDOW_MAX = 256


def row_layout(kp: int) -> Tuple[str, Optional[int]]:
    """How the profile-HMM fills (csrc/viterbi_fill.cu, forward_fill.cu)
    lay out a row of ``kp`` kmers, a ``kmer_width``: ``("warp", kp // 32)``
    up to 256 kmers (one warp per segment, that many kmers per lane),
    ``("block", 0)`` up to 1,024 (one block of kp threads per segment),
    else ``("wide", None)``: the wide row (csrc/profile_hmm_wide.cuh), whose
    geometry depends on the batch too (``wide_layout``).  The second value
    is the kernels' ``kpl`` argument."""
    if kp != kmer_width(kp):
        raise ValueError(f"kmer width {kp} must be a power of two >= 32")
    if kp <= ROW_WARP_MAX:
        return ("warp", kp // 32)
    return ("block", 0) if kp <= ROW_BLOCK_MAX else ("wide", None)


class WideLayout(NamedTuple):
    """One launch's geometry on the wide row: ``threads`` a CTA (its kmer
    threads and the tree warp's 32), ``per_thread`` kmers a kmer thread
    (the kernels' ``kpl``), ``cluster`` CTAs a segment, its rows in
    ``"shared"`` memory or global ``"scratch"``, ``smem`` bytes of dynamic
    shared memory a CTA and ``scratch`` bytes of global scratch a segment
    (0 in shared memory)."""
    threads: int
    per_thread: int
    cluster: int
    rows: str
    smem: int
    scratch: int


def wide_layout(kp: int, B: int, trace: bool,
                n_sms: int = H100_SMS) -> WideLayout:
    """The wide row's geometry for B segments of kmer width kp (> 1,024)
    on a card of n_sms SMs: the largest cluster (a power of two up to
    WIDE_MAX_CLUSTER) that keeps all B x cluster CTAs on the card at once
    and at least WIDE_MIN_CTA_KMERS kmers a CTA, so that a small batch
    spreads each segment over several SMs and a large one keeps one CTA a
    segment; then up to WIDE_MAX_THREADS kmer threads a CTA, and its tree
    warp.  A CTA's rows
    (12 bytes a kmer, 13 with the Viterbi's trace bits) stay in shared
    memory when they fit beside its fixed part, else go to global
    scratch."""
    if kp != kmer_width(kp) or kp <= ROW_BLOCK_MAX:
        raise ValueError(f"kmer width {kp} is not a wide-row width")
    cluster = 1
    while (2 * cluster <= WIDE_MAX_CLUSTER and B * 2 * cluster <= n_sms
           and kp // (2 * cluster) >= WIDE_MIN_CTA_KMERS):
        cluster *= 2
    n = kp // cluster
    kmer_threads = min(WIDE_MAX_THREADS, n)
    geometry = (kmer_threads + 32, n // kmer_threads, cluster)
    row_bytes = n * (13 if trace else 12)
    if WIDE_FIXED_BYTES + row_bytes <= SMEM_BLOCK_MAX:
        return WideLayout(*geometry, "shared", WIDE_FIXED_BYTES + row_bytes,
                          0)
    return WideLayout(*geometry, "scratch", WIDE_FIXED_BYTES,
                      cluster * row_bytes)


def backtrack_tile(kp: int) -> Tuple[int, int]:
    """(rows, window) of the trace tile csrc/viterbi_backtrack.cu stages in
    shared memory for a ``kmer_width`` kp: a window of the whole row up to
    256 kmers, else of 256 kmers, and as many rows as fill BT_TILE_BYTES."""
    window = min(kp, BT_WINDOW_MAX)
    return BT_TILE_BYTES // window, window


def fill_geometry(kp: int, B: int, trace: bool, dev):
    """(kpl, threads, cluster, scratch) of a fill launch of B segments at
    kmer width kp on dev: the warp and block rows' kpl (threads and cluster
    0, no scratch), or the wide row's ``wide_layout`` on dev's SMs with its
    scratch tensor (None in shared memory)."""
    mode, kpl = row_layout(kp)
    if mode != "wide":
        return kpl, 0, 0, None
    lay = wide_layout(kp, B, trace, card_sms(dev))
    return (lay.per_thread, lay.threads, lay.cluster,
            wide_scratch(lay, B, dev))


def card_sms(dev) -> int:
    """SMs of the card dev (a CUDA device)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def wide_scratch(lay: WideLayout, B: int, dev):
    """The wide row's global row buffers of B segments (``lay.scratch``
    bytes each, as uint8) when its rows are in scratch, else None."""
    if lay.rows != "scratch":
        return None
    return torch.empty(B * lay.scratch, dtype=torch.uint8, device=dev)


def viterbi_fill(levels, n_events, mu, sigma, c, n_kmers, trans, clips,
                 out=None):
    """Viterbi fill with trace [B, T, KP] uint8 (``viterbi_fill_plain``
    layout); the kmer tables are [B, KP] with KP from ``kmer_width``, laid
    out on the card as ``row_layout`` says.  ``out``: a trace tensor to
    write into (and return) instead of a new one."""
    if levels.device.type == "cpu":
        trace = viterbi_fill_plain(levels, n_events, mu, sigma, c, n_kmers,
                                   trans, clips)
        return trace if out is None else out.copy_(trace)
    cuda_build.require_cuda(levels)
    dev = levels.device
    B, T = levels.shape
    KP = mu.shape[1]
    f32, i32 = torch.float32, torch.int32
    cuda_build.check_tensor("levels", levels, f32, (B, T), dev)
    for nm, t in (("mu", mu), ("sigma", sigma), ("c", c)):
        cuda_build.check_tensor(nm, t, f32, (B, KP), dev)
    cuda_build.check_tensor("n_events", n_events, i32, (B,), dev)
    cuda_build.check_tensor("n_kmers", n_kmers, i32, (B,), dev)
    cuda_build.check_tensor("trans", trans, f32, (B, 8), dev)
    cuda_build.check_tensor("clips", clips, torch.uint8, (B, 2), dev)
    if out is None:
        trace = torch.empty((B, T, KP), dtype=torch.uint8, device=dev)
    else:
        cuda_build.check_tensor("out", out, torch.uint8, (B, T, KP), dev)
        trace = out
    kpl, threads, cluster, scratch = fill_geometry(KP, B, True, dev)
    cuda_build.launch(
        "viterbi_fill", levels.data_ptr(), T, mu.data_ptr(), sigma.data_ptr(),
        c.data_ptr(), KP, kpl, threads, cluster, n_events.data_ptr(),
        n_kmers.data_ptr(),
        trans.data_ptr(), clips.data_ptr(), float(np.float32(_LOG1M_CLIP)),
        float(np.float32(_CLIP_BASE)), float(np.float32(_CLIP_STEP)), B,
        trace.data_ptr(), None if scratch is None else scratch.data_ptr())
    cuda_build.count_launch("viterbi_fill")
    return trace


def viterbi_backtrack(trace, n_events, n_kmers, out=None):
    """Traceback paths [B, 1 + T + KP] int64 (``viterbi_backtrack_plain``
    layout; entries past each path's length are unspecified).  ``out``: a
    path tensor to write into (and return) instead of a new one."""
    if trace.device.type == "cpu":
        path = viterbi_backtrack_plain(trace, n_events, n_kmers)
        return path if out is None else out.copy_(path)
    cuda_build.require_cuda(trace)
    dev = trace.device
    B, T, KP = trace.shape
    cuda_build.check_tensor("trace", trace, torch.uint8, (B, T, KP), dev)
    cuda_build.check_tensor("n_events", n_events, torch.int32, (B,), dev)
    cuda_build.check_tensor("n_kmers", n_kmers, torch.int32, (B,), dev)
    if trace.data_ptr() % 16:
        raise ValueError("trace: the kernel stages it in 16-byte copies and "
                         "needs a 16-byte aligned start")
    rows, window = backtrack_tile(KP)
    if out is None:
        path = torch.empty((B, 1 + T + KP), dtype=torch.int64, device=dev)
    else:
        cuda_build.check_tensor("out", out, torch.int64, (B, 1 + T + KP), dev)
        path = out
    cuda_build.launch("viterbi_backtrack", trace.data_ptr(), T, KP, window,
                      rows, n_events.data_ptr(), n_kmers.data_ptr(), B,
                      path.data_ptr())
    cuda_build.count_launch("viterbi_backtrack")
    return path


def prepare_viterbi_inputs(levels, n_events, mu, sigma, n_kmers,
                           events_per_base, flags, indel_bias: float = 1.0,
                           trans=None, device=None):
    """Host arrays -> padded kernel tensors on ``device`` (``cuda`` unless
    ``cpu`` is asked).  levels [B, T]
    and mu/sigma [B, K] numpy f32 with the valid prefix given by
    n_events/n_kmers; flags per segment (HAF_*).  The log terms stay numpy:
    ``c = LOG_INV_SQRT_2PI - log(sigma)`` and the transition table."""
    device = resolve_device(device)
    levels = np.asarray(levels, np.float32)
    mu = np.asarray(mu, np.float32)
    sigma = np.asarray(sigma, np.float32)
    n_events = np.asarray(n_events, np.int32).reshape(-1)
    n_kmers = np.asarray(n_kmers, np.int32).reshape(-1)
    B, K0 = mu.shape
    KP = kmer_width(max(K0, 1))
    mu_p = np.zeros((B, KP), np.float32)
    sg_p = np.ones((B, KP), np.float32)
    mu_p[:, :K0] = mu
    sg_p[:, :K0] = sigma
    if trans is None:
        trans = make_transitions(events_per_base, indel_bias)
    flags = np.broadcast_to(np.asarray(flags, np.int32), (B,))
    clips = np.stack([(flags & HAF_ALLOW_PRE_CLIP) > 0,
                      (flags & HAF_ALLOW_POST_CLIP) > 0], axis=1)

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    return dict(levels=t(levels, torch.float32),
                n_events=t(n_events, torch.int32),
                mu=t(mu_p, torch.float32), sigma=t(sg_p, torch.float32),
                c=t(emission_constant(np.log(sg_p)), torch.float32),
                n_kmers=t(n_kmers, torch.int32),
                trans=t(np.asarray(trans, np.float32), torch.float32),
                clips=t(clips.astype(np.uint8), torch.uint8))


def viterbi_paths(x) -> torch.Tensor:
    """Fill + traceback on the tensors of ``prepare_viterbi_inputs``."""
    trace = viterbi_fill(x["levels"], x["n_events"], x["mu"], x["sigma"],
                         x["c"], x["n_kmers"], x["trans"], x["clips"])
    return viterbi_backtrack(trace, x["n_events"], x["n_kmers"])


def profile_hmm_viterbi_align(levels, n_events, mu, sigma, n_kmers,
                              events_per_base, flags, indel_bias: float = 1.0,
                              trans=None, device=None
                              ) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    """Batched Viterbi alignment; per-segment (event_offsets, kmer_idxs,
    state_string) in forward order, as ``viterbi_backtrack`` of the JAX
    scan path returns them."""
    x = prepare_viterbi_inputs(levels, n_events, mu, sigma, n_kmers,
                               events_per_base, flags, indel_bias, trans,
                               device=device)
    return paths_to_segments(viterbi_paths(x).cpu().numpy())
