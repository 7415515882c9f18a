"""Segmentation Viterbi on the card.

Counterpart of ``nanopolish_tpu/ops/pallas_segmentation.py``
(``_seg_fwd_kernel``, ``_seg_back_kernel`` and the ``_seg_summary``
reduction): the hand-written CUDA kernels ``csrc/seg_viterbi_fill.cu``
and ``csrc/seg_backtrack.cu`` (the summary fused into the backward walk).

Each wrapper takes tensors on one device.  For CPU tensors it runs its
kernel's plain version from ``ops/segmentation_hmm.py``; for CUDA tensors
it launches the kernel (building it at first use) or raises.  On the card
the backpointers are stored read-major ([B, N], one warp per read writes
its row coalesced); ``seg_viterbi_fill`` returns them as the [N, B] view
of that storage, which ``seg_backtrack`` takes without a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from .segmentation_hmm import (N_CONSTS, T, seg_backtrack_plain,
                               seg_viterbi_fill_plain)


def seg_viterbi_fill(samples, n_samples, scal, consts):
    """Backpointers [N, B] uint8 (on the card a view of read-major
    storage) and final scores [B, 6] f32 for samples
    [N, B] f32 (sample-major), n_samples [B] i32 (1 <= n <= N) and
    scal [B, 3] f32 (scale, shift, var); consts is ``seg_constants``."""
    consts = np.ascontiguousarray(consts, np.float32)
    if consts.shape != (N_CONSTS,):
        raise ValueError(f"consts: expected ({N_CONSTS},), got {consts.shape}")
    if samples.device.type == "cpu":
        return seg_viterbi_fill_plain(samples, n_samples, scal, consts)
    cuda_build.require_cuda(samples)
    dev = samples.device
    N, B = samples.shape
    cuda_build.check_tensor("samples", samples, torch.float32, (N, B), dev)
    cuda_build.check_tensor("n_samples", n_samples, torch.int32, (B,), dev)
    cuda_build.check_tensor("scal", scal, torch.float32, (B, 3), dev)
    rows = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    vfin = torch.empty((B, 6), dtype=torch.float32, device=dev)
    cuda_build.launch("seg_viterbi_fill", samples.data_ptr(), N, B,
                      n_samples.data_ptr(), scal.data_ptr(),
                      consts.ctypes.data, rows.data_ptr(), vfin.data_ptr())
    cuda_build.count_launch("seg_viterbi_fill")
    return rows.t(), vfin


def seg_backtrack(bptr, n_samples, out=None, labels: bool = False):
    """Follow the backpointers of ``seg_viterbi_fill``: the [B, 5] i32
    summary (written into ``out`` when given) and, only when ``labels``
    is asked for, the labels [N, B] uint8 (T past each read's length);
    else None in their place."""
    if bptr.device.type == "cpu":
        summ, lab = seg_backtrack_plain(bptr, n_samples)
        if out is not None:
            out.copy_(summ)
            summ = out
        return summ, (lab if labels else None)
    cuda_build.require_cuda(bptr)
    dev = bptr.device
    N, B = bptr.shape
    rows = bptr.t().contiguous()        # read-major; no copy for the fill's
    cuda_build.check_tensor("bptr", rows, torch.uint8, (B, N), dev)
    cuda_build.check_tensor("n_samples", n_samples, torch.int32, (B,), dev)
    if out is None:
        out = torch.empty((B, 5), dtype=torch.int32, device=dev)
    cuda_build.check_tensor("out", out, torch.int32, (B, 5), dev)
    lab = torch.full((N, B), T, dtype=torch.uint8, device=dev) \
        if labels else None
    cuda_build.launch("seg_backtrack", rows.data_ptr(), N, B,
                      n_samples.data_ptr(), out.data_ptr(),
                      lab.data_ptr() if labels else None)
    cuda_build.count_launch("seg_backtrack")
    return out, lab
