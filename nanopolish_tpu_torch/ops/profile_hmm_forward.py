"""Profile-HMM Forward scoring on the card.

Counterpart of the Forward half of ``nanopolish_tpu/ops/pallas_profile_hmm.py``
(``_fwd_kernel``, ``profile_hmm_forward_pallas``): the hand-written CUDA
kernel ``csrc/forward_fill.cu``, one log-likelihood per segment.  It takes
the same padded inputs as the Viterbi fill (``prepare_viterbi_inputs``):
per-segment clip flags, so segments with different flags share a launch.

``forward_fill`` takes tensors on one device.  For CPU tensors it runs the
plain version (``ops/profile_hmm.forward_fill_plain``); for CUDA tensors it
launches the kernel (building it at first use) or raises.  With
``logsum="table"`` (``NPT_LOGSUM=table``) it scores with the reference's
quantized logsum: the plain table route on the CPU, on the card the
hand-written ``csrc/forward_table.cu`` (``forward_table``), the one kernel
of every table-mode Forward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.logsum import logsum_mode, logsum_table
from .profile_hmm import _CLIP_BASE, _CLIP_STEP, _LOG1M_CLIP, forward_fill_plain
from .profile_hmm_viterbi import fill_geometry, prepare_viterbi_inputs


def _check_fill_inputs(levels, n_events, mu, sigma, c, n_kmers, trans,
                       clips):
    """Raise unless the Forward inputs are what the kernels take."""
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


def forward_fill(levels, n_events, mu, sigma, c, n_kmers, trans, clips,
                 logsum: str = "exact"):
    """Forward log-likelihood [B] f32 per segment; the kmer tables are
    [B, KP] with KP from ``kmer_width`` (``forward_fill_plain`` contract),
    laid out on the card as ``fill_geometry`` says.  ``logsum="table"`` takes
    the table route (``forward_table`` on the card); any other value the
    exact one."""
    if levels.device.type == "cpu":
        return forward_fill_plain(levels, n_events, mu, sigma, c, n_kmers,
                                  trans, clips, logsum=logsum)
    cuda_build.require_cuda(levels)
    if logsum == "table":
        return forward_table(levels, n_events, mu, sigma, c, n_kmers, trans,
                             clips)
    dev = levels.device
    B, T = levels.shape
    KP = mu.shape[1]
    _check_fill_inputs(levels, n_events, mu, sigma, c, n_kmers, trans, clips)
    kpl, threads, cluster, scratch = fill_geometry(KP, B, False, dev)
    scores = torch.empty(B, dtype=torch.float32, device=dev)
    cuda_build.launch(
        "forward_fill", levels.data_ptr(), T, mu.data_ptr(), sigma.data_ptr(),
        c.data_ptr(), KP, kpl, threads, cluster, n_events.data_ptr(),
        n_kmers.data_ptr(),
        trans.data_ptr(), clips.data_ptr(), float(np.float32(_LOG1M_CLIP)),
        float(np.float32(_CLIP_BASE)), float(np.float32(_CLIP_STEP)), B,
        scores.data_ptr(), None if scratch is None else scratch.data_ptr())
    cuda_build.count_launch("forward_fill")
    return scores


def forward_table(levels, n_events, mu, sigma, c, n_kmers, trans, clips):
    """The table-route Forward [B] f32 on the card: ``csrc/forward_table.cu``
    (``forward_fill_plain(..., logsum="table")`` contract, any kmer width
    KP).  Segments of more than 32 kmers get a strip-boundary column,
    [B, T] float4 of scratch."""
    cuda_build.require_cuda(levels)
    _check_fill_inputs(levels, n_events, mu, sigma, c, n_kmers, trans, clips)
    dev = levels.device
    B, T = levels.shape
    KP = mu.shape[1]
    scores = torch.empty(B, dtype=torch.float32, device=dev)
    scratch = torch.empty((B, T, 4), dtype=torch.float32, device=dev) \
        if KP > 32 else None
    cuda_build.launch(
        "forward_table", levels.data_ptr(), T, mu.data_ptr(),
        sigma.data_ptr(), c.data_ptr(), KP, n_events.data_ptr(),
        n_kmers.data_ptr(), trans.data_ptr(), clips.data_ptr(),
        float(np.float32(_LOG1M_CLIP)), float(np.float32(_CLIP_BASE)),
        float(np.float32(_CLIP_STEP)), logsum_table(dev).data_ptr(), B,
        scores.data_ptr(), None if scratch is None else scratch.data_ptr())
    cuda_build.count_launch("forward_table")
    return scores


def prepare_forward_inputs(levels, n_events, mu, sigma, n_kmers,
                           events_per_base, flags, indel_bias: float = 1.0,
                           trans=None, device=None):
    """Host arrays -> the padded kernel tensors on ``device`` (``cuda``
    unless ``cpu`` is asked); the layout of ``prepare_viterbi_inputs``."""
    return prepare_viterbi_inputs(levels, n_events, mu, sigma, n_kmers,
                                  events_per_base, flags, indel_bias, trans,
                                  device=device)


def forward_scores(x, logsum: str = "exact") -> torch.Tensor:
    """``forward_fill`` on the tensors of ``prepare_forward_inputs``."""
    return forward_fill(x["levels"], x["n_events"], x["mu"], x["sigma"],
                        x["c"], x["n_kmers"], x["trans"], x["clips"],
                        logsum=logsum)


def profile_hmm_forward(levels, n_events, mu, sigma, n_kmers,
                        events_per_base, flags, indel_bias: float = 1.0,
                        trans=None, device=None) -> np.ndarray:
    """Batched Forward scores (profile_hmm_score_r9, r9.cpp:35-65) as a
    host [B] f32 array; ``flags`` may differ per segment.  Sums as
    ``NPT_LOGSUM`` says (``utils.logsum.logsum_mode``)."""
    x = prepare_forward_inputs(levels, n_events, mu, sigma, n_kmers,
                               events_per_base, flags, indel_bias, trans,
                               device=device)
    return forward_scores(x, logsum_mode()).cpu().numpy()
