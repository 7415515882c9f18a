"""Indexed profile-HMM Forward scoring on the card: the variants drain.

Counterpart of ``forward_indexed`` / ``forward_packed`` in
``nanopolish_tpu/ops/pallas_profile_hmm.py`` (``_fwd_packed_kernel``): the
hand-written CUDA kernel ``csrc/forward_indexed.cu``, one Forward
log-likelihood per segment.  A segment is four ids into inputs that many
segments share (variants screening scores ~10 sequences against each read's
event slice, and each sequence against ~10 reads):

  levels_u [E, Tc] f32   drift-corrected event slices, traversal order
  n_ev_u   [E] i32
  tabs     [3, R, S] f32 per-read mu, sigma, c (c = LOG_INV_SQRT_2PI -
                         log(sigma), as prepare_viterbi_inputs computes it)
  rank_mat [U, Kc] i32   kmer-rank rows (padding entries 0)
  n_km_u   [U] i32
  trans_u  [R2, 8] f32   transition rows (TRANS_COLS)
  ids      [n, 4] i32    (event row, table row, rank row, transition row)
  clips    [n, 2] u8     (pre-clip, post-clip allowed)

``forward_indexed`` takes tensors on one device.  For CPU tensors it runs
the plain version (``ops/profile_hmm.forward_indexed_plain``); for CUDA
tensors it launches the kernel (building it at first use) or raises.
``forward_indexed_scores`` is the host side of a flush: one upload of the
indexed inputs, every launch issued, one fetch.  The TPU drain's lane
packing and its relay wire are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import resolve_device
from .profile_hmm import (_CLIP_BASE, _CLIP_STEP, _LOG1M_CLIP,
                          HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP, PAD_C,
                          forward_indexed_plain)
from .profile_hmm_viterbi import kmer_width

# segments per launch: bounds the plain version's gathered tables on the
# CPU (the kernel takes any count)
MAX_LAUNCH = 1 << 16


def forward_indexed(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids,
                    clips, kp=None):
    """Forward log-likelihood [n] f32 per segment (``forward_indexed_plain``
    contract).  ``kp`` is the launch's kmer width, a power of two 32..1024
    at least every segment's n_kmers (default ``kmer_width(Kc)``): 32 runs
    one warp per segment, wider one block per segment."""
    if levels_u.device.type == "cpu":
        return forward_indexed_plain(levels_u, n_ev_u, tabs, rank_mat, n_km_u,
                                     trans_u, ids, clips)
    cuda_build.require_cuda(levels_u)
    dev = levels_u.device
    E, Tc = levels_u.shape
    _, R, S = tabs.shape
    U, Kc = rank_mat.shape
    n = ids.shape[0]
    KP = kmer_width(Kc) if kp is None else kp
    if KP != kmer_width(KP):
        raise ValueError(f"kmer width {KP} must be a power of two >= 32")
    f32, i32 = torch.float32, torch.int32
    cuda_build.check_tensor("levels_u", levels_u, f32, (E, Tc), dev)
    cuda_build.check_tensor("n_ev_u", n_ev_u, i32, (E,), dev)
    cuda_build.check_tensor("tabs", tabs, f32, (3, R, S), dev)
    cuda_build.check_tensor("rank_mat", rank_mat, i32, (U, Kc), dev)
    cuda_build.check_tensor("n_km_u", n_km_u, i32, (U,), dev)
    cuda_build.check_tensor("trans_u", trans_u, f32, (trans_u.shape[0], 8),
                            dev)
    cuda_build.check_tensor("ids", ids, i32, (n, 4), dev)
    cuda_build.check_tensor("clips", clips, torch.uint8, (n, 2), dev)
    scores = torch.empty(n, dtype=f32, device=dev)
    cuda_build.launch(
        "forward_indexed", levels_u.data_ptr(), Tc, n_ev_u.data_ptr(),
        tabs.data_ptr(), R, S, rank_mat.data_ptr(), Kc, n_km_u.data_ptr(),
        trans_u.data_ptr(), ids.data_ptr(), clips.data_ptr(),
        float(np.float32(_LOG1M_CLIP)), float(np.float32(_CLIP_BASE)),
        float(np.float32(_CLIP_STEP)), PAD_C, KP, n, scores.data_ptr())
    cuda_build.count_launch("forward_indexed")
    return scores


def _pow2(x: np.ndarray, lo: int) -> np.ndarray:
    """Each entry rounded up to a power of two, at least lo."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.maximum(lo, 1 << np.ceil(np.log2(x)).astype(np.int64))


def check_indexed(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids):
    """Raise unless every id and rank lies in range and every row fits
    its matrix: the kernel reads what the ids point at unchecked."""
    E, Tc = levels_u.shape
    U, Kc = rank_mat.shape
    bounds = (("event", E), ("table", tabs.shape[1]), ("rank", U),
              ("transition", len(trans_u)))
    for col, (name, hi) in enumerate(bounds):
        if len(ids) and not (0 <= ids[:, col].min() and
                             ids[:, col].max() < hi):
            raise ValueError(f"{name} ids out of range [0, {hi})")
    if len(n_ev_u) and n_ev_u.max() > Tc:
        raise ValueError(f"an event row holds more than Tc={Tc} levels")
    if len(n_km_u) and n_km_u.max() > Kc:
        raise ValueError(f"a rank row holds more than Kc={Kc} kmers")
    if rank_mat.size and not (0 <= rank_mat.min() and
                              rank_mat.max() < tabs.shape[2]):
        raise ValueError(f"kmer ranks out of range [0, {tabs.shape[2]})")


def forward_indexed_scores(levels_u, n_ev_u, tabs, rank_mat, n_km_u,
                           trans_u, ids, flags, device=None) -> np.ndarray:
    """Forward-score n segments given as numpy indexed inputs (module
    docstring; ``flags`` [n] or one HAF_* value) on ``device`` (``cuda``
    unless ``cpu`` is asked).  Returns [n] f32.

    Each input goes to the device once.  Segments are grouped by kernel
    width (``kmer_width`` of their n_kmers) and power-of-two event count,
    ordered by event count within a group so that a block's segments end
    together; every launch is issued before the one fetch of the
    concatenated scores.  A score does not depend on its group."""
    dev = resolve_device(device)
    ids = np.asarray(ids, np.int32).reshape(-1, 4)
    n = len(ids)
    out = np.zeros(n, np.float32)
    if n == 0:
        return out
    levels_u = np.asarray(levels_u, np.float32)
    n_ev_u = np.asarray(n_ev_u, np.int32)
    tabs = np.asarray(tabs, np.float32)
    rank_mat = np.asarray(rank_mat, np.int32)
    n_km_u = np.asarray(n_km_u, np.int32)
    trans_u = np.asarray(trans_u, np.float32)
    check_indexed(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids)
    flags = np.broadcast_to(np.asarray(flags, np.int32), (n,))
    clips = np.stack([(flags & HAF_ALLOW_PRE_CLIP) > 0,
                      (flags & HAF_ALLOW_POST_CLIP) > 0],
                     axis=1).astype(np.uint8)
    nev = n_ev_u[ids[:, 0]]
    kp = _pow2(n_km_u[ids[:, 2]], 32)
    kmer_width(int(kp.max()))           # raises past the kernels' width
    tp = _pow2(nev, 64)
    order = np.lexsort((nev, tp, kp))
    key = kp[order] * (1 << 32) + tp[order]
    cuts = np.flatnonzero(np.diff(key)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [n]])

    def up(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)

    f32, i32 = torch.float32, torch.int32
    lev_d, nev_d = up(levels_u, f32), up(n_ev_u, i32)
    tabs_d, rank_d = up(tabs, f32), up(rank_mat, i32)
    nkm_d, tr_d = up(n_km_u, i32), up(trans_u, f32)
    ids_d, clips_d = up(ids[order], i32), up(clips[order], torch.uint8)
    pending = []
    for lo, hi in zip(starts.tolist(), ends.tolist()):
        width = int(kp[order[lo]])
        for a in range(lo, hi, MAX_LAUNCH):
            b = min(a + MAX_LAUNCH, hi)
            pending.append(forward_indexed(lev_d, nev_d, tabs_d, rank_d,
                                           nkm_d, tr_d, ids_d[a:b],
                                           clips_d[a:b], kp=width))
    out[order] = torch.cat(pending).cpu().numpy()
    return out
