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
indexed inputs, one launch per kmer width, one fetch.  The TPU drain's
lane packing becomes the kernel's 8-lane groups (``indexed_layout``); its
relay wire is not ported.  With ``logsum="table"`` a flush's launches
gather their windows into the flat layout (``gather_indexed``) and score
them with the table-route Forward (``profile_hmm_forward.forward_fill``,
``csrc/forward_table.cu`` on the card), as the JAX package's flat path
does off the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import resolve_device
from .profile_hmm import (_CLIP_BASE, _CLIP_STEP, _LOG1M_CLIP,
                          HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP, PAD_C,
                          forward_indexed_plain, gather_indexed)
from .profile_hmm_forward import forward_fill
from .profile_hmm_viterbi import (ROW_BLOCK_MAX, card_sms, wide_layout,
                                  wide_scratch)

# segments per launch: bounds the plain version's gathered tables on the
# CPU (the kernel takes any count), and past 1,024 kmers the wide row's
# buffers (12 bytes per kmer and segment) to WIDE_LAUNCH_BYTES
MAX_LAUNCH = 1 << 16
WIDE_LAUNCH_BYTES = 1 << 29
# narrowest kmer width of a segment (csrc/forward_indexed.cu: 8 lanes)
MIN_WIDTH = 8
# kmer widths 64-256 whose calling windows run on the warp row (R = KP / 32
# kmers per lane); the others of 64-1024 on the block row.  On an H100
# (chip_smoke phase 4b, PERF.md) the warp row took 0.32 ms against the
# block row's 0.43 on 512 calling windows at 64, 1.65 against 1.71 on 118
# at 128, and 2.87 against 2.25 on 394 at 256
INDEXED_WARP_WIDTHS = (64, 128)


def indexed_width(n_kmers_max: int, lo: int = MIN_WIDTH) -> int:
    """The indexed kernel's kmer width: the smallest power of two >= lo
    that holds n_kmers_max kmers."""
    kp = lo
    while kp < n_kmers_max:
        kp *= 2
    return kp


def indexed_layout(kp: int):
    """(mode, kpl) of the indexed kernel at kmer width kp, a power of two
    >= 8: ``("narrow", 1)`` up to 32 (8 lanes a window, each at its own
    width; ``plan_flush`` puts all of a flush's in one launch),
    ``("warp", kp // 32)`` at INDEXED_WARP_WIDTHS, ``("block", 0)`` up to
    1,024, else ``("wide", None)``: the wide row (csrc/profile_hmm_wide.cuh),
    its geometry from the launch's segment count too (``wide_layout``)."""
    if kp < MIN_WIDTH or kp & (kp - 1):
        raise ValueError(f"kmer width {kp} must be a power of two >= "
                         f"{MIN_WIDTH}")
    if kp <= 32:
        return ("narrow", 1)
    if kp in INDEXED_WARP_WIDTHS:
        return ("warp", kp // 32)
    if kp <= ROW_BLOCK_MAX:
        return ("block", 0)
    return ("wide", None)


def narrow_runs(widths) -> tuple:
    """The run ends (e8, e16) of a launch of windows of up to 32 kmers
    whose kmer widths (host [n]: 8, 16 or 32) come sorted: the windows
    [0, e8) are 8 kmers wide, [e8, e16) 16 and [e16, n) 32."""
    w = np.asarray(widths, np.int64)
    if not np.isin(w, (8, 16, 32)).all() or np.any(np.diff(w) < 0):
        raise ValueError("kmer widths must be 8, 16 or 32, in order")
    return int(np.sum(w == 8)), int(np.sum(w <= 16))


def forward_indexed(levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u, ids,
                    clips, kp=None, widths=None):
    """Forward log-likelihood [n] f32 per segment (``forward_indexed_plain``
    contract).  ``kp`` is the launch's kmer width, a power of two >= 8 and
    at least every segment's n_kmers (default ``indexed_width(Kc)``), laid
    out on the card as ``indexed_layout`` says.  Up to 32 kmers,
    ``widths`` (host [n]) gives each segment's own kmer width, 8, 16 or 32,
    in order (default: kp for all), and each runs at its own width
    (``narrow_runs``)."""
    if levels_u.device.type == "cpu":
        return forward_indexed_plain(levels_u, n_ev_u, tabs, rank_mat, n_km_u,
                                     trans_u, ids, clips)
    cuda_build.require_cuda(levels_u)
    dev = levels_u.device
    E, Tc = levels_u.shape
    _, R, S = tabs.shape
    U, Kc = rank_mat.shape
    n = ids.shape[0]
    KP = indexed_width(Kc) if kp is None else kp
    mode, kpl = indexed_layout(KP)
    e8 = e16 = 0
    if mode == "narrow":
        widths = np.full(n, KP) if widths is None else widths
        if len(widths) != n or (n and int(np.max(widths)) > KP):
            raise ValueError(f"one kmer width of at most {KP} per segment")
        KP = 32
        e8, e16 = narrow_runs(widths)
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
    threads = cluster = 0
    scratch = None
    if mode == "wide":
        lay = wide_layout(KP, n, False, card_sms(dev))
        kpl, threads, cluster = lay.per_thread, lay.threads, lay.cluster
        scratch = wide_scratch(lay, n, dev)
    cuda_build.launch(
        "forward_indexed", levels_u.data_ptr(), Tc, n_ev_u.data_ptr(),
        tabs.data_ptr(), R, S, rank_mat.data_ptr(), Kc, n_km_u.data_ptr(),
        trans_u.data_ptr(), ids.data_ptr(), clips.data_ptr(),
        float(np.float32(_LOG1M_CLIP)), float(np.float32(_CLIP_BASE)),
        float(np.float32(_CLIP_STEP)), PAD_C, KP, kpl, threads, cluster, n,
        scores.data_ptr(), None if scratch is None else scratch.data_ptr(),
        e8, e16)
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


def plan_flush(nev, nk):
    """How a flush launches segments of nev events and nk kmers (host
    [n] each): (order [n], launches [(kp, lo, hi, widths)] over the
    segments in that order).  Segments are sorted by kmer width
    (``indexed_width``), longest event row first within
    a width, so that the segments of a warp and the blocks of a launch end
    together.  The windows of up to 32 kmers share one launch (widths: each
    one's kmer width, 8, 16 or 32); every other width has launches of its
    own (widths None), at most MAX_LAUNCH segments each and, past 1,024
    kmers, within WIDE_LAUNCH_BYTES of row buffers."""
    kp = _pow2(nk, MIN_WIDTH)
    order = np.lexsort((-np.asarray(nev, np.int64), kp))
    kps = kp[order]
    n_narrow = int(np.sum(kps <= 32))
    launches = [(32, a, min(a + MAX_LAUNCH, n_narrow),
                 kps[a:min(a + MAX_LAUNCH, n_narrow)])
                for a in range(0, n_narrow, MAX_LAUNCH)]
    cuts = np.flatnonzero(np.diff(kps[n_narrow:])) + 1 + n_narrow
    for lo, hi in zip(np.concatenate([[n_narrow], cuts]).tolist(),
                      np.concatenate([cuts, [len(kps)]]).tolist()):
        if lo >= hi:
            continue
        width = int(kps[lo])
        step = MAX_LAUNCH if width <= ROW_BLOCK_MAX else \
            max(1, WIDE_LAUNCH_BYTES // (12 * width))
        launches += [(width, a, min(a + step, hi), None)
                     for a in range(lo, hi, step)]
    return order, launches


def run_flush(tensors, ids, clips, launches):
    """Make the launches of ``plan_flush`` on the device tensors (levels_u,
    n_ev_u, tabs, rank_mat, n_km_u, trans_u) and the ids / clips in plan
    order; returns each launch's scores, in order, without waiting."""
    return [forward_indexed(*tensors, ids[lo:hi], clips[lo:hi], kp=kp,
                            widths=widths)
            for kp, lo, hi, widths in launches]


def run_flush_table(tensors, ids, clips, launches, t_max):
    """The launches of ``plan_flush`` through the table-route Forward:
    each launch's windows gathered into the flat layout (the event rows
    cut to its longest, t_max[i] levels, the rank rows to its width) and
    scored by ``forward_fill(..., logsum="table")``; returns each launch's
    scores, in order, without waiting."""
    levels_u, n_ev_u, tabs, rank_mat, n_km_u, trans_u = tensors
    out = []
    for (kp, lo, hi, _), tm in zip(launches, t_max):
        flat = gather_indexed(levels_u[:, :max(tm, 1)], n_ev_u, tabs,
                              rank_mat[:, :kp], n_km_u, trans_u, ids[lo:hi])
        out.append(forward_fill(*flat, clips[lo:hi], logsum="table"))
    return out


def forward_indexed_scores(levels_u, n_ev_u, tabs, rank_mat, n_km_u,
                           trans_u, ids, flags, device=None,
                           logsum: str = "exact") -> np.ndarray:
    """Forward-score n segments given as numpy indexed inputs (module
    docstring; ``flags`` [n] or one HAF_* value) on ``device`` (``cuda``
    unless ``cpu`` is asked).  Returns [n] f32.

    Each input goes to the device once; the segments go in the launches
    of ``plan_flush``, every launch issued before the one fetch of the
    concatenated scores.  A score does not depend on its launch or its
    width.  ``logsum="table"`` scores through ``run_flush_table``."""
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
    order, launches = plan_flush(n_ev_u[ids[:, 0]], n_km_u[ids[:, 2]])

    def up(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)

    f32, i32 = torch.float32, torch.int32
    tens = (up(levels_u, f32), up(n_ev_u, i32), up(tabs, f32),
            up(rank_mat, i32), up(n_km_u, i32), up(trans_u, f32))
    ids_t, clips_t = up(ids[order], i32), up(clips[order], torch.uint8)
    if logsum == "table":
        nev = n_ev_u[ids[order, 0]]
        t_max = [int(nev[lo:hi].max()) for _, lo, hi, _ in launches]
        pending = run_flush_table(tens, ids_t, clips_t, launches, t_max)
    else:
        pending = run_flush(tens, ids_t, clips_t, launches)
    out[order] = torch.cat(pending).cpu().numpy()
    return out
