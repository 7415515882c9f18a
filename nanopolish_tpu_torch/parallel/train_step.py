"""Distributed model-training step: one methyltrain round over a
(data, model) mesh of processes.

The reference's round (src/nanopolish_methyltrain.cpp:721-873) is:
align every read (OpenMP over reads) -> collect per-kmer events under
`omp critical` -> per-kmer Gaussian update (OpenMP over kmers).  Here
each process runs the step on its block of reads and its block of the
k-mer table:

  data axis  : reads split on the batch axis; alignment + recalibration
               are per-read independent; per-kmer moment sums cross the
               axis with one all-reduce over the data group.
  model axis : the k-mer table is split for the M-step; an all-gather over
               the model group reassembles it.  Ranks along the model axis
               repeat their data block's per-read work, as the JAX step's
               devices do.

The step follows ``nanopolish_tpu.parallel.train_step._train_step_body``
line for line: MoM scaling -> adaptive banded event alignment (the
``banded_fill`` and ``banded_backtrack`` kernels) -> WLS recalibration ->
per-kmer sufficient statistics -> all-reduce -> Gaussian M-step ->
whole-read profile-HMM Forward (the ``forward_fill`` kernel, or
``forward_table`` under ``NPT_LOGSUM=table``) under the updated model as
the monitored objective (methyltrain's per-round model
score, methyltrain.cpp:385-402).  Its log terms are computed on the host
in f32, as the port's ingest does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.banded_exact import banded_align_exact
from ..ops.profile_hmm_forward import forward_scores, prepare_forward_inputs
from ..ops.scaling import estimate_scalings_mom, mstate_events_batch, recalibrate
from ..ops.training import KmerMoments, gaussian_update, kmer_moments, psum_moments
from ..utils.device import resolve_device
from ..utils.logsum import logsum_mode
from .distributed import all_gather, all_reduce
from .mesh import Mesh, model_rows


class TrainBatch(NamedTuple):
    """This process's block of reads (arrays or tensors; leading axis =
    reads, ``mesh.shard_reads`` of the global batch)."""

    ev_mean: object   # [B, T] f32 event levels (pA)
    ev_time: object   # [B, T] f32 event start times (s, relative)
    n_events: object  # [B] i32
    ranks: object     # [B, K] i32 read kmer ranks
    n_kmers: object   # [B] i32


class TrainStepResult(NamedTuple):
    level_mean: torch.Tensor  # [R / model] this process's updated rows
    level_stdv: torch.Tensor  # [R / model]
    loss: torch.Tensor        # scalar f32: -mean HMM forward lp of scored reads
    n_scored: torch.Tensor    # scalar i64


def _gather_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t if mesh.model_group is None else all_gather(t, mesh.model_group)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _train_step_body(level_mean, level_stdv, batch: TrainBatch, mesh: Mesh,
                     n_ranks: int, dev: torch.device) -> TrainStepResult:
    f32, i32 = torch.float32, torch.int32

    def d(x, dt):
        return torch.as_tensor(x, dtype=dt, device=dev)

    level_mean, level_stdv = d(level_mean, f32), d(level_stdv, f32)
    ev_mean, ev_time = d(batch.ev_mean, f32), d(batch.ev_time, f32)
    raw_nev, raw_nk = d(batch.n_events, i32), d(batch.n_kmers, i32)
    ranks = d(batch.ranks, i32)

    # --- assemble the replicated full kmer table from the local shard ---
    full_mean = _gather_model(level_mean, mesh)
    full_stdv = _gather_model(level_stdv, mesh)

    n_events = raw_nev.clamp(min=2)
    n_kmers = raw_nk.clamp(min=2)
    valid = (raw_nev > 0) & (raw_nk > 0)

    lvl_mean = full_mean[ranks.long()]
    lvl_stdv = full_stdv[ranks.long()]

    # --- per-read pipeline (independent across the data axis) ---
    shift, scale = estimate_scalings_mom(ev_mean, n_events, lvl_mean, n_kmers)
    mu = scale[:, None] * lvl_mean
    mu = mu + shift[:, None]
    res = banded_align_exact(ev_mean, n_events, mu, lvl_stdv,
                             np.log(_host(lvl_stdv)), n_kmers, device=dev)

    m_mask = mstate_events_batch(res.b2e_start, res.b2e_stop, ranks, n_kmers)
    T = ev_mean.shape[1]
    ev_idx = res.b2e_start.long().clamp(0, T - 1)
    levels = torch.gather(ev_mean, 1, ev_idx)
    times = torch.gather(ev_time, 1, ev_idx) - ev_time[:, :1]
    recal = recalibrate(levels, times, lvl_mean, lvl_stdv, m_mask,
                        scale_var=True, scale_drift=False)

    read_ok = valid & ~res.failed & recal.recalibrated

    # --- E-step statistics: fully-scaled levels keyed by kmer rank ---
    scaled = (levels - recal.shift[:, None]) / recal.scale[:, None]
    w = (read_ok[:, None] & m_mask).to(f32)
    local = kmer_moments(ranks, scaled, w, n_ranks)
    glob = psum_moments(local, mesh.data_group)

    # --- M-step on this process's kmer-table shard ---
    rows = model_rows(mesh, n_ranks)
    new_mean, new_stdv = gaussian_update(
        KmerMoments(*(v[rows] for v in glob)), level_mean, level_stdv)

    # --- objective: HMM forward score under the updated model ---
    upd_mean = _gather_model(new_mean, mesh)
    upd_stdv = _gather_model(new_stdv, mesh)
    mu2 = recal.scale[:, None] * upd_mean[ranks.long()]
    mu2 = mu2 + recal.shift[:, None]
    sg2 = upd_stdv[ranks.long()] * recal.var[:, None]
    levels2 = torch.where(read_ok[:, None], ev_mean, torch.zeros((), dtype=f32,
                                                                 device=dev))
    x = prepare_forward_inputs(_host(levels2), _host(n_events), _host(mu2),
                               _host(sg2), _host(n_kmers),
                               _host(res.events_per_base), 0, device=dev)
    lp = torch.where(read_ok, forward_scores(x, logsum_mode()),
                     torch.zeros((), dtype=f32, device=dev))
    sums = torch.stack([read_ok.sum().to(torch.float64),
                        lp.to(torch.float64).sum()])
    if mesh.data_group is not None:
        sums = all_reduce(sums, mesh.data_group)
    n_scored = sums[0].to(torch.int64)
    loss = (-sums[1] / sums[0].clamp(min=1)).to(f32)
    return TrainStepResult(level_mean=new_mean, level_stdv=new_stdv,
                           loss=loss, n_scored=n_scored)


def make_train_step(mesh: Mesh, n_ranks: int, device=None):
    """Build the train step of this process's place in ``mesh``, on
    ``device`` (``cuda`` unless ``cpu`` is asked).

    Returns step(level_mean_shard [R / model], level_stdv_shard, batch:
    TrainBatch) -> TrainStepResult, the model arrays this process's rows
    (``mesh.shard_model``) and the batch its reads (``mesh.shard_reads``).
    """
    if n_ranks % mesh.model != 0:
        raise ValueError(f"kmer table size {n_ranks} not divisible by "
                         f"model axis {mesh.model}")
    dev = resolve_device(device)

    def step(level_mean, level_stdv, batch: TrainBatch) -> TrainStepResult:
        return _train_step_body(level_mean, level_stdv, batch, mesh,
                                n_ranks, dev)

    return step
