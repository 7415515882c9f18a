"""Read ingest of one chunk on the card, split into dispatch and resolve.

MoM scaling -> reference-exact adaptive banded event alignment (the CUDA
kernels of ``ops/banded_exact``) -> 'M'-event extraction -> WLS
recalibration, with every inter-stage value on the device and one
device-to-host copy per chunk.  ``ingest_align_recalibrate_async`` issues
the whole chunk and returns at once: its inputs go up from pinned host
memory without waiting for the card (a copy from pageable memory would
wait for the chunks before it), and its results come back into pinned
host memory behind the chunk's work; the returned closure waits on an
event.  So a caller can keep several chunks in flight;
``models/read_builder.build_reads`` resolves each chunk before the next,
since a window of 3 gained nothing on the card (tools/ingest_window.py
times the two).

Counterpart of ``nanopolish_tpu/ops/ingest_fused.py``'s
``ingest_align_recalibrate_async`` (of the result's fields, those the
reads are built from; its resolved-at-once form has no caller here).
What that module builds for XLA and the relay (the jnp twin of the banded input
preparation, VMEM-sized sub-batches, one int32 wire) the port does not
need: the chunk's tensors stay on the card between stages as they are.

Spec: SquiggleRead::load_from_raw
(reference: src/nanopolish_squiggle_read.cpp:189-337).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.device import resolve_device
from .banded_align import emission_constant, transition_params_f32
from .banded_exact import align_prepared
from .scaling import estimate_scalings_mom, mstate_events_batch, recalibrate


class IngestResult:
    """Host view of one chunk's fetched ingest results."""

    __slots__ = ("b2e_start", "b2e_stop", "failed", "events_per_base",
                 "shift", "scale", "drift", "var", "recal_ok")

    def __init__(self, arr: np.ndarray, K0: int):
        self.b2e_start = arr[:, :K0]
        self.b2e_stop = arr[:, K0:2 * K0]
        t = np.ascontiguousarray(arr[:, 2 * K0:])
        self.failed = t[:, 0] != 0
        f = t[:, 1:].view(np.float32)
        (self.events_per_base, self.shift, self.scale, self.drift, self.var,
         recal) = (f[:, i].copy() for i in range(6))
        self.recal_ok = recal != 0.0


def ingest_align_recalibrate_async(ev_mean, ev_time, n_events, lvl_mean,
                                   lvl_stdv, ranks, n_kmers, device=None
                                   ) -> Callable[[], IngestResult]:
    """Issue one chunk's ingest on ``device`` (``cuda`` unless ``cpu`` is
    asked) and return the zero-argument closure that fetches it.  Args are
    host numpy arrays: ev_mean/ev_time [B, T] f32, n_events [B] i32,
    lvl_mean/lvl_stdv [B, K] f32 (the model tables of the read's kmers),
    ranks [B, K] i32, n_kmers [B] i32."""
    dev = resolve_device(device)
    T = ev_mean.shape[1]
    K = lvl_mean.shape[1]

    def d(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cpu":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    ev_mean_d, ev_time_d, lvl_mean_d, lvl_stdv_d = (
        d(ev_mean), d(ev_time), d(lvl_mean), d(lvl_stdv))
    n_events_d, n_kmers_d, ranks_d = d(n_events), d(n_kmers), d(ranks)
    # the banded aligner's host-computed terms (prepare_banded_inputs')
    lp_stay, lp_step = transition_params_f32(n_events, n_kmers)

    # MoM scaling, then the scaled gaussians for the banded aligner
    # (var=1, drift=0 here)
    shift, scale = estimate_scalings_mom(ev_mean_d, n_events_d, lvl_mean_d,
                                         n_kmers_d)
    mu = scale[:, None] * lvl_mean_d
    mu = mu + shift[:, None]
    res = align_prepared(dict(
        event_mean=ev_mean_d, n_events=n_events_d, mu=mu, sigma=lvl_stdv_d,
        c=d(emission_constant(np.log(lvl_stdv))), n_kmers=n_kmers_d,
        lp_stay=d(lp_stay), lp_step=d(lp_step)))

    # recalibration inputs: 'M' events
    m_mask = mstate_events_batch(res.b2e_start, res.b2e_stop, ranks_d,
                                 n_kmers_d)
    ev_idx = res.b2e_start.to(torch.int64).clamp(0, T - 1)
    levels = torch.gather(ev_mean_d, 1, ev_idx)
    # time relative to first event (squiggle_read.h get_time)
    times = torch.gather(ev_time_d, 1, ev_idx) - ev_time_d[:, :1]
    recal = recalibrate(levels, times, lvl_mean_d, lvl_stdv_d, m_mask,
                        scale_var=True, scale_drift=False)

    # both maps, the verdicts and the f32 results as raw bits, in one row
    floats = torch.stack([res.events_per_base, recal.shift, recal.scale,
                          recal.drift, recal.var,
                          recal.recalibrated.to(torch.float32)], dim=1)
    wire = torch.cat([res.b2e_start, res.b2e_stop,
                      res.failed.to(torch.int32)[:, None],
                      floats.view(torch.int32)], dim=1)
    if dev.type == "cpu":
        return lambda: IngestResult(wire.numpy(), K)
    # the copy is queued behind the chunk's work; the device tensors may go
    # (the caching allocator hands their memory only to later work on this
    # stream)
    host = torch.empty(wire.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(wire, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()

    def resolve() -> IngestResult:
        ready.synchronize()
        return IngestResult(host.numpy(), K)

    return resolve
