"""recalibrate_model: weighted least-squares re-estimation of per-read
scalings from an event alignment (reference:
src/nanopolish_methyltrain.cpp:204-307).  The Eigen normal-equation solve
is the batched [B,2..3] solve in ops/scaling.py; this wrapper feeds it
from an EventAlignment list and updates the read in place.  The solve
runs on ``device`` (``cuda`` unless the caller asks for ``cpu``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.scaling import recalibrate
from .pore_model import PoreModel
from ..utils.device import resolve_device
from ..utils.syncstats import timed_fetch
from .squiggle import SquiggleRead, SquiggleScalings

MIN_EVENTS_TO_RESCALE = 200


def recalibrate_model(sr: SquiggleRead, pore_model: PoreModel,
                      strand_idx: int, alignment_output: Sequence,
                      scale_var: bool = True,
                      scale_drift: bool = True,
                      min_events: int = MIN_EVENTS_TO_RESCALE,
                      device=None) -> bool:
    """Update sr.scalings[strand_idx] from the M-state alignment rows."""
    k = pore_model.k
    alphabet = pore_model.alphabet
    raw_events, times, means, stdvs = [], [], [], []
    for ea in alignment_output:
        if ea.hmm_state != "M":
            continue
        model_kmer = alphabet.reverse_complement(ea.ref_kmer) if ea.rc \
            else ea.ref_kmer
        try:
            rank = alphabet.kmer_rank(model_kmer, k)
        except (KeyError, ValueError):
            continue
        raw_events.append(float(sr.get_unscaled_level(ea.event_idx, strand_idx)))
        means.append(float(pore_model.level_mean[rank]))
        stdvs.append(float(pore_model.level_stdv[rank]))
        times.append(float(sr.get_time(ea.event_idx, strand_idx)))

    n = len(raw_events)
    if n < min_events:
        return False
    levels = np.asarray(raw_events, np.float32)[None, :]
    t = np.asarray(times, np.float32)[None, :]
    mu = np.asarray(means, np.float32)[None, :]
    sd = np.asarray(stdvs, np.float32)[None, :]
    mask = np.ones((1, n), bool)
    return _solve_and_update(sr, strand_idx, levels, t, mu, sd, mask,
                             scale_var, scale_drift, device)


def recalibrate_model_columns(sr: SquiggleRead, pore_model: PoreModel,
                              strand_idx: int, cols,
                              scale_var: bool = True,
                              scale_drift: bool = True,
                              min_events: int = MIN_EVENTS_TO_RESCALE,
                              device=None) -> bool:
    """recalibrate_model over EventAlignmentColumns (no row objects):
    the M-row filter, model-kmer rank, and level/time extraction are
    vectorized over the column arrays.  Same selection and the same
    batched WLS solve as the row path."""
    ranks = cols.model_kmer_ranks()
    sel = np.flatnonzero((cols.state == 77) & (ranks >= 0))
    n = sel.size
    if n < min_events:
        return False
    ev_idx = np.asarray(cols.event_idx, np.int64)[sel]
    r = ranks[sel]
    levels = np.asarray(sr.get_unscaled_level(ev_idx, strand_idx),
                        np.float32)[None, :]
    t = np.asarray(sr.get_time(ev_idx, strand_idx), np.float32)[None, :]
    mu = pore_model.level_mean[r].astype(np.float32)[None, :]
    sd = pore_model.level_stdv[r].astype(np.float32)[None, :]
    mask = np.ones((1, n), bool)
    return _solve_and_update(sr, strand_idx, levels, t, mu, sd, mask,
                             scale_var, scale_drift, device)


def _solve_and_update(sr, strand_idx, levels, t, mu, sd, mask, scale_var,
                      scale_drift, device) -> bool:
    dev = resolve_device(device)
    res = recalibrate(*(torch.as_tensor(x, device=dev)
                        for x in (levels, t, mu, sd, mask)),
                      scale_var=scale_var, scale_drift=scale_drift)
    vals = timed_fetch(torch.stack([res.shift[0], res.scale[0], res.drift[0],
                                    res.var[0],
                                    res.recalibrated[0].to(torch.float32)]))
    if vals[4] == 0.0:
        return False
    sr.scalings[strand_idx] = SquiggleScalings.from4(*(float(v) for v in vals[:4]))
    return True
