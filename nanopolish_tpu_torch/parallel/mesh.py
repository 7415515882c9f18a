"""Process mesh + sharding policy for the port.

The reference parallelizes with single-node OpenMP over reads
(reference: src/common/nanopolish_bam_processor.cpp:49-133) plus shell-level
window sharding (scripts/nanopolish_makerange.py).  As in the JAX package,
the two axes become a 2-D (data, model) grid, here of processes:

  * ``data``  — batches of reads: each process takes a contiguous block
    of the batch's leading axis; per-read work is independent, so the
    only collectives are the reductions (EM sufficient statistics, the
    objective), an all-reduce over the data group.
  * ``model`` — the k-mer table axis (4^k..5^k rows): the M-step updates
    this process's block of rows; an all-gather over the model group
    reassembles the table.

Rank r sits at (r // model, r % model), as ``nanopolish_tpu``'s
``make_mesh`` reshapes its device list.  Pore models, reference windows
and transition scalars are replicated: every process holds them whole.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh(NamedTuple):
    """This process's place in a (data, model) grid of ``data * model``
    processes.  ``data_group`` holds the ranks of its data column (same
    model index), ``model_group`` those of its model row (same data
    index); both are None in a run without a process group."""

    data: int
    model: int
    rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over the processes of the default group.

    ``model_parallel`` processes go to the k-mer-table axis, the rest to
    the read-batch axis.  Without a process group the mesh is 1 x 1 (and
    ``model_parallel`` must be 1).  Every rank creates every group, in
    the same order, as torch.distributed.new_group requires.
    """
    if not dist.is_initialized():
        n, rank = 1, 0
    else:
        n, rank = dist.get_world_size(), dist.get_rank()
    if n % model_parallel != 0:
        raise ValueError(f"{n} processes not divisible by "
                         f"model_parallel={model_parallel}")
    dp = n // model_parallel
    if not dist.is_initialized():
        return Mesh(dp, model_parallel, rank)
    data_group = model_group = None
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m for d in range(dp)])
        if m == rank % model_parallel:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * model_parallel + m
                            for m in range(model_parallel)])
        if d == rank // model_parallel:
            model_group = g
    return Mesh(dp, model_parallel, rank, data_group, model_group)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts != 0:
        raise ValueError(f"{what} of {n} not divisible by {parts} shards "
                         f"(pad_batch_to_multiple pads a batch)")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def shard_reads(mesh: Mesh, *arrays):
    """This process's contiguous block of each per-read array's leading
    axis (what ``P(DATA_AXIS)`` gives a device in the JAX package)."""
    out = tuple(a[_block(a.shape[0], mesh.data, mesh.data_index, "batch")]
                for a in arrays)
    return out if len(out) != 1 else out[0]


def model_rows(mesh: Mesh, n_ranks: int) -> slice:
    """This process's rows of the k-mer table: [m * R/mp, (m+1) * R/mp)."""
    return _block(n_ranks, mesh.model, mesh.model_index, "k-mer table")


def shard_model(mesh: Mesh, *arrays):
    """This process's block of each k-mer-table array (``P(MODEL_AXIS)``)."""
    out = tuple(a[model_rows(mesh, a.shape[0])] for a in arrays)
    return out if len(out) != 1 else out[0]


def replicated(x):
    """Replicated arrays are held whole by every process."""
    return x


def pad_batch_to_multiple(arrays, multiple: int, batch_axis: int = 0):
    """Pad the batch axis so it divides the data-mesh size; returns
    (padded_arrays, real_batch), host NumPy copies.  Padded rows are
    zeros: n_events = 0 rows are inert in the train step."""
    b = arrays[0].shape[batch_axis]
    pad = (-b) % multiple
    if pad == 0:
        return list(arrays), b
    out = []
    for a in arrays:
        widths = [(0, 0)] * a.ndim
        widths[batch_axis] = (0, pad)
        out.append(np.pad(np.asarray(a), widths))
    return out, b
