"""Multi-process execution: torch.distributed wiring + process-shard env.

The reference scales across machines at the shell level — makerange
windows x GNU parallel (README.md:142-147) and watch-mode file sharding by
suffix mod N (call_methylation.cpp:489-508) — with no communication
backend.  The port has the same two layers as the JAX package:

 * embarrassing read/window sharding across *processes* (each process
   drives a card and owns its output file) — `--shard i/n` on the apps,
   spawned by parallel.launch; no collectives, reads are independent;
 * a `torch.distributed` process group, so that several processes can
   run the training collectives (the EM moment all-reduce of
   parallel.train_step) — joined here from the NPT_* environment the
   launcher exports.

auto_init() is called by `python -m nanopolish_tpu_torch` before every
subcommand: a plain single-process run (no NPT_COORDINATOR, or one
process) is a no-op, while a launcher child joins the process group
before any work starts.

The backend follows one rule: ``nccl`` when the run is on CUDA and every
rank has a card of its own (NPT_NUM_PROCS <= torch.cuda.device_count()),
else ``gloo``.  NCCL refuses two ranks on one device, so several processes
on one card talk over gloo; gloo takes CUDA tensors only for broadcast
and all_reduce, so the collectives below move CUDA tensors through host
copies under gloo and keep them on the card under NCCL.
"""

from __future__ import annotations

import atexit
import os
import sys
from datetime import timedelta
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist


# the longest a rank waits for the others: to join, and then at each
# collective (gloo's and nccl's default is 30 minutes)
JOIN_TIMEOUT = timedelta(seconds=300)


def process_env() -> Tuple[int, int]:
    """(process_id, num_processes) from the launcher env (1-process default)."""
    return (int(os.environ.get("NPT_PROC_ID", "0")),
            int(os.environ.get("NPT_NUM_PROCS", "1")))


def choose_backend(num_processes: int, on_cuda: bool) -> Tuple[str, str]:
    """(backend, reason) by the rule of the module docstring."""
    cards = torch.cuda.device_count() if on_cuda else 0
    if on_cuda and num_processes <= cards:
        return "nccl", f"{num_processes} ranks, {cards} CUDA devices"
    if on_cuda:
        return "gloo", (f"{num_processes} ranks share {cards} CUDA "
                        f"device(s); nccl needs a card per rank")
    return "gloo", "the run is on the CPU"


def join(coordinator: str, num_processes: int, process_id: int,
         device: Union[str, torch.device, None] = None,
         timeout: timedelta = JOIN_TIMEOUT) -> str:
    """Join a process group of ``num_processes`` ranks at
    ``tcp://<coordinator>`` as rank ``process_id``; the rank drives
    ``cuda:(rank % device_count)`` unless ``device`` is the CPU.  Raises
    if the group is not whole within ``timeout``, which also bounds every
    collective's wait.  Returns the backend; rank 0 prints it on stderr
    with the reason."""
    on_cuda = device is None or torch.device(device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        from ..utils.device import resolve_device
        resolve_device(device)                      # raises with the reason
    backend, reason = choose_backend(num_processes, on_cuda)
    if on_cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    atexit.register(_leave)
    if process_id == 0:
        print(f"nanopolish_tpu_torch: {num_processes} processes joined "
              f"torch.distributed over {backend} ({reason})", file=sys.stderr)
    return backend


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def auto_init(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              device: Union[str, torch.device, None] = None
              ) -> Tuple[int, int]:
    """Join the process group if a coordinator is configured and there is
    more than one process.  Returns (process_id, num_processes).  Safe to
    call more than once."""
    coordinator = coordinator or os.environ.get("NPT_COORDINATOR", "")
    pid, n = process_env()
    if process_id is not None:
        pid = process_id
    if num_processes is not None:
        n = num_processes
    if coordinator and n > 1 and not dist.is_initialized():
        join(coordinator, n, pid, device)
    return pid, n


def shard_arg() -> str:
    """The `--shard i/n` value for this process."""
    pid, n = process_env()
    return f"{pid}/{n}"


def _on_card(t: torch.Tensor, group) -> bool:
    return t.device.type == "cpu" or dist.get_backend(group) == "nccl"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor on t's device)."""
    if _on_card(t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out
    host = t.cpu()
    dist.all_reduce(host, group=group)
    return host.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated on axis 0, in rank
    order (JAX's tiled all_gather), on t's device."""
    size = dist.get_world_size(group)
    src = (t if _on_card(t, group) else t.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)
