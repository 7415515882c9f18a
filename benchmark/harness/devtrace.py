"""What the device did in a traced window, from torch.profiler's record of
its kernels and copies: the union of their intervals (busy seconds), each
kernel's summed time, the operations that took most time and the longest
idle gaps, each named by the operations on either side of it; and the
union of the kernels' intervals alone."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple


def device_intervals(prof) -> List[Tuple[float, float, str]]:
    """(start s, end s, name) of every device operation the profiler
    recorded."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) != cuda:
            continue
        tr = e.time_range
        if tr.end > tr.start:
            out.append((tr.start * 1e-6, tr.end * 1e-6, e.name))
    out.sort()
    return out


def kernels(iv):
    """The kernels alone: no copy or fill, which the copy engines run
    beside them."""
    return [i for i in iv if not i[2].startswith(("Memcpy", "Memset"))]


def union_seconds(iv) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def short(name: str) -> str:
    """A kernel's name without its namespace, return type, arguments and
    template parameters."""
    n = name.replace("(anonymous namespace)::", "")
    n = n.split("(")[0].split("<")[0].strip()
    return n.removeprefix("void ").strip()


def by_name(iv) -> dict:
    tot = defaultdict(float)
    for s, e, n in iv:
        tot[short(n)] += e - s
    return dict(tot)


def breakdown(iv, top: int = 10) -> dict:
    ops = sorted(by_name(iv).items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    cur_e, prev = None, None
    for s, e, n in sorted(iv):
        if cur_e is not None and s > cur_e:
            gaps.append((f"after {short(prev)}, before {short(n)}",
                         s - cur_e))
        if cur_e is None or e > cur_e:
            cur_e, prev = e, n
    merged = defaultdict(float)
    for name, g in gaps:
        merged[name] += g
    longest = sorted(merged.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in longest]}
