"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU.
There is no silent fallback: asking for ``cuda`` on a machine without a
usable card raises with the reason.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailable(RuntimeError):
    """The requested device cannot be used on this machine."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    d = torch.device(DEFAULT_DEVICE if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "nanopolish_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(CLI: --device cpu) to run the plain PyTorch path on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}; use 'cuda' or 'cpu'")
    return d
