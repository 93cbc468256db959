"""Where an entry point runs.

Every entry point of the package takes an explicit `device` argument. The
default is the GPU; the CPU is used only when the caller names it (the tests
do). There is no quiet fallback: with no CUDA device and no explicit "cpu"
the call raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceArg = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceArg = None) -> torch.device:
    """None -> the current CUDA device (raises when there is none);
    anything else -> torch.device(device), CUDA requests checked too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "curdleproofs_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
