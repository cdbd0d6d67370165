"""The device an entry point runs on: CUDA unless the caller asks for
another, and no silent fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, caller: str) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device is available; pass "
                           f"device='cpu' to run on the CPU")
    return device
