"""Device selection shared by the port's entry points.

Every entry point takes an explicit `device` that defaults to "cuda". A
CUDA request on a machine without CUDA raises: nothing falls back to the CPU
unless the caller asked for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    return dev
