"""The device check shared by the port's entry points."""

from __future__ import annotations

import torch


def require_device(name: str | torch.device) -> torch.device:
    """The torch device ``name``; raises when it is a CUDA device and no
    GPU is present (nothing falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA GPU is available "
                           "(device='cpu', or --device cpu, runs on the "
                           "CPU)")
    return dev
