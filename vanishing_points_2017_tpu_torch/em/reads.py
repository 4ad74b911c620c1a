"""The EM's device-to-host reads: every loop condition the EM and the
2-clustering's plain twin read back goes through :func:`host_bool`, which
counts it as ``em.host_reads`` inside a trace session
(``utils/profiling.py``)."""

from __future__ import annotations

import torch

from ..utils import profiling


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)``, counted: on a GPU each call waits for the device."""
    profiling.count("em.host_reads")
    return bool(t)
