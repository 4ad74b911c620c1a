# A frozen copy of the port's ``ops/select.py``, part of the benchmark's plain
# reference: it imports nothing of the port, so later changes to the port
# cannot move what the program is judged against.
"""Deterministic selection helpers.

``jax.lax.top_k`` returns ties in index order; ``torch.topk`` promises no
order among ties, and on CUDA its order differs from the CPU's. Wherever
the chosen set or its order reaches an output, the port selects with a
stable descending sort instead, which keeps equal values in index order on
every device.
"""

from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along ``dim``, ties lowest index
    first — ``lax.top_k``'s contract."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)
