"""Fixed-size chunks, so an image's result does not depend on its batch.

cuDNN, cuBLAS and PyTorch's reduction kernels choose their algorithm, and
with it the floating-point summation order, by the shapes they are given.
A stage run on the caller's whole batch therefore gives an image slightly
different numbers at batch 4 than at batch 32, and the CNN grid and the
EM's knife edges turn that into a different VP set. :func:`in_chunks` runs
a stage on chunks of exactly ``CHUNK`` images, the last one padded with
zero images whose rows are dropped, so every image meets the same kernels
whatever the batch size and its position in it: on an NVIDIA H100 the CNN
grid and the EM's VPs and horizon are then bit-identical at batch 1, 4, 32
and 33 at any position, with chunks of 8 or 32 (``scripts/probe_chunks.py``,
PERF.md). Chunk 32 costs the device stage nothing resolvable at batch 8
and 32, and 1.5-1.6x at batch 64 (one host-bound EM loop per chunk);
chunk 8 would cost 2.5-4.4x at batch 32.

On the CPU every image runs alone (chunk 1): there a stage's cost grows
with the rows it is given, so padding a small batch to 32 would multiply
it, and one image per call is batch-invariant by construction.
"""

from __future__ import annotations

import torch

CHUNK = 32  # images per call on a GPU


def default_chunk(t: torch.Tensor) -> int:
    return CHUNK if t.is_cuda else 1


def _cat(parts: list, n: int):
    """Concatenate the chunks' outputs (tensors, or tuples and named
    tuples of them) along dim 0 and keep the first ``n`` rows."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)[:n]
    items = [_cat(list(z), n) for z in zip(*parts)]
    return type(first)(*items) if hasattr(first, "_fields") else \
        type(first)(items)


def in_chunks(fn, tensors: list[torch.Tensor], chunk: int | None = None):
    """``fn(*tensors)`` computed on chunks of ``chunk`` rows (by default
    :func:`default_chunk`) of the tensors' shared leading (batch) dim,
    zero-padded to a whole chunk."""
    chunk = chunk or default_chunk(tensors[0])
    b = tensors[0].shape[0]
    pad = -b % chunk
    if pad:
        tensors = [torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
                   for t in tensors]
    return _cat([fn(*(t[i:i + chunk] for t in tensors))
                 for i in range(0, b + pad, chunk)], b)
