"""Multi-process start-up (``parallel/distributed.py`` of the JAX package).

Every process calls :func:`initialize`, a thin wrapper over
``torch.distributed.init_process_group`` that reads torch's own launcher
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, as ``torchrun`` exports them), binds
the rank's device and returns it. Then :func:`make_multislice_mesh` builds
the (dp, tp) mesh with the model axis (tp) inside a node and the data axis
(dp) across nodes: only the gradient all-reduce then crosses nodes, the
activation collectives stay on the node's links.

The backend is explicit. On a GPU the default is ``nccl``; NCCL refuses
two ranks on one card, so where a node's ranks outnumber its GPUs
:func:`initialize` raises unless the caller passes ``backend="gloo"``
(gloo takes CUDA tensors for the collectives the port uses). Without a
GPU the only backend is ``gloo``. Nothing switches backends by itself.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def _env_int(name: str, default: int | None = None) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None,
               backend: str | None = None) -> torch.device:
    """Start the process group (idempotent) and return this rank's device:
    ``cuda:(LOCAL_RANK % device_count)`` on a GPU machine, else the CPU.

    Arguments left None come from the environment (``init_method``
    defaults to ``env://``, which reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). Raises where a node's ranks outnumber its GPUs and
    ``backend`` is not ``"gloo"``."""
    local_rank = _env_int("LOCAL_RANK", 0)
    if torch.cuda.is_available():
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if dist.is_initialized():
        return device
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE", 1)
    rank = rank if rank is not None else _env_int("RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    if device.type == "cuda":
        backend = backend or "nccl"
        if local_world > torch.cuda.device_count() and backend != "gloo":
            raise ValueError(
                f"{local_world} ranks on a node with "
                f"{torch.cuda.device_count()} GPUs: NCCL takes one rank per "
                "GPU; pass backend='gloo' to share a GPU between ranks")
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return device


def make_multislice_mesh(tp: int = 1) -> Mesh:
    """A (dp, tp) mesh whose tp groups lie inside one node: dp runs across
    nodes. ``LOCAL_WORLD_SIZE`` gives a node's ranks (all ranks when it is
    unset); raises where ``tp`` does not divide them."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return make_mesh(tp=tp)
    per_node = _env_int("LOCAL_WORLD_SIZE", world)
    if tp > per_node or per_node % tp:
        raise ValueError(f"tp={tp} must divide the {per_node} ranks of one "
                         "node")
    return make_mesh(dp=world // tp, tp=tp)
