"""A (dp, tp) mesh of ``torch.distributed`` ranks, the sharding rule for the
CNN's parameters, and the collectives the port's sharded code calls
(``parallel/mesh.py`` of the JAX package).

* **dp**: data parallelism over images. Each dp rank runs its slice of the
  batch's leading axis (:func:`shard_batch`); training averages the
  gradients over dp with one all-reduce.
* **tp**: tensor parallelism over the wide fc6 and fc7 layers (fc6 is
  57600 x 4096, 94% of the dense model's parameters). fc6's output
  dimension and fc7's input dimension are split (:func:`param_spec`), so
  the activation between them stays split and fc7 ends in one tp
  all-reduce (``parallel/tp.py``).

Ranks are laid out dp-major: rank ``r`` is ``(r // tp, r % tp)``, so a tp
group is ``tp`` consecutive ranks and stays inside a node whenever ``tp``
divides the node's ranks (``distributed.make_multislice_mesh``). Without
an initialised process group the mesh is 1 x 1 and every collective is
the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x tp mesh and its two process groups (both
    None without an initialised process group)."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: object = None
    tp_group: object = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(dp: int | None = None, tp: int = 1) -> Mesh:
    """A (dp, tp) mesh over every rank of the process group; ``dp``
    defaults to all ranks over ``tp``. Every rank must call it, with the
    same arguments: the groups are created in the same order on each."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = world // tp
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"dp*tp = {dp}*{tp} != {world} ranks")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0)
    rank = dist.get_rank()
    dp_group = tp_group = None
    for i in range(dp):  # tp groups: consecutive ranks
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if i == rank // tp:
            tp_group = g
    for j in range(tp):  # dp groups: the ranks of one tp index
        g = dist.new_group(list(range(j, world, tp)))
        if j == rank % tp:
            dp_group = g
    return Mesh(dp, tp, rank // tp, rank % tp, dp_group, tp_group)


def param_spec(layer: str, key: str, tensor: torch.Tensor) -> int | None:
    """The dimension of a parameter that tp splits, or None (replicated):
    fc6's output dimension (``w``, ``v``, ``b``; the rank dimension of
    ``u``), fc7's input dimension (``w``, ``u``, and the rank dimension of
    ``v``); fc7's bias, the convolutions and fc8 are replicated. ``key`` is
    part of the rule's signature, as the JAX rule reads the leaf's path;
    the rule itself goes by layer and rank."""
    del key
    if layer == "fc6":
        return 1 if tensor.dim() == 2 else 0
    if layer == "fc7" and tensor.dim() == 2:
        return 0
    return None


def _split(t: torch.Tensor, dim: int, parts: int, index: int,
           what: str) -> torch.Tensor:
    if t.shape[dim] % parts:
        raise ValueError(f"{what}: size {t.shape[dim]} of dim {dim} not "
                         f"divisible by {parts}")
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).contiguous()


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slices of a port-layout ``{layer: {key: tensor}}`` dict,
    by :func:`param_spec` (replicated tensors are returned as they are)."""
    out: dict = {}
    for layer, d in params.items():
        out[layer] = {}
        for key, t in d.items():
            dim = param_spec(layer, key, t)
            out[layer][key] = t if dim is None or mesh.tp == 1 else _split(
                t, dim, mesh.tp, mesh.tp_index, f"{layer}/{key}")
    return out


def gather_params(local: dict, mesh: Mesh) -> dict:
    """The inverse of :func:`shard_params`: every tp-split tensor gathered
    over the tp group, replicated tensors as they are."""
    out: dict = {}
    for layer, d in local.items():
        out[layer] = {}
        for key, t in d.items():
            dim = param_spec(layer, key, t)
            out[layer][key] = t if dim is None or mesh.tp == 1 else \
                all_gather(t.detach(), mesh.tp_group, dim)
    return out


def shard_batch(tree, mesh: Mesh):
    """This rank's dp slice of the leading axis of every tensor of
    ``tree`` (a tensor, or a dict, list or tuple of them)."""
    if isinstance(tree, torch.Tensor):
        return _split(tree, 0, mesh.dp, mesh.dp_index, "batch")
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    return type(tree)(shard_batch(v, mesh) for v in tree)


# ---- collectives. Both backends take CUDA tensors of every type the port
# sends (gloo copies them through the host itself; scripts/probe_gloo_cuda.py
# found all_reduce, all_gather, broadcast and reduce_scatter working on
# CUDA tensors with torch 2.11 on an H100), so nothing is staged here.

def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (the identity without a group);
    returns ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every member's ``t`` concatenated along ``dim`` in rank order (``t``
    itself without a group)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_outputs(out, mesh: Mesh):
    """Outputs of this rank's dp slice (a tensor, or a dict of them) ->
    the whole batch's, gathered over the dp group along the leading
    axis."""
    if isinstance(out, torch.Tensor):
        return all_gather(out, mesh.dp_group, 0)
    return {k: gather_outputs(v, mesh) for k, v in out.items()}
