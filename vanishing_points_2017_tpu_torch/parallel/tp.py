"""Tensor parallelism for the CNN's fc6 and fc7: the collectives that XLA
inserts for the JAX package's tp-sharded parameters, written out.

:class:`TPVPNet` is ``models/cnn.VPNet`` holding this rank's shards
(``mesh.shard_params``) and running fc6/fc7 over the mesh's tp group; the
convolutions and fc8 are replicated, so every rank of a tp group computes
them alike on the same images. The sequence follows from
``mesh.param_spec`` (t is this rank's tp index, n = tp):

* Dense. fc6 is column-parallel: ``h6_t = relu(x @ w6[:, t] + b6[t])`` is
  this rank's slice of fc6's output, and fc6's dropout mask is sliced
  alike. fc7 is row-parallel: ``x7 = sum_t h6_t @ w7[t, :]`` is one tp
  all-reduce, then fc7's (replicated) bias, relu and its full dropout mask.
* Factorized (``x @ u @ v``, rank r). fc6: ``u6[:, t]`` gives the rank
  activations ``r_t = x @ u6[:, t]`` (B, r/n); an all-gather makes the
  whole (B, r), and ``v6[:, t]`` gives fc6's output slice t as in the dense
  case. fc7: ``u7[t, :]`` takes fc6's slice t, ``r = sum_t h6_t @ u7[t, :]``
  (B, r) is one all-reduce; ``v7[t, :]`` takes the columns t of ``r``, and
  ``x7 = sum_t r[:, t] @ v7[t, :]`` is a second all-reduce.

A product whose partial results are summed over tp is taken in float32
from operands rounded to the compute type, and the sum is rounded to the
compute type once: the single-process product (bf16 operands, float32
accumulation, one rounding) up to the order of the float32 sum.

Gradients: a replicated tensor that feeds a tp-split product gets a
partial gradient on every rank, and a tp sum feeds replicated work. So the
input of each split product passes :func:`copy_to_tp` (identity forward,
all-reduce backward) and each sum is :func:`reduce_from_tp` (all-reduce
forward, identity backward; ``torch.distributed.nn``'s all_reduce would
all-reduce the gradient as well and multiply it by n). The all-gather's
backward sums the gradient over the group and keeps this rank's columns.
"""

from __future__ import annotations

import torch

from ..models import cnn
from . import mesh as pmesh


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return pmesh.all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return pmesh.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along the last dim forward; backward, the gradient
    summed over the group and this rank's columns kept."""

    @staticmethod
    def forward(ctx, x, group, index, parts):
        ctx.group, ctx.index, ctx.parts = group, index, parts
        return pmesh.all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        g = pmesh.all_reduce(g.contiguous().clone(), ctx.group)
        n = g.shape[-1] // ctx.parts
        return g.narrow(-1, ctx.index * n, n), None, None, None


def copy_to_tp(x: torch.Tensor, mesh: pmesh.Mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: pmesh.Mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh.tp_group)


def gather_from_tp(x: torch.Tensor, mesh: pmesh.Mesh) -> torch.Tensor:
    return _GatherFromTP.apply(x, mesh.tp_group, mesh.tp_index, mesh.tp)


def local_keep(keep: list, mesh: pmesh.Mesh) -> list:
    """Dropout masks drawn for the global batch -> this rank's: its dp rows
    of both, and its tp columns of fc6's."""
    k6, k7 = pmesh.shard_batch(list(keep), mesh)
    n = k6.shape[1] // mesh.tp
    return [k6[:, mesh.tp_index * n:(mesh.tp_index + 1) * n], k7]


class TPVPNet(cnn.VPNet):
    """The VP-grid CNN with fc6/fc7 split over the mesh's tp group.
    ``params``: this rank's shards of port-layout parameters
    (``mesh.shard_params``). Serving (``forward``, fixed chunks) and
    training (:meth:`logits`) are ``VPNet``'s; every rank of a tp group
    must call them on the same images."""

    def __init__(self, params: dict, mesh: pmesh.Mesh,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(params, compute_dtype)
        self.mesh = mesh

    def fc_widths(self) -> list:
        """The global widths of fc6 and fc7 (the masks are drawn whole)."""
        return [self.layers["fc6"].b.shape[0] * self.mesh.tp,
                self.layers["fc7"].b.shape[0]]

    def logits(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        """As ``VPNet.logits``; ``keep`` holds this rank's slices of the
        masks (:func:`local_keep`)."""
        cd, f32, mesh = self.compute_dtype, torch.float32, self.mesh
        p6, p7, p8 = (self.layers[n] for n in ("fc6", "fc7", "fc8_20x20"))
        h = copy_to_tp(self.features(x), mesh).to(cd)
        if hasattr(p6, "u"):
            r = gather_from_tp((h @ p6.u.to(cd)).to(f32), mesh)
            y = r.to(cd) @ p6.v.to(cd)
        else:
            y = h @ p6.w.to(cd)
        h = torch.relu(y.to(f32) + p6.b)
        if keep is not None:
            h = torch.where(keep[0], h / 0.5, 0.0)

        def partial(a, b):  # summed over tp by the caller
            return a.to(cd).to(f32) @ b.to(cd).to(f32)

        if hasattr(p7, "u"):
            r = reduce_from_tp(partial(h, p7.u), mesh).to(cd)
            n = r.shape[-1] // mesh.tp
            r = copy_to_tp(r, mesh)[:, mesh.tp_index * n:(mesh.tp_index + 1)
                                     * n]
            y = partial(r, p7.v)
        else:
            y = partial(h, p7.w)
        y = reduce_from_tp(y, mesh).to(cd)
        h = torch.relu(y.to(f32) + p7.b)
        if keep is not None:
            h = torch.where(keep[1], h / 0.5, 0.0)
        y = h.to(cd) @ p8.w.to(cd)
        return (y.to(f32) + p8.b).reshape(-1, cnn.GRID, cnn.GRID)


def shard_model(model: cnn.VPNet, mesh: pmesh.Mesh) -> TPVPNet:
    """A :class:`TPVPNet` of this rank's shards of ``model``'s parameters,
    in its compute type and mode."""
    tp = TPVPNet(pmesh.shard_params(
        {n: {k: v.detach() for k, v in d.items()}
         for n, d in model.params().items()}, mesh), mesh,
        model.compute_dtype)
    return tp.train(model.training)
