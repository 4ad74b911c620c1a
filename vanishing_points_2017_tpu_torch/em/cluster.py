"""Masked average-linkage agglomerative 2-clustering (``em/cluster.py`` of
the JAX package), batched: each step merges the closest active cluster
pair of every image that still has more than two clusters and updates the
average-linkage distances in closed form,
D[new, :] = (n_i D[i, :] + n_j D[j, :]) / (n_i + n_j).

On a CUDA tensor the whole loop is one launch of kernel K3
(``csrc/cluster_two.cu``), one block per image, which reads nothing back;
on a CPU tensor it is the plain twin :func:`agglomerative_two_ref`, one
host read per merge step. The two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils import profiling
from .reads import host_bool

BIG = 1e12

CLUSTER_KERNEL = kernels.CudaKernel(
    "cluster_two.cu", "cluster_two_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    extra_flags=("-fmad=false",))


def agglomerative_two(dist: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """dist (B, N, N) float32, active (B, N) bool, contiguous, on one
    device -> (B, N) bool: True for the items in the cluster holding each
    image's lowest-indexed active item. The plain twin on the CPU; on a
    CUDA device one launch of K3, counted as ``em.cluster_launches``
    (inside a CUDA graph's capture, at each replay: ``em.em._capture``)."""
    dev = dist.device
    if dev.type not in ("cpu", "cuda") or active.dim() != 2:
        raise ValueError(f"agglomerative_two: dist on {dev}, active of "
                         f"shape {tuple(active.shape)}")
    b, n = active.shape
    kernels.require(dist, "dist", torch.float32, (b, n, n), dev)
    kernels.require(active, "active", torch.bool, (b, n), dev)
    if dev.type == "cpu":
        return agglomerative_two_ref(dist, active)
    out = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return out
    # the matrices of the images whose active items overflow shared memory
    scratch = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    CLUSTER_KERNEL.launch(
        kernels.ptr(dist), kernels.ptr(active), kernels.ptr(out),
        kernels.ptr(scratch), b, n, kernels.stream_of(dist))
    profiling.count("em.cluster_launches")
    return out


def agglomerative_two_ref(dist: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """The plain twin of :func:`agglomerative_two`, on any device.

    One host check per merge step decides whether any image still merges;
    an image that reached two clusters keeps its state unchanged, as a
    vmapped ``while_loop`` keeps it."""
    b, n, _ = dist.shape
    dev = dist.device
    ar = torch.arange(n, device=dev)
    bi = torch.arange(b, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    labels = ar.repeat(b, 1)
    sizes = torch.ones((b, n), dtype=dist.dtype, device=dev)
    pair_ok = active[:, :, None] & active[:, None, :] & ~eye
    d = torch.where(pair_ok, dist, BIG)
    num_clusters = torch.sum(active, dim=1)
    while host_bool((num_clusters > 2).any()):
        go = num_clusters > 2
        flat = torch.argmin(d.reshape(b, -1), dim=1)
        i, j = flat // n, flat % n  # merge j into i
        ni, nj = sizes[bi, i], sizes[bi, j]
        newrow = (ni[:, None] * d[bi, i] + nj[:, None] * d[bi, j]) / \
            (ni + nj)[:, None]
        is_i = (ar[None, :] == i[:, None])
        is_j = (ar[None, :] == j[:, None])
        d2 = torch.where(is_i[:, :, None], newrow[:, None, :], d)
        d2 = torch.where(is_i[:, None, :], newrow[:, :, None], d2)
        d2 = torch.where(is_j[:, :, None] | is_j[:, None, :], BIG, d2)
        d2 = torch.where(is_i[:, :, None] & is_i[:, None, :], BIG, d2)
        labels2 = torch.where(labels == j[:, None], i[:, None], labels)
        sizes2 = torch.where(is_i, (ni + nj)[:, None], sizes)
        d = torch.where(go[:, None, None], d2, d)
        labels = torch.where(go[:, None], labels2, labels)
        sizes = torch.where(go[:, None], sizes2, sizes)
        num_clusters = torch.where(go, num_clusters - 1, num_clusters)
    first = torch.argmax(active.to(torch.uint8), dim=1)
    return active & (labels == labels[bi, first][:, None])
