"""Masked average-linkage agglomerative 2-clustering (``em/cluster.py`` of
the JAX package), batched: each step merges the closest active cluster
pair of every image that still has more than two clusters and updates the
average-linkage distances in closed form,
D[new, :] = (n_i D[i, :] + n_j D[j, :]) / (n_i + n_j).
"""

from __future__ import annotations

import torch

BIG = 1e12


def agglomerative_two(dist: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """dist (B, N, N) symmetric, active (B, N) -> (B, N) bool: True for the
    items in the cluster holding each image's lowest-indexed active item.

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
    while bool((num_clusters > 2).any()):
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
