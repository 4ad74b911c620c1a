"""The inverse-gnomonic sphere image, in plain PyTorch, for the
benchmark's reference.

Each homogeneous line (l0, l1, l2) is the curve
beta(alpha) = arctan((-l0 sin(alpha) - l2 cos(alpha)) / l1) over the
hemisphere's columns; every curve adds an anti-aliased coverage
clamp(0.5 + w/2 - |row - r(alpha)| / sqrt(1 + r'(alpha)^2), 0, 1) to each
pixel (w = 100/72 px, r' the central difference of the row centres), and
the image is 1 - 0.9^(sum of coverages), floored to 255 levels. Row 0 is
beta = +pi/2, column 0 is alpha = -pi/2. Lines are added eight at a
time, so memory stays at B x 8 x S^2 values.
"""

from __future__ import annotations

import math

import torch

LINEWIDTH_PX = 100.0 / 72.0
ALPHA = 0.1
CHUNK = 8


def sphere_image_u8(l: torch.Tensor, lmask: torch.Tensor, size: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """l (B, N, 3), lmask (B, N) -> (B, size, size) uint8, computed in
    ``dtype``."""
    b, n, _ = l.shape
    dev = l.device
    col = torch.arange(size, dtype=dtype, device=dev)
    alphas = (col - 0.5 * size + 0.5) * (math.pi / size)
    sa, ca = torch.sin(alphas), torch.cos(alphas)
    rows = torch.arange(size, dtype=dtype, device=dev)[:, None]
    l = l.to(dtype)
    acc = torch.zeros((b, size, size), dtype=dtype, device=dev)
    for c0 in range(0, n, CHUNK):
        lc = l[:, c0:c0 + CHUNK]
        beta = torch.arctan((-lc[..., 0:1] * sa - lc[..., 2:3] * ca)
                            / lc[..., 1:2])
        rc = 0.5 * size - 0.5 - beta * (size / math.pi)
        rc = torch.where(torch.isnan(rc), -1e6, rc)
        slope = torch.cat([rc[..., 1:2] - rc[..., 0:1],
                           0.5 * (rc[..., 2:] - rc[..., :-2]),
                           rc[..., -1:] - rc[..., -2:-1]], dim=-1)
        inv = torch.rsqrt(1.0 + slope * slope)
        dist = torch.abs(rows - rc[..., None, :]) * inv[..., None, :]
        cov = torch.clamp(0.5 + 0.5 * LINEWIDTH_PX - dist, 0.0, 1.0)
        cov = torch.where(lmask[:, c0:c0 + CHUNK, None, None], cov, 0.0)
        acc = acc + torch.sum(cov, dim=1)
    log1m = float(torch.log1p(torch.tensor(-ALPHA, dtype=torch.float32)))
    img = 1.0 - torch.exp(acc * log1m)
    return torch.floor(img.float() * 255.0).to(torch.uint8)
