"""Sphere-grid coordinate conversions (``ops/coords.py`` of the JAX package).

A hemisphere point is parameterised by (alpha, beta) in [-pi/2, pi/2]^2:
p = (sin(alpha) cos(beta), sin(beta), cos(alpha) cos(beta)). Grid index
``a`` of an (M, N) sphere image maps to the cell-centre angle
``(a - M/2 + 0.5) * pi / M``. All functions take arbitrary leading batch
dimensions; ``angle_to_point`` keeps the reference's ``sign(z)`` quirk
(z == 0 collapses to the zero vector).
"""

from __future__ import annotations

import math

import torch


def index_to_angle(index: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(..., 2) grid indices (a, b), possibly fractional -> (alpha, beta)."""
    m = torch.tensor(shape, dtype=index.dtype, device=index.device)
    return (index - 0.5 * m + 0.5) * math.pi / m


def angle_to_index(angle: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Angle -> (fractional) grid index. Inverse of :func:`index_to_angle`."""
    m = torch.tensor(shape, dtype=angle.dtype, device=angle.device)
    return (angle / math.pi + 0.5 - 0.5 / m) * m


def angle_to_point(angle: torch.Tensor) -> torch.Tensor:
    """(..., 2) angles -> (..., 3) unit hemisphere points (z >= 0)."""
    alpha, beta = angle[..., 0], angle[..., 1]
    point = torch.stack([torch.sin(alpha) * torch.cos(beta), torch.sin(beta),
                         torch.cos(alpha) * torch.cos(beta)], dim=-1)
    return point * torch.sign(point[..., 2:3])


def point_to_angle(point: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit points -> (..., 2) angles (alpha, beta)."""
    beta = torch.arcsin(point[..., 1])
    inner = point[..., 0] / torch.cos(beta)
    alpha = torch.arcsin(torch.clamp(inner, -1.0, 1.0))
    return torch.stack([alpha, beta], dim=-1)
