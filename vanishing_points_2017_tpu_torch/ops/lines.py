"""Line-segment geometry (``ops/lines.py`` of the JAX package).

Dense masked (N, N) computations over padded segment arrays, with any
number of leading batch dimensions. A segment ``lp`` is (x1, y1, x2, y2)
in the normalized image frame (centre origin, +y up, long axis in
[-1, 1]); padded rows contribute exactly zero to every output.
"""

from __future__ import annotations

import math

import torch

from .select import topk_stable

PI = math.pi
# sentinel self/padding distance, the reference's self-distance 4
SELF_DIST = 4.0


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def line_length(lp: torch.Tensor) -> torch.Tensor:
    """(..., 4) segments -> (...,) Euclidean endpoint distance."""
    d = lp[..., 0:2] - lp[..., 2:4]
    return torch.linalg.vector_norm(d, dim=-1)


def lines_angles(lp: torch.Tensor) -> torch.Tensor:
    """Per-segment undirected inclination angle in [0, pi/2]."""
    v = lp[..., 0:2] - lp[..., 2:4]
    n = torch.linalg.vector_norm(v, dim=-1)
    vx = v[..., 0] / torch.where(n == 0, 1.0, n)
    phi = torch.abs(torch.arccos(torch.clamp(vx, -1.0, 1.0)))
    return torch.where(phi > PI / 2, PI - phi, phi)


def pairwise_cosangle(lp: torch.Tensor, f: float = 1.0) -> torch.Tensor:
    """(..., N, 4) -> (..., N, N) sharpened |cos| of the direction angle,
    cos(clip(f * dphi, -pi/2, pi/2)), dphi from atan2(|cross|, |dot|)."""
    v = lp[..., 0:2] - lp[..., 2:4]
    n = torch.linalg.vector_norm(v, dim=-1)
    vn = v / torch.where(n == 0, 1.0, n)[..., None]
    dot = torch.abs(vn @ _t(vn))
    cross = torch.abs(vn[..., :, None, 0] * vn[..., None, :, 1]
                      - vn[..., :, None, 1] * vn[..., None, :, 0])
    dphi = torch.atan2(cross, dot)
    return torch.cos(torch.clamp(f * dphi, -PI / 2, PI / 2))


def segment_point_distance(lp: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Distance from 2-D point(s) to segment(s), broadcasting."""
    a = lp[..., 0:2]
    ab = lp[..., 2:4] - a
    denom = torch.sum(ab * ab, dim=-1)
    t = torch.sum((p - a) * ab, dim=-1) / torch.where(denom == 0, 1.0, denom)
    t = torch.clamp(t, 0.0, 1.0)
    closest = a + t[..., None] * ab
    return torch.linalg.vector_norm(closest - p, dim=-1)


def pairwise_closest_distance(lp: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) -> (..., N, N) min endpoint-to-other-segment distance,
    diagonal = SELF_DIST."""
    n = lp.shape[-2]
    p1 = lp[..., None, :, 0:2]
    p2 = lp[..., None, :, 2:4]
    seg = lp[..., :, None, :]
    d1 = segment_point_distance(seg, p1)  # (..., N_seg, N_pt)
    d2 = segment_point_distance(seg, p2)
    d = torch.minimum(torch.minimum(d1, d2), torch.minimum(_t(d1), _t(d2)))
    eye = torch.eye(n, dtype=torch.bool, device=lp.device)
    return torch.where(eye, SELF_DIST, d)


def pairwise_proximity(lp: torch.Tensor, sigma: float = 0.1,
                       dist: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N, N) exp(-d^2 / (2 s^2)), s = sigma * min(len_i, len_j)."""
    if dist is None:
        dist = pairwise_closest_distance(lp)
    ll = line_length(lp)
    s = sigma * torch.minimum(ll[..., :, None], ll[..., None, :])
    s2 = torch.where(s == 0, 1.0, 2.0 * s * s)
    prox = torch.exp(-(dist * dist) / s2)
    return torch.where(s == 0, 0.0, prox)


def calc_lsim(lp: torch.Tensor, mask: torch.Tensor,
              sigma: float = 0.1) -> torch.Tensor:
    """Masked (..., N, N) line similarity: cosangle(f=9) * proximity,
    zero diagonal, zero rows/columns for invalid lines."""
    n = lp.shape[-2]
    sim = pairwise_cosangle(lp, f=9.0) * pairwise_proximity(lp, sigma)
    eye = torch.eye(n, dtype=torch.bool, device=lp.device)
    sim = torch.where(eye, 0.0, sim)
    m2 = mask[..., :, None] & mask[..., None, :]
    return torch.where(m2, sim, 0.0)


def line_rating_knn(lp: torch.Tensor, mask: torch.Tensor, k1: int = 10,
                    k2: int = 3, sigma: float = 1.0) -> torch.Tensor:
    """Per-line kNN quality score (``line_rating_knn`` of the reference):
    among the k1 nearest segments take the k2 best by cosangle(f=9), sum
    proximity * cosangle, divide by min(k2, #valid)."""
    n = lp.shape[-2]
    num_valid = torch.sum(mask, dim=-1)
    dist0 = pairwise_closest_distance(lp)
    big = 1e9
    dist = torch.where(mask[..., None, :], dist0, big)
    k1 = min(k1, n)
    k2 = min(k2, n)
    _, nbr = topk_stable(-dist, k1)  # (..., N, k1)

    cosang = pairwise_cosangle(lp, f=9.0)
    prox = pairwise_proximity(lp, sigma, dist=dist0)

    mask_b = mask[..., None, :].expand(dist.shape)
    nbr_valid = (torch.gather(mask_b, -1, nbr)
                 & (torch.gather(dist, -1, nbr) < big / 2))
    cosphi = torch.where(nbr_valid, torch.gather(cosang, -1, nbr), -1.0)
    proxk = torch.where(nbr_valid, torch.gather(prox, -1, nbr), 0.0)

    topc, topi = topk_stable(cosphi, k2)
    topp = torch.gather(proxk, -1, topi)
    contrib = torch.where(topc > -0.5, topp * topc, 0.0)
    k2_eff = torch.clamp(torch.minimum(
        torch.tensor(float(k2), dtype=dist.dtype, device=dist.device),
        num_valid.to(dist.dtype)), min=1.0)
    score = torch.sum(contrib, dim=-1) / k2_eff[..., None]
    return torch.where(mask, score, 0.0)


def segments_to_homogeneous(lp: torch.Tensor) -> torch.Tensor:
    """(..., 4) segments -> (..., 3) homogeneous lines l = p1 x p2."""
    x1, y1, x2, y2 = lp[..., 0], lp[..., 1], lp[..., 2], lp[..., 3]
    return torch.stack([y1 - y2, x2 - x1, x1 * y2 - y1 * x2], dim=-1)


def normalize_rows(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize the last axis; zero rows stay zero."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n <= eps, 1.0, n)
