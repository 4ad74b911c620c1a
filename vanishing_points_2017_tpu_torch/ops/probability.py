"""E-step probability kernels (``ops/probability.py`` of the JAX package),
batched: every function takes a leading image dimension B.

Log-space likelihoods with the reference's floors (s >= 1e-200,
p(l) >= 1e-12), masked static shapes (padded lines, dead VP slots), and the
reference's quirks: the duplicated d4 wraparound term of ``calc_pdf``
(``wrap_quirk``) and the top-100 truncation of the CNN prior. The "area"
distance (:func:`calc_lvsq_area`) keeps the reference's cross product of a
2-vector with a 3-vector, which numpy pads with a zero: the VP acts as a
point at infinity. It is exported as in the JAX package; ``EMConfig``
refuses it as a distance measure there and here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LOG2PI = math.log(2.0 * math.pi)
LOG_S_FLOOR = -460.517018598809136804  # log(1e-200), reference's s floor
LOG_PL_FLOOR = -27.63102111592854820822  # log(1e-12), reference's p(l) floor


class PDFParams(NamedTuple):
    """Hemisphere GMM prior derived from the CNN's 20x20 grids."""

    means: torch.Tensor    # (K, 2) cell-centre (alpha, beta)
    weights: torch.Tensor  # (B, K) normalized, top-k truncated, scaled
    sigma: float           # isotropic std dev (float32 value)


class PDFResult(NamedTuple):
    p_v: torch.Tensor      # (B, M) prior at VP positions; 0 on dead slots
    log_plv: torch.Tensor  # (B, N, M) log likelihood
    p_vl: torch.Tensor     # (B, M, N) posterior
    log_pl: torch.Tensor   # (B, N) log evidence (floored)
    lvsq: torch.Tensor     # (B, N, M) squared line-VP inconsistency
    angles: torch.Tensor   # (B, M, 2) VP angles


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def pdf_params(cnn_response: torch.Tensor, confidence: float = 1.282,
               top_k: int = 100) -> PDFParams:
    """(B, 20, 20) CNN grids -> GMM prior; sigma = pi / (confidence * A)."""
    b, a_dim, b_dim = cnn_response.shape
    dev = cnn_response.device
    sigma = _f32(math.pi / (confidence * a_dim))
    alphas = torch.linspace(-(a_dim - 1.0) / a_dim * math.pi / 2,
                            (a_dim - 1.0) / a_dim * math.pi / 2, a_dim,
                            device=dev)
    betas = torch.linspace(-(b_dim - 1.0) / b_dim * math.pi / 2,
                           (b_dim - 1.0) / b_dim * math.pi / 2, b_dim,
                           device=dev)
    means = torch.stack([alphas.repeat(b_dim),
                         betas.repeat_interleave(a_dim)], dim=-1)
    weights = cnn_response.reshape(b, -1)
    n = weights.shape[1]
    if top_k < n:
        kth = torch.sort(weights, dim=-1).values[:, n - top_k:n - top_k + 1]
        weights = torch.where(weights >= kth, weights, 0.0)
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    weights = weights / torch.where(wsum == 0, 1.0, wsum)
    s = torch.tensor(sigma, dtype=torch.float32)
    weights = weights / float(2.0 * math.pi * s * s)
    return PDFParams(means=means, weights=weights, sigma=sigma)


def calc_pdf(pdfpar: PDFParams, query: torch.Tensor,
             wrap_quirk: bool = True) -> torch.Tensor:
    """GMM prior at query angles: query (B, Q, 2) -> (B, Q)."""
    mx = pdfpar.means[:, 0]
    my = pdfpar.means[:, 1]
    qx = query[..., 0][..., None]  # (B, Q, 1)
    qy = query[..., 1][..., None]

    def sq(dx, dy):
        return dx * dx + dy * dy

    d1 = sq(qx - mx, qy - my)
    d2 = sq(qx - mx + math.pi, qy + my)
    d3 = sq(qx - mx - math.pi, qy + my)
    d4 = sq(qx + mx, qy - my - math.pi)
    d5 = d4 if wrap_quirk else sq(qx + mx, qy - my + math.pi)
    s = torch.tensor(pdfpar.sigma, dtype=torch.float32)
    inv = float(-0.5 / (s * s))
    e = (torch.exp(d1 * inv) + torch.exp(d2 * inv) + torch.exp(d3 * inv)
         + torch.exp(d4 * inv) + torch.exp(d5 * inv))
    return (e @ pdfpar.weights[..., None])[..., 0]


def calc_angles(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) VP points -> (..., 2) angles (alpha, beta)."""
    beta = torch.arcsin(torch.clamp(v[..., 1], -1.0, 1.0))
    inner = v[..., 0] / torch.cos(beta)
    alpha = torch.arcsin(torch.clamp(inner, -1.0, 1.0))
    return torch.stack([alpha, beta], dim=-1)


def calc_lvsq_dotprod(v: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) VPs x (B, N, 3) lines -> (B, N, M) squared dot products."""
    lv = l @ v.transpose(-1, -2)
    return lv * lv


def calc_lvsq_angle(v: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """(1 - |cos(midpoint - VP, p1 - p2)|)^2: (B, M, 3), (B, N, 4) ->
    (B, N, M)."""
    v2 = v[..., 0:2] / v[..., 2:3]
    lm = 0.5 * (lp[..., 0:2] + lp[..., 2:4])
    vec1 = lm[..., :, None, :] - v2[..., None, :, :]  # (B, N, M, 2)
    vec2 = lp[..., 0:2] - lp[..., 2:4]
    dot = torch.sum(vec1 * vec2[..., :, None, :], dim=-1)
    n1 = torch.linalg.vector_norm(vec1, dim=-1)
    n2 = torch.linalg.vector_norm(vec2, dim=-1)[..., None]
    c = torch.abs(dot / (n1 * n2))
    d = 1.0 - c
    return d * d


def calc_lvsq(v: torch.Tensor, l: torch.Tensor, lp: torch.Tensor,
              distance_measure: str) -> torch.Tensor:
    if distance_measure == "angle":
        return calc_lvsq_angle(v, lp)
    if distance_measure == "dotprod":
        return calc_lvsq_dotprod(v, l)
    raise ValueError(f"unsupported distance measure: {distance_measure}")


def calc_probabilities(pdfpar: PDFParams, v: torch.Tensor, alive: torch.Tensor,
                       l: torch.Tensor, lp: torch.Tensor, log_s: torch.Tensor,
                       lmask: torch.Tensor, distance_measure: str = "angle",
                       wrap_quirk: bool = True) -> PDFResult:
    """Full E-step. v (B, M, 3), alive (B, M), l (B, N, 3), lp (B, N, 4),
    log_s (B, M), lmask (B, N). Dead slots become the placeholder (0, 0, 1)
    before any geometry and get a zero prior. The placeholder is made on
    the device (a copy from the host would break a CUDA graph capture)."""
    ph = (torch.arange(3, device=v.device) == 2).to(v.dtype)
    v_safe = torch.where(alive[..., None], v, ph)

    angles = calc_angles(v_safe)
    p_v = torch.where(alive, calc_pdf(pdfpar, angles, wrap_quirk), 0.0)

    lvsq = calc_lvsq(v_safe, l, lp, distance_measure)  # (B, N, M)
    log_s_f = torch.clamp(log_s, min=LOG_S_FLOOR)
    expo = -torch.exp(torch.log(lvsq) - log_s_f[:, None, :] - math.log(2.0))
    log_plv = expo - 0.5 * (LOG2PI + log_s_f)[:, None, :]

    log_pv = torch.where(p_v > 0, torch.log(torch.where(p_v > 0, p_v, 1.0)),
                         -math.inf)
    joint = log_plv + log_pv[:, None, :]
    joint = torch.where(alive[:, None, :], joint, -math.inf)
    jmax = torch.max(joint, dim=2, keepdim=True).values
    jmax_safe = torch.where(torch.isfinite(jmax), jmax, 0.0)
    log_pl = jmax_safe[..., 0] + torch.log(
        torch.sum(torch.exp(joint - jmax_safe), dim=2))
    log_pl = torch.clamp(log_pl, min=LOG_PL_FLOOR)

    p_vl = torch.exp(joint - log_pl[..., None]).transpose(1, 2)  # (B, M, N)
    p_vl = torch.where(alive[:, :, None] & lmask[:, None, :], p_vl, 0.0)
    return PDFResult(p_v=p_v, log_plv=log_plv, p_vl=p_vl, log_pl=log_pl,
                     lvsq=lvsq, angles=angles)


def calc_lvsq_single(v: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """Per-(VP, line) angle measure for the outlier test, broadcasting
    (..., 3) with (..., 4) -> (...,)."""
    v2 = v[..., 0:2] / v[..., 2:3]
    lm = 0.5 * (lp[..., 0:2] + lp[..., 2:4])
    vec1 = lm - v2
    vec2 = lp[..., 0:2] - lp[..., 2:4]
    dot = torch.sum(vec1 * vec2, dim=-1)
    c = torch.abs(dot / (torch.linalg.vector_norm(vec1, dim=-1)
                         * torch.linalg.vector_norm(vec2, dim=-1)))
    d = 1.0 - c
    return d * d


def _area_measure(vx, vy, lp: torch.Tensor) -> torch.Tensor:
    """(a b^2 / c)^2 of the triangle between a segment and the line through
    its midpoint with direction (vx, vy): b the distance of endpoint 1 to
    that line, c half the segment's length, a = sqrt(c^2 - b^2) (NaN when
    b > c, as in the reference). vx, vy and lp[..., k] broadcast."""
    lmx = 0.5 * (lp[..., 0] + lp[..., 2])
    lmy = 0.5 * (lp[..., 1] + lp[..., 3])
    # cross((vx, vy, 0), (lmx, lmy, 1)) = (vy, -vx, vx lmy - vy lmx)
    vl2 = vx * lmy - vy * lmx
    b = torch.abs(vy * lp[..., 0] - vx * lp[..., 1] + vl2) / torch.sqrt(
        vy * vy + vx * vx)
    dx, dy = lmx - lp[..., 2], lmy - lp[..., 3]
    c = torch.sqrt(dx * dx + dy * dy)
    t = torch.sqrt(c * c - b * b) * b * b / c
    return t * t


def calc_lvsq_area(v: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """Triangle-area measure: (B, M, 3) VPs, (B, N, 4) segments ->
    (B, N, M)."""
    v2 = v[..., 0:2] / v[..., 2:3]
    return _area_measure(v2[..., None, :, 0], v2[..., None, :, 1],
                         lp[..., :, None, :])


def calc_lvsq_area_single(v: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """Per-(VP, line) area measure, broadcasting (..., 3) with (..., 4) ->
    (...,)."""
    v2 = v[..., 0:2] / v[..., 2:3]
    return _area_measure(v2[..., 0], v2[..., 1], lp)


def pdf_grid(cnn_response: torch.Tensor, n: int = 50,
             wrap_quirk: bool = True) -> dict:
    """The GMM prior of (B, 20, 20) CNN grids on an n x n angle grid, for
    plots: ``X`` and ``Y`` (n, n), ``p`` (B, n, n)."""
    xs = torch.from_numpy(np.arange(-np.pi / 2, np.pi / 2, np.pi / n,
                                    dtype=np.float32)).to(cnn_response.device)
    grid_x, grid_y = torch.meshgrid(xs, xs, indexing="xy")
    q = torch.stack([grid_x.reshape(-1), grid_y.reshape(-1)], dim=-1)
    b = cnn_response.shape[0]
    p = calc_pdf(pdf_params(cnn_response), q[None].expand(b, -1, -1),
                 wrap_quirk)
    return {"X": grid_x, "Y": grid_y, "p": p.reshape(b, *grid_x.shape)}


def calc_vp_line_triangles(vp: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """Signed test of whether each segment faces the VP: vp (..., 3),
    lp (..., N, 4) -> (..., N)."""
    v = (vp[..., 0:2] / vp[..., 2:3])[..., None, :]
    p1, p2 = lp[..., 0:2], lp[..., 2:4]
    a1 = torch.sum((v - p1) * (p2 - p1), dim=-1)
    a2 = torch.sum((v - p2) * (p1 - p2), dim=-1)
    return torch.where(a1 > 0, torch.minimum(a1, a2), a1)


def vp_is_within_image(vp: torch.Tensor) -> torch.Tensor:
    """|x/z| < 2 and |y/z| < 2 (looser than the horizon module's +-1
    ``vp_in_image``): (..., 3) -> (...,) bool."""
    v2 = vp[..., 0:2] / vp[..., 2:3]
    return (torch.abs(v2[..., 0]) < 2) & (torch.abs(v2[..., 1]) < 2)
