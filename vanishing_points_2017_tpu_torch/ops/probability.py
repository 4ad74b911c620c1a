"""E-step probability kernels (``ops/probability.py`` of the JAX package),
batched: every function takes a leading image dimension B.

Log-space likelihoods with the reference's floors (s >= 1e-200,
p(l) >= 1e-12), masked static shapes (padded lines, dead VP slots), and the
reference's quirks: the duplicated d4 wraparound term of ``calc_pdf``
(``wrap_quirk``) and the top-100 truncation of the CNN prior.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
    before any geometry and get a zero prior."""
    ph = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
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
