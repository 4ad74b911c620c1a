"""Responsibility regularisation, VP refits and inlier counting
(``em/weights.py`` of the JAX package), batched over images.

``calc_new_vanishing_point`` takes the smallest eigenvector of the 3x3
Gram matrix L^T diag(w~^2) L through the same closed-form solver as the
JAX package (trigonometric eigenvalues + adjugate cross products), not
``torch.linalg.eigh``, so both packages pick the same null direction on
near-degenerate inputs.
"""

from __future__ import annotations

import math

import torch

from ..ops import probability as prob


def smallest_eigvec_3x3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    matrices; sign unspecified. Multiplicity >= 2 returns a vector
    orthogonal to the largest row of A - lambda I; isotropic A returns
    (1, 0, 0)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    b = a - q * eye
    p2 = torch.sum(b * b, dim=(-2, -1), keepdim=True) / 6.0
    p = torch.sqrt(p2)
    bn = b / torch.where(p > 0, p, 1.0)
    det = (bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2]
                            - bn[..., 1, 2] * bn[..., 2, 1])
           - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2]
                              - bn[..., 1, 2] * bn[..., 2, 0])
           + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1]
                              - bn[..., 1, 1] * bn[..., 2, 0]))
    r = torch.clamp(det / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q[..., 0, 0] + 2.0 * p[..., 0, 0] * torch.cos(
        phi + 2.0 * math.pi / 3.0)

    m = a - lam_min[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    rn = torch.sum(m * m, dim=-1)
    rn_max = torch.max(rn, dim=-1).values
    good = torch.max(norms, dim=-1).values > 1e-6 * rn_max * rn_max

    bi = torch.argmax(rn, dim=-1)
    brow = torch.gather(m, -2, bi[..., None, None].expand(
        *bi.shape, 1, 3))[..., 0, :]
    ax = torch.argmin(torch.abs(brow), dim=-1)
    alt = torch.linalg.cross(brow, eye[ax])
    isotropic = rn_max <= 0
    alt = torch.where(isotropic[..., None], eye[0], alt)
    v = torch.where(good[..., None], v, alt)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def weight_matrix(p_vl: torch.Tensor, lweight: torch.Tensor,
                  lsim: torch.Tensor, bias: float = 1.0) -> torch.Tensor:
    """w[m, k] = (w'[k] + bias lw[k] <w', lsim[:, k]>) /
    (1 + bias lw[k] sum_n lsim[n, k]), w' = p_vl[m] * lweight.
    p_vl (B, M, N), lweight (B, N), lsim (B, N, N) -> (B, M, N)."""
    wp = p_vl * lweight[:, None, :]
    smooth = wp @ lsim
    colsum = torch.sum(lsim, dim=1)
    return (wp + bias * lweight[:, None, :] * smooth) / \
        (1.0 + bias * lweight * colsum)[:, None, :]


def calc_new_vanishing_point(l: torch.Tensor, w: torch.Tensor):
    """Weighted total-least-squares VPs, one per weight row.

    l (B, N, 3) unit lines, w (B, M, N) -> (vp (B, M, 3), valid (B, M));
    valid is False where a row's weights are all zero. The sign fix
    multiplies by sign(z), so z == 0 collapses to the zero vector."""
    wmax = torch.max(w, dim=-1).values
    valid = wmax > 0
    wn = w / torch.where(valid, wmax, 1.0)[..., None]
    lw = l[:, None, :, :] * wn[..., None]          # (B, M, N, 3)
    gram = lw.transpose(-1, -2) @ lw              # (B, M, 3, 3)
    vp = smallest_eigvec_3x3(gram)
    return vp * torch.sign(vp[..., 2:3]), valid


def assoc_argmax(w: torch.Tensor, alive: torch.Tensor,
                 lmask: torch.Tensor) -> torch.Tensor:
    """Per-line best VP slot by weight, -1 for invalid lines: (B, M, N) ->
    (B, N). Dead slots get weight -1 so they never win a tie."""
    wm = torch.where(alive[..., None], w, -1.0)
    a = torch.argmax(wm, dim=1)
    return torch.where(lmask, a, -1)


def calc_vp_line_counts(vp: torch.Tensor, alive: torch.Tensor,
                        l: torch.Tensor, lp: torch.Tensor,
                        lmask: torch.Tensor, log_s: torch.Tensor,
                        decision_metric: torch.Tensor, lweights: torch.Tensor,
                        distance_measure: str, thresh: float = 1.96 ** 2):
    """Inlier counting with outlier rejection: line n belongs to its argmax
    VP m unless its distance exceeds thresh * sqrt(s_m) or its weight is
    zero. Returns (counts (B, M), counts_weighted (B, M), assoc (B, N))."""
    m_slots = vp.shape[1]
    assoc = assoc_argmax(decision_metric, alive, lmask)
    safe = torch.clamp(assoc, 0, m_slots - 1)
    vpn = torch.gather(vp, 1, safe[..., None].expand(*safe.shape, 3))
    if distance_measure == "dotprod":
        dist = torch.abs(torch.sum(vpn * l, dim=-1))
    elif distance_measure == "angle":
        dist = prob.calc_lvsq_single(vpn, lp)
    else:
        raise ValueError(f"unsupported distance measure: {distance_measure}")
    cut = thresh * torch.gather(torch.exp(0.5 * log_s), 1, safe)
    keep = (assoc >= 0) & ~(dist > cut) & (lweights != 0)
    assoc = torch.where(keep, assoc, -1)
    onehot = assoc[:, None, :] == torch.arange(m_slots, device=vp.device)[
        None, :, None]
    counts = torch.sum(onehot, dim=2).to(l.dtype)
    counts_weighted = torch.sum(onehot * lweights[:, None, :], dim=2)
    return counts, counts_weighted, assoc
