"""Horizon estimation from refined vanishing points (``em/horizon.py`` of
the JAX package), batched.

All C(maxbest, 3) VP triplets are scored at once; the winner is the first
argmax, which picks the same triplet as the reference's strict-improvement
loop (including its quirk that when every gate fails the first triplet's
horizon is returned). Kept: zenith-of-triplet by strict |y| comparisons
(ties go to the third VP), the orthogonality zenith is the LAST zenith
candidate of the triplet, fallbacks for < 3 VPs use the first alive slots,
and the ``pos_gate_ideal_tol`` waiver of the zenith side gate.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.select import topk_stable


def num_combo3(n: int) -> int:
    """C(n, 3), the number of VP triplets the search scores."""
    if n < 3:
        return 0
    return n * (n - 1) * (n - 2) // 6


def vp_in_image(vp: np.ndarray) -> bool:
    """|x/z| <= 1 and |y/z| <= 1 (the reference's ``VPinImage``)."""
    v = np.asarray(vp, np.float64)
    v = v / v[2]
    return bool(abs(v[0]) <= 1 and abs(v[1]) <= 1)


@functools.lru_cache(maxsize=None)
def _triplets(n: int) -> np.ndarray:
    """All (i, j, k), i < j < k, in the reference's (lexicographic) order."""
    out = [(i, j, k) for i in range(n) for j in range(i + 1, n)
           for k in range(j + 1, n)]
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _vec(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def _f32_fn(fn, x: float) -> float:
    """fn evaluated in float32, as ``jnp.sin(python_float)`` is."""
    return float(fn(torch.tensor(x, dtype=torch.float32)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) gathered along dim 1 by idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _score_triplets(vps, counts, alive, maxbest: int, theta_vmin: float,
                    theta_z: float, pos_gate_ideal_tol: float) -> dict:
    """Triplet enumeration, gating and scoring. vps (B, M, 3), counts and
    alive (B, M). ``score`` is -2 for invalid/NaN triplets."""
    m_slots = vps.shape[1]
    counts = torch.where(alive, counts, -1.0)
    num_best = torch.clamp(torch.sum(alive, dim=1), max=maxbest)

    # descending, ties highest slot first (reversed stable ascending sort,
    # like the reference's np.argsort(counts)[::-1]); dead slots last
    order = torch.argsort(counts, dim=1, stable=True).flip(1)
    kbest = min(maxbest, m_slots)
    best_vps = order[:, :kbest]
    bv = _take(vps, best_vps)
    bc_raw = _take(counts, best_vps)
    bcounts = torch.clamp(bc_raw, min=0.0)
    zenith_cand = torch.abs(vps[..., 1]) > _f32_fn(torch.sin, theta_z)
    bz = _take(zenith_cand, best_vps) & (bc_raw >= 0)
    in_image = ((torch.abs(bv[..., 0] / bv[..., 2]) <= 1.0)
                & (torch.abs(bv[..., 1] / bv[..., 2]) <= 1.0))

    tri = torch.from_numpy(_triplets(kbest)).to(vps.device)
    ta, tb, tc = tri[:, 0], tri[:, 1], tri[:, 2]
    tri_valid = tc[None] < num_best[:, None]
    va, vb, vc = bv[:, ta], bv[:, tb], bv[:, tc]
    ca, cb, cc = bcounts[:, ta], bcounts[:, tb], bcounts[:, tc]

    ab = torch.abs(torch.sum(va * vb, dim=-1))
    bc = torch.abs(torch.sum(vb * vc, dim=-1))
    ac = torch.abs(torch.sum(va * vc, dim=-1))
    za, zb, zc = bz[:, ta], bz[:, tb], bz[:, tc]
    num_zenith = za.int() + zb.int() + zc.int()
    zenith = torch.where(za[..., None], va, torch.zeros_like(va))
    zenith = torch.where(zb[..., None], vb, zenith)
    zenith = torch.where(zc[..., None], vc, zenith)
    num_central = (in_image[:, ta].int() + in_image[:, tb].int()
                   + in_image[:, tc].int())

    ya, yb, yc = torch.abs(va[..., 1]), torch.abs(vb[..., 1]), \
        torch.abs(vc[..., 1])
    a_is_z = (ya > yb) & (ya > yc)
    b_is_z = (yb > ya) & (yb > yc)

    def pick(xa, xb, xc):
        ca_, cb_ = a_is_z, b_is_z
        if xa.dim() > a_is_z.dim():
            ca_, cb_ = ca_[..., None], cb_[..., None]
        return torch.where(ca_, xa, torch.where(cb_, xb, xc))

    z_vp = pick(va, vb, vc)
    h_vp1 = pick(vb, va, va)
    h_vp2 = pick(vc, vc, vb)
    h1_count = pick(cb, ca, ca)
    h2_count = pick(cc, cc, cb)

    e3 = _vec([0.0, 0.0, 1.0], vps)
    zlin = torch.linalg.cross(z_vp, e3.expand_as(z_vp))
    zlin = zlin / torch.linalg.vector_norm(zlin[..., 0:2], dim=-1,
                                           keepdim=True)
    l1, l2 = zlin[..., 0], zlin[..., 1]
    hv1 = h_vp1 / h_vp1[..., 2:3]
    hv2 = h_vp2 / h_vp2[..., 2:3]
    d1 = torch.linalg.vector_norm(e3 - hv1, dim=-1)
    d2 = torch.linalg.vector_norm(e3 - hv2, dim=-1)
    w1 = d2 * h1_count
    w2 = d1 * h2_count
    h3 = ((h_vp1[..., 0] * l2 - h_vp1[..., 1] * l1) / h_vp1[..., 2] * w1
          + (h_vp2[..., 0] * l2 - h_vp2[..., 1] * l1) / h_vp2[..., 2] * w2) \
        / (w1 + w2)
    hlin = torch.stack([-l2, l1, h3], dim=-1)

    hvec = hv1 - hv2
    hvec_norm = torch.linalg.vector_norm(hvec, dim=-1)
    hang = torch.arccos(torch.abs(hvec[..., 0]) / hvec_norm)
    hp1 = torch.linalg.cross(hlin, _vec([1.0, 0.0, 1.0], vps).expand_as(hlin))
    hp2 = torch.linalg.cross(hlin, _vec([-1.0, 0.0, 1.0], vps).expand_as(hlin))
    hp1 = hp1 / hp1[..., 2:3]
    hp2 = hp2 / hp2[..., 2:3]

    cosphi = torch.abs(torch.sum(
        hvec / hvec_norm[..., None] * zenith
        / torch.linalg.vector_norm(zenith, dim=-1, keepdim=True), dim=-1))
    ortho_score = torch.where(num_zenith == 1,
                              1.0 - torch.clamp(cosphi, 0.0, 1.0), 0.0)
    zenith_pos = torch.where(z_vp[..., 1] > 0, 1.0, -1.0)
    hor_pos = torch.where((hp1[..., 1] + hp2[..., 1]) / 2 < 0, 1.0, -1.0)
    # near-ideal zenith: the side is below the noise floor (tol = inf and
    # z == 0 gives inf * 0 = NaN -> False: the reference's gate)
    near_ideal = torch.abs(z_vp[..., 1]) > pos_gate_ideal_tol * torch.abs(
        z_vp[..., 2])
    costh = _f32_fn(torch.cos, theta_vmin)
    gate = ((ab < costh) & (bc < costh) & (ac < costh) & (num_zenith == 1)
            & (num_central <= 1) & (hang < 30.0 * math.pi / 180.0)
            & ((zenith_pos * hor_pos == 1.0) | near_ideal))
    score = torch.where(gate, 1.0, 0.0) * (ca + cb + cc) * ortho_score
    score = torch.where(tri_valid, score, -2.0)
    score = torch.where(torch.isnan(score), -2.0, score)
    return {"score": score, "hlin": hlin, "hp1": hp1, "hp2": hp2,
            "z_vp": z_vp, "h_vp1": h_vp1, "h_vp2": h_vp2, "tri": tri,
            "best_vps": best_vps, "num_best": num_best}


def calculate_horizon_and_ortho_vp(vps: torch.Tensor, counts: torch.Tensor,
                                   alive: torch.Tensor, maxbest: int = 20,
                                   theta_vmin: float = float(np.pi / 10),
                                   theta_z: float = float(np.pi / 4),
                                   pos_gate_ideal_tol: float = float("inf")):
    """Returns (hP1, hP2, zVP, hVP1, hVP2, best triplet slot indices), each
    with a leading batch dimension. vps (B, M, 3) unit VPs, counts (B, M),
    alive (B, M). hP1/hP2 are the horizon's intersections with x = +-1."""
    t = _score_triplets(vps, counts, alive, maxbest, theta_vmin, theta_z,
                        pos_gate_ideal_tol)
    b = vps.shape[0]
    bi = torch.arange(b, device=vps.device)
    best = torch.argmax(t["score"], dim=1)  # first max

    alive_order = torch.argsort((~alive).to(torch.uint8), dim=1, stable=True)
    v_a0 = vps[bi, alive_order[:, 0]]
    v_a1 = vps[bi, alive_order[:, 1]]
    e010 = _vec([0.0, 1.0, 0.0], vps).expand(b, 3)
    hlin_default = torch.linalg.cross(_vec([0.0, 0.0, 1.0], vps),
                                      _vec([1.0, 0.0, 1.0], vps)).expand(b, 3)
    combo_ge3 = torch.gather(t["best_vps"], 1, t["tri"][best])
    zeros3 = torch.zeros((b, 3), dtype=combo_ge3.dtype, device=vps.device)
    outs = [
        (hlin_default, e010, _vec([-1.0, 0.0, 0.0], vps).expand(b, 3),
         _vec([1.0, 0.0, 0.0], vps).expand(b, 3), zeros3),
        (hlin_default, e010, v_a0, v_a0, zeros3),
        (torch.linalg.cross(v_a0, v_a1), e010, v_a0, v_a1,
         torch.tensor([0, 1, 0], device=vps.device).expand(b, 3)),
        (t["hlin"][bi, best], t["z_vp"][bi, best], t["h_vp1"][bi, best],
         t["h_vp2"][bi, best], combo_ge3),
    ]
    case = torch.clamp(t["num_best"], 0, 3)[:, None]
    sel = []
    for k in range(5):
        o = outs[3][k]
        for c in (2, 1, 0):
            o = torch.where(case == c, outs[c][k], o)
        sel.append(o)
    hlin_f, z_vp_f, h_vp1_f, h_vp2_f, combo_f = sel
    hp1 = torch.linalg.cross(hlin_f, _vec([1.0, 0.0, 1.0], vps).expand(b, 3))
    hp2 = torch.linalg.cross(hlin_f, _vec([-1.0, 0.0, 1.0], vps).expand(b, 3))
    return (hp1 / hp1[:, 2:3], hp2 / hp2[:, 2:3], z_vp_f, h_vp1_f, h_vp2_f,
            combo_f)


def triplet_score_margin(vps: torch.Tensor, counts: torch.Tensor,
                         alive: torch.Tensor, maxbest: int = 20,
                         theta_vmin: float = float(np.pi / 10),
                         theta_z: float = float(np.pi / 4),
                         pos_gate_ideal_tol: float = float("inf")):
    """How close the horizon's triplet search is to picking another
    triplet: two triplets that score nearly alike let a float32-level
    change of the segments flip the winner, and with it the horizon's tilt.
    Same arguments as :func:`calculate_horizon_and_ortho_vp`; returns, each
    (B,): ``s1`` and ``s2``, the two highest triplet scores;
    ``rel_margin`` = (s1 - max(s2, 0)) / s1 (0 when s1 <= 0);
    ``disagreement``, the largest |dy| at x = +-1 between the two
    triplets' horizons (0 when s2 <= 0): a small margin matters only where
    the runner-up's horizon lies elsewhere."""
    t = _score_triplets(vps, counts, alive, maxbest, theta_vmin, theta_z,
                        pos_gate_ideal_tol)
    top, idx = topk_stable(t["score"], 2)
    s1, s2 = top[:, 0], top[:, 1]
    rel_margin = torch.where(
        s1 > 0, (s1 - torch.clamp(s2, min=0.0)) / s1, 0.0)
    y1 = torch.gather(t["hp1"][..., 1], 1, idx)
    y2 = torch.gather(t["hp2"][..., 1], 1, idx)
    d = torch.maximum(torch.abs(y1[:, 0] - y1[:, 1]),
                      torch.abs(y2[:, 0] - y2[:, 1]))
    return s1, s2, rel_margin, torch.where(s2 > 0, d, 0.0)
