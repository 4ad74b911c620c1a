"""Initial vanishing-point proposals from the CNN grid and the sphere image
(``em/init_vps.py`` of the JAX package), batched.

Reference quirks kept: ``find_maxima`` treats neighbours at index 0 as 0;
the sphere image is flipped vertically before patch extraction; a cell's
VP is the AVERAGE index of all pixels equal to its patch maximum; all-zero
patches are skipped; VPs are packed in row-major cell order.
"""

from __future__ import annotations

import torch

from ..ops import coords
from ..ops.select import topk_stable


def find_maxima(cnn_response: torch.Tensor) -> torch.Tensor:
    """Strict 4-neighbour local maxima, (..., B, A) -> bool, with the
    reference's edge quirk (neighbours at index 0 count as 0)."""
    r = cnn_response
    zc = torch.zeros_like(r[..., :, :1])
    zr = torch.zeros_like(r[..., :1, :])
    vu = torch.cat([r[..., :, 1:], zc], dim=-1)
    vd = torch.cat([zc, zc, r[..., :, 1:-1]], dim=-1)
    vl = torch.cat([zr, zr, r[..., 1:-1, :]], dim=-2)
    vr = torch.cat([r[..., 1:, :], zr], dim=-2)
    return (r > vu) & (r > vd) & (r > vl) & (r > vr)


def find_initial_vps(sphere_image: torch.Tensor, cnn_response: torch.Tensor,
                     num_max: int, m_slots: int):
    """sphere_image (B, S, S) in Agg orientation, cnn_response (B, 20, 20)
    -> (v0 (B, m_slots, 3), alive (B, m_slots))."""
    sphere = torch.flip(sphere_image.to(torch.float32), dims=[1])
    nb, b_dim, a_dim = cnn_response.shape
    s_dim = sphere.shape[1]
    pb, pa = s_dim // b_dim, sphere.shape[2] // a_dim

    maxima = find_maxima(cnn_response)
    flat = cnn_response.reshape(nb, -1)
    flat_max = maxima.reshape(nb, -1)
    scores = torch.where(flat_max, flat, -torch.inf)
    k = min(num_max, flat.shape[1])
    topv, _ = topk_stable(scores, k)
    kth = topv[:, k - 1:k]
    selected = flat_max & (scores >= kth) & torch.isfinite(scores)

    patches = sphere.reshape(nb, b_dim, pb, a_dim, pa)
    pmax = torch.amax(patches, dim=(2, 4))
    eq = patches >= pmax[:, :, None, :, None]
    cnt = torch.sum(eq, dim=(2, 4))
    rows = torch.arange(pb, dtype=torch.float32,
                        device=sphere.device)[None, None, :, None, None]
    cols = torch.arange(pa, dtype=torch.float32,
                        device=sphere.device)[None, None, None, None, :]
    avg_row = torch.sum(eq * rows, dim=(2, 4)) / cnt
    avg_col = torch.sum(eq * cols, dim=(2, 4)) / cnt
    selected = selected & (pmax.reshape(nb, -1) > 0)

    dev = sphere.device
    cell_b = torch.arange(b_dim, device=dev).repeat_interleave(a_dim).to(
        torch.float32)
    cell_a = torch.arange(a_dim, device=dev).repeat(b_dim).to(torch.float32)
    idx_alpha = avg_col.reshape(nb, -1) + cell_a * pa
    idx_beta = avg_row.reshape(nb, -1) + cell_b * pb
    angles = coords.index_to_angle(
        torch.stack([idx_alpha, idx_beta], dim=-1), tuple(sphere.shape[1:]))
    vps = coords.angle_to_point(angles)  # (B, K, 3)

    order = torch.argsort((~selected).to(torch.uint8), dim=1, stable=True)
    packed = torch.gather(vps, 1, order[:, :m_slots, None].expand(
        nb, m_slots, 3))
    alive = torch.sum(selected, dim=1, keepdim=True) > torch.arange(
        m_slots, device=dev)[None]
    packed = torch.where(alive[..., None], packed, 0.0)
    return packed, alive
