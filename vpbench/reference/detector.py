"""The on-device line detector, in plain PyTorch, for the benchmark's
reference.

The port's ``ops/lines_device.detect_segments_device`` at the pipeline's
arguments (global selection, exact top-k, 8 CCL passes, blur 1), with
the floating-point dtype as an argument: float32 is what the
configuration states, bfloat16 the control's step below it. The raster
CCL is written here again (:func:`connected_components`): the same
alternating raster passes as the port's kernel K1 and its twin, each
row's horizontal scans taken as one minimum per run of joined pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .select import topk_stable

QUANT = 2.0
TOL_DEG = 22.5
BLUR_SIGMA = 1.0
CCL_PASSES = 8
I32_MAX = 2 ** 31 - 1
# bit index per neighbour direction (dy, dx)
NEIGHBOUR_BITS = {(-1, -1): 0, (-1, 0): 1, (-1, 1): 2, (0, -1): 3,
                  (0, 1): 4, (1, -1): 5, (1, 0): 6, (1, 1): 7}


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx], border-filled."""
    h, w = a.shape[-2:]
    p = torch.nn.functional.pad(a, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian, edge-replicated borders, summed tap by tap."""
    r = max(1, int(3.0 * sigma + 0.5))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    h, w = img.shape[-2:]
    p = torch.cat([img[..., :1, :].expand(*img.shape[:-2], r, w), img,
                   img[..., -1:, :].expand(*img.shape[:-2], r, w)], dim=-2)
    out = 0
    for i in range(2 * r + 1):
        out = out + float(k[i]) * p[..., i:i + h, :]
    p = torch.cat([out[..., :1].expand(*out.shape[:-1], r), out,
                   out[..., -1:].expand(*out.shape[:-1], r)], dim=-1)
    res = 0
    for i in range(2 * r + 1):
        res = res + float(k[i]) * p[..., i:i + w]
    return res


def gradient_front(images: torch.Tensor, dtype: torch.dtype):
    """(B, H, W) grey levels -> (mag, active, ux, uy) on the (H-1, W-1)
    2x2-gradient grid, in ``dtype``."""
    img = _gaussian_blur(images.to(dtype), BLUR_SIGMA)
    com1 = img[..., 1:, 1:] - img[..., :-1, :-1]
    com2 = img[..., :-1, 1:] - img[..., 1:, :-1]
    gx = 0.5 * (com1 + com2)
    gy = 0.5 * (com1 - com2)
    mag = torch.sqrt(gx * gx + gy * gy)
    active = mag > QUANT / math.sin(math.radians(TOL_DEG))
    inv = torch.where(mag > 0, 1.0 / torch.clamp(mag, min=1e-12), 0.0)
    return mag, active, gx * inv, -gy * inv


def pack_edge_masks(active, ux, uy, cos_tol: float) -> torch.Tensor:
    """The 8 directed edge masks as bits of an int32 plane: an edge joins
    two active pixels whose unit directions have dot > cos_tol."""
    packed = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    for (dy, dx), bit in NEIGHBOUR_BITS.items():
        dot = ux * _shift(ux, dy, dx, 0.0) + uy * _shift(uy, dy, dx, 0.0)
        edge = active & _shift(active, dy, dx, False) & (dot > cos_tol)
        packed = packed | (edge.to(torch.int32) << bit)
    return packed


def connected_components(packed: torch.Tensor,
                         passes: int = CCL_PASSES) -> torch.Tensor:
    """(B, H, W) packed edge bits -> (B, H*W) int32 labels after
    ``2 * max(1, passes // 2)`` raster half passes, alternately top-down
    and bottom-up. Each row takes the minimum of its own labels and of the
    previous row's through the vertical and diagonal bits, then every run
    of pixels joined by the horizontal bits takes its minimum. (The west
    bit of x and the east bit of x - 1 are one edge, so a forward and a
    backward segmented minimum scan give that run minimum.)"""
    b, h, w = packed.shape
    dev = packed.device
    lab = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(
        1, h, w).repeat(b, 1, 1)
    bits = [((packed >> i) & 1).to(torch.bool) for i in range(8)]
    joined = bits[3].clone()
    joined[..., 0] = False
    run = torch.cumsum((~joined).to(torch.int64), dim=-1) - 1
    big = torch.full((b, 1), I32_MAX, dtype=torch.int32, device=dev)
    fill = torch.full((b, w), I32_MAX, dtype=torch.int32, device=dev)
    for p in range(2 * max(1, passes // 2)):
        asc = p & 1
        up, upl, upr = (bits[6], bits[5], bits[7]) if asc else \
            (bits[1], bits[0], bits[2])
        prev = fill
        for y in (range(h - 1, -1, -1) if asc else range(h)):
            left = torch.cat([big, prev[:, :-1]], dim=1)
            right = torch.cat([prev[:, 1:], big], dim=1)
            v = torch.minimum(lab[:, y], torch.where(up[:, y], prev, I32_MAX))
            v = torch.minimum(v, torch.where(upl[:, y], left, I32_MAX))
            v = torch.minimum(v, torch.where(upr[:, y], right, I32_MAX))
            runmin = fill.scatter_reduce(1, run[:, y], v, "amin")
            prev = torch.gather(runmin, 1, run[:, y])
            lab[:, y] = prev
    return lab.reshape(b, h * w)


def _segmented_min_scan(v, conn, log_steps: int, fill):
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = torch.nn.functional.pad(v[..., :-d], (d, 0), value=fill)
        m_sh = torch.nn.functional.pad(m[..., :-d], (d, 0), value=False)
        v = torch.where(m, torch.minimum(v, v_sh), v)
        m = m & m_sh
    return v


def _segmented_sum_scan(v, conn, log_steps: int):
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = torch.nn.functional.pad(v[..., :-d], (d, 0))
        m_sh = torch.nn.functional.pad(m[..., :-d], (d, 0), value=False)
        v = torch.where(m, v + v_sh, v)
        m = m & m_sh
    return v


def _segmented_copy_first(v, conn, log_steps: int):
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = torch.nn.functional.pad(v[..., :-d], (d, 0))
        m_sh = torch.nn.functional.pad(m[..., :-d], (d, 0), value=False)
        v = torch.where(m, v_sh, v)
        m = m & m_sh
    return v


def _gather(x, idx):
    return torch.gather(x, -1, idx)


def _component_stats(root, wgt, max_segments: int, shape, coord_affine,
                     max_records: int, dtype: torch.dtype) -> dict:
    """Top ``max_segments`` components by gradient mass with their moments
    and extremal projections, from per-row run records selected image-wide
    (the top ``max_records`` run ends by mass after a per-row prefilter of
    max(64, 3w/10))."""
    h, w = shape
    b = root.shape[0]
    dev = root.device
    ft = dtype
    r2 = root.reshape(b, h, w)
    w2 = wgt.reshape(b, h, w)
    w_full, h_full, s_half = coord_affine
    xs = torch.arange(w, dtype=ft, device=dev)
    xn2 = ((xs + 0.5) - w_full / 2.0) / s_half

    false_col = torch.zeros((b, h, 1), dtype=torch.bool, device=dev)
    same = r2[..., 1:] == r2[..., :-1]
    conn = torch.cat([false_col, same], dim=-1)
    is_end = torch.cat([~same, ~false_col], dim=-1)
    log_w = max(1, math.ceil(math.log2(w)))
    q = torch.stack([w2, w2 * xn2, w2 * xn2 * xn2, (w2 > 0).to(ft)], dim=1)
    qs = _segmented_sum_scan(q, conn[:, None], log_w)

    mass_row = torch.where(is_end, qs[:, 0], -1.0)
    row_i = torch.arange(h, device=dev)[:, None]
    k_pre = min(w, max(64, (3 * w) // 10))
    pre_mass, pre_col = topk_stable(mass_row, k_pre)
    cand_pos = (row_i * w + pre_col).reshape(b, -1)
    top_mass, top_i = topk_stable(pre_mass.reshape(b, -1),
                                  min(max_records, cand_pos.shape[1]))
    flat_pos = _gather(cand_pos, top_i)
    rec_ok = top_mass > 0.0

    qf = qs.reshape(b, 4, h * w)
    g = [_gather(qf[:, i], flat_pos) for i in range(4)]
    rec_root = torch.where(rec_ok, _gather(root.to(torch.int64), flat_pos), -1)
    row_idx = flat_pos // w
    col_idx = flat_pos - row_idx * w
    rec_x1 = ((col_idx.to(ft) + 0.5) - w_full / 2.0) / s_half
    rec_y = -((row_idx.to(ft) + 0.5) - h_full / 2.0) / s_half
    col0 = col_idx.to(ft) - g[3] + 1.0
    rec_x0 = ((col0 + 0.5) - w_full / 2.0) / s_half
    rec_w, rec_wx, rec_wxx, rec_cnt = [torch.where(rec_ok, g[i], 0.0)
                                       for i in range(4)]
    rec_q = [rec_w, rec_wx, rec_y * rec_w, rec_wxx, rec_y * rec_wx,
             rec_y * rec_y * rec_w, rec_cnt]

    key = (rec_root + 1) * (h * w) + flat_pos
    perm = torch.argsort(key, dim=-1)
    rs = _gather(rec_root, perm)
    payload = torch.stack([*rec_q, rec_x0, rec_x1, rec_y], dim=1)
    payload = torch.gather(payload, -1, perm[:, None].expand_as(payload))
    sq = payload[:, :7]
    sx0, sx1, sy = payload[:, 7], payload[:, 8], payload[:, 9]
    n_rec = rs.shape[1]
    log_r = max(1, math.ceil(math.log2(n_rec)))
    false1 = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    same_r = rs[:, 1:] == rs[:, :-1]
    gconn = torch.cat([false1, same_r], dim=1)
    g_end = torch.cat([~same_r, ~false1], dim=1)

    gsum = _segmented_sum_scan(sq, gconn[:, None], log_r)
    s_w, s_wx, s_wy, s_wxx, s_wxy, s_wyy, s_cnt = gsum.unbind(1)

    sw = torch.clamp(s_w, min=1e-9)
    cx, cy = s_wx / sw, s_wy / sw
    vxx = torch.clamp(s_wxx / sw - cx * cx, min=0.0)
    vxy = s_wxy / sw - cx * cy
    vyy = torch.clamp(s_wyy / sw - cy * cy, min=0.0)
    tr = vxx + vyy
    det = vxx * vyy - vxy * vxy
    lam_max = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det,
                                                min=0.0))
    lam_min = torch.clamp(tr - lam_max, min=0.0)
    ex_a, ey_a = vxy, lam_max - vxx
    ex_b, ey_b = lam_max - vyy, vxy
    use_a = ex_a * ex_a + ey_a * ey_a >= ex_b * ex_b + ey_b * ey_b
    ex = torch.where(use_a, ex_a, ex_b)
    ey = torch.where(use_a, ey_a, ey_b)
    en = torch.sqrt(ex * ex + ey * ey)
    ok_e = en > 1e-12
    ddx = torch.where(ok_e, ex / torch.where(ok_e, en, 1.0), 1.0)
    ddy = torch.where(ok_e, ey / torch.where(ok_e, en, 1.0), 0.0)

    same_next = torch.cat([same_r, false1], dim=1)
    dd_b = _segmented_copy_first(
        torch.stack([ddx.flip(-1), ddy.flip(-1)], dim=1),
        same_next.flip(-1)[:, None], log_r).flip(-1)
    ddx_b, ddy_b = dd_b[:, 0], dd_b[:, 1]

    t0 = ddx_b * sx0 + ddy_b * sy
    t1 = ddx_b * sx1 + ddy_b * sy
    inf = torch.where(rs >= 0, 0.0, math.inf)
    gmm = _segmented_min_scan(
        torch.stack([torch.minimum(t0, t1) + inf,
                     -torch.maximum(t0, t1) + inf], dim=1),
        gconn[:, None], log_r, float(I32_MAX))
    gmin, gmax = gmm[:, 0], -gmm[:, 1]

    score = torch.where(g_end & (rs >= 0), s_w, -1.0)
    top, pos = topk_stable(score, max_segments)
    sel = lambda a: _gather(a, pos)  # noqa: E731
    return {"valid": top > 0.0, "cnt": sel(s_cnt), "cx": sel(cx),
            "cy": sel(cy), "ddx": sel(ddx), "ddy": sel(ddy),
            "lam_min": sel(lam_min), "tmin": sel(gmin), "tmax": sel(gmax)}


def detect_segments(images: torch.Tensor, det: dict,
                    dtype: torch.dtype = torch.float32):
    """(B, H, W) grey levels -> (segments (B, S, 4) in the normalized
    frame, mask (B, S)), valid segments first by decreasing mass. ``det``
    holds the configuration's ``max_segments``, ``min_count``,
    ``min_len_px``, ``min_density`` and ``max_records``."""
    b, h, w = images.shape
    hi, wi = h - 1, w - 1
    npix = hi * wi
    mag, active, ux, uy = gradient_front(images, dtype)
    packed = pack_edge_masks(active, ux, uy, math.cos(math.radians(TOL_DEG)))
    root = connected_components(packed)
    s = max(h, w) / 2.0
    wgt = torch.where(active, mag / 255.0, 0.0)
    st = _component_stats(root, wgt.reshape(b, -1), det["max_segments"],
                          (hi, wi), (float(w), float(h), s),
                          det["max_records"], dtype)
    s_cnt, cx, cy = st["cnt"], st["cx"], st["cy"]
    ddx, ddy = st["ddx"], st["ddy"]
    tmin, tmax = st["tmin"], st["tmax"]
    span = torch.clamp(tmax - tmin, min=0.0)
    span_px = span * s
    width_px = torch.sqrt(12.0 * st["lam_min"]) * s

    p_align = TOL_DEG / 180.0
    area = span_px * torch.clamp(width_px, min=1.0)
    dens = torch.clamp(s_cnt / torch.clamp(area, min=1.0), 1e-6, 1.0 - 1e-6)
    kl = (dens * torch.log(dens / p_align)
          + (1.0 - dens) * torch.log((1.0 - dens) / (1.0 - p_align)))
    log10_nfa = 2.5 * math.log10(npix) - area * kl / math.log(10.0)
    meaningful = (dens > p_align) & (log10_nfa < 0.0)
    if det["min_density"] > 0.0:
        meaningful = meaningful & (dens >= det["min_density"])
    valid = (st["valid"] & torch.isfinite(span) & meaningful
             & (s_cnt >= det["min_count"]) & (span_px >= det["min_len_px"]))

    t_c = cx * ddx + cy * ddy
    seg = torch.stack([cx + (tmin - t_c) * ddx, cy + (tmin - t_c) * ddy,
                       cx + (tmax - t_c) * ddx, cy + (tmax - t_c) * ddy],
                      dim=-1)
    seg = torch.where(valid[..., None], seg, 0.0)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    return (torch.gather(seg, 1, order[..., None].expand_as(seg)).float(),
            torch.gather(valid, 1, order))
