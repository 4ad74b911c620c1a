"""On-device line-segment detection (``ops/lines_device.py`` of the JAX
package), batched over images.

A data-parallel reformulation of LSD with static shapes:

1. Gaussian blur, 2x2 gradient and DIRECTED level-line angles, LSD's
   ``rho = quant / sin(tol)`` activation threshold.
2. Connected components: two 8-neighbours join when both are active and
   their level-line directions agree within ``pair_tol_factor * tol``. The
   8 directed edge masks are packed once into an int32 bit-plane
   (:func:`pack_edge_masks`), then alternating raster min-label passes
   spread labels — the CUDA kernel ``csrc/ccl_raster.cu`` on a GPU, the
   plain twin :func:`connected_components_ref` on the CPU.
3. Per-row run records (segmented row scans), a selection of runs by mass
   (per row, or image-wide), one canonical (root, position) sort,
   per-component moment sums, principal direction and extremal
   projections.
4. LSD-style NFA, count, length and density gates, then a stable re-rank.

The JAX function's arguments and defaults, with ``coord_affine`` always
on; its ``ccl_impl`` has no counterpart (one CCL: the kernel and its
bit-identical twin). Every selection goes through a stable sort
(``ops/select.py``), so ties resolve in index order as ``lax.top_k``
resolves them.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import kernels
from ..utils import profiling
from .select import topk_stable

QUANT = 2.0
TOL_DEG = 22.5
BLUR_SIGMA = 1.0
CCL_PASSES = 8

I32_MAX = 2 ** 31 - 1
# bit index per neighbour direction (dy, dx), the JAX package's order
NEIGHBOUR_BITS = {(-1, -1): 0, (-1, 0): 1, (-1, 1): 2, (0, -1): 3,
                  (0, 1): 4, (1, -1): 5, (1, 0): 6, (1, 1): 7}

CCL_KERNEL = kernels.CudaKernel(
    "ccl_raster.cu", "ccl_raster_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    extra_flags=("-Xptxas", "--register-usage-level=10"))


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx], border-filled."""
    h, w = a.shape[-2:]
    p = torch.nn.functional.pad(a, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian with edge-replicated borders over (B, H, W),
    summed tap by tap in the JAX function's order."""
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


def pack_edge_masks(active: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor,
                    cos_tol: float) -> torch.Tensor:
    """(B, H, W) activity + level-line direction -> int32 bit-plane of the
    8 directed edge masks. An edge joins two active pixels whose unit
    directions have dot > cos_tol. The one place the edge threshold is
    decided, shared by the kernel and its twin, so both see identical
    integers."""
    packed = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    for (dy, dx), bit in NEIGHBOUR_BITS.items():
        dot = ux * _shift(ux, dy, dx, 0.0) + uy * _shift(uy, dy, dx, 0.0)
        edge = active & _shift(active, dy, dx, False) & (dot > cos_tol)
        packed = packed | (edge.to(torch.int32) << bit)
    return packed


def _segmented_min_scan(v: torch.Tensor, conn: torch.Tensor, log_steps: int,
                        fill) -> torch.Tensor:
    """Per-row segmented min scan along the last axis (Hillis-Steele);
    conn[..., x] means x joins x-1. ``fill`` pads the shifted-in values,
    as the JAX function pads with int32 max."""
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = torch.nn.functional.pad(v[..., :-d], (d, 0), value=fill)
        m_sh = torch.nn.functional.pad(m[..., :-d], (d, 0), value=False)
        v = torch.where(m, torch.minimum(v, v_sh), v)
        m = m & m_sh
    return v


def _segmented_sum_scan(v: torch.Tensor, conn: torch.Tensor,
                        log_steps: int) -> torch.Tensor:
    """Per-segment inclusive prefix sum along the last axis (doubling, the
    JAX function's exact f32 association)."""
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = torch.nn.functional.pad(v[..., :-d], (d, 0))
        m_sh = torch.nn.functional.pad(m[..., :-d], (d, 0), value=False)
        v = torch.where(m, v + v_sh, v)
        m = m & m_sh
    return v


def _segmented_copy_first(v: torch.Tensor, conn: torch.Tensor,
                          log_steps: int) -> torch.Tensor:
    """Broadcast each segment's first value to its members (last axis)."""
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = torch.nn.functional.pad(v[..., :-d], (d, 0))
        m_sh = torch.nn.functional.pad(m[..., :-d], (d, 0), value=False)
        v = torch.where(m, v_sh, v)
        m = m & m_sh
    return v


def _half_passes(passes: int) -> int:
    # the JAX function runs max(1, passes // 2) descending/ascending pairs
    return 2 * max(1, passes // 2)


def connected_components_ref(packed: torch.Tensor,
                             passes: int = CCL_PASSES) -> torch.Tensor:
    """Plain PyTorch raster CCL: (B, H, W) packed edge bits -> (B, H*W)
    int32 roots (inactive pixels keep their own flat index). Row by row,
    like the JAX ``lax.scan``: inject the previous row's labels through the
    N/NW/NE bits (S/SW/SE ascending), then a forward and a backward
    segmented min scan over the W/E bits."""
    b, h, w = packed.shape
    dev = packed.device
    lab = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(
        1, h, w).repeat(b, 1, 1)
    bits = [((packed >> i) & 1).to(torch.bool) for i in range(8)]
    log_w = max(1, math.ceil(math.log2(w)))
    big = torch.full((b, 1), I32_MAX, dtype=torch.int32, device=dev)
    for p in range(_half_passes(passes)):
        asc = p & 1
        up, upl, upr = (bits[6], bits[5], bits[7]) if asc else \
            (bits[1], bits[0], bits[2])
        prev = torch.full((b, w), I32_MAX, dtype=torch.int32, device=dev)
        for s in range(h):
            y = h - 1 - s if asc else s
            init = torch.minimum(lab[:, y], torch.where(up[:, y], prev,
                                                        I32_MAX))
            left = torch.cat([big, prev[:, :-1]], dim=1)
            right = torch.cat([prev[:, 1:], big], dim=1)
            init = torch.minimum(init, torch.minimum(
                torch.where(upl[:, y], left, I32_MAX),
                torch.where(upr[:, y], right, I32_MAX)))
            fwd = _segmented_min_scan(init, bits[3][:, y], log_w, I32_MAX)
            bwd = _segmented_min_scan(init.flip(-1), bits[4][:, y].flip(-1),
                                      log_w, I32_MAX).flip(-1)
            prev = torch.minimum(fwd, bwd)
            lab[:, y] = prev
    return lab.reshape(b, h * w)


def connected_components_cuda(packed: torch.Tensor,
                              passes: int = CCL_PASSES) -> torch.Tensor:
    """Kernel K1 on a CUDA batch: (B, H, W) int32 packed -> (B, H*W)."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"connected_components_cuda: tensor on {dev}")
    b, h, w = packed.shape
    kernels.require(packed, "packed", torch.int32, (b, h, w), dev)
    if h * w >= I32_MAX:
        raise ValueError("connected_components_cuda: image too large")
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    if b == 0 or h == 0:
        return labels.reshape(b, h * w)
    scratch = torch.empty_like(labels)
    CCL_KERNEL.launch(kernels.ptr(packed), kernels.ptr(labels),
                      kernels.ptr(scratch), b, h, w, _half_passes(passes),
                      kernels.stream_of(packed))
    return labels.reshape(b, h * w)


def connected_components(packed: torch.Tensor, passes: int = CCL_PASSES) -> torch.Tensor:
    """Raster CCL on packed edge bits: the kernel for a CUDA tensor, the
    plain twin for a CPU tensor."""
    with profiling.span("vp.detector.ccl"):
        if packed.is_cuda:
            return connected_components_cuda(packed.contiguous(), passes)
        if packed.device.type != "cpu":
            raise ValueError(f"connected_components: unsupported device "
                             f"{packed.device}")
        return connected_components_ref(packed, passes)


def ccl_fixpoint_residual(packed: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per image, the number of pixels whose label one more round of
    neighbour minima would still change: 0 exactly when ``labels`` is the
    fixpoint. packed (B, H, W) edge bits, labels (B, H*W) -> (B,).

    A check on the fixed number of raster passes: they are exact for
    digital straight lines, while curved or zigzag noise components may
    need more."""
    lab = labels.reshape(packed.shape)
    best = lab
    for (dy, dx), bit in NEIGHBOUR_BITS.items():
        edge = ((packed >> bit) & 1).to(torch.bool)
        best = torch.minimum(best, torch.where(
            edge, _shift(lab, dy, dx, I32_MAX), I32_MAX))
    return torch.sum(best != lab, dim=(1, 2))


def gradient_front(images: torch.Tensor, tol_deg: float = TOL_DEG,
                   blur_sigma: float = BLUR_SIGMA):
    """(B, H, W) grayscale in [0, 255] -> (mag, active, ux, uy) on the
    (H-1, W-1) inner 2x2-gradient grid (LSD's operators). ``blur_sigma``
    0 skips the blur."""
    img = images.to(torch.float32)
    if blur_sigma > 0:
        img = _gaussian_blur(img, blur_sigma)
    com1 = img[..., 1:, 1:] - img[..., :-1, :-1]
    com2 = img[..., :-1, 1:] - img[..., 1:, :-1]
    gx = 0.5 * (com1 + com2)
    gy = 0.5 * (com1 - com2)
    mag = torch.sqrt(gx * gx + gy * gy)
    active = mag > QUANT / math.sin(math.radians(tol_deg))
    inv = torch.where(mag > 0, 1.0 / torch.clamp(mag, min=1e-12), 0.0)
    return mag, active, gx * inv, -gy * inv


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def _select_runs(mass_row: torch.Tensor, max_segments: int,
                 runs_per_row: int | None, selection: str, max_records: int,
                 global_prefilter: int | None, topk_impl: str):
    """The run records to keep, by run mass: (B, h, w) masses (-1 off the
    run ends) -> (masses (B, R), flat run-end positions (B, R) int64).

    ``selection="row"``: each row's top ``runs_per_row`` (default
    ``max(64, w // 10, max_segments // 8)``, clamped to w), row-major.
    ``selection="global"``: the image-wide top ``max_records``. With
    ``topk_impl="exact"`` it is two-stage, a per-row top-``k_pre``
    prefilter first (``global_prefilter``: None = ``max(64, 3w/10)``, 0 =
    none, the one-stage top-k over all h*w run ends, > 0 = that cap).
    ``topk_impl="approx"`` is ``lax.approx_max_k`` in the JAX package,
    which off the TPU lowers to the exact sort (its comment in
    ``_component_stats``): so here it is the one-stage exact top-k, the
    same records as ``global_prefilter=0``. It is ignored by the row
    selection, as in JAX."""
    if selection not in ("row", "global"):
        raise ValueError(f"unknown selection {selection!r}; "
                         "expected 'row' or 'global'")
    if topk_impl not in ("exact", "approx"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}; "
                         "expected 'exact' or 'approx'")
    b, h, w = mass_row.shape
    row_i = torch.arange(h, device=mass_row.device)[:, None]
    if selection == "row":
        if runs_per_row is None:
            runs_per_row = max(64, w // 10, max_segments // 8)
        top_mass, top_col = topk_stable(mass_row, min(runs_per_row, w))
        return top_mass.reshape(b, -1), (row_i * w + top_col).reshape(b, -1)
    if topk_impl == "approx" or global_prefilter == 0:
        flat = mass_row.reshape(b, -1)
        return topk_stable(flat, min(max_records, flat.shape[1]))
    k_pre = (min(w, max(64, (3 * w) // 10)) if global_prefilter is None
             else min(w, int(global_prefilter)))
    pre_mass, pre_col = topk_stable(mass_row, k_pre)
    cand_pos = (row_i * w + pre_col).reshape(b, -1)
    top_mass, top_i = topk_stable(pre_mass.reshape(b, -1),
                                  min(max_records, cand_pos.shape[1]))
    return top_mass, _gather(cand_pos, top_i)


def _component_stats(root: torch.Tensor, wgt: torch.Tensor, max_segments: int,
                     shape: tuple[int, int],
                     coord_affine: tuple[float, float, float],
                     runs_per_row: int | None = None, selection: str = "row",
                     max_records: int = 32768,
                     global_prefilter: int | None = None,
                     topk_impl: str = "exact") -> dict:
    """Top-k components by gradient mass with exact moments and extremal
    projections, from per-row run records (the JAX ``_component_stats`` on
    its affine path; the selection arguments as :func:`_select_runs`).
    root, wgt: (B, h*w). Returns per-slot (B, max_segments) tensors."""
    h, w = shape
    b = root.shape[0]
    dev = root.device
    f32 = torch.float32
    r2 = root.reshape(b, h, w)
    w2 = wgt.reshape(b, h, w)
    w_full, h_full, s_half = coord_affine
    xs = torch.arange(w, dtype=f32, device=dev)
    xn2 = ((xs + 0.5) - w_full / 2.0) / s_half

    # ---- per-row run scans
    false_col = torch.zeros((b, h, 1), dtype=torch.bool, device=dev)
    same = r2[..., 1:] == r2[..., :-1]
    conn = torch.cat([false_col, same], dim=-1)
    is_end = torch.cat([~same, ~false_col], dim=-1)
    log_w = max(1, math.ceil(math.log2(w)))
    q = torch.stack([w2, w2 * xn2, w2 * xn2 * xn2, (w2 > 0).to(f32)], dim=1)
    qs = _segmented_sum_scan(q, conn[:, None], log_w)      # (B, 4, h, w)

    # ---- run-record selection
    top_mass, flat_pos = _select_runs(
        torch.where(is_end, qs[:, 0], -1.0), max_segments, runs_per_row,
        selection, max_records, global_prefilter, topk_impl)
    rec_ok = top_mass > 0.0

    # ---- record fetch; coordinates recomputed from the position with the
    # detector's own affine op sequence
    qf = qs.reshape(b, 4, h * w)
    g = [_gather(qf[:, i], flat_pos) for i in range(4)]
    rec_root = torch.where(rec_ok, _gather(root.to(torch.int64), flat_pos), -1)
    row_idx = flat_pos // w
    col_idx = flat_pos - row_idx * w
    rec_x1 = ((col_idx.to(f32) + 0.5) - w_full / 2.0) / s_half
    rec_y = -((row_idx.to(f32) + 0.5) - h_full / 2.0) / s_half
    col0 = col_idx.to(f32) - g[3] + 1.0
    rec_x0 = ((col0 + 0.5) - w_full / 2.0) / s_half
    rec_w, rec_wx, rec_wxx, rec_cnt = [torch.where(rec_ok, g[i], 0.0)
                                       for i in range(4)]
    rec_q = [rec_w, rec_wx, rec_y * rec_w, rec_wxx, rec_y * rec_wx,
             rec_y * rec_y * rec_w, rec_cnt]

    # ---- canonical (root, position) order: one int64 key, root = -1 first.
    # The keys are distinct, so the order is total and the f32 group sums
    # below do not depend on the order records were selected in.
    key = (rec_root + 1) * (h * w) + flat_pos
    perm = torch.argsort(key, dim=-1)
    rs = _gather(rec_root, perm)
    payload = torch.stack([*rec_q, rec_x0, rec_x1, rec_y], dim=1)  # (B,10,R)
    payload = torch.gather(payload, -1, perm[:, None].expand_as(payload))
    sq = payload[:, :7]
    sx0, sx1, sy = payload[:, 7], payload[:, 8], payload[:, 9]
    n_rec = rs.shape[1]
    log_r = max(1, math.ceil(math.log2(n_rec)))
    false1 = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    same_r = rs[:, 1:] == rs[:, :-1]
    gconn = torch.cat([false1, same_r], dim=1)
    g_end = torch.cat([~same_r, ~false1], dim=1)

    gsum = _segmented_sum_scan(sq, gconn[:, None], log_r)   # (B, 7, R)
    s_w, s_wx, s_wy, s_wxx, s_wxy, s_wyy, s_cnt = gsum.unbind(1)

    # ---- moments -> principal direction (meaningful at group ends)
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

    # ---- broadcast each group's end direction back to its records
    same_next = torch.cat([same_r, false1], dim=1)
    dd_b = _segmented_copy_first(
        torch.stack([ddx.flip(-1), ddy.flip(-1)], dim=1),
        same_next.flip(-1)[:, None], log_r).flip(-1)
    ddx_b, ddy_b = dd_b[:, 0], dd_b[:, 1]

    # ---- extremal projections: per-run extrema sit at run endpoints
    t0 = ddx_b * sx0 + ddy_b * sy
    t1 = ddx_b * sx1 + ddy_b * sy
    inf = torch.where(rs >= 0, 0.0, math.inf)
    gmm = _segmented_min_scan(
        torch.stack([torch.minimum(t0, t1) + inf,
                     -torch.maximum(t0, t1) + inf], dim=1),
        gconn[:, None], log_r, float(I32_MAX))
    gmin, gmax = gmm[:, 0], -gmm[:, 1]

    # ---- top-k components by total mass (group ends only)
    score = torch.where(g_end & (rs >= 0), s_w, -1.0)
    top, pos = topk_stable(score, max_segments)
    sel = lambda a: _gather(a, pos)
    return {
        "valid": top > 0.0, "root": sel(rs), "mass": sel(s_w),
        "cnt": sel(s_cnt), "cx": sel(cx), "cy": sel(cy), "ddx": sel(ddx),
        "ddy": sel(ddy), "lam_min": sel(lam_min), "tmin": sel(gmin),
        "tmax": sel(gmax),
    }


def detect_segments_device(images: torch.Tensor, max_segments: int = 512,
                           tol_deg: float = TOL_DEG, min_count: int = 15,
                           min_len_px: float = 12.0,
                           min_density: float = 0.7,
                           ccl_passes: int = CCL_PASSES,
                           blur_sigma: float = BLUR_SIGMA,
                           pair_tol_factor: float = 1.0,
                           runs_per_row: int | None = None,
                           check_fixpoint: bool = False,
                           selection: str = "row",
                           max_records: int = 32768,
                           global_prefilter: int | None = None,
                           topk_impl: str = "exact"):
    """(B, H, W) grayscale in [0, 255] -> (segments (B, S, 4) normalized,
    mask (B, S)), valid segments first, by decreasing gradient mass.

    The JAX function's arguments and defaults. ``tol_deg`` sets the
    activation threshold, the edge tolerance (times ``pair_tol_factor``)
    and the NFA's alignment probability; ``ccl_passes`` the raster passes;
    ``blur_sigma`` 0 skips the blur; ``min_density`` 0 turns the density
    gate off. ``check_fixpoint=True`` adds NaN to every valid segment of an
    image whose labels are not the CCL fixpoint after ``ccl_passes``
    passes (:func:`ccl_fixpoint_residual`). ``selection`` (``"row"``, the
    JAX function's low-level default, or ``"global"``, the pipeline's),
    ``runs_per_row``, ``max_records``, ``global_prefilter`` and
    ``topk_impl``: the run-record selection of :func:`_select_runs`."""
    with profiling.span("vp.detector"):
        if images.dim() != 3:
            raise ValueError(f"detect_segments_device: expected (B, H, W), "
                             f"got {tuple(images.shape)}")
        b, h, w = images.shape
        hi, wi = h - 1, w - 1
        npix = hi * wi
        mag, active, ux, uy = gradient_front(images, tol_deg, blur_sigma)
        packed = pack_edge_masks(active, ux, uy, math.cos(
            pair_tol_factor * math.radians(tol_deg)))
        root = connected_components(packed, ccl_passes)
        poison = 0.0
        if check_fixpoint:
            resid = ccl_fixpoint_residual(packed, root)
            poison = torch.where(resid > 0, math.nan, 0.0)[:, None, None]

        s = max(h, w) / 2.0
        wgt = torch.where(active, mag / 255.0, 0.0)
        st = _component_stats(root, wgt.reshape(b, -1), max_segments, (hi, wi),
                              (float(w), float(h), s),
                              runs_per_row=runs_per_row,
                              selection=selection, max_records=max_records,
                              global_prefilter=global_prefilter,
                              topk_impl=topk_impl)
        s_cnt, cx, cy = st["cnt"], st["cx"], st["cy"]
        ddx, ddy = st["ddx"], st["ddy"]
        tmin, tmax = st["tmin"], st["tmax"]

        span = torch.clamp(tmax - tmin, min=0.0)
        span_px = span * s
        width_px = torch.sqrt(12.0 * st["lam_min"]) * s

        # ---- NFA-style validation (Hoeffding bound on LSD's binomial test)
        p_align = tol_deg / 180.0
        area = span_px * torch.clamp(width_px, min=1.0)
        dens = torch.clamp(s_cnt / torch.clamp(area, min=1.0), 1e-6,
                           1.0 - 1e-6)
        kl = (dens * torch.log(dens / p_align)
              + (1.0 - dens) * torch.log((1.0 - dens) / (1.0 - p_align)))
        log10_nfa = 2.5 * math.log10(npix) - area * kl / math.log(10.0)
        meaningful = (dens > p_align) & (log10_nfa < 0.0)
        if min_density > 0.0:
            meaningful = meaningful & (dens >= min_density)
        valid = (st["valid"] & torch.isfinite(span) & meaningful
                 & (s_cnt >= min_count) & (span_px >= min_len_px))

        t_c = cx * ddx + cy * ddy
        seg = torch.stack([cx + (tmin - t_c) * ddx, cy + (tmin - t_c) * ddy,
                           cx + (tmax - t_c) * ddx, cy + (tmax - t_c) * ddy],
                          dim=-1)
        seg = torch.where(valid[..., None], seg + poison, 0.0)
        order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
        return (torch.gather(seg, 1, order[..., None].expand_as(seg)),
                torch.gather(valid, 1, order))
