"""Inverse-gnomonic sphere-image renderer (``ops/sphere.py`` of the JAX
package) and its CUDA kernel.

Every homogeneous image line (l0, l1, l2) maps to the curve
beta(alpha) = arctan((-l0 sin(alpha) - l2 cos(alpha)) / l1) in hemisphere
angle space; all curves are composited in white (alpha = 0.1) onto a black
size x size canvas with an anti-aliased perpendicular-distance coverage,
and the image is 1 - (1 - alpha)^(sum of coverages). Orientation matches
matplotlib's Agg framebuffer: row 0 is beta = +pi/2, column 0 is
alpha = -pi/2.

:func:`sphere_render` dispatches on the device of its input: a CPU tensor
goes to the plain twin :func:`sphere_render_ref`, a CUDA tensor to the
hand-written kernel ``csrc/sphere_render.cu`` (or raises).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import kernels
from ..utils import profiling

DEFAULT_LINEWIDTH_PX = 100.0 / 72.0
LINE_CHUNK = 8

SPHERE_KERNEL = kernels.CudaKernel(
    "sphere_render.cu", "sphere_render_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
    + [ctypes.c_void_p],
    extra_flags=("-fmad=false",))


def curve_beta(l: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """beta(alpha) for homogeneous lines: l (..., 3), alpha (A,) -> (..., A)."""
    l0, l1, l2 = l[..., 0:1], l[..., 1:2], l[..., 2:3]
    return torch.arctan((-l0 * torch.sin(alpha) - l2 * torch.cos(alpha)) / l1)


def _column_alphas(size: int, device) -> torch.Tensor:
    col = torch.arange(size, dtype=torch.float32, device=device)
    return (col - 0.5 * size + 0.5) * (math.pi / size)


@functools.lru_cache(maxsize=None)
def _column_tables(size: int, device: torch.device):
    """sin and cos of the column angles, made once per (size, device)."""
    alphas = _column_alphas(size, device)
    return torch.sin(alphas), torch.cos(alphas)


def _log1m(alpha: float) -> float:
    """log1p(-alpha) rounded to float32, computed on the host."""
    return float(torch.log1p(torch.tensor(-alpha, dtype=torch.float32)))


def sphere_render_ref(l: torch.Tensor, lmask: torch.Tensor, size: int = 500,
                      alpha: float = 0.1,
                      linewidth: float = DEFAULT_LINEWIDTH_PX) -> torch.Tensor:
    """Plain PyTorch renderer: l (B, N, 3), lmask (B, N) -> (B, S, S) f32.

    Lines are accumulated in chunks of 8, like the JAX function, so memory
    stays at O(B * 8 * S^2)."""
    b, n, _ = l.shape
    dev = l.device
    alphas = _column_alphas(size, dev)
    rows = torch.arange(size, dtype=torch.float32, device=dev)[:, None]
    half_w = 0.5 * linewidth
    l = l.to(torch.float32)
    acc = torch.zeros((b, size, size), dtype=torch.float32, device=dev)
    for c0 in range(0, n, LINE_CHUNK):
        lc = l[:, c0:c0 + LINE_CHUNK]
        mc = lmask[:, c0:c0 + LINE_CHUNK]
        beta = curve_beta(lc, alphas)                     # (B, C, S)
        rc = 0.5 * size - 0.5 - beta * (size / math.pi)
        rc = torch.where(torch.isnan(rc), -1e6, rc)
        m = 0.5 * (rc[..., 2:] - rc[..., :-2])
        m = torch.cat([rc[..., 1:2] - rc[..., 0:1], m,
                       rc[..., -1:] - rc[..., -2:-1]], dim=-1)
        inv_scale = torch.rsqrt(1.0 + m * m)
        dist = torch.abs(rows - rc[..., None, :]) * inv_scale[..., None, :]
        cov = torch.clamp(0.5 + half_w - dist, 0.0, 1.0)  # (B, C, S, S)
        cov = torch.where(mc[..., None, None], cov, 0.0)
        acc = acc + torch.sum(cov, dim=1)
    return 1.0 - torch.exp(acc * _log1m(alpha))


def sphere_render_cuda(l: torch.Tensor, lmask: torch.Tensor, size: int = 500,
                       alpha: float = 0.1,
                       linewidth: float = DEFAULT_LINEWIDTH_PX) -> torch.Tensor:
    """Kernel K2 on a CUDA batch: l (B, N, 3) f32, lmask (B, N) bool."""
    dev = l.device
    if dev.type != "cuda":
        raise ValueError(f"sphere_render_cuda: tensor on {dev}")
    if size < 2:
        raise ValueError("sphere_render_cuda: size must be >= 2")
    b, n = lmask.shape
    kernels.require(l, "l", torch.float32, (b, n, 3), dev)
    kernels.require(lmask, "lmask", torch.bool, (b, n), dev)
    sa, ca = _column_tables(size, dev)
    out = torch.empty((b, size, size), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    c0 = 0.5 * size - 0.5
    c1 = size / math.pi
    f32 = ctypes.c_float  # rounds to nearest, as torch's float32 cast does
    SPHERE_KERNEL.launch(
        kernels.ptr(l), kernels.ptr(lmask), kernels.ptr(sa), kernels.ptr(ca),
        kernels.ptr(out), b, n, size, f32(c0), f32(c1),
        f32(0.5 + 0.5 * linewidth), f32(_log1m(alpha)), kernels.stream_of(l))
    return out


def sphere_render(l: torch.Tensor, lmask: torch.Tensor, size: int = 500,
                  alpha: float = 0.1,
                  linewidth: float = DEFAULT_LINEWIDTH_PX) -> torch.Tensor:
    """Batched render (B, N, 3) -> (B, S, S) float32 in [0, 1]: the kernel
    for a CUDA tensor, the plain twin for a CPU tensor."""
    if l.is_cuda:
        return sphere_render_cuda(l.to(torch.float32).contiguous(),
                                  lmask.contiguous(), size, alpha, linewidth)
    if l.device.type != "cpu":
        raise ValueError(f"sphere_render: unsupported device {l.device}")
    return sphere_render_ref(l, lmask, size, alpha, linewidth)


def sphere_image_uint8(l: torch.Tensor, lmask: torch.Tensor, size: int = 500,
                       alpha: float = 0.1,
                       linewidth: float = DEFAULT_LINEWIDTH_PX) -> torch.Tensor:
    """uint8 sphere images floor(img * 255), the CNN-input contract."""
    with profiling.span("vp.render"):
        img = sphere_render(l, lmask, size=size, alpha=alpha,
                            linewidth=linewidth)
        return torch.floor(img * 255.0).to(torch.uint8)


def save_sphere_image(l: torch.Tensor, lmask: torch.Tensor, filename: str,
                      size: int = 500, alpha: float = 0.5) -> None:
    """Render one image's lines, l (N, 3) and lmask (N,), and write the
    sphere image as an 8-bit grayscale PNG."""
    from ..data.io import encode_png

    img = sphere_image_uint8(l[None], lmask[None], size=size, alpha=alpha)
    with open(filename, "wb") as fh:
        fh.write(encode_png(img[0].cpu().numpy()))


def segments_image(lp: torch.Tensor, lmask: torch.Tensor,
                   size: int = 250) -> torch.Tensor:
    """Raw segments in the normalized frame, lp (B, N, 4) and lmask (B, N),
    as white 1-px lines on black: (B, size, size) uint8, with the main
    renderer's analytic coverage (the reference's unused ``makeImage``)."""
    lp = lp.to(torch.float32)
    px = torch.arange(size, dtype=torch.float32, device=lp.device)
    # the canvas spans [-1, 1]; y up, so row 0 is the top
    xs = (px - 0.5 * size + 0.5) * (2.0 / size)
    gx, gy = torch.meshgrid(xs, -xs, indexing="xy")
    pts = torch.stack([gx, gy], dim=-1)                     # (S, S, 2)
    out = torch.zeros((lp.shape[0], size, size), dtype=torch.float32,
                      device=lp.device)
    for c0 in range(0, lp.shape[1], LINE_CHUNK):
        a = lp[:, c0:c0 + LINE_CHUNK, None, None, 0:2]      # (B, C, 1, 1, 2)
        ab = lp[:, c0:c0 + LINE_CHUNK, None, None, 2:4] - a
        denom = torch.sum(ab * ab, dim=-1)
        denom = torch.where(denom == 0, 1.0, denom)
        t = torch.clamp(torch.sum((pts - a) * ab, dim=-1) / denom, 0.0, 1.0)
        closest = a + t[..., None] * ab
        dist = torch.linalg.vector_norm(pts - closest, dim=-1) * (size / 2.0)
        cov = torch.clamp(1.0 - dist, 0.0, 1.0)
        cov = torch.where(lmask[:, c0:c0 + LINE_CHUNK, None, None], cov, 0.0)
        out = torch.maximum(out, cov.amax(dim=1))
    return torch.floor(out * 255.0).to(torch.uint8)
