"""The yardstick's arithmetic: the card's published peaks, the CNN's
operations per image, and the work the two hand-written kernels' calls
must do, all from shapes, so that they read the same work whatever
implements a call.
"""

from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM, data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # outside the tensor cores
BF16_FLOPS = 989e12


def _ceil_pool(n: int, k: int = 3, s: int = 2) -> int:
    return -(-(n - k) // s) + 1


def cnn_flops_per_image(net: dict) -> int:
    """The network's floating-point operations per image, 2 per
    multiply-add, from a configuration's ``network`` section: every conv
    over full windows (taps on padding included, grouped convs by their
    in / groups weights), every dense fc product. Pooling, LRN, biases and activations are
    not counted. ``pool_after`` names the convs followed by a 3/2 pool."""
    flops, side, cin = 0, net["input"], net["channels"]
    for name, cout, k, stride, pad, groups in net["convs"]:
        side = (side + 2 * pad - k) // stride + 1
        flops += 2 * k * k * (cin // groups) * cout * side * side
        if name in net["pool_after"]:
            side = _ceil_pool(side)
        cin = cout
    din = cin * side * side
    for _name, dout in net["fc"]:
        flops += 2 * din * dout
        din = dout
    return flops


def ccl_work(b: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, operations) of the raster CCL on a (b, h, w) packed int32
    edge grid: the grid read once and the int32 labels written once; the
    operations are left at 0 (integer minima, far below the byte time)."""
    return 2 * b * h * w * 4, 0


def render_work(l: torch.Tensor, lmask: torch.Tensor, size: int,
                linewidth: float = 100.0 / 72.0) -> tuple[int, int]:
    """(bytes, float operations) of the uint8 sphere image of these lines:
    the lines and their mask read once and the uint8 image written once;
    12 operations per masked (line, column) for the curve, 7 per pixel a
    line covers (difference, abs, product, coverage, clamp pair, sum) and
    3 per output pixel (product, exp, difference)."""
    b, n = lmask.shape
    cols = torch.arange(size, dtype=torch.float32, device=l.device)
    alphas = (cols - 0.5 * size + 0.5) * (math.pi / size)
    cov_c = 0.5 + 0.5 * linewidth
    covered = 0
    for c in range(0, n, 64):
        lc = l[:, c:c + 64].float()
        beta = torch.arctan((-lc[..., 0:1] * torch.sin(alphas)
                             - lc[..., 2:3] * torch.cos(alphas))
                            / lc[..., 1:2])
        rc = 0.5 * size - 0.5 - beta * (size / math.pi)
        rc = torch.where(torch.isnan(rc), -1e6, rc)
        m = torch.cat([rc[..., 1:2] - rc[..., :1],
                       0.5 * (rc[..., 2:] - rc[..., :-2]),
                       rc[..., -1:] - rc[..., -2:-1]], dim=-1)
        half = cov_c * torch.sqrt(1.0 + m * m)
        lo = torch.clamp(torch.floor(rc - half) + 1, min=0)
        hi = torch.clamp(torch.ceil(rc + half) - 1, max=size - 1)
        rows = torch.clamp(hi - lo + 1, min=0) * lmask[:, c:c + 64, None]
        covered += int(rows.sum())
    n_bytes = l.numel() * 4 + lmask.numel() + b * size * size
    n_ops = 12 * int(lmask.sum()) * size + 7 * covered + 3 * b * size * size
    return n_bytes, n_ops


def roofline_share(n_bytes: float, n_ops: float, seconds: float) -> float:
    """The least time the work could take on the card (the larger of its
    bytes at the HBM rate and its float32 operations at the float32 peak)
    as a percentage of ``seconds``."""
    return 100.0 * max(n_bytes / HBM_BYTES_PER_S,
                       n_ops / FP32_FLOPS) / seconds
