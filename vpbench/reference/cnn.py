"""The VP-grid CNN of Kluger et al. (GCPR 2017, ``cnn/deploy.prototxt``)
in plain PyTorch, for the benchmark's reference.

On the weights the benchmark reads from the configuration's file and hands
to both sides (``vpbench/weights.py``: convs OIHW, fc layers dense): conv1 96@11x11/4, LRN, max pool 3/2
(Caffe's ceil), conv2 256@5x5 pad 2 group 2, LRN, pool, conv3 384@3x3,
conv4 384@3x3 group 2, conv5 256@3x3 group 2, pool, fc6 4096, fc7 4096,
fc8 400 -> sigmoid 20 x 20.

``precision`` says how the conv and fc products are computed: ``"bf16"``
(operands cast to bfloat16, the product's result rounded to bfloat16, the
bias added in float32: what the configuration states), ``"fp8"`` (each
operand rounded to float8 e4m3 with a per-tensor scale, the product in
float32 with TF32 off: the control's step below bfloat16) or ``"f32"``.
LRN and pooling run in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (name, stride, pad, groups)
CONVS = [("conv1", 4, 0, 1), ("conv2", 1, 2, 2), ("conv3", 1, 1, 1),
         ("conv4", 1, 1, 2), ("conv5", 1, 1, 2)]
FCS = ["fc6", "fc7", "fc8_20x20"]
GRID = 20
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    back in float32."""
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return q.float() * scale


def _operands(x, w, precision: str):
    if precision == "bf16":
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    if precision == "fp8":
        return _fp8(x), _fp8(w)
    return x.float(), w.float()


def _lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
         beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Caffe's ACROSS_CHANNELS LRN, summed in channel order."""
    half = (size - 1) // 2
    sq = F.pad((x * x).float(), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    ssum = sq[:, 0:c]
    for i in range(1, size):
        ssum = ssum + sq[:, i:i + c]
    return (x.float() / (k + (alpha / size) * ssum) ** beta).to(x.dtype)


def _pool(x):
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def forward(params: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (B, 1, S, S) mean-subtracted float32 -> (B, 20, 20) grid."""
    h = x
    for name, stride, pad, groups in CONVS:
        p = params[name]
        a, w = _operands(h, p["w"], precision)
        y = F.conv2d(a, w, stride=stride, padding=pad, groups=groups)
        h = torch.relu(y.float() + p["b"][None, :, None, None])
        if name in ("conv1", "conv2"):
            h = _pool(_lrn(h))
    h = _pool(h).reshape(x.shape[0], -1)
    for name in FCS:
        p = params[name]
        a, w = _operands(h, p["w"], precision)
        h = (a @ w).float() + p["b"]
        if name != "fc8_20x20":
            h = torch.relu(h)
    return torch.sigmoid(h).reshape(-1, GRID, GRID)


def grid(params: dict, mean: torch.Tensor, sphere_u8: torch.Tensor,
         precision: str, block: int = 8) -> torch.Tensor:
    """uint8 sphere images (B, S, S) -> CNN grids (B, 20, 20), computed in
    blocks of ``block`` images with TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            outs = []
            for i in range(0, sphere_u8.shape[0], block):
                x = sphere_u8[i:i + block].float() - mean[None]
                outs.append(forward(params, x[:, None], precision))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(outs)
