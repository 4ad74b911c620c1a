"""AlexNet-variant VP-grid CNN as an ``nn.Module`` (``models/cnn.py`` of
the JAX package).

1 x 500 x 500 mean-subtracted sphere image in, 20 x 20 sigmoid grid out:
conv1 96@11x11/4 -> LRN -> maxpool 3/2 -> conv2 256@5x5 pad 2 group 2 ->
LRN -> pool -> conv3 384@3x3 pad 1 -> conv4 384@3x3 pad 1 group 2 ->
conv5 256@3x3 pad 1 group 2 -> pool -> fc6 4096 -> fc7 4096 -> fc8 400,
ReLU after every layer but fc8. Caffe details kept: CEIL pooling
(123 -> 61 -> 30 -> 15), across-channel LRN, the NCHW fc6 flatten (the
native layout here), factorized fc6/fc7 (``x @ u @ v``).

``compute_dtype`` follows the JAX ``_conv``: inputs and weights are cast
to it for every conv and fc product, the product comes back in that dtype,
and the bias is added in float32; LRN and pooling run in float32. In
float32 mode TF32 is pinned off for cuDNN and cuBLAS. The weights are
``nn.Parameter``s: serving calls the module (fixed chunks, no autograd),
training calls :meth:`VPNet.logits` with dropout masks
(``models/train.py``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..batching import in_chunks

GRID = 20
INPUT_SIZE = 500

# (name, out_ch, kernel, stride, pad, groups, bias_init, weight_std)
CONV_SPECS = [
    ("conv1", 96, 11, 4, 0, 1, 0.0, 0.01),
    ("conv2", 256, 5, 1, 2, 2, 0.1, 0.01),
    ("conv3", 384, 3, 1, 1, 1, 0.0, 0.01),
    ("conv4", 384, 3, 1, 1, 2, 0.1, 0.01),
    ("conv5", 256, 3, 1, 1, 2, 0.1, 0.01),
]
# (name, out_dim, bias_init, weight_std)
FC_SPECS = [
    ("fc6", 4096, 0.1, 0.005),
    ("fc7", 4096, 0.1, 0.005),
    ("fc8_20x20", GRID * GRID, 0.0, 0.01),
]


def _ceil_pool(n: int, k: int = 3, s: int = 2) -> int:
    return -(-(n - k) // s) + 1


def pool5_side(input_size: int = INPUT_SIZE) -> int:
    """500 -> conv1/4 -> 123 -> pool -> 61 -> pool -> 30 -> pool5 -> 15."""
    c1 = (input_size - 11) // 4 + 1
    return _ceil_pool(_ceil_pool(_ceil_pool(c1)))


def flops_per_image(params: dict, input_size: int = INPUT_SIZE) -> int:
    """The network's floating-point operations per image, 2 per
    multiply-add, from the parameters' shapes (this port's layout, tensors
    or arrays): every conv over full windows (the taps on padding
    included, grouped convs by their (in / groups) weights) and every fc
    product (``x @ w``, or ``x @ u`` and ``@ v`` for a factorized layer).
    Pooling, LRN, biases and activations are not counted."""
    def size(a) -> int:
        return math.prod(a.shape)

    flops, side = 0, input_size
    for name, _o, k, stride, pad, _g, _b, _s in CONV_SPECS:
        side = (side + 2 * pad - k) // stride + 1
        flops += 2 * size(params[name]["w"]) * side * side
        if name in ("conv1", "conv2", "conv5"):
            side = _ceil_pool(side)
    for name, *_ in FC_SPECS:
        p = params[name]
        flops += 2 * ((size(p["u"]) + size(p["v"])) if "u" in p
                      else size(p["w"]))
    return flops


def caffe_max_pool(x: torch.Tensor, window: int = 3,
                   stride: int = 2) -> torch.Tensor:
    """Max pool with Caffe's ceil output size, (B, C, H, W). PyTorch's
    ``ceil_mode`` gives the same windows here: with no padding every last
    window starts inside the input."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


def lrn_across_channels(x: torch.Tensor, local_size: int = 5,
                        alpha: float = 1e-4, beta: float = 0.75,
                        k: float = 1.0) -> torch.Tensor:
    """Caffe ACROSS_CHANNELS LRN on (B, C, H, W), written out:
    out = x / (k + alpha/n * sum_{|c'-c| <= n//2} x_c'^2)^beta."""
    half = (local_size - 1) // 2
    sq = F.pad((x * x).to(torch.float32), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    ssum = sq[:, 0:c]
    for i in range(1, local_size):
        ssum = ssum + sq[:, i:i + c]
    scale = (k + (alpha / local_size) * ssum) ** beta
    return (x.to(torch.float32) / scale).to(x.dtype)


def init_params(seed: int = 0, input_size: int = INPUT_SIZE,
                fc_width: int | None = None) -> dict:
    """Random Gaussian parameters in the JAX package's layout (numpy,
    HWIO convs) with the prototxt's fillers, from a numpy seed."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    in_ch = 1
    for name, out_ch, k, _s, _p, g, bias, std in CONV_SPECS:
        w = rng.normal(size=(k, k, in_ch // g, out_ch)) * std
        params[name] = {"w": w.astype(np.float32),
                        "b": np.full((out_ch,), bias, np.float32)}
        in_ch = out_ch
    in_dim = 256 * pool5_side(input_size) ** 2
    for name, out_dim, bias, std in FC_SPECS:
        if fc_width is not None and name != "fc8_20x20":
            out_dim = fc_width
        w = rng.normal(size=(in_dim, out_dim)) * std
        params[name] = {"w": w.astype(np.float32),
                        "b": np.full((out_dim,), bias, np.float32)}
        in_dim = out_dim
    return params


@contextlib.contextmanager
def tf32_disabled():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls; restores
    the caller's matmul setting afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class VPNet(nn.Module):
    """The VP-grid CNN. ``params``: this port's layout (see
    ``weights.params_from_numpy``), fc layers either ``w`` or ``u``/``v``;
    they become the module's float32 ``nn.Parameter``s (sharing storage
    with ``params`` where those already are contiguous float32)."""

    def __init__(self, params: dict, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleDict()
        for name, *_ in CONV_SPECS + FC_SPECS:
            layer = nn.Module()
            for k, v in params[name].items():
                layer.register_parameter(
                    k, nn.Parameter(v.to(torch.float32).contiguous()))
            self.layers[name] = layer

    def params(self) -> dict:
        """The weights as ``{layer: {key: nn.Parameter}}``, this port's
        layout (what ``weights.params_to_npz`` writes)."""
        return {name: dict(layer.named_parameters())
                for name, layer in self.layers.items()}

    def fc_widths(self) -> list:
        """The widths of fc6 and fc7, those of their dropout masks."""
        return [self.layers[n].b.shape[0] for n in ("fc6", "fc7")]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution stack: (B, 1, S, S) -> fc6's input (B, 256 *
        side^2), flattened in NCHW order (Caffe's)."""
        cd = self.compute_dtype
        h = x
        for name, _o, _k, stride, pad, groups, _b, _s in CONV_SPECS:
            p = self.layers[name]
            y = F.conv2d(h.to(cd), p.w.to(cd), stride=stride, padding=pad,
                         groups=groups)
            h = torch.relu(y.to(torch.float32) + p.b[None, :, None, None])
            if name in ("conv1", "conv2"):
                h = caffe_max_pool(lrn_across_channels(h))
        h = caffe_max_pool(h)
        return h.reshape(h.shape[0], -1)

    def logits(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        """fc8 logits (B, 20, 20) of the whole batch, unchunked, with
        autograd when the caller's mode allows it; the caller runs it (and
        a backward pass) under :meth:`numerics`. Training (JAX
        ``forward(train=True, logits=True)``) passes ``keep``: the dropout
        keep masks after fc6 and fc7, bool (B, width) each, kept units
        scaled by 2; ``None`` applies no dropout."""
        cd = self.compute_dtype
        h = self.features(x)
        for i, (name, *_) in enumerate(FC_SPECS):
            p = self.layers[name]
            hc = h.to(cd)
            if hasattr(p, "u"):
                y = (hc @ p.u.to(cd)) @ p.v.to(cd)
            else:
                y = hc @ p.w.to(cd)
            h = y.to(torch.float32) + p.b
            if name != "fc8_20x20":
                h = torch.relu(h)
                if keep is not None:  # dropout, p = 0.5 (JAX cnn.py:180)
                    h = torch.where(keep[i], h / 0.5, 0.0)
        return h.reshape(-1, GRID, GRID)

    def numerics(self):
        """The context the network's products run in, the backward pass's
        included: TF32 off in float32 mode, the defaults in bfloat16."""
        if self.compute_dtype == torch.float32:
            return tf32_disabled()
        return contextlib.nullcontext()

    def forward_unchunked(self, x: torch.Tensor) -> torch.Tensor:
        """The network on the whole batch at once; cuDNN and cuBLAS then
        pick their kernels by the batch size, so an image's grid depends
        on the batch it came in."""
        with self.numerics():
            return torch.sigmoid(self.logits(x))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, S, S) mean-subtracted float32 -> (B, 20, 20) sigmoid
        grid; row b of the grid is beta index b. Serving only: no autograd
        graph is recorded.

        The network runs on fixed chunks of ``batching.default_chunk``
        images (32 on a GPU), so an image's grid is bit-identical at any
        batch size and position."""
        return in_chunks(self.forward_unchunked, [x])


def preprocess(sphere_images: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """uint8/float (B, S, S) sphere images + (S, S) mean -> (B, 1, S, S)."""
    x = sphere_images.to(torch.float32) - mean.to(torch.float32)[None]
    return x[:, None]
