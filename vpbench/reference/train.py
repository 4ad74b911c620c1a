"""One Caffe training step of the VP-grid CNN (Kluger et al., GCPR 2017:
``train/train_val.prototxt`` and ``train/solver.prototxt`` of
fkluger/vanishing_points_2017) in plain PyTorch, for the benchmark's
reference.

On the weights as the benchmark hands them to both sides
(``vpbench/weights.py``: convs OIHW, fc layers dense ``w`` (in, out)):
the layers of ``reference/cnn.py`` (conv1 96@11x11/4, LRN, ceil pooling,
grouped conv2/4/5, fc6, fc7, fc8 -> 20 x 20 logits), dropout 0.5 after
fc6 and fc7 (kept units x2), and Caffe's SigmoidCrossEntropyLoss (summed
over the grid, averaged over the batch); the gradients by
``torch.autograd.grad`` over those plain operations; Caffe's SGD written
out per tensor:

    V <- momentum * V - local_lr * (grad + local_wd * theta)
    theta <- theta + V

with local_lr = lr * lr_mult and local_wd = weight_decay * decay_mult
(weights 1 and 1, biases 2 and 0), lr Caffe's "step" policy.

``precision`` says how the conv and fc products are computed, as in
``reference/cnn.py``: ``"bf16"`` (what the configuration states),
``"f32"``, or ``"fp8"``, the control's step below bfloat16: each
operand's value rounded to float8 e4m3 under a per-tensor scale and the
product in float32, the gradient passed through the rounding unchanged
(a cast to float8 in the autograd graph would round the gradients too,
to zero at their sizes). Everything outside the products runs in
float32, with TF32 off for cuBLAS and cuDNN.

Departures from the prototxt: the training images are the inverse
gnomonic sphere renders of synthetic Manhattan scenes (``vpbench/
train_scenes.py``) in place of the unpublished LMDBs, with the mean image
of the configuration's file; the dropout masks are given (the program's),
not drawn here; the products run in the configuration's precision where
Caffe ran float32; fc6 and fc7 are dense, multiplied out from the shipped
rank-256 factors.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import cnn, render


@contextlib.contextmanager
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def input_images(l: torch.Tensor, lmask: torch.Tensor, mean: torch.Tensor,
                 size: int, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Padded lines (B, N, 3), (B, N) -> the network's input (B, 1, S, S):
    the sphere image, computed in ``dtype``, floored to 255 levels, less
    the mean."""
    img = render.sphere_image_u8(l, lmask, size, dtype).float() - mean[None]
    return img[:, None]


def _operands(x, w, precision: str):
    if precision == "fp8":
        return (x + (cnn._fp8(x) - x).detach(),
                w + (cnn._fp8(w) - w).detach())
    return cnn._operands(x, w, precision)


def logits(params: dict, x: torch.Tensor, keep: list,
           precision: str) -> torch.Tensor:
    """x (B, 1, S, S) -> fc8's logits (B, 400), with the dropout keep
    masks ``keep`` (fc6's and fc7's, bool (B, width))."""
    h = x
    for name, stride, pad, groups in cnn.CONVS:
        p = params[name]
        a, w = _operands(h, p["w"], precision)
        y = F.conv2d(a, w, stride=stride, padding=pad, groups=groups)
        h = torch.relu(y.float() + p["b"][None, :, None, None])
        if name in ("conv1", "conv2"):
            h = cnn._pool(cnn._lrn(h))
    h = cnn._pool(h).reshape(x.shape[0], -1)
    for i, name in enumerate(cnn.FCS):
        p = params[name]
        a, w = _operands(h, p["w"], precision)
        h = (a @ w).float() + p["b"]
        if name != "fc8_20x20":
            h = torch.where(keep[i], 2.0 * torch.relu(h), 0.0)
    return h


def sigmoid_xent(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Caffe's SigmoidCrossEntropyLoss of logits (B, 400) against labels
    (B, 20, 20): max(z, 0) - z y + log(1 + exp(-|z|)), summed, over B."""
    y = labels.reshape(z.shape)
    per = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return per.sum() / z.shape[0]


def loss_and_grads(params: dict, x: torch.Tensor, labels: torch.Tensor,
                   keep: list, precision: str) -> tuple:
    """-> (the loss, a float32 scalar tensor; the gradient of every
    parameter, ``{layer: {key: tensor}}``) at ``params``."""
    leaves = {n: {k: v.detach().float().requires_grad_()
                  for k, v in d.items()} for n, d in params.items()}
    names = [(n, k) for n, d in leaves.items() for k in d]
    with no_tf32(), torch.enable_grad():
        loss = sigmoid_xent(logits(leaves, x, keep, precision), labels)
        flat = torch.autograd.grad(loss, [leaves[n][k] for n, k in names])
    grads: dict = {}
    for (n, k), g in zip(names, flat):
        grads.setdefault(n, {})[k] = g.float()
    return loss.detach(), grads


def learning_rate(solver: dict, step: int) -> float:
    """Caffe's "step" policy: base_lr * gamma^floor(step / stepsize)."""
    return solver["base_lr"] * solver["gamma"] ** (step // solver["stepsize"])


def step_terms(params: dict, grads: dict, solver: dict, step: int) -> dict:
    """Each parameter's step term local_lr * (grad + local_wd * theta) at
    solver step ``step``: what the update takes from the momentum."""
    lr = learning_rate(solver, step)
    out: dict = {}
    for n, d in params.items():
        for k, theta in d.items():
            j = 1 if k == "b" else 0
            local_lr = lr * solver["lr_mult"][j]
            local_wd = solver["weight_decay"] * solver["decay_mult"][j]
            out.setdefault(n, {})[k] = local_lr * (grads[n][k]
                                                   + local_wd * theta)
    return out


def sgd_update(params: dict, momentum: dict, terms: dict,
               solver: dict) -> tuple:
    """-> (the parameters, the momentum) after Caffe's update by the step
    terms, tensor by tensor; the inputs are left as they were."""
    new_p: dict = {}
    new_v: dict = {}
    for n, d in params.items():
        for k, theta in d.items():
            v = solver["momentum"] * momentum[n][k] - terms[n][k]
            new_v.setdefault(n, {})[k] = v
            new_p.setdefault(n, {})[k] = theta + v
    return new_p, new_v
