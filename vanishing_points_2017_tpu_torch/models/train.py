"""CNN training: sigmoid cross-entropy and Caffe's SGD (``models/train.py``
of the JAX package).

The solver is the reference's (``train/solver.prototxt`` of
fkluger/vanishing_points_2017): base_lr 1e-4, x0.1 every 200k steps,
momentum 0.9, weight decay 5e-4, and Caffe's per-blob multipliers (biases:
2x learning rate, no weight decay). Caffe's update, written out by hand
because ``torch.optim.SGD`` keeps ``g`` in its momentum where Caffe keeps
``lr * g`` (the two part ways when the learning rate steps):

    V <- momentum * V - local_lr * (grad + local_wd * theta)
    theta <- theta + V

The network trains in bfloat16 products with float32 parameters, as the
JAX step does. Training batches are synthetic: scenes and labels from
``models/synth.py`` on the host, images rendered by ``ops/sphere`` (the
CUDA kernel K2 on a GPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import require_device
from ..ops import sphere as sph
from . import cnn, synth

BASE_LR = 1e-4
LR_GAMMA = 0.1
LR_STEPSIZE = 200_000
MOMENTUM = 0.9
WEIGHT_DECAY = 5e-4
KEEP_PROB = 0.5  # dropout after fc6 and fc7


@dataclasses.dataclass
class TrainState:
    """The network (its ``nn.Parameter``s are trained in place), Caffe's
    momentum per parameter, the step count and the solver's schedule."""
    model: cnn.VPNet
    momentum: dict
    step: int = 0
    base_lr: float = BASE_LR
    lr_stepsize: int = LR_STEPSIZE


def init_state(params: dict, step: int = 0, base_lr: float = BASE_LR,
               lr_stepsize: int = LR_STEPSIZE) -> TrainState:
    """A state that trains a copy of ``params`` (this port's layout) from
    ``step`` with zero momentum, in bfloat16 products."""
    model = cnn.VPNet({n: {k: v.detach().clone() for k, v in d.items()}
                       for n, d in params.items()}, torch.bfloat16)
    momentum = {n: {k: torch.zeros_like(v) for k, v in d.items()}
                for n, d in model.params().items()}
    return TrainState(model, momentum, step, base_lr, lr_stepsize)


def learning_rate(step: int, base_lr: float = BASE_LR,
                  stepsize: int = LR_STEPSIZE) -> float:
    """Caffe's "step" policy: base_lr * gamma^floor(step / stepsize)."""
    return base_lr * LR_GAMMA ** (step // stepsize)


def sigmoid_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Caffe's SigmoidCrossEntropyLoss: summed over the grid, averaged over
    the batch (``train_val.prototxt:411-417``)."""
    per = torch.clamp_min(logits, 0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.sum(per) / logits.shape[0]


def sgd_update(params: dict, grads: dict, momentum: dict, step: int,
               base_lr: float = BASE_LR,
               lr_stepsize: int = LR_STEPSIZE) -> None:
    """Caffe's SGD step on nested ``{layer: {key: tensor}}`` dicts, in
    place (``params`` and ``momentum`` are overwritten; the dense fc6 alone
    is ~1 GB). Biases (key ``b``) take 2 lr and no weight decay; ``w``,
    ``u`` and ``v`` take lr and ``WEIGHT_DECAY``."""
    lr = learning_rate(step, base_lr, lr_stepsize)
    for is_bias in (False, True):
        keys = [(n, k) for n, d in params.items() for k in d
                if (k == "b") == is_bias]
        if not keys:
            continue
        p = [params[n][k] for n, k in keys]
        g = [grads[n][k] for n, k in keys]
        v = [momentum[n][k] for n, k in keys]
        local_lr, local_wd = (2.0 * lr, 0.0) if is_bias else (lr,
                                                               WEIGHT_DECAY)
        with torch.no_grad():
            delta = torch._foreach_add(g, p, alpha=local_wd)
            torch._foreach_mul_(delta, local_lr)
            torch._foreach_mul_(v, MOMENTUM)
            torch._foreach_sub_(v, delta)
            torch._foreach_add_(p, v)


def step_generator(seed: int, step: int,
                   device: str | torch.device) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, step) as the
    JAX drivers fold the step into their key: a resumed run draws what an
    unbroken one would."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def dropout_masks(model: cnn.VPNet, batch: int,
                  generator: torch.Generator) -> list:
    """Keep masks for fc6 and fc7, bool (batch, width), each unit kept with
    probability ``KEEP_PROB``, drawn from ``generator`` on its device."""
    dev = generator.device
    return [torch.rand((batch, model.layers[name].b.shape[0]),
                       generator=generator, device=dev) < KEEP_PROB
            for name in ("fc6", "fc7")]


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               generator: torch.Generator | None = None,
               keep: list | None = None) -> torch.Tensor:
    """One Caffe-SGD step, in place on ``state``; returns the loss (a
    float32 scalar tensor, before the update).

    images: (B, 1, S, S) mean-subtracted; labels: (B, 20, 20) in [0, 1].
    The dropout masks are drawn from ``generator``, or given as ``keep``
    (fc6's and fc7's, bool (B, width))."""
    if keep is None:
        if generator is None:
            raise ValueError("train_step: pass a generator or keep masks")
        keep = dropout_masks(state.model, images.shape[0], generator)
    params = state.model.params()
    names = [(n, k) for n, d in params.items() for k in d]
    with state.model.numerics():
        loss = sigmoid_xent(state.model.logits(images, keep), labels)
        flat = torch.autograd.grad(loss, [params[n][k] for n, k in names])
    grads: dict = {}
    for (n, k), g in zip(names, flat):
        grads.setdefault(n, {})[k] = g
    sgd_update(params, grads, state.momentum, state.step, state.base_lr,
               state.lr_stepsize)
    state.step += 1
    return loss.detach()


def make_batch(rng_np: np.random.Generator, batch: int,
               mean: torch.Tensor | None = None, n_pad: int = 512,
               size: int = cnn.INPUT_SIZE,
               device: str | torch.device = "cuda"):
    """A synthetic training batch on ``device`` (the GPU unless the caller
    names another): images (B, 1, S, S) float32, floor(render * 255) less
    ``mean``, and labels (B, 20, 20).

    Scenes and labels are drawn on the host from ``rng_np`` in the JAX
    package's order (scenes past ``n_pad`` lines are cut to their first
    ``n_pad``); the render is ``ops.sphere.sphere_render``, so on a GPU it
    is the kernel K2."""
    device = require_device(device)
    ls = np.zeros((batch, n_pad, 3), np.float32)
    masks = np.zeros((batch, n_pad), bool)
    labels = []
    for i in range(batch):
        scene = synth.make_training_scene(rng_np)
        n = min(scene.lines.shape[0], n_pad)
        ls[i, :n] = scene.lines[:n]
        masks[i, :n] = True
        labels.append(synth.vp_grid_label(scene.vps).astype(np.float32))
    img = sph.sphere_render(torch.from_numpy(ls).to(device),
                            torch.from_numpy(masks).to(device), size=size)
    img = torch.floor(img * 255.0)
    if mean is not None:
        img = img - mean[None]
    return img[:, None], torch.from_numpy(np.stack(labels)).to(device)
