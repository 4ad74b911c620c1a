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
JAX step does. Training batches are synthetic, in two parts:

* host drawing (:func:`draw_batch`): scenes and labels from
  ``models/synth.py`` on the host, as padded lines, their mask and the
  20 x 20 labels;
* the device step (:func:`device_step`): that batch copied in, rendered
  by ``ops/sphere`` (the CUDA kernel K2 on a GPU), floor(. * 255) less
  the mean, the dropout masks drawn from :func:`step_generator`, and
  :func:`train_step`, all under one ``vp.batch`` root span with the
  spans ``vp.train.input``, ``vp.train.forward``, ``vp.train.backward``
  and ``vp.train.update`` (``utils/profiling.py``).

:func:`make_batch` is the two halves of the input alone (drawing and
rendering, no step), for the mean image and the tests.

On a dp x tp mesh (``parallel/mesh.py``; the JAX step is the same program
under a ``Mesh``) a state made with ``init_state(..., mesh=)`` holds this
rank's shards of fc6/fc7 and of their momentum, and ``train_step(...,
mesh=)`` takes this rank's dp slice of the batch: the dropout masks are
drawn for the global batch and sliced, the fc layers run split over tp
(``parallel/tp.py``), and the gradients and the loss are averaged over dp
with one all-reduce before Caffe's update, so a step equals the
single-process step on the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import require_device
from ..ops import sphere as sph
from ..parallel import mesh as pmesh
from ..parallel import tp as ptp
from ..utils import profiling
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
               lr_stepsize: int = LR_STEPSIZE,
               mesh: pmesh.Mesh | None = None) -> TrainState:
    """A state that trains a copy of ``params`` (this port's layout) from
    ``step`` with zero momentum, in bfloat16 products; with ``mesh``, of
    this rank's shards of them (``mesh.param_spec``)."""
    params = {n: {k: v.detach().clone() for k, v in d.items()}
              for n, d in params.items()}
    if mesh is None:
        model = cnn.VPNet(params, torch.bfloat16)
    else:
        model = ptp.TPVPNet(pmesh.shard_params(params, mesh), mesh,
                            torch.bfloat16)
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
    return [torch.rand((batch, width), generator=generator, device=dev)
            < KEEP_PROB for width in model.fc_widths()]


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               generator: torch.Generator | None = None,
               keep: list | None = None,
               mesh: pmesh.Mesh | None = None) -> torch.Tensor:
    """One Caffe-SGD step, in place on ``state``; returns the loss (a
    float32 scalar tensor, before the update).

    images: (B, 1, S, S) mean-subtracted; labels: (B, 20, 20) in [0, 1].
    The dropout masks are drawn from ``generator``, or given as ``keep``
    (fc6's and fc7's, bool (B, width)). With ``mesh`` (the one the state
    was made with), images and labels are this rank's dp slice, the masks
    are the global batch's, and the loss returned is the global batch's."""
    dp = 1 if mesh is None else mesh.dp
    if keep is None:
        if generator is None:
            raise ValueError("train_step: pass a generator or keep masks")
        keep = dropout_masks(state.model, images.shape[0] * dp, generator)
    if mesh is not None:
        keep = ptp.local_keep(keep, mesh)
    params = state.model.params()
    names = [(n, k) for n, d in params.items() for k in d]
    with state.model.numerics():
        with profiling.span("vp.train.forward"):
            loss = sigmoid_xent(state.model.logits(images, keep), labels)
        with profiling.span("vp.train.backward"):
            flat = torch.autograd.grad(loss,
                                       [params[n][k] for n, k in names])
            loss = loss.detach()
            if mesh is not None and mesh.dp_group is not None:
                # one all-reduce of every gradient and the loss: their dp
                # means
                buf = pmesh.all_reduce(torch.cat(
                    [g.reshape(-1) for g in flat] + [loss.reshape(1)]),
                    mesh.dp_group) / dp
                flat = [b.view_as(g) for b, g in zip(
                    torch.split(buf, [g.numel() for g in flat] + [1]), flat)]
                loss = buf[-1]
    grads: dict = {}
    for (n, k), g in zip(names, flat):
        grads.setdefault(n, {})[k] = g
    with profiling.span("vp.train.update"):
        sgd_update(params, grads, state.momentum, state.step, state.base_lr,
                   state.lr_stepsize)
    state.step += 1
    return loss


def draw_batch(rng_np: np.random.Generator, batch: int,
               n_pad: int = 512) -> tuple:
    """The host half of a synthetic training batch: ``batch`` scenes and
    labels drawn from ``rng_np`` in the JAX package's order (scenes past
    ``n_pad`` lines cut to their first ``n_pad``) -> CPU tensors (lines
    (B, n_pad, 3) float32, their mask (B, n_pad) bool, labels (B, 20, 20)
    float32)."""
    ls = np.zeros((batch, n_pad, 3), np.float32)
    masks = np.zeros((batch, n_pad), bool)
    labels = []
    for i in range(batch):
        scene = synth.make_training_scene(rng_np)
        n = min(scene.lines.shape[0], n_pad)
        ls[i, :n] = scene.lines[:n]
        masks[i, :n] = True
        labels.append(synth.vp_grid_label(scene.vps).astype(np.float32))
    return (torch.from_numpy(ls), torch.from_numpy(masks),
            torch.from_numpy(np.stack(labels)))


def render_images(lines: torch.Tensor, lmask: torch.Tensor,
                  mean: torch.Tensor | None = None,
                  size: int = cnn.INPUT_SIZE) -> torch.Tensor:
    """Lines on the device -> the network's input (B, 1, S, S) float32:
    floor(render * 255) less ``mean``; the render is
    ``ops.sphere.sphere_render``, so on a GPU it is the kernel K2."""
    img = torch.floor(sph.sphere_render(lines, lmask, size=size) * 255.0)
    if mean is not None:
        img = img - mean[None]
    return img[:, None]


def make_batch(rng_np: np.random.Generator, batch: int,
               mean: torch.Tensor | None = None, n_pad: int = 512,
               size: int = cnn.INPUT_SIZE,
               device: str | torch.device = "cuda"):
    """A synthetic training batch on ``device`` (the GPU unless the caller
    names another): images (B, 1, S, S) float32, floor(render * 255) less
    ``mean``, and labels (B, 20, 20): :func:`draw_batch` and
    :func:`render_images`, with no step."""
    device = require_device(device)
    ls, masks, labels = draw_batch(rng_np, batch, n_pad)
    img = render_images(ls.to(device), masks.to(device), mean, size)
    return img, labels.to(device)


@dataclasses.dataclass
class StepOut:
    """What :func:`device_step` gives back: the loss (a float32 scalar
    tensor on the device, before the update), the network's input
    (B, 1, S, S) and the dropout keep masks of fc6 and fc7 it used."""
    loss: torch.Tensor
    images: torch.Tensor
    keep: list


def device_step(state: TrainState, lines: torch.Tensor, lmask: torch.Tensor,
                labels: torch.Tensor, mean: torch.Tensor, seed: int,
                size: int = cnn.INPUT_SIZE) -> StepOut:
    """One training step on a batch from :func:`draw_batch` (host or
    device tensors), in place on ``state``, on the state's device, under
    one ``vp.batch`` root span.

    ``vp.train.input``: the batch copied in (without blocking: pinned
    host memory overlaps), rendered and less ``mean``
    (:func:`render_images`), and the dropout masks drawn from
    ``step_generator(seed, state.step)``; then :func:`train_step`
    (``vp.train.forward``, ``vp.train.backward``, ``vp.train.update``).
    Equal, bit for bit, to :func:`make_batch` followed by
    :func:`train_step` with that generator. Nothing here reads from the
    device: the caller reads the loss."""
    dev = state.model.layers["conv1"].w.device
    with profiling.batch():
        with profiling.span("vp.train.input"):
            images = render_images(lines.to(dev, non_blocking=True),
                                   lmask.to(dev, non_blocking=True), mean,
                                   size)
            labels = labels.to(dev, non_blocking=True)
            keep = dropout_masks(state.model, images.shape[0],
                                 step_generator(seed, state.step, dev))
        loss = train_step(state, images, labels, keep=keep)
    return StepOut(loss, images, keep)
