"""The port's training step against the benchmark's plain training-step
reference (``vpbench/reference/train.py``) on the CPU, and the device
step against today's two calls.

A small network of the published layer kinds (grouped convs, LRN, ceil
pooling, dropout after fc6 and fc7, the 20 x 20 grid) at narrow widths,
on 99 x 99 inputs, with seeded random weights from the prototxt's
fillers: two Caffe-SGD steps of ``models/train.train_step`` with given
dropout masks against the reference, which gets the same masks: the
loss, every gradient (taken where ``train_step`` hands them to
``sgd_update``), the parameters and the momentum after each step.
"""

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch.models import cnn, synth, train
from vanishing_points_2017_tpu_torch.ops import sphere as sph
from vpbench.reference import train as ref
from torch_cpu import torch_threads  # noqa: F401

SIZE, BATCH = 99, 3
# (name, out, in / groups, kernel): conv1 96, conv2 256 g2, conv3 384,
# conv4 384 g2, conv5 256 g2 cut to 8, 8, 12, 12, 8; fc6 / fc7 to 16
CONVS = [("conv1", 8, 1, 11), ("conv2", 8, 4, 5), ("conv3", 12, 8, 3),
         ("conv4", 12, 6, 3), ("conv5", 8, 6, 3)]
FCS = [("fc6", 16), ("fc7", 16), ("fc8_20x20", 400)]
SOLVER = {"base_lr": 5e-4, "gamma": train.LR_GAMMA,
          "stepsize": train.LR_STEPSIZE, "momentum": train.MOMENTUM,
          "weight_decay": train.WEIGHT_DECAY, "lr_mult": [1, 2],
          "decay_mult": [1, 0]}
# Relative L2 differences allowed. float32 products: the port and the
# reference run the same float32 operations, so only the order a kernel
# sums in may differ (float32's 6e-8 per rounding, over sums of up to
# ~10^4 terms). bfloat16 products: both round the same operands to
# bfloat16 and run the same CPU kernels, so they too part only where a
# float32 sum is ordered otherwise (4e-8 seen, in the momentum); 1e-3 is
# a quarter of bfloat16's spacing of 2^-8, and products computed in
# float32 or float8 in its place move the gradients by 0.27 and 1.2.
TOL = {"f32": 1e-5, "bf16": 1e-3}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def small_params(seed: int = 0) -> dict:
    """The prototxt's fillers (convs N(0, 0.01), fc6/fc7 N(0, 0.005), fc8
    N(0, 0.01); biases 0 or 0.1) at the narrow widths, port layout."""
    g = torch.Generator().manual_seed(seed)
    p = {}
    for name, out, cin, k in CONVS:
        p[name] = {"w": torch.randn(out, cin, k, k, generator=g) * 0.01,
                   "b": torch.full((out,), 0.0 if name in ("conv1", "conv3")
                                   else 0.1)}
    din = 8 * 2 * 2  # conv5's 8 channels on the 2 x 2 grid left of 99
    for name, out in FCS:
        std, bias = (0.01, 0.0) if name == "fc8_20x20" else (0.005, 0.1)
        p[name] = {"w": torch.randn(din, out, generator=g) * std,
                   "b": torch.full((out,), bias)}
        din = out
    return p


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    x = 60.0 * torch.randn(BATCH, 1, SIZE, SIZE, generator=g)
    labels = torch.rand(BATCH, 20, 20, generator=g)
    keep = [torch.rand(BATCH, 16, generator=g) < 0.5 for _ in range(2)]
    return x, labels, keep


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def _two_steps(precision: str, ref_precision: str, monkeypatch) -> dict:
    """Two ``train_step``s of the small network in ``precision`` against
    the reference's in ``ref_precision`` -> the largest relative L2
    difference of the loss, a gradient, a parameter and a momentum."""
    params = small_params()
    model = cnn.VPNet(params, DTYPES[precision])
    state = train.TrainState(
        model, {n: {k: torch.zeros_like(v) for k, v in d.items()}
                for n, d in model.params().items()},
        base_lr=SOLVER["base_lr"])
    seen = []
    sgd = train.sgd_update

    def spy(p, grads, *a, **k):
        seen.append({n: {key: g.clone() for key, g in d.items()}
                     for n, d in grads.items()})
        return sgd(p, grads, *a, **k)

    monkeypatch.setattr(train, "sgd_update", spy)
    theta = {n: {k: v.clone() for k, v in d.items()}
             for n, d in params.items()}
    v = {n: {k: torch.zeros_like(t) for k, t in d.items()}
         for n, d in theta.items()}
    worst = dict.fromkeys(("loss", "grad", "param", "momentum"), 0.0)
    for step in range(2):
        x, labels, keep = _batch(step)
        loss = train.train_step(state, x, labels, keep=keep)
        want, grads = ref.loss_and_grads(theta, x, labels, keep,
                                         ref_precision)
        terms = ref.step_terms(theta, grads, SOLVER, step)
        theta, v = ref.sgd_update(theta, v, terms, SOLVER)
        got = model.params()
        worst["loss"] = max(worst["loss"], _rel(loss, want))
        for n, d in grads.items():
            for k, g in d.items():
                for key, a, b in (("grad", seen[step][n][k], g),
                                  ("param", got[n][k].detach(), theta[n][k]),
                                  ("momentum", state.momentum[n][k],
                                   v[n][k])):
                    worst[key] = max(worst[key], _rel(a, b))
        assert state.step == step + 1
    return worst


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_two_port_steps_match_the_plain_reference(precision, monkeypatch):
    worst = _two_steps(precision, precision, monkeypatch)
    assert max(worst.values()) < TOL[precision], worst


def test_float8_products_part_beyond_the_tolerance(monkeypatch):
    """The reference one precision step below the configuration's
    (float8 operands) is told apart from the port's bfloat16 step."""
    worst = _two_steps("bf16", "fp8", monkeypatch)
    assert worst["grad"] > 10 * TOL["bf16"], worst


def test_the_reference_updates_biases_at_twice_the_rate_without_decay():
    theta = {"fc": {"w": torch.tensor([2.0]), "b": torch.tensor([2.0])}}
    grads = {"fc": {"w": torch.tensor([1.0]), "b": torch.tensor([1.0])}}
    solver = dict(SOLVER, base_lr=0.1, stepsize=10)
    terms = ref.step_terms(theta, grads, solver, 10)  # lr 0.01 after a step
    assert float(terms["fc"]["w"]) == pytest.approx(0.01 * (1 + 5e-4 * 2))
    assert float(terms["fc"]["b"]) == pytest.approx(0.02)
    v0 = {"fc": {"w": torch.tensor([1.0]), "b": torch.tensor([0.0])}}
    p, v = ref.sgd_update(theta, v0, terms, solver)
    assert float(v["fc"]["w"]) == pytest.approx(0.9 - 0.01001)
    assert float(p["fc"]["w"]) == pytest.approx(2.0 + 0.9 - 0.01001)
    assert float(theta["fc"]["w"]) == 2.0  # the inputs are left alone


def _make_batch_as_it_was(rng_np, batch, mean, n_pad, size):
    """``models/train.make_batch`` as the drivers called it before the
    device step: draw, pad, render, floor, less the mean, in one call."""
    ls = np.zeros((batch, n_pad, 3), np.float32)
    masks = np.zeros((batch, n_pad), bool)
    labels = []
    for i in range(batch):
        scene = synth.make_training_scene(rng_np)
        n = min(scene.lines.shape[0], n_pad)
        ls[i, :n] = scene.lines[:n]
        masks[i, :n] = True
        labels.append(synth.vp_grid_label(scene.vps).astype(np.float32))
    img = sph.sphere_render(torch.from_numpy(ls), torch.from_numpy(masks),
                            size=size)
    img = torch.floor(img * 255.0) - mean[None]
    return img[:, None], torch.from_numpy(np.stack(labels))


def test_the_device_step_equals_make_batch_and_train_step():
    """Two steps of ``device_step`` on ``draw_batch``'s host tensors,
    bit for bit against the drivers' former ``make_batch`` and
    ``train_step`` with the step's generator, and ``make_batch`` as it is
    now against the former one."""
    params = small_params(1)
    mean = 50.0 + 10.0 * torch.rand(
        SIZE, SIZE, generator=torch.Generator().manual_seed(2))
    a, b = train.init_state(params), train.init_state(params)
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    seed = 2 ** 31 + 3
    for _ in range(2):
        x, y = _make_batch_as_it_was(rng_a, BATCH, mean, 128, SIZE)
        now = train.make_batch(np.random.default_rng(7), BATCH, mean,
                               n_pad=128, size=SIZE, device="cpu")
        if a.step == 0:
            assert torch.equal(now[0], x) and torch.equal(now[1], y)
        want = train.train_step(a, x, y, train.step_generator(seed, a.step,
                                                              "cpu"))
        lines, lmask, labels = train.draw_batch(rng_b, BATCH, n_pad=128)
        out = train.device_step(b, lines, lmask, labels, mean, seed, SIZE)
        assert torch.equal(out.loss, want)
        assert torch.equal(out.images, x)
        assert [m.shape for m in out.keep] == [(BATCH, 16), (BATCH, 16)]
    assert a.step == b.step == 2
    pa, pb = a.model.params(), b.model.params()
    for n in pa:
        for k in pa[n]:
            assert torch.equal(pa[n][k], pb[n][k])
            assert torch.equal(a.momentum[n][k], b.momentum[n][k])
