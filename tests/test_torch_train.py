"""Training path of the PyTorch port vs the JAX package: synthetic training
scenes and labels, the solver's pure functions, Caffe's SGD update,
the factorization, checkpoints in both directions and ``make_batch``."""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu import weights as jweights
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.models import factorize as jfactorize
from vanishing_points_2017_tpu.models import synth as jsynth
from vanishing_points_2017_tpu.models import train as jtrain
from vanishing_points_2017_tpu_torch import weights as tweights
from vanishing_points_2017_tpu_torch.models import cnn as tcnn
from vanishing_points_2017_tpu_torch.models import factorize as tfactorize
from vanishing_points_2017_tpu_torch.models import synth as tsynth
from vanishing_points_2017_tpu_torch.models import train as ttrain
from torch_cpu import torch_threads  # noqa: F401

# JAX's Caffe update with the grads given: the reference script's helper
_spec = importlib.util.spec_from_file_location(
    "make_jax_reference_train",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "make_jax_reference_train.py"))
jref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jref)


@pytest.mark.parametrize("seed", range(20))
def test_training_scene_and_label_equal_jax(seed):
    """Same seed, same draws: segments, lines, VPs, associations and the
    20x20 label are exactly JAX's, and both generators end in one state."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    a, b = jsynth.make_training_scene(rj), tsynth.make_training_scene(rt)
    for f in ("segments", "lines", "vps", "vp_assoc", "horizon"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    np.testing.assert_array_equal(tsynth.vp_grid_label(b.vps),
                                  jsynth.vp_grid_label(a.vps))
    assert rj.random() == rt.random()


@pytest.mark.parametrize("step", [0, 199_999, 200_000, 400_000])
def test_learning_rate_matches_jax(step):
    """Caffe's step policy: rtol 1e-6 (JAX computes it in float32)."""
    np.testing.assert_allclose(
        ttrain.learning_rate(step),
        float(jtrain.learning_rate(jnp.asarray(step))), rtol=1e-6)


def test_sigmoid_xent_matches_jax():
    """Random logits (saturated ones included) and labels: rtol 1e-6."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 20, 20)) * 8).astype(np.float32)
    labels = rng.uniform(size=(3, 20, 20)).astype(np.float32)
    ref = float(jtrain.sigmoid_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(ttrain.sigmoid_xent(torch.from_numpy(logits),
                                    torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 199_999, 200_000])
def test_sgd_update_matches_jax(step):
    """Caffe's update alone, from nonzero momentum, on both sides of the
    learning-rate step: a conv ``w``, a factorized ``u``/``v`` and the
    biases. New params and momentum at rtol 1e-6 (float32; the learning
    rate is rounded in float32 by JAX, in float64 here)."""
    rng = np.random.default_rng(step)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32)
    params = {"conv2": {"w": f32(5, 5, 4, 8, scale=0.01),
                        "b": f32(8, scale=0.1)},
              "fc6": {"u": f32(32, 4, scale=0.01), "v": f32(4, 16),
                      "b": f32(16, scale=0.1)}}
    grads = jax.tree.map(lambda p: f32(*p.shape), params)
    momentum = jax.tree.map(lambda p: f32(*p.shape, scale=1e-3), params)
    ref_p, ref_v = jref.jax_update(params, grads, momentum, step)

    tp, tg, tv = (tweights.params_from_numpy(t)
                  for t in (params, grads, momentum))
    ttrain.sgd_update(tp, tg, tv, step)
    got_p, got_v = tweights.params_to_numpy(tp), tweights.params_to_numpy(tv)
    for layer, d in params.items():
        for k in d:
            np.testing.assert_allclose(got_p[layer][k], ref_p[layer][k],
                                       rtol=1e-6, err_msg=f"{layer}/{k}")
            np.testing.assert_allclose(got_v[layer][k], ref_v[layer][k],
                                       rtol=1e-6, err_msg=f"{layer}/{k}")


def test_factorize_matches_jax():
    """Same seed, same u and v, and densify: rtol 1e-6 (the same numpy
    calls in both packages)."""
    rng = np.random.default_rng(1)
    params = {"fc6": {"w": rng.normal(size=(120, 64)).astype(np.float32),
                      "b": np.zeros(64, np.float32)},
              "fc7": {"w": rng.normal(size=(64, 48)).astype(np.float32),
                      "b": np.ones(48, np.float32)},
              "conv1": {"w": np.ones((3, 3, 1, 2), np.float32),
                        "b": np.zeros(2, np.float32)}}
    ranks = {"fc6": 16, "fc7": 8}
    ref = jfactorize.factorize_params(params, ranks, seed=3)
    got = tfactorize.factorize_params(params, ranks, seed=3)
    assert got.keys() == ref.keys()
    for layer, d in ref.items():
        assert got[layer].keys() == d.keys()
        for k, v in d.items():
            np.testing.assert_allclose(got[layer][k], v, rtol=1e-6)
    for layer, d in jfactorize.densify(ref).items():
        for k, v in d.items():
            np.testing.assert_allclose(tfactorize.densify(got)[layer][k], v,
                                       rtol=1e-6)


def _small_params(seed=0):
    npp = tcnn.init_params(seed, input_size=100, fc_width=32)
    u, v = tfactorize.factorize_layer(npp["fc6"]["w"], 8, seed=seed)
    npp["fc6"] = {"u": u, "v": v, "b": npp["fc6"]["b"]}
    return npp


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's params_to_npz -> JAX params_from_npz: the JAX layout
    (HWIO convs, u/v kept) with every value and the step equal."""
    npp = _small_params()
    path = str(tmp_path / "port.npz")
    tweights.params_to_npz(tweights.params_from_numpy(npp), path, step=11)
    got, step = jweights.params_from_npz(path, with_step=True)
    assert step == 11
    assert got.keys() == npp.keys()
    for layer, d in npp.items():
        assert got[layer].keys() == d.keys()
        for k, v in d.items():
            np.testing.assert_array_equal(np.asarray(got[layer][k]), v)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """JAX params_to_npz(step=7, dtype=float16) -> the port's
    params_from_npz(with_step=True): equal to what the JAX package reads
    back, and step 7; written again by the port (float16), the same
    file contents."""
    params = jcnn.init_params(jax.random.PRNGKey(6), input_size=100,
                              fc_width=32)
    path = str(tmp_path / "jax16.npz")
    jweights.params_to_npz(params, path, step=7, dtype=np.float16)
    ref = jweights.params_from_npz(path, as_numpy=True)
    got, step = tweights.params_from_npz(path, with_step=True, device="cpu")
    assert step == 7
    back = tweights.params_to_numpy(got)
    for layer, d in ref.items():
        for k, v in d.items():
            np.testing.assert_array_equal(back[layer][k], v)
    again = str(tmp_path / "port16.npz")
    tweights.params_to_npz(got, again, step=7, dtype=np.float16)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_make_batch_cpu_matches_jax():
    """Same seed: labels exactly JAX's; the images (the render twin here,
    XLA there) within K2's uint8 gate: off by at most 1 on at most 0.1% of
    the pixels. The mean is subtracted after the floor."""
    mean = np.load(tweights.default_mean_path())
    ref_x, ref_y = jtrain.make_batch(np.random.default_rng(0), 2,
                                     jnp.asarray(mean))
    x, y = ttrain.make_batch(np.random.default_rng(0), 2,
                             torch.from_numpy(mean), device="cpu")
    assert x.shape == (2, 1, 500, 500) and x.dtype == torch.float32
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_y))
    d = np.abs(x.numpy()[:, 0] + mean - (np.asarray(ref_x)[..., 0] + mean))
    assert np.abs(np.round(d) - d).max() < 1e-3  # whole grey levels
    assert d.max() <= 1 and (d > 0.5).mean() <= 1e-3


def test_make_batch_defaults_to_the_gpu():
    """Without a device argument the batch lands on the GPU, or raises
    where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        x, y = ttrain.make_batch(np.random.default_rng(0), 1)
        assert x.is_cuda and y.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            ttrain.make_batch(np.random.default_rng(0), 1)
