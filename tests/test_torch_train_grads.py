"""Loss, gradients and whole training steps of the PyTorch port vs the JAX
package: the same numpy inputs and, where dropout is on, JAX's own keep
masks replayed into the port."""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu import weights as jweights
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.models import train as jtrain
from vanishing_points_2017_tpu_torch import weights as tweights
from vanishing_points_2017_tpu_torch.models import cnn as tcnn
from vanishing_points_2017_tpu_torch.models import train as ttrain
from chip_smoke import cosine


# JAX's keep masks of a key: the reference script's helper
_spec = importlib.util.spec_from_file_location(
    "make_jax_reference_train",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "make_jax_reference_train.py"))
jref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jref)


@pytest.fixture(scope="module")
def small():
    """The small network of ``tests/test_cnn.py:59`` (input 250, fc width
    64) and one synthetic batch of 2 from JAX's make_batch."""
    params = jcnn.init_params(jax.random.PRNGKey(0), input_size=250,
                              fc_width=64)
    x, y = jtrain.make_batch(np.random.default_rng(3), batch=2, n_pad=128,
                             size=250)
    return params, np.array(x), np.array(y)


def _jax_loss_grads(params, x, y, dtype, key=None):
    def loss_fn(p):
        logits = jcnn.forward(p, jnp.asarray(x), train=key is not None,
                              rng=key, compute_dtype=dtype, logits=True)
        return jtrain.sigmoid_xent(logits, jnp.asarray(y))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_grads(params, x, y, dtype, keep=None):
    net = tcnn.VPNet(tweights.params_from_numpy(params), dtype)
    p = net.params()
    names = [(n, k) for n, d in p.items() for k in d]
    with net.numerics():
        logits = net.logits(
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            None if keep is None else [torch.from_numpy(k) for k in keep])
        loss = ttrain.sigmoid_xent(logits, torch.from_numpy(y))
        flat = torch.autograd.grad(loss, [p[n][k] for n, k in names])
    grads: dict = {}
    for (n, k), g in zip(names, flat):
        grads.setdefault(n, {})[k] = g
    return float(loss.detach()), tweights.params_to_numpy(grads)


def test_grads_f32_match_jax(small):
    """float32, no dropout: loss at rtol 1e-5 and every parameter's grad
    within 1e-4 of the layer's max |g| (measured: <= 1.4e-6, conv and
    matmul sum order)."""
    params, x, y = small
    ref_loss, ref = _jax_loss_grads(params, x, y, jnp.float32)
    loss, got = _port_loss_grads(params, x, y, torch.float32)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for layer, d in ref.items():
        for k, g in d.items():
            err = np.abs(got[layer][k] - g).max() / np.abs(g).max()
            assert err <= 1e-4, (layer, k, err)


def test_grads_bf16_with_jax_dropout_match_jax(small):
    """bfloat16 products and JAX's dropout masks replayed: loss at rtol
    1e-4 and each parameter's grad at cosine >= 0.97 to JAX's.

    Measured over seeds 0-2: losses equal to 1e-6; the lowest cosine
    0.982 (conv1's w, the farthest from the loss). JAX's own bf16 grads
    lie as far from its float32 grads (lowest cosine 0.988-0.991): the two
    frameworks round the backward pass's bf16 products at other places."""
    params, x, y = small
    key = jax.random.PRNGKey(5)
    ref_loss, ref = _jax_loss_grads(params, x, y, jnp.bfloat16, key)
    loss, got = _port_loss_grads(params, x, y, torch.bfloat16,
                                 jref.keep_masks(key, 2, (64, 64)))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    for layer, d in ref.items():
        for k, g in d.items():
            c = cosine(got[layer][k], g)
            assert c >= 0.97, (layer, k, c)


def test_full_width_compact_train_step_matches_jax():
    """Two full train_steps of the compress_weights configuration: the
    shipped compact weights at full width (500 input, rank-256 fc6/fc7),
    batch 2 from make_batch(seed 0) with the shipped mean, bf16, and JAX's
    keep masks of fold_in(PRNGKey(1), step) replayed. Losses at rtol 2e-2
    and the 2-step update of every parameter at cosine >= 0.99 to JAX's,
    its norm within 5%.

    Measured on the CPU: losses 64.41 / 40.09 against JAX's 64.48 / 39.91
    (4.6e-3 apart at step 2), lowest update cosine 0.9961 (fc6's b), norms
    within 1.6%."""
    jp = jweights.params_from_npz(tweights.default_weights_path())
    shipped = jax.tree.map(np.asarray, jp)
    mean = np.load(tweights.default_mean_path())
    x, y = jtrain.make_batch(np.random.default_rng(0), 2, jnp.asarray(mean))
    x, y = np.array(x), np.array(y)
    jstate = jtrain.TrainState(params=jp,
                               momentum=jax.tree.map(jnp.zeros_like, jp),
                               step=jnp.zeros((), jnp.int32))
    tstate = ttrain.init_state(tweights.params_from_numpy(shipped))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    for step in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(1), step)
        jstate, ref_loss = jtrain.train_step(jstate, jnp.asarray(x),
                                             jnp.asarray(y), key)
        keep = [torch.from_numpy(k) for k in jref.keep_masks(key, 2, (4096, 4096))]
        loss = ttrain.train_step(tstate, xt, torch.from_numpy(y), keep=keep)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-2)
    assert tstate.step == 2
    got = tweights.params_to_numpy(tstate.model.params())
    for layer, d in shipped.items():
        for k, v in d.items():
            ref_upd = np.asarray(jstate.params[layer][k]) - v
            upd = got[layer][k] - v
            assert cosine(upd, ref_upd) >= 0.99, (layer, k)
            ratio = np.linalg.norm(upd) / np.linalg.norm(ref_upd)
            assert abs(ratio - 1) <= 0.05, (layer, k, ratio)


def test_short_training_run_lowers_the_loss():
    """Four steps on a fixed 2-image batch at input 250 memorize it, as
    ``tests/test_cnn.py:58-69`` shows for the JAX package; the dropout
    masks come from a seeded CPU generator."""
    params = tweights.params_from_numpy(
        tcnn.init_params(2, input_size=250, fc_width=512))
    state = ttrain.init_state(params)
    x, y = ttrain.make_batch(np.random.default_rng(3), 2, n_pad=128,
                             size=250, device="cpu")
    losses = [float(ttrain.train_step(
        state, x, y, ttrain.step_generator(4, i, "cpu"))) for i in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    # the state trains a copy: the caller's parameters are unchanged
    assert torch.equal(params["conv1"]["w"],
                       tweights.params_from_numpy(tcnn.init_params(
                           2, input_size=250, fc_width=512))["conv1"]["w"])
