"""Regenerate assets/examples/jax_reference_train.npz.

Runs the JAX package's training path on the CPU and saves what
``chip_smoke.py`` holds the PyTorch port's trainer against on the GPU,
where JAX is not installed:

* ``images`` (2, 500, 500) uint8 and ``labels`` (2, 20, 20) float32: the
  JAX ``make_batch(np.random.default_rng(0), 2)`` (its images before the
  mean is subtracted; with ``assets/mean.npy`` subtracted they are the
  training input);
* ``keep`` (2 steps, 2 layers, 2, 512) uint8: the dropout keep masks of
  fc6 and fc7 that JAX's ``train_step`` draws from
  ``fold_in(PRNGKey(1), step)``, bits packed along the 4096 units;
* ``losses`` (2,): the losses of two ``train_step``s on that batch from
  the shipped compact weights; ``losses_f32`` (2,): the same two steps
  with float32 products in place of ``train_step``'s bfloat16;
* per parameter ``norm/<layer>/<key>`` and ``head/<layer>/<key>``: the
  norm of the update after the two steps (new minus shipped, in the JAX
  layout) and its first 4096 values.

Its helpers ``keep_masks`` and ``jax_update`` also serve the port's CPU
tests (``tests/test_torch_train*.py``), which load this file.

    python scripts/make_jax_reference_train.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_train.npz")
STEPS, BATCH, HEAD = 2, 2, 4096


def keep_masks(key, batch: int, widths) -> list:
    """The keep masks JAX's ``cnn.forward(train=True)`` draws from ``key``
    (the splits of ``cnn.py:181-182``), as numpy bool arrays."""
    import jax
    import numpy as np

    out = []
    for w in widths:
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.bernoulli(sub, 0.5, (batch, w))))
    return out


def jax_update(params, grads, momentum, step: int):
    """JAX's Caffe update (``models/train.py:83-91``) with the grads given:
    (new params, new momentum)."""
    import jax
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.models import train

    lr = train.learning_rate(jnp.asarray(step, jnp.int32))

    def update(path, p, g, v):
        local_lr, local_wd = ((2.0 * lr, 0.0) if train._is_bias(path)
                              else (lr, train.WEIGHT_DECAY))
        v = train.MOMENTUM * v - local_lr * (g + local_wd * p)
        return p + v, v

    flat = jax.tree_util.tree_map_with_path(update, params, grads, momentum)
    leaf = lambda t: isinstance(t, tuple)
    return (jax.tree.map(lambda t: t[0], flat, is_leaf=leaf),
            jax.tree.map(lambda t: t[1], flat, is_leaf=leaf))


def f32_losses(params, x, labels, keys) -> list:
    """The losses of JAX's ``train_step`` taken from ``params`` with the
    given keys, with float32 products (``train_step`` fixes bfloat16, so
    its loss and Caffe update are written out here)."""
    import jax
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.models import cnn, train

    momentum = jax.tree.map(jnp.zeros_like, params)
    losses = []
    for step, key in enumerate(keys):
        def loss_fn(p):
            return train.sigmoid_xent(cnn.forward(
                p, x, train=True, rng=key, compute_dtype=jnp.float32,
                logits=True), labels)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, momentum = jax_update(params, grads, momentum, step)
        losses.append(float(loss))
    return losses


def reference() -> dict:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from vanishing_points_2017_tpu import weights
    from vanishing_points_2017_tpu.models import train

    params = weights.params_from_npz(weights.default_weights_path(False))
    mean = np.load(weights.default_mean_path())
    imgs, labels = train.make_batch(np.random.default_rng(0), BATCH)
    imgs = np.asarray(imgs)[..., 0]
    x = jnp.asarray((imgs - mean[None])[..., None])
    state = train.TrainState(params=params,
                             momentum=jax.tree.map(jnp.zeros_like, params),
                             step=jnp.zeros((), jnp.int32))
    width = params["fc7"]["b"].shape[0]
    keys = [jax.random.fold_in(jax.random.PRNGKey(1), step)
            for step in range(STEPS)]
    losses_f32 = f32_losses(params, x, labels, keys)
    losses, keep = [], []
    for key in keys:
        keep.append(np.packbits(np.stack(keep_masks(key, BATCH,
                                                    (width, width))), -1))
        state, loss = train.train_step(state, x, labels, key)
        losses.append(float(loss))
    ref = {"images": imgs.astype(np.uint8), "labels": np.asarray(labels),
           "keep": np.stack(keep), "losses": np.asarray(losses, np.float32),
           "losses_f32": np.asarray(losses_f32, np.float32)}
    shipped = weights.params_from_npz(weights.default_weights_path(False),
                                      as_numpy=True)
    for layer, d in shipped.items():
        for k, v in d.items():
            upd = (np.asarray(state.params[layer][k]) - v).ravel()
            ref[f"norm/{layer}/{k}"] = np.asarray(np.linalg.norm(upd),
                                                  np.float32)
            ref[f"head/{layer}/{k}"] = upd[:HEAD].astype(np.float32)
    return ref


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import numpy as np

    ref = reference()
    np.savez_compressed(args.out, **ref)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e3:.0f} kB): "
          f"losses {ref['losses'].tolist()}")


if __name__ == "__main__":
    main()
