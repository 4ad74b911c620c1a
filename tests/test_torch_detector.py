"""On-device line detector of the PyTorch port vs the JAX detector on its
production path (selection="global", topk_impl="exact").

The blur and the `mag > rho` threshold depend on f32 summation order, so
parity is held at the segment level: the same number of valid segments
(within 1) and every matched segment within 1e-3 normalized units."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vanishing_points_2017_tpu.data.datasets import render_scene_image
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import lines_device as jld
from vanishing_points_2017_tpu_torch.ops import lines_device as tld
from vanishing_points_2017_tpu_torch.ops.select import topk_stable


def _images(size, seeds):
    out = []
    for s in seeds:
        rng = np.random.default_rng(s)
        scene = synth.make_scene(rng, lines_per_vp=30, outliers=8)
        out.append(render_scene_image(scene, size=size, rng=rng))
    return np.stack(out)


def _match(ref_seg, got_seg):
    """Max over reference segments of the distance to the closest port
    segment (endpoint order free)."""
    worst = 0.0
    for s in ref_seg:
        d1 = np.abs(got_seg - s).max(axis=1)
        d2 = np.abs(got_seg - s[[2, 3, 0, 1]]).max(axis=1)
        worst = max(worst, float(np.minimum(d1, d2).min()))
    return worst


def test_detector_matches_jax():
    imgs = _images(160, (0, 1))
    seg, mask = tld.detect_segments_device(torch.from_numpy(imgs),
                                           max_segments=256,
                                           selection="global")
    for i in range(imgs.shape[0]):
        js, jm = jld.detect_segments_device(
            jnp.asarray(imgs[i]), max_segments=256, selection="global",
            topk_impl="exact")
        js, jm = np.asarray(js), np.asarray(jm)
        ts, tm = seg[i].numpy(), mask[i].numpy()
        assert jm.sum() > 20
        assert abs(int(jm.sum()) - int(tm.sum())) <= 1
        assert _match(js[jm], ts[tm]) < 1e-3
        assert _match(ts[tm], js[jm]) < 1e-3
        assert np.all(ts[~tm] == 0)
        # valid slots lead (stable re-rank)
        assert not np.any(tm[1:] & ~tm[:-1])


def test_gradient_front_matches_jax():
    img = _images(96, (5,))[0].astype(np.float32)
    mag, active, ux, uy = tld.gradient_front(torch.from_numpy(img)[None])
    im = jld._gaussian_blur(jnp.asarray(img), 1.0)
    com1 = im[1:, 1:] - im[:-1, :-1]
    com2 = im[:-1, 1:] - im[1:, :-1]
    gx, gy = 0.5 * (com1 + com2), 0.5 * (com1 - com2)
    jmag = np.asarray(jnp.sqrt(gx * gx + gy * gy))
    np.testing.assert_allclose(mag[0].numpy(), jmag, rtol=1e-5, atol=1e-4)
    # the threshold may flip only where mag straddles rho within f32 noise
    flips = active[0].numpy() != (jmag > jld.QUANT / np.sin(
        np.radians(jld.TOL_DEG)))
    assert flips.mean() < 1e-3


def test_topk_stable_keeps_lax_tie_order():
    """Run masses are -1 on every non-run-end pixel, so ties are the common
    case; the port's selection must return them in index order like
    lax.top_k."""
    rng = np.random.default_rng(0)
    x = np.where(rng.uniform(size=(6, 300)) < 0.8, -1.0,
                 rng.integers(0, 4, size=(6, 300))).astype(np.float32)
    vals, idx = topk_stable(torch.from_numpy(x), 120)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 120)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
