"""Sphere renderer of the PyTorch port (twin of kernel K2) vs the JAX
renderer and the Pallas kernel in interpret mode."""

import numpy as np
import jax.numpy as jnp
import torch

from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import sphere as jsphere
from vanishing_points_2017_tpu.ops.sphere_pallas import sphere_render_pallas
from vanishing_points_2017_tpu_torch.ops import sphere as tsphere
from torch_cpu import torch_threads  # noqa: F401


def _scene_lines(seed, n_pad=48):
    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=12, outliers=4)
    l = np.zeros((n_pad, 3), np.float32)
    n = min(scene.lines.shape[0], n_pad)
    l[:n] = scene.lines[:n]
    return l, np.arange(n_pad) < n


def _torch_render(ls, masks, size):
    return tsphere.sphere_render(torch.from_numpy(np.stack(ls)),
                                 torch.from_numpy(np.stack(masks)),
                                 size=size).numpy()


def test_twin_matches_jax_renderer():
    """Float image within 1e-5 (sin/atan/rsqrt ulps and the chunk-sum
    order); uint8 images differ by at most 1, on at most 0.1% of pixels
    (a floor boundary may move)."""
    size = 120
    ls, masks = zip(*[_scene_lines(s) for s in (0, 1)])
    got = _torch_render(ls, masks, size)
    for i in range(2):
        ref = np.asarray(jsphere.sphere_render(
            jnp.asarray(ls[i]), jnp.asarray(masks[i]), size=size))
        np.testing.assert_allclose(got[i], ref, atol=1e-5)
        u_ref = np.asarray(jsphere.sphere_image_uint8(
            jnp.asarray(ls[i]), jnp.asarray(masks[i]), size=size))
        u_got = tsphere.sphere_image_uint8(
            torch.from_numpy(ls[i])[None], torch.from_numpy(masks[i])[None],
            size=size).numpy()[0]
        diff = np.abs(u_got.astype(int) - u_ref.astype(int))
        assert diff.max() <= 1
        assert np.mean(diff > 0) <= 1e-3


def test_twin_matches_pallas_interpret():
    """The Pallas kernel's polynomial atan shifts curve rows by <= ~0.002 px:
    the same 3e-3 bound as tests/test_sphere_pallas.py."""
    l, mask = _scene_lines(0)
    size = 120
    ref = np.asarray(sphere_render_pallas(jnp.asarray(l), jnp.asarray(mask),
                                          size=size, tile_r=40,
                                          interpret=True))
    got = _torch_render([l], [mask], size)[0]
    np.testing.assert_allclose(got, ref, atol=3e-3)
    assert np.mean(np.abs(got - ref)) < 1e-4


def test_twin_empty_mask_black():
    img = _torch_render([np.zeros((16, 3), np.float32)],
                        [np.zeros(16, bool)], 80)
    assert np.all(img == 0)


def test_twin_nan_padding_and_vertical_lines():
    """NaN lines in the masked padding must not leak; l1 = 0 (a vertical
    image line: atan(+-inf) = +-pi/2) renders like the JAX function."""
    l, mask = _scene_lines(3, n_pad=40)
    n = int(mask.sum())
    l[n:] = np.nan
    l[0] = [1.0, 0.0, -0.25]
    size = 100
    got = _torch_render([l], [mask], size)[0]
    assert np.isfinite(got).all()
    ref = np.asarray(jsphere.sphere_render(jnp.asarray(l), jnp.asarray(mask),
                                           size=size))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_curve_beta_matches_jax():
    rng = np.random.default_rng(5)
    l = rng.normal(size=(7, 3)).astype(np.float32)
    alpha = np.linspace(-1.5, 1.5, 33).astype(np.float32)
    ref = np.asarray(jsphere.curve_beta(jnp.asarray(l), jnp.asarray(alpha)))
    got = tsphere.curve_beta(torch.from_numpy(l),
                             torch.from_numpy(alpha)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_coords_and_line_geometry_match_jax():
    from vanishing_points_2017_tpu.ops import coords as jc
    from vanishing_points_2017_tpu.ops import lines as jl
    from vanishing_points_2017_tpu_torch.ops import coords as tc
    from vanishing_points_2017_tpu_torch.ops import lines as tl

    rng = np.random.default_rng(6)
    idx = rng.uniform(0, 500, size=(9, 2)).astype(np.float32)
    ang = np.asarray(jc.index_to_angle(jnp.asarray(idx), (500, 500)))
    t_ang = tc.index_to_angle(torch.from_numpy(idx), (500, 500))
    np.testing.assert_allclose(t_ang.numpy(), ang, atol=1e-6)
    np.testing.assert_allclose(
        tc.angle_to_index(t_ang, (500, 500)).numpy(),
        np.asarray(jc.angle_to_index(jnp.asarray(ang), (500, 500))),
        atol=1e-3)
    pts = tc.angle_to_point(t_ang)
    np.testing.assert_allclose(
        pts.numpy(), np.asarray(jc.angle_to_point(jnp.asarray(ang))),
        atol=1e-6)
    np.testing.assert_allclose(
        tc.point_to_angle(pts).numpy(),
        np.asarray(jc.point_to_angle(jnp.asarray(pts.numpy()))), atol=1e-5)

    lp = rng.uniform(-1, 1, size=(12, 4)).astype(np.float32)
    lp[3] = [0.2, 0.2, 0.2, 0.2]  # degenerate zero-length segment
    tlp = torch.from_numpy(lp)
    for jf, tf in ((jl.line_length, tl.line_length),
                   (jl.lines_angles, tl.lines_angles),
                   (jl.segments_to_homogeneous, tl.segments_to_homogeneous),
                   (jl.pairwise_closest_distance,
                    tl.pairwise_closest_distance),
                   (jl.pairwise_proximity, tl.pairwise_proximity),
                   (lambda x: jl.pairwise_cosangle(x, 2.0),
                    lambda x: tl.pairwise_cosangle(x, 2.0))):
        np.testing.assert_allclose(tf(tlp).numpy(),
                                   np.asarray(jf(jnp.asarray(lp))),
                                   atol=2e-6)
    x = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(
        tl.normalize_rows(torch.from_numpy(x)).numpy(),
        np.asarray(jl.normalize_rows(jnp.asarray(x))))
