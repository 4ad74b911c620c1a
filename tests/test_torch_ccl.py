"""Raster CCL of the PyTorch port (twin of kernel K1) and its shared edge
packing vs the JAX raster scan and the Pallas kernel in interpret mode.

Labels are integers: the twin must be bit-exact. The edge bit-plane is
compared separately; a difference there is allowed only where the dot
product lies within one float32 ulp of the threshold (where a fused
multiply-add may round the other way)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu.data.datasets import render_scene_image
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import lines_device as jld
from vanishing_points_2017_tpu.ops.ccl_pallas import (
    _pack_masks, connected_components_pallas_batch)
from vanishing_points_2017_tpu_torch.ops import lines_device as tld
from torch_cpu import torch_threads  # noqa: F401

COS_TOL = math.cos(math.radians(jld.TOL_DEG))


def _fronts(size, seed, count=3):
    """JAX-side (active, ux, uy) of rendered scenes, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        scene = synth.make_scene(rng, lines_per_vp=12, outliers=4)
        img = render_scene_image(scene, size=size, rng=rng).astype(np.float32)
        im = jld._gaussian_blur(jnp.asarray(img), 1.0)
        com1 = im[1:, 1:] - im[:-1, :-1]
        com2 = im[:-1, 1:] - im[1:, :-1]
        gx, gy = 0.5 * (com1 + com2), 0.5 * (com1 - com2)
        mag = jnp.sqrt(gx * gx + gy * gy)
        active = mag > jld.QUANT / math.sin(math.radians(jld.TOL_DEG))
        inv = jnp.where(mag > 0, 1.0 / jnp.maximum(mag, 1e-12), 0.0)
        out.append((np.asarray(active), np.asarray(gx * inv),
                    np.asarray(-gy * inv)))
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("size,passes", [(256, 8), (192, 4)])
def test_ccl_twin_bit_exact(size, passes):
    act, ux, uy = _fronts(size, size + passes)
    packed = np.asarray(_pack_masks(jnp.asarray(act), jnp.asarray(ux),
                                    jnp.asarray(uy), COS_TOL))
    got = tld.connected_components(torch.from_numpy(packed.copy()),
                                   passes).numpy()
    pallas = np.asarray(connected_components_pallas_batch(
        jnp.asarray(act), jnp.asarray(ux), jnp.asarray(uy), COS_TOL,
        passes=passes, interpret=True))
    for s in range(act.shape[0]):
        ref = np.asarray(jld._connected_components(
            jnp.asarray(act[s]), jnp.asarray(ux[s]), jnp.asarray(uy[s]),
            COS_TOL, passes))
        assert np.array_equal(got[s], ref), \
            f"scene {s}: {(got[s] != ref).sum()} labels differ from XLA"
        assert np.array_equal(got[s], pallas[s]), \
            f"scene {s}: {(got[s] != pallas[s]).sum()} differ from Pallas"


def test_pack_edge_masks_matches_jax():
    act, ux, uy = _fronts(160, 7, count=2)
    ref = np.asarray(_pack_masks(jnp.asarray(act), jnp.asarray(ux),
                                 jnp.asarray(uy), COS_TOL))
    got = tld.pack_edge_masks(torch.from_numpy(act), torch.from_numpy(ux),
                              torch.from_numpy(uy), COS_TOL).numpy()
    diff = got != ref
    if diff.any():
        # only threshold-straddling dots may differ
        for (dy, dx), bit in tld.NEIGHBOUR_BITS.items():
            bd = ((got >> bit) & 1) != ((ref >> bit) & 1)
            if not bd.any():
                continue
            sh = lambda a: np.asarray(tld._shift(torch.from_numpy(a), dy, dx,
                                                 0.0))
            dot = ux * sh(ux) + uy * sh(uy)
            ulp = np.spacing(np.float32(COS_TOL))
            assert np.all(np.abs(dot[bd] - np.float32(COS_TOL)) <= ulp)
    assert diff.mean() < 1e-4


def test_ccl_twin_on_torch_packing_matches_jax():
    """End to end on the port's own packing (the kernel's input)."""
    act, ux, uy = _fronts(128, 11, count=2)
    packed = tld.pack_edge_masks(torch.from_numpy(act), torch.from_numpy(ux),
                                 torch.from_numpy(uy), COS_TOL)
    got = tld.connected_components(packed, 8).numpy()
    for s in range(2):
        ref = np.asarray(jld._connected_components(
            jnp.asarray(act[s]), jnp.asarray(ux[s]), jnp.asarray(uy[s]),
            COS_TOL, 8))
        assert np.array_equal(got[s], ref)


@pytest.mark.parametrize("w", [1100, 1279, 1919, 2049, 4031])
def test_ccl_twin_bit_exact_past_1024_columns(w):
    """A few rows wider than 1024 columns, where K1 leaves its 4-warp
    kernel (720p's and 1080p's gradient widths 1279 and 1919, 16 warps at
    2049 and 4031): the twin's labels equal the JAX raster scan's, and at
    1100 also the Pallas kernel's in interpret mode (which pads the width
    to a multiple of 128; ~18 s a width, so once)."""
    rng = np.random.default_rng(w)
    h = 6
    ang = (np.arange(w) // 37 * 0.4)[None, :] + rng.normal(0, 0.2, (2, h, w))
    act = rng.uniform(size=(2, h, w)) < 0.8
    ux, uy = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    packed = np.asarray(_pack_masks(jnp.asarray(act), jnp.asarray(ux),
                                    jnp.asarray(uy), COS_TOL))
    got = tld.connected_components(torch.from_numpy(packed.copy()),
                                   8).numpy()
    pallas = None
    if w == 1100:
        pallas = np.asarray(connected_components_pallas_batch(
            jnp.asarray(act), jnp.asarray(ux), jnp.asarray(uy), COS_TOL,
            passes=8, interpret=True))
    for s in range(2):
        ref = np.asarray(jld._connected_components(
            jnp.asarray(act[s]), jnp.asarray(ux[s]), jnp.asarray(uy[s]),
            COS_TOL, 8))
        assert np.array_equal(got[s], ref)
        if pallas is not None:
            assert np.array_equal(got[s], pallas[s])
    assert len(np.unique(got)) < 0.9 * got.size  # components span pixels


def test_connected_components_rejects_unsupported_device():
    packed = torch.zeros((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tld.connected_components(packed)
