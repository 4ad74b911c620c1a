"""The PyTorch port's pipeline vs the JAX pipeline, end to end.

Small config (sphere 240, 256 line slots, 192x192 images, float32 CNN):
random conv/fc weights with fc8 scaled down and its bias set to the
logit of the scene's true-VP grid, so the CNN stage runs in full but its
output is a meaningful prior, and the EM is not left on a random one."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu import pipeline as jpipe
from vanishing_points_2017_tpu.data.datasets import render_scene_image
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.weights import (load_params_and_mean,
                                                     params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jpipe.PipelineConfig(sphere_size=240, n_pad=256, cnn_dtype="float32",
                            det_topk="exact")
TCFG = tpipe.PipelineConfig(sphere_size=240, n_pad=256, cnn_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = synth.make_scene(rng, lines_per_vp=30, outliers=6)
    # a second image of the same VPs: every other segment
    segs = [scene.segments, scene.segments[::2]]
    prior = np.clip(synth.vp_grid_label(scene.vps), 1e-3, 1 - 1e-3)
    params = jcnn.init_params(jax.random.PRNGKey(0), input_size=240)
    npp = {k: {kk: np.asarray(vv) for kk, vv in d.items()}
           for k, d in params.items()}
    npp["fc8_20x20"]["w"] = npp["fc8_20x20"]["w"] * 1e-3
    npp["fc8_20x20"]["b"] = np.log(prior / (1 - prior)).reshape(-1).astype(
        np.float32)
    mean = np.zeros((240, 240), np.float32)
    return scene, segs, npp, mean


def _horizon_err(out_t, i, out_j):
    est = np.cross(out_t["hp1"][i].double().numpy(),
                   out_t["hp2"][i].double().numpy())
    ref = np.cross(np.asarray(out_j["hp1"][i], np.float64),
                   np.asarray(out_j["hp2"][i], np.float64))
    return tio.normalized_horizon_error(est, ref, 640, 640)


def _compare(out_t, out_j, n, u8_frac):
    """Sphere images off by <= 1 on at most ``u8_frac`` of pixels, CNN
    grids within 1e-4, the same alive VPs, counts within 1, horizons
    within 1e-3 normalized error."""
    for i in range(n):
        du8 = np.abs(out_t["sphere_image"][i].numpy().astype(int)
                     - np.asarray(out_j["sphere_image"][i]).astype(int))
        assert du8.max() <= 1 and np.mean(du8 > 0) <= u8_frac
        np.testing.assert_allclose(out_t["cnn_prediction"][i].numpy(),
                                   np.asarray(out_j["cnn_prediction"][i]),
                                   atol=1e-4)
        np.testing.assert_array_equal(out_t["alive"][i].numpy(),
                                      np.asarray(out_j["alive"][i]))
        assert np.abs(out_t["counts"][i].numpy()
                      - np.asarray(out_j["counts"][i])).max() <= 1
        assert _horizon_err(out_t, i, out_j) < 1e-3


def test_device_pipeline_batch_matches_jax(setup):
    _, segs, npp, mean = setup
    padded = [tpipe.pad_lines(s, 256) for s in segs]
    l, lp, m = (np.stack(x) for x in zip(*padded))
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in d.items()}
          for k, d in npp.items()}
    out_j = jpipe.device_pipeline_batch(jnp.asarray(l), jnp.asarray(lp),
                                        jnp.asarray(m), jp,
                                        jnp.asarray(mean), JCFG)
    model = tpipe.build_model(params_from_numpy(npp), TCFG)
    out_t = tpipe.device_pipeline_batch(
        torch.from_numpy(l), torch.from_numpy(lp), torch.from_numpy(m),
        model, torch.from_numpy(mean), TCFG)
    # same lines: only the renderer's f32 sum order differs
    _compare(out_t, out_j, 2, u8_frac=1e-3)
    one = tpipe.device_pipeline(torch.from_numpy(l[1]), torch.from_numpy(lp[1]),
                                torch.from_numpy(m[1]), model,
                                torch.from_numpy(mean), TCFG)
    for k in ("hp1", "hp2", "counts", "alive"):
        np.testing.assert_allclose(one[k].numpy(), out_t[k][1].numpy(),
                                   atol=1e-5)


def test_device_pipeline_full_matches_jax(setup):
    scene, segs, npp, mean = setup
    imgs = []
    for i, s in enumerate(segs):
        sc = dataclasses.replace(scene, segments=s)
        imgs.append(render_scene_image(sc, size=192,
                                       rng=np.random.default_rng(i)))
    imgs = np.stack(imgs)
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in d.items()}
          for k, d in npp.items()}
    out_j = jpipe.device_pipeline_full(jnp.asarray(imgs), jp,
                                       jnp.asarray(mean), JCFG)
    pipe = tpipe.Pipeline(params_from_numpy(npp), mean, TCFG)
    out_t = pipe.process_images(list(imgs))
    assert int(out_t["segment_mask"][0].sum()) > 10
    # detected endpoints agree to ~1e-5 (test_torch_detector.py), which
    # moves floor(255 * img) on a few percent of the curve pixels
    _compare(out_t, out_j, 2, u8_frac=3e-2)


@pytest.mark.slow
def test_full_size_scenes_match_committed_jax_reference():
    """The shipped weights and default config (bf16 CNN) on the four
    bundled 640x640 scenes: each horizon within 0.02 normalized error of
    the committed JAX outputs (the gate chip_smoke.py applies on the GPU)
    and within 0.02 of the ground truth."""
    params, mean = load_params_and_mean()
    pipe = tpipe.Pipeline(params, mean, tpipe.PipelineConfig())
    paths = [os.path.join(ROOT, "assets", "examples", f"scene_{i}.png")
             for i in range(4)]
    out = pipe.process_images([pipe.ingest_image(p)["gray"] for p in paths])
    ref = np.load(os.path.join(ROOT, "assets", "examples",
                               "jax_reference_outputs.npz"))
    for i, p in enumerate(paths):
        assert _horizon_err(out, i, ref) < 0.02
        est = np.cross(out["hp1"][i].double().numpy(),
                       out["hp2"][i].double().numpy())
        gt = np.load(p.replace(".png", ".horizon.npy")).astype(np.float64)
        assert tio.normalized_horizon_error(est, gt, 640, 640) < 0.02


@pytest.mark.slow
def test_committed_jax_reference_is_current():
    """Regenerates the JAX outputs chip_smoke.py compares against and
    checks the committed file still holds them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_ref", os.path.join(ROOT, "scripts",
                                 "make_jax_reference_outputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.reference_outputs()
    committed = np.load(mod.DEFAULT_OUT)
    for k in mod.KEYS:
        np.testing.assert_allclose(fresh[k], committed[k], atol=1e-6,
                                   err_msg=k)


def test_port_imports_no_jax():
    """Importing the port (every module) must not import jax or the JAX
    package: the GPU machine has neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vanishing_points_2017_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import vanishing_points_2017_tpu_torch.kernels as k\n"
        "k.all_kernels()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'vanishing_points_2017_tpu'"
        " or m.startswith('vanishing_points_2017_tpu.') or m == 'PIL']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)
