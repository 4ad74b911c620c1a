"""The PyTorch port's host path (host LSD -> line buckets -> render -> CNN
-> EM -> horizon) vs the JAX package's, plus the bucket choice, the cache
keys and the truncation warning.

Small config (sphere 240, buckets (64, 128), 320x320 images, float32 CNN)
with the prior trick of test_torch_pipeline.py: random conv/fc weights,
fc8 scaled down and its bias set to the logit of the scene's true-VP grid.
"""

import dataclasses
import logging
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu import pipeline as jpipe
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.models.synth import vp_grid_label
from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch.data import datasets as tds
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.models import synth
from vanishing_points_2017_tpu_torch.weights import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (64, 128)
JCFG = jpipe.PipelineConfig(sphere_size=240, buckets=BUCKETS,
                            cnn_dtype="float32", det_topk="exact")
TCFG = tpipe.PipelineConfig(sphere_size=240, buckets=BUCKETS,
                            cnn_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = synth.make_scene(rng, lines_per_vp=25, outliers=6)
    imgs = [tds.render_scene_image(dataclasses.replace(scene, segments=s),
                                   size=320, rng=np.random.default_rng(i))
            for i, s in enumerate([scene.segments, scene.segments[::2]])]
    prior = np.clip(vp_grid_label(scene.vps), 1e-3, 1 - 1e-3)
    params = jcnn.init_params(jax.random.PRNGKey(0), input_size=240)
    npp = {k: {kk: np.asarray(vv) for kk, vv in d.items()}
           for k, d in params.items()}
    npp["fc8_20x20"]["w"] = npp["fc8_20x20"]["w"] * 1e-3
    npp["fc8_20x20"]["b"] = np.log(prior / (1 - prior)).reshape(-1).astype(
        np.float32)
    mean = np.zeros((240, 240), np.float32)
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in d.items()}
          for k, d in npp.items()}
    return (imgs, jpipe.Pipeline(jp, mean, JCFG),
            tpipe.Pipeline(params_from_numpy(npp), mean, TCFG,
                           device="cpu"))


def _gates(hp_t, hp_j, i, out_t, out_j, u8_frac=1e-3):
    """test_torch_pipeline.py's gates: sphere images off by <= 1 on at most
    ``u8_frac`` of pixels, CNN grids within 1e-4, the same alive VPs,
    counts within 1, horizons within 1e-3 normalized error."""
    du8 = np.abs(np.asarray(out_t["sphere_image"][i]).astype(int)
                 - np.asarray(out_j["sphere_image"][i]).astype(int))
    assert du8.max() <= 1 and np.mean(du8 > 0) <= u8_frac
    np.testing.assert_allclose(np.asarray(out_t["cnn_prediction"][i]),
                               np.asarray(out_j["cnn_prediction"][i]),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_t["alive"][i]),
                                  np.asarray(out_j["alive"][i]))
    assert np.abs(np.asarray(out_t["counts"][i])
                  - np.asarray(out_j["counts"][i])).max() <= 1
    assert tio.normalized_horizon_error(hp_t, hp_j, 320, 320) < 1e-3


def _line(out, i):
    return np.cross(np.asarray(out["hp1"][i], np.float64),
                    np.asarray(out["hp2"][i], np.float64))


def test_ingest_matches_jax(setup):
    """Same LSD, same normalization, same bucket and padding."""
    imgs, pj, pt = setup
    for img, bucket in zip(imgs, (128, 64)):
        bj, bt = pj.ingest(img), pt.ingest(img)
        assert bt["l"].shape[0] == bj["l"].shape[0] == bucket
        for k in ("segments", "nfa", "l", "lp", "lmask", "image_shape"):
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_process_batch_mixed_buckets_matches_jax(setup):
    """A batch of a 128-bucket and a 64-bucket image is re-padded to 128
    on both sides and held to the pipeline gates; ``process`` of the
    small image alone (64 slots) lands on the same result."""
    imgs, pj, pt = setup
    out_j = pj.process_batch([pj.ingest(im) for im in imgs])
    out_t = pt.process_batch([pt.ingest(im) for im in imgs])
    assert out_t["vp_assoc"].shape == (2, 128)
    for i in range(2):
        _gates(_line(out_t, i), _line(out_j, i), i, out_t, out_j)
    one = pt.process(imgs[1])
    assert one["vp_assoc"].shape == (64,) and one["image_shape"] == (320, 320)
    np.testing.assert_array_equal(one["alive"], out_t["alive"][1].numpy())
    assert tio.normalized_horizon_error(tpipe.Pipeline.horizon_line(one),
                                        _line(out_j, 1), 320, 320) < 1e-3


def test_select_bucket():
    assert tpipe.BUCKETS == jpipe.BUCKETS
    for n in (0, 10, 512, 513, 1024, 1025, 2048, 2049, 10 ** 5):
        assert tpipe.select_bucket(n) == jpipe.select_bucket(n)
    assert tpipe.select_bucket(70, (64, 128)) == 128
    assert tpipe.select_bucket(500, (64, 128)) == 128


def test_pad_lines_truncation_warns(caplog):
    seg = np.zeros((600, 4), np.float32)
    seg[:, 2] = np.linspace(0.1, 0.9, 600)
    with caplog.at_level(logging.WARNING):
        l, lp, m = tpipe.pad_lines(seg, 512)
    assert m.sum() == 512
    assert any("truncating" in r.getMessage() for r in caplog.records)
    jl, jlp, jm = jpipe.pad_lines(seg, 512)
    for a, b in ((l, jl), (lp, jlp), (m, jm)):
        np.testing.assert_array_equal(a, b)


# (field, value, or for ``em`` the EMConfig field changed)
CACHE_FIELDS = [("horizon_pos_gate_tol", 4.0),
                ("horizon_pos_gate_tol", float("inf")), ("sphere_size", 240),
                ("horizon_consensus", 8), ("em", ("do_split", False)),
                ("em", ("do_merge", False)), ("em", ("use_weights", False)),
                ("em", ("distance_measure", "dotprod"))]
DET_FIELDS = [("det_min_count", 20), ("det_min_len_px", 15.0),
              ("det_min_density", 0.0), ("det_max_records", 16384)]


def _with(cfg, field, val):
    if field == "em":  # each package's own EMConfig, one field changed
        val = dataclasses.replace(cfg.em, **{val[0]: val[1]})
    return dataclasses.replace(cfg, **{field: val})


def test_cache_key_tracks_the_jax_fields():
    """cache_key spells JAX's key plus a torch tag; it changes with every
    field that changes JAX's and not with the detector's."""
    base_t, base_j = tpipe.PipelineConfig(), jpipe.PipelineConfig()
    assert base_t.cache_key() == base_j.cache_key() + "_torch"
    seen = {base_t.cache_key()}
    for field, val in CACHE_FIELDS:
        t, j = _with(base_t, field, val), _with(base_j, field, val)
        assert t.cache_key() == j.cache_key() + "_torch", field
        seen.add(t.cache_key())
    assert len(seen) == len(CACHE_FIELDS) + 1
    for k in (8, 4):
        for extra in ({}, {"consensus_mode": "bootstrap"},
                      {"consensus_guard": 0.02}, {"consensus_seed": 3}):
            kw = dict(horizon_consensus=k, **extra)
            assert (dataclasses.replace(base_t, **kw).cache_key()
                    == dataclasses.replace(base_j, **kw).cache_key()
                    + "_torch")
    assert dataclasses.replace(base_t, det_min_count=3).cache_key() == \
        base_t.cache_key()


def test_det_key_tracks_detector_fields():
    base = tpipe.PipelineConfig()
    seen = {base.det_key()}
    assert base.det_key().endswith("-torch")
    assert base.det_key() != jpipe.PipelineConfig().det_key()
    for field, val in DET_FIELDS:
        key = dataclasses.replace(base, **{field: val}).det_key()
        assert key not in seen, field
        seen.add(key)
    assert dataclasses.replace(base, maxbest=10).det_key() == base.det_key()


def test_require_device_refuses_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tpipe.require_device("cuda")
    assert tpipe.require_device("cpu") == torch.device("cpu")


def test_benchmark_result_dir_and_refused_flags():
    """The stage cache defaults to build/results/ of this checkout, so two
    checkouts on one machine never read each other's results; flags with
    nothing to act on in the port are refused, not silently accepted, and
    so is a real data set without its --dataset_dir."""
    from vanishing_points_2017_tpu_torch import benchmark

    assert benchmark.RESULT_DIR == os.path.join(ROOT, "build", "results")
    for flag in ("--update_datalist", "--no_weights_warn", "--yud"):
        with pytest.raises(SystemExit) as exc:
            benchmark.main(["--synthetic", flag, "--device", "cpu"])
        assert exc.value.code == 2, flag


@pytest.mark.slow
def test_drivers_run_on_cpu(tmp_path):
    """The two ``python -m`` drivers, end to end on the CPU with the
    shipped weights: the benchmark on 3 synthetic scenes prints an AUC,
    the example prints each bundled scene's horizon error."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = dict(cwd=ROOT, env=env, capture_output=True, text=True,
               timeout=900, check=True)
    out = subprocess.run(
        [sys.executable, "-m", "vanishing_points_2017_tpu_torch.benchmark",
         "--synthetic", "--num_synthetic", "3", "--device", "cpu",
         "--run_em", "--result_dir", str(tmp_path)], **run).stdout
    assert "evaluated: 3 / 3" in out
    auc = float(out.split("AUC: ")[1].split()[0])
    assert 0.9 < auc <= 1.0
    out = subprocess.run(
        [sys.executable, "-m", "vanishing_points_2017_tpu_torch.example",
         "--device", "cpu"], **run).stdout
    errs = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("horizon error vs ground truth")]
    assert len(errs) == 4 and max(errs) < 0.02
    with pytest.raises(subprocess.CalledProcessError):
        subprocess.run([sys.executable, "-m",
                        "vanishing_points_2017_tpu_torch.benchmark", "--yud",
                        "--device", "cpu"], **run)


@pytest.mark.slow
def test_committed_host_reference_is_current():
    """Regenerates the bundled-scene part of assets/examples/
    jax_reference_host.npz (the JAX host path) and checks the committed
    file still holds it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_ref_host", os.path.join(ROOT, "scripts",
                                      "make_jax_reference_host.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.bundled_outputs()
    committed = np.load(mod.DEFAULT_OUT)
    for k in mod.BUNDLED_KEYS:
        np.testing.assert_allclose(fresh[k], committed[k], atol=1e-6,
                                   err_msg=k)
