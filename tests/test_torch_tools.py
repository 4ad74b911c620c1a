"""The port's accuracy harnesses (``vanishing_points_2017_tpu_torch.tools``)
against the JAX package's ``scripts/`` on the CPU: the scene set, the error
functions and the jitter draws exactly; ``run_populations`` and the ideal
path within the stated tolerances; the flip protocol on the five pinned
scenes (slow), and the committed ``jax_reference_tools.npz`` (slow).

The JAX side's functions come from ``scripts/`` through ``sys.path``, as
``tests/test_knife_edge.py`` takes them; both sides get the same numpy
inputs."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import eval_device_detector as jeval  # noqa: E402
import perturb_knife_edge as jknife  # noqa: E402

from vanishing_points_2017_tpu_torch.data.io import \
    normalized_horizon_error  # noqa: E402
from vanishing_points_2017_tpu_torch.tools import \
    eval_device_detector as teval  # noqa: E402
from vanishing_points_2017_tpu_torch.tools import \
    perturb_knife_edge as tknife  # noqa: E402
from vanishing_points_2017_tpu_torch.tools import make_pipeline  # noqa: E402

REF = os.path.join(ROOT, "assets", "examples", "jax_reference_tools.npz")
SIGMA_NORM = 0.5 * 2.0 / 640
DROP = 0.02
PINNED = (12, 15, 27, 31, 38)
HORIZON_TOL = 0.02   # the repo's horizon parity gate
SCORE_RTOL = 5e-2    # triplet scores: see test_run_populations_match_jax


def _load_oracle():
    spec = importlib.util.spec_from_file_location(
        "make_ref_tools", os.path.join(ROOT, "scripts",
                                       "make_jax_reference_tools.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _horizon_gap(a1, a2, b1, b2) -> float:
    line = lambda p, q: np.cross(np.asarray(p, np.float64),
                                 np.asarray(q, np.float64))
    return normalized_horizon_error(line(a1, a2), line(b1, b2), 640, 640)


@pytest.fixture(scope="module")
def scene_set():
    return teval.build_scene_set(50)


@pytest.fixture(scope="module")
def tpipe():
    return make_pipeline(torch.device("cpu"))


def test_build_scene_set_equals_jax():
    """The same draws: images byte for byte, horizons, VPs and segments
    equal."""
    js, ji = jeval.build_scene_set(3)
    ts, ti = teval.build_scene_set(3)
    for a, b in zip(ji, ti):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a.horizon, b.horizon)
        np.testing.assert_array_equal(a.vps, b.vps)
        np.testing.assert_array_equal(a.segments, b.segments)


def test_error_functions_equal_jax():
    """``scene_horizon_errors`` and ``photo_errs`` on fixed inputs, within
    1e-12."""
    rng = np.random.default_rng(3)
    scenes, _ = teval.build_scene_set(3)
    hp1 = np.concatenate([np.ones((3, 1)), rng.normal(0, 0.3, (3, 1)),
                          np.ones((3, 1))], 1).astype(np.float32)
    hp2 = hp1 * np.array([-1, 1, 1], np.float32) + rng.normal(
        0, 0.05, (3, 3)).astype(np.float32) * np.array([0, 1, 0], np.float32)
    np.testing.assert_allclose(
        teval.scene_horizon_errors(scenes, hp1, hp2, 640),
        jeval.scene_horizon_errors(scenes, hp1, hp2, 640), rtol=0,
        atol=1e-12)
    res = {"hp1": hp1, "hp2": hp2}
    for shape in ((480, 640), (640, 427)):
        np.testing.assert_allclose(
            tknife.photo_errs(res, shape, 0.7701, 0.7743),
            jknife.photo_errs(res, shape, 0.7701, 0.7743), rtol=0,
            atol=1e-12)


def test_jitter_population_identical_to_jax():
    """The same seed and population give identical arrays, draw for draw,
    also over a probe's whole sequence of jitters."""
    rng = np.random.default_rng(0)
    lp = np.zeros((512, 4), np.float32)
    lp[:300] = rng.uniform(-1, 1, (300, 4)).astype(np.float32)
    m = np.arange(512) < 300
    for drop in (0.02, 0.3):
        a = jknife.jitter_population(np.random.default_rng(11), lp, m,
                                     SIGMA_NORM, drop)
        b = tknife.jitter_population(np.random.default_rng(11), lp, m,
                                     SIGMA_NORM, drop)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    jr = np.random.default_rng(11)
    want = [(lp, m)] + [jknife.jitter_population(jr, lp, m, SIGMA_NORM, DROP)
                        for _ in range(3)]
    got = tknife.jittered_populations(np.random.default_rng(11), lp, m, 3,
                                      SIGMA_NORM, DROP)
    for i, (x, y) in enumerate(want):
        np.testing.assert_array_equal(got[0][i], x)
        np.testing.assert_array_equal(got[1][i], y)


def test_run_populations_match_jax(scene_set, tpipe):
    """Scenes 15 and 27 (two of JAX's pinned knife-edge scenes), K = 2
    jitters at seed 11 of the port's detected populations, through both
    packages' ``run_populations``: ``em_valid`` equal, horizons within
    0.02, the top two triplet scores within a relative 5e-2.

    Why not 1e-3 on the scores: the two sides do not run one trajectory.
    JAX's ``run_populations`` runs the three populations under one
    ``vmap``, and the vmap alone moves JAX's own EM: on the same inputs
    its batch-1 run ends on another iteration count or VP set for 4 of
    the 21 populations of ``jax_reference_em.npz``, scene 15's second
    jitter among them (19 iterations and 14 VPs under the vmap, 18 and
    13 alone). The port runs one image per call on the CPU, from its own
    sphere image and CNN grid. On identical inputs at batch 1 the port
    follows JAX's trajectory except where one ULP on a near-degenerate
    VP refit moves JAX's own result
    (``tests/test_torch_em_trajectory.py``). The scores lie up to 3.2%
    apart (s1 2.6-3.1%, s2 0.4-2.8%) while the horizons agree: parity at
    the horizon, not at the trajectory (ROADMAP's EM knife-edge hazard).
    The relative margins, differences of two nearby scores, are not
    compared."""
    _, images = scene_set
    oracle = _load_oracle()
    jpipe, _ = oracle.pipelines()
    for i in (15, 27):
        lp0, m0 = tknife.detect_device(tpipe, tpipe.cfg, images[i])
        lps, masks = tknife.jittered_populations(
            np.random.default_rng(11), lp0, m0, 2, SIGMA_NORM, DROP)
        want = jknife.run_populations(jpipe, jpipe.cfg, lps, masks)
        got = tknife.run_populations(tpipe, tpipe.cfg, lps, masks)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["em_valid"], want["em_valid"])
        for k in range(3):
            assert _horizon_gap(got["hp1"][k], got["hp2"][k],
                                want["hp1"][k], want["hp2"][k]) \
                <= HORIZON_TOL, (i, k)
        for key in ("s1", "s2"):
            np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL,
                                       err_msg=f"scene {i} {key}")


def test_ideal_path_matches_jax(scene_set, tpipe):
    """The ideal-prior path (device segments, the scenes' own VP grids) on
    scenes 0 and 1: horizons within 0.02 of JAX's ``ideal_one``
    (``jax_reference_tools.npz``, current by the slow test below)."""
    scenes, images = scene_set
    ref = np.load(REF)
    r = teval.run_path("ideal", tpipe, scenes[:2], images[:2], 2, 640)
    for i in range(2):
        assert _horizon_gap(r["hp1"][i], r["hp2"][i], ref["ideal_hp1"][i],
                            ref["ideal_hp2"][i]) <= HORIZON_TOL, i


@pytest.mark.slow
def test_synthetic_knife_edge_scenes_flip_rate(scene_set, tpipe):
    """``tests/test_knife_edge.py::test_synthetic_knife_edge_scenes_flip_rate``
    on the port: the five lowest-margin scenes of the seed-7 pool, K = 8
    jitters at seed 11, each pinned at JAX's 0 flips of 8."""
    scenes, images = scene_set
    ref = np.load(REF)
    for j, idx in enumerate(PINNED):
        lp0, m0 = tknife.detect_device(tpipe, tpipe.cfg, images[idx])
        lps, masks = tknife.jittered_populations(
            np.random.default_rng(11), lp0, m0, 8, SIGMA_NORM, DROP)
        res = tknife.run_populations(tpipe, tpipe.cfg, lps, masks)
        errs = teval.scene_horizon_errors([scenes[idx]] * 9, res["hp1"],
                                          res["hp2"], 640)
        flips = int((errs[1:] > tknife.FLIP_GATE).sum())
        assert flips <= int(ref["ke_single_flips"][j]) == 0, (idx, flips)


@pytest.mark.slow
def test_committed_tools_reference_is_current():
    """Regenerates part of ``jax_reference_tools.npz`` (the first batch of
    10 scenes on the three paths, and the single-EM flip probe of scene
    15) and checks the committed file still holds it."""
    oracle = _load_oracle()
    committed = np.load(oracle.DEFAULT_OUT)
    pipe, _ = oracle.pipelines()
    fresh = oracle.decomposition(pipe, count=10)
    for k, v in fresh.items():
        np.testing.assert_allclose(v, committed[k][:10], atol=1e-6,
                                   err_msg=k)
    j = oracle.PINNED.index(15)
    errs, margins, flips = oracle.flip_probes(
        pipe, oracle.populations(pipe, [15]), indices=[15])
    np.testing.assert_allclose(errs[0], committed["ke_single_errs"][j],
                               atol=1e-6)
    np.testing.assert_allclose(margins[0],
                               committed["ke_single_rel_margin"][j],
                               atol=1e-6)
    assert int(flips[0]) == int(committed["ke_single_flips"][j])
