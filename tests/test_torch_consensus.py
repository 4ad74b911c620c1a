"""Consensus horizon of the PyTorch port (em/consensus.py) vs the JAX
package's.

The member draws differ by design (torch.Generator vs jax.random), so the
EM side is compared on JAX's own populations; the pick is compared on
JAX's own member horizons."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu.em import EMConfig as JEMConfig
from vanishing_points_2017_tpu.em import consensus as jcons
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import sphere as jsphere
from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.em import EMConfig
from vanishing_points_2017_tpu_torch.em import consensus as tcons

K, N = 4, 256
HORIZON_ARGS = dict(maxbest=20, theta_vmin=float(np.pi / 10),
                    pos_gate_ideal_tol=8.0)


def _scene(seed):
    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=35, outliers=10, noise=0.002)
    n = scene.segments.shape[0]
    l, lp = np.zeros((N, 3), np.float32), np.zeros((N, 4), np.float32)
    l[:n], lp[:n] = scene.lines, scene.segments
    lmask = np.arange(N) < n
    cnn = synth.vp_grid_label(scene.vps).astype(np.float32)
    img = np.asarray(jsphere.sphere_image_uint8(
        jnp.asarray(l), jnp.asarray(lmask), size=500)).astype(np.float32)
    return l, lp, cnn, img, lmask


@pytest.fixture(scope="module")
def jax_runs():
    """Two scenes through JAX's consensus (guard 0 and 0.05), with JAX's
    populations."""
    runs = []
    for seed in (1, 2):
        l, lp, cnn, img, m = _scene(seed)
        pops = jcons.bootstrap_populations(jnp.asarray(l), jnp.asarray(lp),
                                           jnp.asarray(m), K, 0,
                                           mode="dropout")
        out = {}
        for guard in (0.0, 0.05):
            em, hz, diag = jcons.consensus_em_horizon(
                jnp.asarray(l), jnp.asarray(lp), jnp.asarray(cnn),
                jnp.asarray(img), jnp.asarray(m), JEMConfig(), k=K, seed=0,
                mode="dropout", guard=guard, **HORIZON_ARGS)
            out[guard] = (em, hz, diag)
        runs.append(((l, lp, cnn, img, m), pops, out))
    return runs


def test_masked_median_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 7)).astype(np.float32)
    m = rng.random((40, 7)) < 0.6
    m[0], m[1] = False, True
    got = tcons.masked_median(torch.from_numpy(x), torch.from_numpy(m))
    for i in range(40):
        ref = jcons.masked_median(jnp.asarray(x[i]), jnp.asarray(m[i]))
        assert float(got[i]) == float(ref), i


def test_medoid_and_guard_pick_match_jax(jax_runs):
    """On JAX's member horizons and validity, the port picks JAX's member,
    with and without the guard."""
    for _, _, out in jax_runs:
        for guard, (_, _, diag) in out.items():
            yl, yr, valid = (torch.from_numpy(np.array(diag[k]))[None]
                             for k in ("consensus_yl", "consensus_yr",
                                       "consensus_valid"))
            pick = tcons.medoid_pick(yl, yr, valid, guard)
            assert int(pick[0]) == int(diag["consensus_pick"]), guard
    yl = torch.tensor([[0.0, 0.1, 0.2, 0.3]])
    valid = torch.tensor([[False, True, True, True]])
    assert int(tcons.medoid_pick(yl, yl, valid)[0]) == 2
    assert int(tcons.medoid_pick(yl, yl, valid, guard=1.0)[0]) == 2
    assert int(tcons.medoid_pick(yl, yl, valid & False)[0]) == 0


def test_member_em_on_jax_populations_matches_jax(jax_runs):
    """JAX's populations of two scenes, stacked as one (K, B=2) batch,
    through the port's EM + horizon + medoid: per member the same validity
    and horizon heights within 2e-3, the same pick, and the picked member
    held to the pipeline gates (same alive VPs, counts within 1, horizon
    within 1e-3)."""
    pops = [np.stack([np.asarray(r[1][i]) for r in jax_runs], 1)
            for i in range(3)]
    inputs = [np.stack([r[0][i] for r in jax_runs]) for i in range(5)]
    em, hz, diag = tcons.member_em_horizon(
        *(torch.from_numpy(p) for p in pops),
        torch.from_numpy(inputs[2]), torch.from_numpy(inputs[3]), EMConfig(),
        **HORIZON_ARGS)
    for b, (_, _, out) in enumerate(jax_runs):
        jem, jhz, jdiag = out[0.0]
        np.testing.assert_array_equal(diag["consensus_valid"][b].numpy(),
                                      np.asarray(jdiag["consensus_valid"]))
        for key in ("consensus_yl", "consensus_yr"):
            np.testing.assert_allclose(diag[key][b].numpy(),
                                       np.asarray(jdiag[key]), atol=2e-3)
        assert int(diag["consensus_pick"][b]) == int(jdiag["consensus_pick"])
        np.testing.assert_array_equal(em.alive[b].numpy(),
                                      np.asarray(jem.alive))
        assert np.abs(em.counts[b].numpy()
                      - np.asarray(jem.counts)).max() <= 1
        est = np.cross(hz[0][b].double().numpy(), hz[1][b].double().numpy())
        ref = np.cross(np.asarray(jhz[0], np.float64),
                       np.asarray(jhz[1], np.float64))
        assert tio.normalized_horizon_error(est, ref, 640, 640) < 1e-3


@pytest.mark.parametrize("mode", ["dropout", "bootstrap"])
def test_bootstrap_populations_structure(mode):
    """Member 0 is the original; members draw only valid rows (dropout:
    JAX's subset size, no duplicates); a seed gives the same draws."""
    rng = np.random.default_rng(0)
    nv = np.array([40, 7])
    lp = rng.uniform(-1, 1, size=(2, 64, 4)).astype(np.float32)
    l = rng.normal(size=(2, 64, 3)).astype(np.float32)
    m = np.arange(64)[None] < nv[:, None]
    m = m[:, rng.permutation(64)]  # valid rows scattered
    args = [torch.from_numpy(a) for a in (l, lp, m)]
    l_all, lp_all, m_all = tcons.bootstrap_populations(*args, k=5, seed=3,
                                                       mode=mode)
    assert l_all.shape == (5, 2, 64, 3) and m_all.shape == (5, 2, 64)
    assert torch.equal(l_all[0], args[0]) and torch.equal(m_all[0], args[2])
    for b in range(2):
        jm = np.asarray(jcons.bootstrap_populations(
            jnp.asarray(l[b]), jnp.asarray(lp[b]), jnp.asarray(m[b]), 5, 3,
            mode=mode)[2])
        np.testing.assert_array_equal(m_all[:, b].numpy(), jm)
        valid_rows = {tuple(r) for r in lp[b][m[b]].tolist()}
        for j in range(1, 5):
            rows = lp_all[j, b][m_all[j, b]].tolist()
            assert all(tuple(r) in valid_rows for r in rows)
            if mode == "dropout":
                assert len({tuple(r) for r in rows}) == len(rows)
    again = tcons.bootstrap_populations(*args, k=5, seed=3, mode=mode)
    assert torch.equal(again[1], lp_all)
    other = tcons.bootstrap_populations(*args, k=5, seed=4, mode=mode)
    assert not torch.equal(other[1], lp_all)


def test_pipeline_consensus_member0_equals_single_em():
    """Through device_pipeline_batch (random CNN, sphere 240, float32):
    member 0's horizon heights equal the single-EM run's exactly, and the
    consensus outputs are finite."""
    from vanishing_points_2017_tpu_torch.models import cnn as tcnn
    from vanishing_points_2017_tpu_torch.weights import params_from_numpy

    scenes = [_scene(s) for s in (1, 2)]
    l, lp, _, _, m = (torch.from_numpy(np.stack([s[i] for s in scenes]))
                      for i in range(5))
    cfg = tpipe.PipelineConfig(sphere_size=240, cnn_dtype="float32")
    model = tpipe.build_model(params_from_numpy(
        tcnn.init_params(0, input_size=240, fc_width=64)), cfg)
    mean = torch.zeros((240, 240))
    single = tpipe.device_pipeline_batch(l, lp, m, model, mean, cfg)
    cons = tpipe.device_pipeline_batch(
        l, lp, m, model, mean,
        tpipe.PipelineConfig(sphere_size=240, cnn_dtype="float32",
                             horizon_consensus=2))
    assert cons["consensus_yl"].shape == (2, 2)
    assert torch.equal(cons["consensus_yl"][:, 0], single["hp1"][:, 1])
    assert torch.equal(cons["consensus_yr"][:, 0], single["hp2"][:, 1])
    for key in ("hp1", "hp2", "consensus_spread"):
        assert bool(torch.isfinite(cons[key]).all()), key
