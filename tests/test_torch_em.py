"""EM and horizon search of the PyTorch port vs the JAX package.

Unit pieces are compared on random inputs; the whole EM and horizon on
synthetic Manhattan scenes with the idealized CNN grid, held to the
trajectory gates of PARITY.md: the same alive VP set, VPs within 0.5 deg,
inlier counts within 1, iteration counts within 1."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vanishing_points_2017_tpu.em import (EMConfig, expectation_maximisation,
                                          calculate_horizon_and_ortho_vp)
from vanishing_points_2017_tpu.em import cluster as jcluster
from vanishing_points_2017_tpu.em import init_vps as jinit
from vanishing_points_2017_tpu.em import weights as jw
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import lines as jlines
from vanishing_points_2017_tpu.ops import sphere
from vanishing_points_2017_tpu_torch.em import cluster as tcluster
from vanishing_points_2017_tpu_torch.em import em as tem
from vanishing_points_2017_tpu_torch.em import horizon as thz
from vanishing_points_2017_tpu_torch.em import init_vps as tinit
from vanishing_points_2017_tpu_torch.em import weights as tw
from vanishing_points_2017_tpu_torch.ops import lines as tlines


def T(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, noise=0.002, outliers=10, lines_per_vp=35, n_pad=256):
    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=lines_per_vp,
                             outliers=outliers, noise=noise)
    n = scene.segments.shape[0]
    lp = np.zeros((n_pad, 4), np.float32)
    l = np.zeros((n_pad, 3), np.float32)
    lp[:n] = scene.segments
    l[:n] = scene.lines
    lmask = np.arange(n_pad) < n
    cnn = synth.vp_grid_label(scene.vps).astype(np.float32)
    img = np.asarray(sphere.sphere_image_uint8(
        jnp.asarray(l), jnp.asarray(lmask), size=500)).astype(np.float32)
    return l, lp, cnn, img, lmask


def _torch_em(scenes, cfg):
    stack = lambda k: T(np.stack([s[k] for s in scenes]))
    return tem.expectation_maximisation(stack(0), stack(1), stack(2),
                                        stack(3), stack(4), cfg)


def _assert_em_close(got, i, ref):
    """PARITY.md trajectory gates between batch element i and a JAX run."""
    ja, ta = np.asarray(ref.alive), got.alive[i].numpy()
    assert np.array_equal(ja, ta), (ja.nonzero(), ta.nonzero())
    jv, tv = np.asarray(ref.vp)[ja], got.vp[i].numpy()[ta]
    cos = np.clip(np.abs(np.sum(jv * tv, axis=1)), 0.0, 1.0)
    assert np.degrees(np.arccos(cos)).max(initial=0.0) < 0.5
    assert np.abs(np.asarray(ref.counts) - got.counts[i].numpy()).max() <= 1
    assert abs(int(ref.iterations) - int(got.iterations[i])) <= 1
    assert bool(ref.valid) == bool(got.valid[i])


def _sym(rng, b, kind):
    a = rng.normal(size=(b, 3, 3)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1)
    if kind == "rank2":  # smallest eigenvalue 0, unique
        u = rng.normal(size=(b, 3, 2)).astype(np.float32)
        a = u @ u.transpose(0, 2, 1)
    elif kind == "iso":
        a = np.broadcast_to(np.eye(3, dtype=np.float32) * 2.0, (b, 3, 3))
    return np.ascontiguousarray(a)


@pytest.mark.parametrize("kind", ["psd", "rank2", "iso"])
def test_smallest_eigvec_matches_jax(kind):
    a = _sym(np.random.default_rng(0), 64, kind)
    ref = np.asarray(jw.smallest_eigvec_3x3(jnp.asarray(a)))
    got = tw.smallest_eigvec_3x3(T(a)).numpy()
    # equal up to sign; 1e-4 covers the f32 conditioning of the closed form
    dots = np.abs(np.sum(ref * got, axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_weight_matrix_and_counts_match_jax():
    rng = np.random.default_rng(1)
    n, m = 24, 6
    l, lp, _, _, lmask = _scene(3, n_pad=n + 200)
    l, lp, lmask = l[:n], lp[:n], lmask[:n]
    lmask[-3:] = False
    p_vl = rng.uniform(size=(m, n)).astype(np.float32) * lmask
    lweight = rng.uniform(0.2, 1.0, size=n).astype(np.float32) * lmask
    lsim = np.asarray(jlines.calc_lsim(jnp.asarray(lp), jnp.asarray(lmask)))
    ref = np.asarray(jw.weight_matrix(jnp.asarray(p_vl), jnp.asarray(lweight),
                                      jnp.asarray(lsim)))
    got = tw.weight_matrix(T(p_vl)[None], T(lweight)[None], T(lsim)[None])
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5, atol=1e-6)

    lsim_t = tlines.calc_lsim(T(lp)[None], T(lmask)[None])
    np.testing.assert_allclose(lsim_t[0].numpy(), lsim, atol=1e-6)
    knn_j = np.asarray(jlines.line_rating_knn(jnp.asarray(lp),
                                              jnp.asarray(lmask), 10, 4, 1.0))
    knn_t = tlines.line_rating_knn(T(lp)[None], T(lmask)[None], 10, 4, 1.0)
    np.testing.assert_allclose(knn_t[0].numpy(), knn_j, atol=1e-6)

    vp = rng.normal(size=(m, 3)).astype(np.float32)
    vp /= np.linalg.norm(vp, axis=1, keepdims=True)
    alive = np.array([1, 1, 0, 1, 1, 0], bool)
    log_s = np.full(m, -8.0, np.float32)
    ln = l / np.maximum(np.linalg.norm(l, axis=1, keepdims=True), 1e-12)
    rc = jw.calc_vp_line_counts(jnp.asarray(vp), jnp.asarray(alive),
                                jnp.asarray(ln), jnp.asarray(lp),
                                jnp.asarray(lmask), jnp.asarray(log_s),
                                jnp.asarray(ref), jnp.asarray(lweight),
                                "angle")
    gc = tw.calc_vp_line_counts(T(vp)[None], T(alive)[None], T(ln)[None],
                                T(lp)[None], T(lmask)[None], T(log_s)[None],
                                got, T(lweight)[None], "angle")
    for r, g in zip(rc, gc):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), atol=1e-5)

    nv, ok = tw.calc_new_vanishing_point(T(ln)[None], got)
    for k in range(m):
        jv, jok = jw.calc_new_vanishing_point(jnp.asarray(ln),
                                              jnp.asarray(ref[k]))
        assert bool(jok) == bool(ok[0, k])
        assert abs(abs(float(np.dot(np.asarray(jv), nv[0, k].numpy()))) - 1) \
            < 1e-5


def test_agglomerative_two_matches_jax():
    rng = np.random.default_rng(2)
    n = 40
    pts = np.concatenate([rng.normal(0, 0.2, size=(20, 2)),
                          rng.normal(3, 0.2, size=(20, 2))])
    dist = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
    actives = np.stack([rng.uniform(size=n) < 0.7, np.ones(n, bool),
                        np.arange(n) < 2])
    got = tcluster.agglomerative_two(T(dist)[None].repeat(3, 1, 1),
                                     T(actives)).numpy()
    for i in range(3):
        ref = np.asarray(jcluster.agglomerative_two(jnp.asarray(dist),
                                                    jnp.asarray(actives[i])))
        assert np.array_equal(got[i], ref)


def test_find_initial_vps_matches_jax():
    scenes = [_scene(s) for s in (0, 1)]
    v0, alive = tinit.find_initial_vps(T(np.stack([s[3] for s in scenes])),
                                       T(np.stack([s[2] for s in scenes])),
                                       25, 40)
    for i, s in enumerate(scenes):
        rv, ra = jinit.find_initial_vps(jnp.asarray(s[3]), jnp.asarray(s[2]),
                                        25, 40)
        assert np.array_equal(alive[i].numpy(), np.asarray(ra))
        np.testing.assert_allclose(v0[i].numpy(), np.asarray(rv), atol=1e-6)
    cnn = np.random.default_rng(4).uniform(size=(20, 20)).astype(np.float32)
    np.testing.assert_array_equal(
        tinit.find_maxima(T(cnn)).numpy(),
        np.asarray(jinit.find_maxima(jnp.asarray(cnn))))


CASES = {
    # default config; the split/merge cadence is never reached (< 10 iters)
    "default": (EMConfig(), tem.EMConfig(),
                [dict(seed=s) for s in range(4)]),
    # noisy scenes with split/merge every 2nd iteration: exercises the
    # split move, the linkage loop and the merge loop
    "split_merge": (EMConfig(split_merge_freq=2),
                    tem.EMConfig(split_merge_freq=2),
                    [dict(seed=s, noise=0.02, outliers=20, lines_per_vp=30)
                     for s in range(6)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_em_and_horizon_match_jax(case):
    jcfg, tcfg, kws = CASES[case]
    scenes = [_scene(**kw) for kw in kws]
    got = _torch_em(scenes, tcfg)
    hz = thz.calculate_horizon_and_ortho_vp(got.vp, got.counts, got.alive,
                                            pos_gate_ideal_tol=8.0)
    for i, s in enumerate(scenes):
        ref = expectation_maximisation(*[jnp.asarray(x) for x in s], jcfg)
        _assert_em_close(got, i, ref)
        rh = calculate_horizon_and_ortho_vp(ref.vp, ref.counts, ref.alive,
                                            pos_gate_ideal_tol=8.0)
        # same triplet, horizon within 1e-4 normalized units at x = +-1
        np.testing.assert_array_equal(hz[5][i].numpy(), np.asarray(rh[5]))
        for k in (0, 1):
            np.testing.assert_allclose(hz[k][i].numpy(), np.asarray(rh[k]),
                                       atol=1e-4)


def test_em_batch_equals_single_runs():
    """A batch whose elements converge at different iterations gives each
    element's own single-image result (per-element done/empty freezing)."""
    cfg = tem.EMConfig(split_merge_freq=2)
    scenes = [_scene(seed=s, noise=0.02, outliers=20, lines_per_vp=30)
              for s in (1, 2, 4)]
    got = _torch_em(scenes, cfg)
    assert len(set(got.iterations.tolist())) == 3
    for i, s in enumerate(scenes):
        one = _torch_em([s], cfg)
        assert np.array_equal(one.alive[0].numpy(), got.alive[i].numpy())
        assert int(one.iterations[0]) == int(got.iterations[i])
        np.testing.assert_allclose(one.vp[0].numpy(), got.vp[i].numpy(),
                                   atol=1e-5)
        np.testing.assert_array_equal(one.counts[0].numpy(),
                                      got.counts[i].numpy())


@pytest.mark.parametrize("case", ["two", "one", "zero", "all_fail"])
def test_horizon_fallbacks_match_jax(case):
    rng = np.random.default_rng(7)
    m = 40
    vps = rng.normal(size=(m, 3)).astype(np.float32)
    vps[:, 2] = np.abs(vps[:, 2])
    vps /= np.linalg.norm(vps, axis=1, keepdims=True)
    counts = rng.integers(3, 60, size=m).astype(np.float32)
    n_alive = {"two": 2, "one": 1, "zero": 0, "all_fail": 12}[case]
    alive = np.zeros(m, bool)
    alive[rng.permutation(m)[:n_alive]] = True
    ref = calculate_horizon_and_ortho_vp(jnp.asarray(vps), jnp.asarray(counts),
                                         jnp.asarray(alive))
    got = thz.calculate_horizon_and_ortho_vp(T(vps)[None], T(counts)[None],
                                             T(alive)[None])
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0].numpy().astype(np.float64),
                                   np.asarray(r).astype(np.float64),
                                   atol=1e-5)
    assert math.isfinite(float(got[0][0, 1]))


def test_probability_matches_jax():
    from vanishing_points_2017_tpu.ops import probability as jp
    from vanishing_points_2017_tpu_torch.ops import probability as tp

    l, lp, cnn, _, lmask = _scene(5, n_pad=200)
    ln = l / np.maximum(np.linalg.norm(l, axis=1, keepdims=True), 1e-12)
    rng = np.random.default_rng(8)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    alive = rng.uniform(size=40) < 0.5
    log_s = rng.uniform(-14, -8, size=40).astype(np.float32)
    jpar = jp.pdf_params(jnp.asarray(cnn))
    tpar = tp.pdf_params(T(cnn)[None])
    np.testing.assert_allclose(tpar.weights[0].numpy(),
                               np.asarray(jpar.weights), rtol=1e-5)
    for wrap in (True, False):
        for dm in ("angle", "dotprod"):
            ref = jp.calc_probabilities(jpar, jnp.asarray(v),
                                        jnp.asarray(alive), jnp.asarray(ln),
                                        jnp.asarray(lp), jnp.asarray(log_s),
                                        jnp.asarray(lmask), dm, wrap)
            got = tp.calc_probabilities(tpar, T(v)[None], T(alive)[None],
                                        T(ln)[None], T(lp)[None],
                                        T(log_s)[None], T(lmask)[None], dm,
                                        wrap)
            np.testing.assert_allclose(got.p_v[0].numpy(),
                                       np.asarray(ref.p_v), rtol=1e-4)
            np.testing.assert_allclose(got.p_vl[0].numpy(),
                                       np.asarray(ref.p_vl), atol=1e-5)
            np.testing.assert_allclose(got.log_pl[0].numpy(),
                                       np.asarray(ref.log_pl), rtol=1e-4,
                                       atol=1e-4)
