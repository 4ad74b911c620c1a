"""The port's reference-shaped entry points (em/compat.py) and the small
single functions, each against its JAX namesake on the same numpy inputs.

compat: every case of tests/test_compat.py that touches em/compat.py, run
through both packages: the dict's keys and shapes, the compact
renumbering of ``vp_assoc``, the empty contract, the ``distribution``
bundle's fields at rtol 1e-4 in float64, ``save_cnn_result``'s round trip.
Single functions: float32, atol 1e-6; ``num_combo3`` and ``vp_in_image``
exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vanishing_points_2017_tpu.data.datasets import render_scene_image
from vanishing_points_2017_tpu.em import compat as jcompat
from vanishing_points_2017_tpu.em import horizon as jhorizon
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.ops import lines_device as jld
from vanishing_points_2017_tpu.ops import probability as jprob
from vanishing_points_2017_tpu.ops import sphere as jsphere
from vanishing_points_2017_tpu_torch.em import EMResult
from vanishing_points_2017_tpu_torch.em import compat as tcompat
from vanishing_points_2017_tpu_torch.em import horizon as thorizon
from vanishing_points_2017_tpu_torch.models import synth
from vanishing_points_2017_tpu_torch.ops import lines_device as tld
from vanishing_points_2017_tpu_torch.ops import probability as tprob
from vanishing_points_2017_tpu_torch.ops import sphere as tsphere
from vanishing_points_2017_tpu_torch.weights import params_from_numpy

ATOL = 1e-6


def _scene_inputs(seed: int, lines_per_vp: int, outliers: int):
    scene = synth.make_scene(np.random.default_rng(seed),
                             lines_per_vp=lines_per_vp, outliers=outliers)
    n = scene.lines.shape[0]
    lpad = np.zeros((256, 3), np.float32)
    lpad[:n] = scene.lines
    img = np.asarray(jsphere.sphere_image_uint8(
        jnp.asarray(lpad), jnp.asarray(np.arange(256) < n), size=500))
    return scene, synth.vp_grid_label(scene.vps), img


def _params(input_size: int):
    p = jcnn.init_params(jax.random.PRNGKey(0), input_size=input_size)
    npp = {k: {kk: np.asarray(vv) for kk, vv in d.items()}
           for k, d in p.items()}
    return p, params_from_numpy(npp)


@pytest.mark.parametrize("seed,lines_per_vp,outliers", [(1, 30, 8),
                                                        (3, 25, 5)])
def test_run_em_single_matches_jax(seed, lines_per_vp, outliers):
    """test_run_em_single_compact_contract and
    test_run_em_single_distribution_key, through both packages: the same
    inputs give the same keys, the same compact VPs and counts, and the
    same final E-step bundle."""
    scene, cnn, img = _scene_inputs(seed, lines_per_vp, outliers)
    n = scene.lines.shape[0]
    want = jcompat.run_em_single(scene.lines, scene.segments, cnn, img)
    got = tcompat.run_em_single(scene.lines, scene.segments, cnn, img,
                                device="cpu")
    assert list(got) == list(want)
    m = want["vp"].shape[0]
    assert got["vp"].shape == (m, 3) and got["vp_assoc"].shape == (n,)
    assert got["count_id"] is None and got["iterations"] == want["iterations"]
    for k in ("counts", "counts_weighted", "sigma"):
        assert got[k].shape == (m,)
    assert got["decision_metric"].shape == want["decision_metric"].shape
    assert got["decision_metric"].shape[0] == m
    # compact renumbering: indices in [-1, m), each VP's count is its lines
    assert got["vp_assoc"].min() >= -1 and got["vp_assoc"].max() < m
    for k in range(m):
        assert (got["vp_assoc"] == k).sum() == got["counts"][k]
    np.testing.assert_array_equal(got["vp_assoc"], want["vp_assoc"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_allclose(got["vp"], want["vp"], atol=1e-5)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-3)
    np.testing.assert_allclose(got["counts_weighted"],
                               want["counts_weighted"], rtol=1e-4)

    p, q = got["distribution"], want["distribution"]
    assert type(p).__name__ == "PDF" and p._fields == q._fields
    assert p.v.shape == (m,) and p.lv.shape == (n, m)
    assert p.vl.shape == (m, n) and p.l.shape == (n,)
    assert p.lvsq.shape == (n, m) and p.angles.shape == (m, 2)
    assert np.all(p.l >= 1e-12 - 1e-18)  # the evidence floor
    assert np.all((p.vl >= 0) & (p.vl <= 1 + 1e-6))
    for field in p._fields:
        a, b = getattr(p, field), getattr(q, field)
        assert a.dtype == np.float64, field
        # end to end the two EMs arrive at sigmas equal to rtol 1e-3 (the
        # gate above; variances down to 1e-10 of float32 (1 - cos)^2
        # residuals), and p(l|v) = exp(-lvsq / 2s) / sqrt(2 pi s) carries
        # that over: relative 5e-3, absolute for the likelihoods that
        # underflow to nothing against the largest
        np.testing.assert_allclose(a, b, rtol=5e-3,
                                   atol=1e-4 * np.abs(b).max(), err_msg=field)

    # the bundle itself, from one and the same EM state (JAX's result handed
    # to both packages' final E-step): every field at rtol 1e-4 in float64
    from vanishing_points_2017_tpu.em import EMConfig as JEMConfig
    from vanishing_points_2017_tpu.em import expectation_maximisation as jem
    l = np.zeros((512, 3), np.float32)
    lp = np.zeros((512, 4), np.float32)
    l[:n], lp[:n] = scene.lines, scene.segments
    lmask = np.arange(512) < n
    res = jem(jnp.asarray(l), jnp.asarray(lp), jnp.asarray(cnn, jnp.float32),
              jnp.asarray(img, jnp.float32), jnp.asarray(lmask), JEMConfig())
    q = jcompat._final_distribution(res, jnp.asarray(l), jnp.asarray(lp),
                                    jnp.asarray(lmask), cnn, JEMConfig(), n)
    p = tcompat._final_distribution(
        EMResult(*(torch.from_numpy(np.array(f))[None] for f in res)),
        torch.from_numpy(l)[None], torch.from_numpy(lp)[None],
        torch.from_numpy(lmask)[None],
        torch.from_numpy(np.asarray(cnn, np.float32))[None],
        tcompat.EMConfig(), n)
    for field in p._fields:
        a, b = getattr(p, field), getattr(q, field)
        assert a.dtype == np.float64 and a.shape == b.shape, field
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=field)


def test_run_em_single_empty_contract_matches_jax():
    args = (np.zeros((0, 3)), np.zeros((0, 4)),
            np.zeros((20, 20), np.float32), np.zeros((500, 500), np.float32))
    want = jcompat.run_em_single(*args)
    got = tcompat.run_em_single(*args, device="cpu")
    assert got == want
    assert got["vp"] is None and got["iterations"] == 0
    assert got["distribution"] is None
    with pytest.raises(ValueError, match="exceed the n_pad bucket"):
        tcompat.run_em_single(np.zeros((9, 3)), np.zeros((9, 4)), args[2],
                              args[3], n_pad=8, device="cpu")


def test_em_result_to_dict_renumbers_slots():
    """Slots 1, 4 and 5 alive of 6: compact order 0, 1, 2; outliers stay
    -1; both packages give the same dict from the same masked result."""
    rng = np.random.default_rng(0)
    alive = np.array([False, True, False, False, True, True])
    fields = dict(
        vp=rng.normal(size=(6, 3)).astype(np.float32), alive=alive,
        vp_assoc=np.array([4, -1, 1, 5, 5, -1, 1], np.int32),
        counts=np.arange(6, dtype=np.float32),
        counts_weighted=rng.uniform(size=6).astype(np.float32),
        decision_metric=rng.uniform(size=(6, 7)).astype(np.float32),
        log_sigma=rng.normal(size=6).astype(np.float32),
        iterations=np.int32(17), valid=np.bool_(True))
    from vanishing_points_2017_tpu.em import EMResult as JEMResult
    want = jcompat.em_result_to_dict(JEMResult(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    got = tcompat.em_result_to_dict(EMResult(
        **{k: torch.as_tensor(v) for k, v in fields.items()}))
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["vp_assoc"], [1, -1, 0, 2, 2, -1, 0])
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
        else:
            assert got[k] == v, k
    empty = tcompat.em_result_to_dict(EMResult(
        **{k: torch.as_tensor(v) for k, v in
           (fields | {"valid": np.bool_(False)}).items()}))
    assert empty == jcompat.em_result_to_dict(JEMResult(
        **{k: jnp.asarray(v) for k, v in
           (fields | {"valid": np.bool_(False)}).items()}))


def test_create_data_dict_single_matches_jax():
    scene = synth.make_scene(np.random.default_rng(4), lines_per_vp=20,
                             outliers=4)
    img = render_scene_image(scene, size=320)
    rgb = np.stack([img] * 3, axis=-1).astype(np.uint8)
    want = jcompat.create_data_dict_single(rgb, cnn_input_size=250)
    got = tcompat.create_data_dict_single(rgb, cnn_input_size=250,
                                          device="cpu")
    assert got["sphere_image"].shape == (250, 250)
    assert got["sphere_image"].dtype == np.uint8
    d = np.abs(got["sphere_image"].astype(int) - want["sphere_image"])
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3  # the renderer's gate
    dj, dt = want["lines"], got["lines"]
    assert list(dt) == list(dj) and dt["image_shape"] == (320, 320)
    np.testing.assert_array_equal(dt["line_segments"], dj["line_segments"])
    np.testing.assert_array_equal(dt["lines"], dj["lines"])
    np.testing.assert_array_equal(dt["image"], rgb)


def _lines_of(scene) -> np.ndarray:
    seg = scene.segments
    ones = np.ones((seg.shape[0], 1))
    return np.cross(np.concatenate([seg[:, 0:2], ones], axis=1),
                    np.concatenate([seg[:, 2:4], ones], axis=1))


def test_renew_cnn_result_matches_jax():
    scene = synth.make_scene(np.random.default_rng(6), lines_per_vp=15,
                             outliers=2)
    jp, tp = _params(250)
    mean = np.zeros((250, 250), np.float32)
    img_j, pred_j = jcompat.renew_cnn_result(jp, mean, _lines_of(scene),
                                             image_size=250)
    img_t, pred_t = tcompat.renew_cnn_result(tp, mean, _lines_of(scene),
                                             image_size=250, device="cpu")
    assert img_t.shape == (250, 250) and img_t.dtype == np.uint8
    assert pred_t.shape == (20, 20) and pred_t.dtype == np.float32
    d = np.abs(img_t.astype(int) - img_j)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    np.testing.assert_allclose(pred_t, pred_j, atol=1e-4)  # the CNN's gate


def test_save_cnn_result_roundtrip_matches_jax(tmp_path):
    scene = synth.make_scene(np.random.default_rng(5), lines_per_vp=15,
                             outliers=2)
    jp, tp = _params(250)
    mean = np.zeros((250, 250), np.float32)
    dj, dt = ({"line_segments": scene.segments} for _ in range(2))
    pj = jcompat.save_cnn_result(jp, mean, dj, str(tmp_path / "j" / "i.jpg")
                                 if (tmp_path / "j").mkdir() is None else "",
                                 sphere_size=250, n_pad=128)
    pt = tcompat.save_cnn_result(tp, mean, dt, str(tmp_path / "img.jpg"),
                                 sphere_size=250, n_pad=128, device="cpu")
    assert pt.endswith("img.cnn_result.npz") and pj.endswith("i.cnn_result.npz")
    assert dt["prediction"].shape == (20, 20)
    back, back_j = np.load(pt), np.load(pj)
    assert sorted(back.files) == sorted(back_j.files)
    np.testing.assert_array_equal(back["prediction"], dt["prediction"])
    np.testing.assert_array_equal(back["line_segments"], scene.segments)
    np.testing.assert_allclose(dt["prediction"], dj["prediction"], atol=1e-4)


# --------------------------------------------------------- single functions

def test_num_combo3_and_vp_in_image():
    for n in range(0, 25):
        assert thorizon.num_combo3(n) == jhorizon.num_combo3(n) \
            == math.comb(n, 3)
    for vp in ([0.5, 0.5, 1.0], [3.0, 0.0, 1.0], [2.0, 2.0, 2.0],
               [1.0, -1.0, 1.0], [0.0, 1.0001, 1.0]):
        assert thorizon.vp_in_image(np.array(vp)) \
            == jhorizon.vp_in_image(np.array(vp))


def _vps_and_segments(seed: int, m: int = 5, n: int = 40):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(m, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    lp = rng.uniform(-1, 1, size=(n, 4)).astype(np.float32)
    return v, lp


def test_area_measures_match_jax():
    v, lp = _vps_and_segments(0)
    want = np.asarray(jprob.calc_lvsq_area(jnp.asarray(v), jnp.asarray(lp)))
    got = tprob.calc_lvsq_area(torch.from_numpy(v)[None],
                               torch.from_numpy(lp)[None])[0].numpy()
    assert got.shape == (40, 5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4,
                               equal_nan=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    want1 = np.asarray(jprob.calc_lvsq_area_single(
        jnp.asarray(v[:, None]), jnp.asarray(lp[None])))
    got1 = tprob.calc_lvsq_area_single(torch.from_numpy(v[:, None]),
                                       torch.from_numpy(lp[None])).numpy()
    np.testing.assert_allclose(got1, want1, atol=ATOL, rtol=1e-4,
                               equal_nan=True)
    np.testing.assert_allclose(got1.T, got, atol=ATOL, rtol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("n,wrap_quirk", [(10, True), (50, True),
                                          (25, False)])
def test_pdf_grid_matches_jax(n, wrap_quirk):
    resp = np.random.default_rng(0).uniform(size=(2, 20, 20)).astype(
        np.float32)
    got = tprob.pdf_grid(torch.from_numpy(resp), n=n, wrap_quirk=wrap_quirk)
    assert got["p"].shape == (2, n, n) and bool((got["p"] >= 0).all())
    for b in range(2):
        want = jprob.pdf_grid(jnp.asarray(resp[b]), n=n,
                              wrap_quirk=wrap_quirk)
        for k in ("X", "Y"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=ATOL)
        np.testing.assert_allclose(got["p"][b].numpy(), np.asarray(want["p"]),
                                   atol=ATOL, rtol=1e-5)


def test_vp_line_triangles_and_within_image_match_jax():
    v, lp = _vps_and_segments(2)
    for vp in list(v) + [np.array([2.0, 0.0, 1.0], np.float32)]:
        want = np.asarray(jprob.calc_vp_line_triangles(jnp.asarray(vp),
                                                       jnp.asarray(lp)))
        got = tprob.calc_vp_line_triangles(torch.from_numpy(vp),
                                           torch.from_numpy(lp)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
    pts = np.array([[0.0, 0.0, 1.0, 0.0], [0.0, 0.5, 0.0, -0.5]], np.float32)
    out = tprob.calc_vp_line_triangles(
        torch.tensor([2.0, 0.0, 1.0]), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out[0], -1.0, atol=ATOL)
    batched = tprob.calc_vp_line_triangles(torch.from_numpy(v),
                                           torch.from_numpy(lp)[None])
    assert batched.shape == (5, 40)
    probes = np.array([[1.5, 0, 1], [2.5, 0, 1], [0, -1.9, 1], [4, 4, 2.1],
                       [1, 1, -0.4]], np.float32)
    np.testing.assert_array_equal(
        tprob.vp_is_within_image(torch.from_numpy(probes)).numpy(),
        np.asarray(jprob.vp_is_within_image(jnp.asarray(probes))))


def test_segments_image_matches_jax():
    rng = np.random.default_rng(0)
    lp = rng.uniform(-1, 1, size=(2, 11, 4)).astype(np.float32)
    lp[0, 0] = [-0.5, 0.0, 0.5, 0.0]
    lp[1, 3, 2:] = lp[1, 3, :2]  # a zero-length segment
    mask = rng.uniform(size=(2, 11)) < 0.8
    mask[0, 0] = True
    got = tsphere.segments_image(torch.from_numpy(lp),
                                 torch.from_numpy(mask), size=100).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 100, 100)
    for b in range(2):
        want = np.asarray(jsphere.segments_image(
            jnp.asarray(lp[b]), jnp.asarray(mask[b]), size=100))
        # floor(coverage * 255) of float32 coverages equal to 1e-6
        assert np.abs(got[b].astype(int) - want).max() <= 1
        assert (got[b] != want).mean() <= 1e-3
    one = tsphere.segments_image(torch.from_numpy(lp[:1, :1]),
                                 torch.ones((1, 1), dtype=torch.bool),
                                 size=100)[0].numpy()
    assert one[49:51, 30:70].max() >= 120 and one[10].max() == 0


def test_save_sphere_image_writes_the_rendered_png(tmp_path):
    scene = synth.make_scene(np.random.default_rng(7), lines_per_vp=12,
                             outliers=3)
    l = torch.from_numpy(scene.lines.astype(np.float32))
    mask = torch.ones(l.shape[0], dtype=torch.bool)
    pt, pj = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tsphere.save_sphere_image(l, mask, pt, size=120)
    jsphere.save_sphere_image(jnp.asarray(scene.lines, jnp.float32),
                              jnp.ones(l.shape[0], bool), pj, size=120)
    got, want = np.asarray(Image.open(pt)), np.asarray(Image.open(pj))
    assert got.dtype == np.uint8 and got.shape == (120, 120)
    np.testing.assert_array_equal(got, tsphere.sphere_image_uint8(
        l[None], mask[None], size=120, alpha=0.5)[0].numpy())
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_triplet_score_margin_matches_jax():
    rng = np.random.default_rng(0)
    for seed in range(4):
        scene = synth.make_scene(np.random.default_rng(seed))
        extra = rng.normal(size=(5, 3))
        extra[:, 2] = np.abs(extra[:, 2])
        vps = np.zeros((12, 3), np.float32)
        vps[:8] = np.concatenate([scene.vps, extra])
        vps[:8] /= np.linalg.norm(vps[:8], axis=1, keepdims=True)
        counts = np.zeros(12, np.float32)
        counts[:8] = rng.integers(3, 60, size=8)
        alive = np.arange(12) < 8
        for tol in (float("inf"), 8.0):
            want = jhorizon.triplet_score_margin(
                jnp.asarray(vps), jnp.asarray(counts), jnp.asarray(alive),
                pos_gate_ideal_tol=tol)
            got = thorizon.triplet_score_margin(
                torch.from_numpy(vps)[None], torch.from_numpy(counts)[None],
                torch.from_numpy(alive)[None], pos_gate_ideal_tol=tol)
            for a, b in zip(got, want):
                assert a.shape == (1,)
                np.testing.assert_allclose(a[0].numpy(), np.asarray(b),
                                           atol=1e-5, rtol=1e-5)


def test_ccl_fixpoint_residual_matches_jax():
    """On the detector's own labels the residual is 0 in both packages;
    on labels cut short (2 passes on a zigzag) both count the same
    pixels."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(2, 40, 56)).astype(np.float32)
    img[:, 10:30, 20:24] = 20.0
    cos_tol = math.cos(math.radians(tld.TOL_DEG))
    _, active, ux, uy = tld.gradient_front(torch.from_numpy(img))
    packed = tld.pack_edge_masks(active, ux, uy, cos_tol)
    for passes in (8, 2):
        lab = tld.connected_components(packed, passes)
        got = tld.ccl_fixpoint_residual(packed, lab).numpy()
        assert got.shape == (2,)
        for b in range(2):
            want = jld.ccl_fixpoint_residual(
                jnp.asarray(active[b].numpy()), jnp.asarray(ux[b].numpy()),
                jnp.asarray(uy[b].numpy()), cos_tol,
                jnp.asarray(lab[b].numpy()))
            assert got[b] == int(want)
    own = torch.arange(39 * 55, dtype=torch.int32).reshape(1, -1).repeat(2, 1)
    assert bool((tld.ccl_fixpoint_residual(packed, own) > 0).all())
    assert bool((tld.ccl_fixpoint_residual(
        packed, tld.connected_components(packed, 64)) == 0).all())
