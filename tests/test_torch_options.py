"""The JAX package's non-default detector and EM configurations on the port,
against the JAX functions on the same numpy inputs.

Detector variants (selections, prefilter caps, the approximate top-k,
``tol_deg``, ``blur_sigma``, ``pair_tol_factor``, ``ccl_passes`` with
``check_fixpoint``) are held at the segment level of
``tests/test_torch_detector.py`` (valid counts within 1, every matched
segment within 1e-3 normalized units) to the JAX detector's outputs on the
same 160x160 scenes, committed in ``assets/examples/jax_reference_options.npz``
(``scripts/make_jax_reference_options.py``; one XLA compile per variant
would cost ~4 s here, so the slow test checks that the file is current).
``EMConfig(loop="phase")`` is held bit-identical to the port's uniform
loop, and to JAX's phase loop, run here, at the trajectory gates of
``tests/test_torch_em.py``."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_detector import _images, _match
from test_torch_em import CASES, _assert_em_close, _scene
from vanishing_points_2017_tpu import pipeline as jpipe
from vanishing_points_2017_tpu.em import (expectation_maximisation,
                                          calculate_horizon_and_ortho_vp)
from vanishing_points_2017_tpu_torch import bench
from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch.em import em as tem
from vanishing_points_2017_tpu_torch.em import horizon as thz
from vanishing_points_2017_tpu_torch.ops import lines_device as tld

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "make_jax_reference_options.py")
REF = os.path.join(ROOT, "assets", "examples", "jax_reference_options.npz")


def _load_script():
    spec = importlib.util.spec_from_file_location("make_ref_options", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OPTIONS = _load_script()
SIZE, SEEDS = OPTIONS.SMALL_SIZE, OPTIONS.SMALL_SEEDS
MAX_SEGMENTS = OPTIONS.SLOTS["small"]
GLOBAL = OPTIONS.GLOBAL
VARIANTS = {k: v for k, v in OPTIONS.VARIANTS.items() if k != "global"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's EM and CPU detector here are thousands of small ops.
    Under the suite's parallel workers, each with PyTorch's full thread
    pool, the pools' waits multiply their time (one case ran 270x its
    single-process time); one thread keeps each at its own cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


@pytest.fixture(scope="module")
def images(ref):
    imgs = _images(SIZE, SEEDS)
    assert OPTIONS.sha256(imgs) == str(ref["small_images_sha256"])
    return imgs


@pytest.fixture(scope="module")
def port(images):
    """The port's detector under a variant's arguments, each run once."""
    seen = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in seen:
            seg, mask = tld.detect_segments_device(
                torch.from_numpy(images), max_segments=MAX_SEGMENTS, **kw)
            seen[key] = seg.numpy(), mask.numpy()
        return seen[key]
    return run


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_detector_variant_matches_jax(name, images, port, ref):
    seg, mask = port(**VARIANTS[name])
    js, jm = ref[f"small_{name}_segments"], ref[f"small_{name}_mask"]
    poisoned = 0
    for i in range(images.shape[0]):
        # without the blur the scenes' pixel noise leaves a few segments
        assert jm[i].sum() > (0 if name == "blur0" else 10)
        assert abs(int(jm[i].sum()) - int(mask[i].sum())) <= 1
        # NaN (check_fixpoint) on every valid segment of the same images
        jnan = np.isnan(js[i][jm[i]]).any(axis=1)
        tnan = np.isnan(seg[i][mask[i]]).any(axis=1)
        assert jnan.all() == tnan.all() and jnan.any() == tnan.any()
        if jnan.all():
            poisoned += 1
            continue
        assert _match(js[i][jm[i]], seg[i][mask[i]]) < 1e-3
        assert _match(seg[i][mask[i]], js[i][jm[i]]) < 1e-3
        assert np.all(seg[i][~mask[i]] == 0)
    if name == "passes2_fixpoint":
        # two passes leave labels to spread on these scenes, in JAX too
        assert poisoned > 0


@pytest.mark.slow
def test_committed_options_reference_is_current(ref):
    """Regenerates the oracle with the JAX package and checks the
    committed file still holds it."""
    fresh = OPTIONS.reference_outputs()
    assert sorted(fresh) == sorted(ref)
    for k, v in fresh.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_selections_agree_and_binding_knobs_are_live(port):
    """No row of these scenes holds more than 64 runs or 3w/10 candidates,
    so every unbound selection keeps the global selection's records and,
    through the canonical sort, its bits (JAX's own assertion); a binding
    per-row budget or prefilter cap drops records and moves the result;
    ``"approx"`` is the one-stage exact top-k."""
    base = port(**GLOBAL)
    for kw in (VARIANTS["row"], VARIANTS["prefilter0"], VARIANTS["approx"],
               dict(GLOBAL, check_fixpoint=True)):
        for a, b in zip(port(**kw), base):
            np.testing.assert_array_equal(a, b)
    for kw in (VARIANTS["row_rpr8"], VARIANTS["prefilter1"]):
        assert not all(np.array_equal(a, b) for a, b in zip(port(**kw), base))


def test_unknown_selection_and_topk_raise():
    img = torch.zeros((1, 32, 32))
    with pytest.raises(ValueError, match="unknown selection"):
        tld.detect_segments_device(img, max_segments=8, selection="rows")
    with pytest.raises(ValueError, match="unknown topk_impl"):
        tld.detect_segments_device(img, max_segments=8, selection="global",
                                   topk_impl="fast")
    with pytest.raises(ValueError, match="det_selection"):
        tpipe.PipelineConfig(det_selection="rows")
    with pytest.raises(ValueError, match="det_topk"):
        tpipe.PipelineConfig(det_topk="fast")


DET_FIELDS = [("det_selection", "row"), ("det_topk", "approx"),
              ("det_min_count", 20), ("det_min_len_px", 15.0),
              ("det_min_density", 0.0), ("det_max_records", 16384)]


@pytest.mark.parametrize("field,val", DET_FIELDS)
def test_det_key_is_jax_key_with_torch_tag(field, val):
    """The JAX package's key with its CCL part dropped and a ``torch`` tag:
    it changes with every detector field, not with the EM's, and the
    default configuration keeps the key it had."""
    base = tpipe.PipelineConfig()
    assert base.det_key() == "detglobal15-12-0.7-32768-torch"
    cfg = dataclasses.replace(base, **{field: val})
    assert cfg.det_key() != base.det_key()
    jcfg = dataclasses.replace(jpipe.PipelineConfig(det_topk="exact"),
                               **{field: val})
    jkey = jcfg.det_key().replace("-xla", "")
    assert cfg.det_key() == jkey + "-torch"
    em = dataclasses.replace(cfg, em=tem.EMConfig(loop="phase",
                                                  split_merge_freq=3))
    assert em.det_key() == cfg.det_key()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("selection,topk", [("global", "exact"),
                                            ("row", "approx")])
def test_callers_pass_the_config_selection(monkeypatch, selection, topk):
    """Every caller that detects on a configuration's behalf passes its
    selection and top-k (``chip_smoke.py``'s K2 input too): the
    detector's own default is the row selection, so a caller that forgot
    would switch the main path silently."""
    import chip_smoke
    import vanishing_points_2017_tpu_torch
    from vanishing_points_2017_tpu_torch.tools import (eval_device_detector,
                                                       perturb_knife_edge,
                                                       profile_e2e)

    seen = []

    def record(*args, **kw):
        seen.append((kw["selection"], kw["topk_impl"]))
        raise _Stop

    monkeypatch.setattr(tld, "_component_stats", record)
    cfg = tpipe.PipelineConfig(det_selection=selection, det_topk=topk)
    imgs = torch.zeros((1, 24, 24), dtype=torch.uint8)
    imgs[:, 8:16, 8:16] = 255

    class Pipe:
        device = torch.device("cpu")
        model = mean = None

    Pipe.cfg = cfg
    monkeypatch.setattr(profile_e2e, "make_pipeline", lambda dev: Pipe)
    calls = [
        lambda: tpipe.device_pipeline_full(imgs, None, None, cfg),
        lambda: bench.stage_pass(imgs, None, torch.zeros(1), cfg),
        lambda: eval_device_detector.ideal_batch(imgs, None, cfg),
        lambda: perturb_knife_edge.detect_device(Pipe, cfg, imgs[0].numpy()),
        lambda: profile_e2e.measure(Pipe.device, batches=(1,), iters=1,
                                    size=32),
        lambda: chip_smoke.detected_lines(vanishing_points_2017_tpu_torch,
                                          imgs, cfg),
    ]
    for call in calls:
        with pytest.raises(_Stop):
            call()
    assert seen == [(selection, topk)] * len(calls)


def _noisy(n):
    return [_scene(seed=s, noise=0.02, outliers=20, lines_per_vp=30)
            for s in range(n)]


def _stack(scenes):
    return [torch.from_numpy(np.stack([s[k] for s in scenes]))
            for k in range(5)]


@pytest.mark.parametrize("batch,freq,max_reads", [(6, 10, 7), (6, 3, 182)])
def test_phase_loop_is_bit_identical_to_uniform(batch, freq, max_reads):
    """Same batch, same outputs to the bit, and the trips' plain bodies
    read nothing back (the uniform loop reads 34 times at freq 10)."""
    args = _stack(_noisy(batch))
    out, reads = {}, {}
    for loop in ("uniform", "phase"):
        cfg = tem.EMConfig(split_merge_freq=freq, loop=loop)
        with bench.host_reads(torch.device("cpu")) as n:
            out[loop] = tem.expectation_maximisation(*args, cfg)
        reads[loop] = n["n"]
    same = dict(rtol=0, atol=0, equal_nan=True)
    for a, b in zip(out["uniform"], out["phase"]):
        torch.testing.assert_close(a, b, **same)
    hz = [thz.calculate_horizon_and_ortho_vp(o.vp, o.counts, o.alive)
          for o in out.values()]
    for a, b in zip(*hz):
        torch.testing.assert_close(a, b, **same)
    assert reads["phase"] <= max_reads < reads["uniform"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_loop_matches_jax_phase_loop(case):
    """The port's phase loop at batch 1 against JAX's ``loop="phase"``:
    the trajectory gates, the same triplet, horizons within 1e-4."""
    jcfg, tcfg, kws = CASES[case]
    jcfg = dataclasses.replace(jcfg, loop="phase")
    tcfg = dataclasses.replace(tcfg, loop="phase")
    for kw in kws:
        s = _scene(**kw)
        got = tem.expectation_maximisation(*_stack([s]), tcfg)
        ref = expectation_maximisation(*[jnp.asarray(x) for x in s], jcfg)
        _assert_em_close(got, 0, ref)
        hz = thz.calculate_horizon_and_ortho_vp(
            got.vp, got.counts, got.alive, pos_gate_ideal_tol=8.0)
        rh = calculate_horizon_and_ortho_vp(ref.vp, ref.counts, ref.alive,
                                            pos_gate_ideal_tol=8.0)
        np.testing.assert_array_equal(hz[5][0].numpy(), np.asarray(rh[5]))
        for k in (0, 1):
            np.testing.assert_allclose(hz[k][0].numpy(), np.asarray(rh[k]),
                                       atol=1e-4)


def test_unknown_loop_raises():
    with pytest.raises(ValueError, match="'uniform' or 'phase'"):
        tem.EMConfig(loop="bogus")
