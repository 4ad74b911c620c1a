"""The port's data-set adapters, miniset generators and benchmark driver on
the real data sets' formats, against the JAX package's.

The adapters of both packages read minis written by the JAX generators
(PIL's JPEG files): equal names, order, skip counts and ground-truth
horizons (rtol 1e-12). The port's generators give the JAX generators'
ground truth and, through the port's own drawing and JPEG writer, the same
image files byte for byte. The driver test runs both ``benchmark --hlw``
drivers on one 3-image mini on the CPU with the shipped weights.
"""

import contextlib
import csv
import hashlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import scipy.io as sio

from vanishing_points_2017_tpu.data import datasets as jds
from vanishing_points_2017_tpu.data import minisets as jmini
from vanishing_points_2017_tpu_torch import benchmark as tbench
from vanishing_points_2017_tpu_torch.data import datasets as tds
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data import minisets as tmini
from vanishing_points_2017_tpu_torch.models import synth
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the host-path gate of tests/test_torch_host_pipeline.py: normalized
# horizon error between the two packages' horizons
HORIZON_GATE = 1e-3
GOLDEN = {"yud": 0.9750, "ecd": 0.9695, "hlw": 0.9461}  # test_minisets.py
SIZES = {"yud": (640, 480), "ecd": (1024, 768), "hlw": (900, 600)}
N_EVAL = {"yud": 1, "ecd": 1, "hlw": 3}


def _files(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def minis(tmp_path_factory):
    """{set: (JAX-written dir, port-written dir)}, same seeds."""
    base = tmp_path_factory.mktemp("minis")
    out = {}
    for name, n in N_EVAL.items():
        dj, dt = str(base / f"j{name}"), str(base / f"t{name}")
        sj = getattr(jmini, f"make_mini_{name}")(dj, n_eval=n)
        st = getattr(tmini, f"make_mini_{name}")(dt, n_eval=n)
        assert len(sj) == len(st)
        out[name] = (dj, dt)
    return out


@pytest.mark.parametrize("name", ["yud", "ecd", "hlw"])
def test_adapters_match_jax(minis, name):
    root = minis[name][0]
    rj, start_j = getattr(jds, f"{name}_records")(root)
    rt, start_t = getattr(tds, f"{name}_records")(root)
    assert start_t == start_j == (0 if name == "hlw" else 25)
    assert len(rt) == len(rj) == start_j + N_EVAL[name]
    assert [r.name for r in rt] == [r.name for r in rj]
    assert [r.image_path for r in rt] == [r.image_path for r in rj]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.true_horizon, b.true_horizon,
                                   rtol=1e-12)
    table_name = {"yud": "york", "ecd": "eurasian", "hlw": "horizon"}[name]
    assert tds.DATASETS[table_name][1] == jds.DATASETS[table_name][1]
    assert tds.DATASETS[table_name][0] is getattr(tds, f"{name}_records")


@pytest.mark.parametrize("name", ["yud", "ecd", "hlw"])
def test_port_minis_equal_jax_minis(minis, name):
    """Same seed: the same ground truth (.mat arrays, .csv and split text)
    and the same JPEG bytes, whichever package wrote the mini."""
    fj, ft = _files(minis[name][0]), _files(minis[name][1])
    assert sorted(fj) == sorted(ft)
    for rel in fj:
        if rel.endswith(".mat"):  # the header carries the creation time
            mj = sio.loadmat(os.path.join(minis[name][0], rel))
            mt = sio.loadmat(os.path.join(minis[name][1], rel))
            keys = [k for k in mj if not k.startswith("__")]
            assert keys == [k for k in mt if not k.startswith("__")]
            for k in keys:
                np.testing.assert_array_equal(mt[k], mj[k], err_msg=rel)
        else:
            assert ft[rel] == fj[rel], rel


@pytest.mark.parametrize("name", ["yud", "ecd", "hlw"])
def test_render_scene_image_wh_equals_jax(name):
    width, height = SIZES[name]
    for seed in (0, 1):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        scene = synth.make_scene(np.random.default_rng(10 + seed),
                                 lines_per_vp=40, outliers=12)
        want = jmini.render_scene_image_wh(scene, width, height, rng=rj)
        got = tds.render_scene_image_wh(scene, width, height, rng=rt)
        assert got.shape == (height, width)
        np.testing.assert_array_equal(got, want)
        assert rj.integers(1 << 30) == rt.integers(1 << 30)
    np.testing.assert_array_equal(
        tds.render_scene_image_wh(scene, width, height),
        jmini.render_scene_image_wh(scene, width, height))


def test_horizon_from_points_and_ecd_size_from_header(minis):
    p1, p2 = np.array([1.0, 2.0, 1.0]), np.array([-1.0, 0.5, 1.0])
    np.testing.assert_array_equal(tds.horizon_from_points(p1, p2),
                                  jds.horizon_from_points(p1, p2))
    path = os.path.join(minis["ecd"][0], "0001.jpg")
    assert tio.image_size(path) == (768, 1024)


@pytest.mark.parametrize("dataset_name", ["york", "eurasian", "horizon",
                                          None])
def test_get_data_list_matches_jax(minis, tmp_path, dataset_name):
    src = {"york": "yud", "eurasian": "ecd", "horizon": "hlw"}.get(
        dataset_name)
    source = minis[src][0] if src else str(tmp_path / "src")
    if src is None:
        os.makedirs(source)
        for f in ("b.jpg", "a.png", "c.txt"):
            open(os.path.join(source, f), "wb").close()
    dj, dt = tmp_path / "dj", tmp_path / "dt"
    dj.mkdir(), dt.mkdir()
    kw = dict(dataset_name=dataset_name, do_split=False, update=True)
    mj = jds.get_data_list(source, str(dj), "net", **kw)
    mt = tds.get_data_list(source, str(dt), "net", **kw)
    assert mt["name"] == mj["name"] == "net_angle_weights_nosplit_merge"
    assert mt["image_files"] == mj["image_files"] and mt["image_files"]
    for k in mj:
        if k not in ("destination_folder", "cache_files"):
            assert mt[k] == mj[k], k
    assert ([os.path.basename(f) for f in mt["cache_files"]]
            == [os.path.basename(f) for f in mj["cache_files"]])
    with open(dj / "net_angle_weights_nosplit_merge.json") as fj, \
            open(dt / "net_angle_weights_nosplit_merge.json") as ft:
        assert ft.read() == fj.read().replace(str(dj), str(dt))
    # the kept manifest is reused
    assert tds.get_data_list(source, str(dt), "net", dataset_name=dataset_name,
                             do_split=False) == mt


# ------------------------------------------------------------------ driver

def _run_torch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tbench.main(argv + ["--device", "cpu"])
    out = buf.getvalue()
    assert rc == 0, out
    return out


def _run_jax(argv):
    import benchmark  # the root driver of the JAX package

    old, sys.argv = sys.argv, ["benchmark.py"] + argv + ["--no_weights_warn"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = benchmark.main()
    finally:
        sys.argv = old
    assert rc == 0, buf.getvalue()
    return buf.getvalue()


def _auc(out: str) -> float:
    return float([ln for ln in out.splitlines()
                  if ln.startswith("AUC:")][-1].split()[-1])


def _torch_cache(result_dir, name, device_detect=False):
    from vanishing_points_2017_tpu_torch import weights as tw
    from vanishing_points_2017_tpu_torch.data.cache import StageCache
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    cache = StageCache(os.path.join(result_dir, name),
                       tbench.cache_key(PipelineConfig(), device_detect))
    return cache, "result_w" + tw.weights_identity() + "_m" + tw.mean_identity()


def _jax_cache(result_dir, name):
    from vanishing_points_2017_tpu import weights as jw
    from vanishing_points_2017_tpu.data.cache import StageCache
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    cache = StageCache(os.path.join(result_dir, name),
                       PipelineConfig().cache_key())
    return cache, "result_w" + jw.weights_identity() + "_m" + jw.mean_identity()


def test_benchmark_hlw_matches_jax_driver(minis, tmp_path):
    """Both drivers on the JAX-written 3-image HLW mini (900x600 JPEG ->
    resize to 800 -> LSD -> device stage) on the CPU: 3 ``max_error``
    lines each, every horizon within the host-path gate of the JAX
    driver's, the CDF plot written."""
    root = minis["hlw"][0]
    rt, rj = str(tmp_path / "t"), str(tmp_path / "j")
    argv = ["--hlw", "--dataset_dir", root, "--run_em", "--batch", "3"]
    out_t = _run_torch(argv + ["--result_dir", rt])
    out_j = _run_jax(argv + ["--result_dir", rj])
    assert out_t.count("max_error:") == out_j.count("max_error:") == 3
    assert "dataset: horizon  images: 3  skip: 0" in out_t
    assert "device stage: 3 imgs" in out_t
    assert abs(_auc(out_t) - _auc(out_j)) < 1e-3
    assert os.path.getsize(os.path.join(rt, "auc_horizon.png")) > 0
    ct, st = _torch_cache(rt, "horizon")
    cj, sj = _jax_cache(rj, "horizon")
    records, _ = tds.hlw_records(root)
    for rec in records:
        a, b = ct.load(rec.name, st), cj.load(rec.name, sj)
        shape = ct.load(rec.name, "lines")["image_shape"]
        assert tuple(shape) == (533, 800)
        err = tio.normalized_horizon_error(
            np.cross(a["hp1"].astype(np.float64), a["hp2"].astype(np.float64)),
            np.cross(b["hp1"].astype(np.float64), b["hp2"].astype(np.float64)),
            int(shape[1]), int(shape[0]))
        assert err < HORIZON_GATE, (rec.name, err)


def test_benchmark_dataset_flags():
    """A real data set needs its --dataset_dir; no data set at all is
    refused too."""
    for argv in (["--yud"], ["--ecd", "--run_em"], ["--hlw"], ["--run_em"]):
        with pytest.raises(SystemExit) as exc:
            tbench.main(argv + ["--device", "cpu"])
        assert exc.value.code == 2, argv


def _seed_skips(result_dir, name, records, start, device_detect=False):
    """Placeholder results for the protocol's skipped split, so the device
    stage runs on the evaluated images only (tests/test_minisets.py)."""
    cache, stage = _torch_cache(result_dir, name, device_detect)
    for rec in records[:start]:
        cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))


@pytest.mark.slow
@pytest.mark.parametrize("run", ["yud", "ecd", "hlw", "yud_dev"])
def test_golden_auc_minisets(tmp_path, run):
    """The JAX package's golden-AUC gate (tests/test_minisets.py) on the
    port: 8 evaluated images per format, AUC within 0.02 of the committed
    golden and of the JAX driver's AUC on the same files
    (assets/examples/jax_reference_minisets.npz); 25 records skipped on
    YUD and ECD; YUD also through the on-device detector."""
    name = run.split("_")[0]
    table = {"yud": "york", "ecd": "eurasian", "hlw": "horizon"}[name]
    detect = run.endswith("_dev")
    root, res = str(tmp_path / name), str(tmp_path / "results")
    getattr(tmini, f"make_mini_{name}")(root, n_eval=8)
    records, start = tds.DATASETS[table][0](root)
    _seed_skips(res, table, records, start, detect)
    out = _run_torch([f"--{name}", "--dataset_dir", root, "--result_dir", res,
                      "--run_em", "--batch", "4"]
                     + (["--device_detect"] if detect else []))
    assert out.count("max_error:") == 8, out
    assert f"skip: {start}" in out and "device stage: 8 imgs" in out, out
    ref = np.load(os.path.join(ROOT, "assets", "examples",
                               "jax_reference_minisets.npz"))
    assert abs(_auc(out) - GOLDEN[name]) < 0.02, out
    assert abs(_auc(out) - float(ref[f"auc_{run}"])) < 0.02, out


@pytest.mark.slow
def test_committed_miniset_reference_is_current():
    """Regenerates the HLW part of assets/examples/
    jax_reference_minisets.npz (the port's writer, then the JAX driver)
    and checks that the committed file still holds it; the other data
    sets' digests are checked against freshly written files."""
    spec = importlib.util.spec_from_file_location(
        "make_ref_minisets", os.path.join(
            ROOT, "scripts", "make_jax_reference_minisets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    committed = np.load(mod.DEFAULT_OUT)
    fresh = mod.reference(runs=("hlw",))
    for k, v in fresh.items():
        if v.dtype.kind in "US":
            assert list(v) == list(committed[k]), k
        else:
            np.testing.assert_allclose(v, committed[k], atol=1e-6, err_msg=k)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for name, directory in mod.write_minis(tmp, ("yud", "ecd")).items():
            files, digests = mod.jpeg_hashes(directory)
            assert files == list(committed[f"files_{name}"])
            assert digests == list(committed[f"sha256_{name}"])
