"""The port's small modules on the CPU: ``utils/profiling.py`` against the
JAX package's (tests/test_utils.py's cases through both), ``viz.py``,
``config.py`` and the example driver's ``--show`` on a JPEG input."""

import builtins
import contextlib
import io
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu import config as jconfig
from vanishing_points_2017_tpu import viz as jviz
from vanishing_points_2017_tpu.data.datasets import render_scene_image
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu.utils import profiling as jprof
from vanishing_points_2017_tpu_torch import config as tconfig
from vanishing_points_2017_tpu_torch import example as texample
from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch import viz as tviz
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data import jpeg
from vanishing_points_2017_tpu_torch.models import synth
from vanishing_points_2017_tpu_torch.utils import profiling as tprof
from vanishing_points_2017_tpu_torch.weights import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("prof", [tprof, jprof], ids=["torch", "jax"])
def test_stage_timer_accumulates(prof):
    t = prof.StageTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    t.add("b", 0.25)
    rep = t.report()
    assert list(rep) == ["a", "b"]
    assert rep["a"]["count"] == 2 and rep["b"]["count"] == 2
    assert set(rep["a"]) == {"total_s", "count", "mean_s"}
    assert rep["b"]["total_s"] >= 0.25
    assert rep["b"]["mean_s"] == pytest.approx(rep["b"]["total_s"] / 2,
                                               abs=1e-4)
    assert t.pretty().startswith("stage timings:\n")
    assert prof.StageTimer().pretty() == "no spans"


def test_stage_timer_reports_like_jax():
    """The same spans give the same report keys and the same pretty
    layout in both packages."""
    tt, tj = tprof.StageTimer(), jprof.StageTimer()
    for t in (tt, tj):
        t.add("lsd", 0.5)
        t.add("lsd", 1.5)
        t.add("device", 0.125)
    assert tt.report() == tj.report()
    assert tt.pretty() == tj.pretty()


def test_stage_timer_block_on_takes_nested_cpu_tensors():
    """``block_on`` walks tensors, dicts, lists and tuples; CPU tensors need
    no wait, and a span that raises is still counted."""
    t = tprof.StageTimer()
    out = {"a": torch.zeros(2), "b": [torch.ones(1), (torch.ones(1), 3)]}
    with t.span("stage", block_on=out):
        pass
    with pytest.raises(KeyError):
        with t.span("stage", block_on=None):
            raise KeyError("x")
    assert t.report()["stage"]["count"] == 2
    assert tprof._cuda_devices(out, set()) == set()


def test_trace_noop_and_trace_file(tmp_path):
    with tprof.trace(None):
        x = 1
    with tprof.trace(""):
        x += 1
    assert x == 2 and not list(tmp_path.iterdir())
    log_dir = tmp_path / "traces" / "run"
    with tprof.trace(str(log_dir)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = log_dir / "trace.json"
    assert path.is_file()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_logger_singleton():
    log = tprof.get_logger()
    assert log is tprof.get_logger() and log.name == "vp_torch"
    assert len(log.handlers) == 1 and log.level == logging.INFO
    assert tprof.get_logger("vp_torch.x") is not log


def test_paths_read_the_jax_packages_environment(monkeypatch):
    for var in ("YUD", "ECD", "HLW", "RESULTS", "WEIGHTS", "MEAN"):
        monkeypatch.delenv(f"VP_TPU_{var}", raising=False)
    pt, pj = tconfig.Paths(), jconfig.Paths()
    for field in ("yud", "ecd", "hlw", "weights", "mean"):
        assert getattr(pt, field) == getattr(pj, field), field
    assert pt.result_dir == os.path.join(ROOT, "build", "results")
    for var in ("YUD", "ECD", "HLW", "RESULTS", "WEIGHTS", "MEAN"):
        monkeypatch.setenv(f"VP_TPU_{var}", f"/somewhere/{var.lower()}")
    assert vars(tconfig.Paths()) == vars(jconfig.Paths())
    assert tconfig.Paths().result_dir == "/somewhere/results"
    assert tconfig.EMConfig().distance_measure == "angle"
    assert tconfig.PipelineConfig().sphere_size == 500


def test_angle_to_index_matches_jax():
    angles = np.random.default_rng(0).uniform(-np.pi / 2, np.pi / 2, (9, 2))
    for size in (20, 250, 500):
        # JAX's is float32: a few ulps of 500
        np.testing.assert_allclose(tviz.angle_to_index(angles, size),
                                   np.asarray(jviz._angle_to_index(angles,
                                                                   size)),
                                   rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def small_result():
    """One 320 x 320 synthetic scene through a narrow host-path pipeline
    (sphere 240, random weights) on the CPU."""
    scene = synth.make_scene(np.random.default_rng(0), lines_per_vp=20,
                             outliers=4)
    img = render_scene_image(scene, size=320)
    p = jcnn.init_params(jax.random.PRNGKey(0), input_size=240, fc_width=64)
    npp = {k: {kk: np.asarray(v) for kk, v in d.items()}
           for k, d in p.items()}
    pipe = tpipe.Pipeline(params_from_numpy(npp),
                          torch.zeros((240, 240)),
                          tpipe.PipelineConfig(sphere_size=240),
                          device="cpu")
    return img, pipe.process(img)


def test_show_em_result_writes_figure(tmp_path, small_result):
    img, res = small_result
    out = tmp_path / "result.png"
    tviz.show_em_result(res, img, str(out), maxbest=3,
                        horizon=((0, 100), (320, 110)))
    assert out.is_file() and os.path.getsize(out) > 10_000
    fig = tio.load_image(str(out))  # a PNG the port's own reader takes
    assert fig.ndim == 3 and fig.shape[2] == 3 and fig.shape[1] > fig.shape[0]
    # without a horizon, and with more VPs asked for than are alive
    tviz.show_em_result(res, np.stack([img] * 3, -1), str(out), maxbest=12)
    assert os.path.getsize(out) > 10_000


def test_show_em_result_without_matplotlib_says_so(tmp_path, monkeypatch,
                                                   small_result):
    img, res = small_result
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        tviz.show_em_result(res, img, str(tmp_path / "r.png"))
    assert not (tmp_path / "r.png").exists()


def test_example_image_paths_take_jpeg_and_png(tmp_path):
    for f in ("b.JPG", "a.png", "c.jpeg", "notes.txt"):
        (tmp_path / f).write_bytes(b"")
    got = texample.image_paths([str(tmp_path), "x/y.jpg"])
    assert [os.path.basename(p) for p in got] == ["a.png", "b.JPG", "c.jpeg",
                                                  "y.jpg"]
    assert len(texample.image_paths(None)) == 4


def test_example_show_on_a_jpeg(tmp_path, monkeypatch):
    """The example driver on a bundled scene stored as a JPEG, on the CPU
    with the shipped weights: the horizon is printed and ``--show`` writes
    the figure into the driver's result directory."""
    monkeypatch.setattr(texample, "RESULTS", str(tmp_path / "figs"))
    src = os.path.join(ROOT, "assets", "examples", "scene_0.png")
    img = tio.load_image(src)
    with open(tmp_path / "scene.jpg", "wb") as fh:
        fh.write(jpeg.encode_jpeg(img, quality=95))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = texample.main(["--device", "cpu", "--images",
                            str(tmp_path / "scene.jpg"), "--show"])
    out = buf.getvalue()
    assert rc == 0 and "image file: " in out, out
    assert os.path.getsize(tmp_path / "figs" / "scene.result.png") > 10_000
