"""The port's training drivers (``python -m
vanishing_points_2017_tpu_torch.train_cnn`` / ``.compress_weights``) on
the CPU, and the committed JAX training reference that ``chip_smoke.py``
holds the port against on the GPU."""

import glob
import os

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu import weights as jweights
from vanishing_points_2017_tpu_torch import compress_weights, train_cnn
from vanishing_points_2017_tpu_torch import weights as tweights
from vanishing_points_2017_tpu_torch.models import cnn as tcnn
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assets_mtimes():
    return {p: os.stat(p).st_mtime_ns
            for p in glob.glob(os.path.join(ROOT, "assets", "**"),
                               recursive=True)}


def _dense_npz(path, fc_width=32, step=None):
    """A dense full-input network with narrow fc6/fc7 (fc6 57600 x
    ``fc_width``), written by the port."""
    params = tweights.params_from_numpy(
        tcnn.init_params(1, fc_width=fc_width))
    tweights.params_to_npz(params, str(path), step=step)


def test_train_cnn_resume_snapshots_and_mean(tmp_path, capsys):
    """train_cnn on the CPU: the mean is estimated into --mean_out, each
    --snapshot writes --out with __step__, a run resumed from it starts at
    its step, and nothing under assets/ changes. A fresh start builds the
    dense 4096-wide network (~1 GB), so here the runs resume from a narrow
    one."""
    before = _assets_mtimes()
    start, out, mean = (tmp_path / "start.npz", tmp_path / "w.npz",
                        tmp_path / "m.npy")
    _dense_npz(start, step=0)
    common = ["--device", "cpu", "--batch", "2", "--mean_samples", "2",
              "--display", "1", "--out", str(out), "--mean_out", str(mean)]
    assert train_cnn.main(common + ["--steps", "2", "--snapshot", "1",
                                    "--resume", str(start)]) == 0
    log = capsys.readouterr().out
    assert "estimating mean image" in log
    assert "step 1  loss" in log and "step 2  loss" in log
    assert log.count("snapshot ->") == 2
    # the last line counts K2's launches: none here, the twin renders
    assert log.splitlines()[-1] == "done at step 2; sphere kernel launches: 0"
    m = np.load(mean)
    assert m.shape == (500, 500) and m.dtype == np.float32
    assert 0 < m.max() <= 255
    params, step = jweights.params_from_npz(str(out), with_step=True)
    assert step == 2 and params["fc6"]["w"].shape == (57600, 32)

    assert train_cnn.main(common + ["--steps", "3", "--resume",
                                    str(out)]) == 0
    log = capsys.readouterr().out
    assert "estimating" not in log and "step 2  loss" not in log
    assert "step 3  loss" in log and "lr 1.00e-04" in log
    assert log.splitlines()[-1] == "done at step 3; sphere kernel launches: 0"
    assert jweights.params_from_npz(str(out), with_step=True)[1] == 3
    assert _assets_mtimes() == before


def test_compress_weights_factorizes_and_fine_tunes(tmp_path, capsys):
    """compress_weights on the CPU: rank-8 fc6/fc7 from a dense file, two
    fine-tune steps, float16 storage that both packages load; nothing
    under assets/ changes."""
    before = _assets_mtimes()
    dense, out = tmp_path / "dense.npz", tmp_path / "c.npz"
    _dense_npz(dense)
    assert compress_weights.main([
        "--weights", str(dense), "--out", str(out), "--rank6", "8",
        "--rank7", "8", "--steps", "2", "--batch", "2",
        "--device", "cpu"]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith(f"wrote {out}")
    assert last.endswith("; sphere kernel launches: 0")
    with np.load(out) as z:
        assert z["fc6/u"].shape == (57600, 8) and z["fc7/v"].shape == (8, 32)
        assert z["conv1/w"].dtype == np.float16
        assert "__step__" not in z.files
    params, mean = tweights.load_params_and_mean(str(out), device="cpu")
    assert set(params["fc6"]) == {"u", "v", "b"}
    jparams = jweights.params_from_npz(str(out), as_numpy=True)
    back = tweights.params_to_numpy(params)
    for layer, d in jparams.items():
        for k, v in d.items():
            np.testing.assert_array_equal(back[layer][k], v)
    assert _assets_mtimes() == before


@pytest.mark.parametrize("driver", [train_cnn, compress_weights],
                         ids=["train_cnn", "compress_weights"])
def test_drivers_default_to_the_gpu(driver, tmp_path):
    """Without --device the drivers run on the GPU; without one they
    raise before reading or writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the drivers")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        driver.main(["--out", str(tmp_path / "x.npz")])
    assert not os.listdir(tmp_path)


@pytest.mark.slow
def test_committed_train_reference_is_current():
    """Regenerates assets/examples/jax_reference_train.npz with the JAX
    package and checks the committed file still holds it: batch, labels
    and masks exactly, losses and updates at rtol 1e-5."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_ref_train", os.path.join(ROOT, "scripts",
                                       "make_jax_reference_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.reference()
    with np.load(mod.DEFAULT_OUT) as z:
        assert sorted(z.files) == sorted(fresh)
        for key in ("images", "labels", "keep"):
            np.testing.assert_array_equal(z[key], fresh[key], key)
        for key in fresh:
            np.testing.assert_allclose(z[key], fresh[key], rtol=1e-5,
                                       atol=1e-9, err_msg=key)
