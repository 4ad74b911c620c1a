"""Weights loading, artifact fingerprint and the PIL-free PNG reader of the
PyTorch port vs the JAX package."""

import glob
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vanishing_points_2017_tpu import weights as jweights
from vanishing_points_2017_tpu.data import datasets as jdatasets
from vanishing_points_2017_tpu.data import io as jio
from vanishing_points_2017_tpu_torch import pipeline as tpipe
from vanishing_points_2017_tpu_torch import weights as tweights
from vanishing_points_2017_tpu_torch.data import io as tio
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(glob.glob(os.path.join(ROOT, "assets", "examples",
                                       "scene_*.png")))


def test_fingerprint_equals_jax_weights_identity():
    assert tweights.artifact_fingerprint(tweights.default_weights_path()) \
        == jweights.weights_identity()
    assert tweights.artifact_fingerprint(tweights.default_mean_path()) \
        == jweights.mean_identity()
    assert tweights.artifact_fingerprint(None) == "none"


def test_params_from_numpy_round_trip():
    """The shipped artifact through params_from_numpy: convs HWIO -> OIHW,
    factorized fc6/fc7 kept as u/v, every value unchanged."""
    jp = jweights.params_from_npz(tweights.default_weights_path(),
                                  as_numpy=True)
    flat = {f"{k}/{kk}": v for k, d in jp.items() for kk, v in d.items()}
    for src in (jp, flat):
        tp = tweights.params_from_numpy(src)
        assert set(tp) == set(jp)
        for layer, d in jp.items():
            for k, v in d.items():
                got = tp[layer][k].numpy()
                if k == "w" and v.ndim == 4:
                    got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
                np.testing.assert_array_equal(got, v)
    assert "u" in tp["fc6"] and "v" in tp["fc7"]
    params, mean = tweights.load_params_and_mean(device="cpu")
    assert params["conv2"]["w"].shape == (256, 48, 5, 5)
    assert mean.shape == (500, 500) and mean.dtype == torch.float32


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_png_reader_equals_pil(path):
    got = tio.load_image(path)
    np.testing.assert_array_equal(got, jio.load_image(path))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
def test_png_reader_modes_and_filters(mode):
    """PIL's encoder picks filters per row (all five appear on a noisy
    gradient); every colour type the reader accepts decodes exactly."""
    rng = np.random.default_rng(0)
    ch = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2}[mode]
    base = np.linspace(0, 255, 37 * 29 * ch).reshape(37, 29, ch)
    arr = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)
    arr = arr[..., 0] if ch == 1 else arr
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", optimize=True)
    dec = tio.decode_png(buf.getvalue())
    np.testing.assert_array_equal(dec, arr)


def test_rgb2gray_and_horizon_error_match_jax():
    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tio.rgb2gray(rgb), jio.rgb2gray(rgb))
    est = np.array([0.01, 1.0, 0.05])
    true = np.array([-0.02, 1.0, 0.01])
    assert tio.normalized_horizon_error(est, true, 640, 480) == \
        jdatasets.normalized_horizon_error(est, true, 640, 480)



def test_weights_and_mean_identity_equal_jax():
    assert tweights.weights_identity() == jweights.weights_identity()
    assert tweights.mean_identity() == jweights.mean_identity()
    path = tweights.default_mean_path()
    assert tweights.mean_identity(path) == jweights.mean_identity(path)


def test_default_weights_path_prefers_newer_dense(tmp_path, monkeypatch,
                                                  capsys):
    """The JAX package's resolution: a dense retrain newer than the compact
    artifact wins with a notice on stderr; an older one is ignored, also
    with a notice; without the compact artifact the dense one is used."""
    assets = tmp_path / "assets"
    assets.mkdir()
    compact, dense = assets / "weights_compact.npz", assets / "weights.npz"
    monkeypatch.setattr(tweights, "_repo_root", lambda: str(tmp_path))
    monkeypatch.setattr(tweights, "_notified", set())
    np.savez(dense, **{"fc8_20x20/b": np.zeros(4, np.float32)})
    assert tweights.default_weights_path() == str(dense)
    np.savez(compact, **{"fc8_20x20/b": np.ones(4, np.float32)})
    os.utime(dense, (1e9, 1e9))
    assert tweights.default_weights_path() == str(compact)
    assert "IGNORING stale dense" in capsys.readouterr().err
    os.utime(dense, (2e9, 2e9))
    assert tweights.default_weights_path() == str(dense)
    assert "using dense retrain" in capsys.readouterr().err
    assert tweights.weights_identity() == tweights.artifact_fingerprint(
        str(dense))


def test_caffe_artifacts_are_refused(tmp_path):
    """Caffe artifacts load since the port has its importer
    (tests/test_torch_caffe.py); what is refused is a file that is not
    one: a missing file, and a .caffemodel without the network's layers."""
    for kw in ({"weights_path": "w.caffemodel"},
               {"mean_path": "m.binaryproto"}):
        with pytest.raises(FileNotFoundError, match="no such file"):
            tweights.load_params_and_mean(**kw)
    empty = tmp_path / "empty.caffemodel"
    empty.write_bytes(b"\x0a\x03net")  # a NetParameter with a name only
    with pytest.raises(ValueError, match="missing layers"):
        tweights.load_params_and_mean(weights_path=str(empty), device="cpu")


@pytest.mark.parametrize("entry", ["pipeline", "weights"])
def test_entry_points_default_to_the_gpu(entry):
    """Without a device argument both entry points run on the GPU: where
    there is one they land on it, where there is none they raise and
    nothing falls back to the CPU."""
    params, mean = tweights.load_params_and_mean(device="cpu")

    def call():
        if entry == "pipeline":
            return tpipe.Pipeline(params, mean).mean
        return tweights.load_params_and_mean()[1]

    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


@pytest.mark.parametrize("kw,error", [
    ({"weights_path": "w.caffemodel"}, FileNotFoundError),
    ({"mean_path": "m.binaryproto"}, FileNotFoundError),
    ({"weights_path": "missing.npz"}, FileNotFoundError),
    ({"mean_path": "missing.npy"}, FileNotFoundError)])
def test_artifact_errors_precede_the_device_check(monkeypatch, kw, error):
    """A missing file, Caffe's formats included, is reported as such, also
    on a machine without a GPU, where the default device would raise too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error):
        tweights.load_params_and_mean(**kw)
