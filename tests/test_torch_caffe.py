"""Caffe artifacts in the PyTorch port against the JAX package's, at narrow
widths (input 120, fc width 64) on the CPU.

The two exporters write the same bytes in both framings (modern field 100,
legacy V1 field 2), a low-rank layer densified alike; the port's importer
reads a JAX-written file into the parameters ``caffemodel_to_params`` of
the JAX package gives (exact); ``.binaryproto`` goes both ways; and
``load_params_and_mean`` on ``.caffemodel`` + ``.binaryproto`` gives the
CNN grid of the npz route bit for bit.
"""

import struct

import jax
import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu import weights as jweights
from vanishing_points_2017_tpu.models import caffe_export as jexport
from vanishing_points_2017_tpu.models import caffe_import as jimport
from vanishing_points_2017_tpu.models import cnn as jcnn
from vanishing_points_2017_tpu_torch import weights as tweights
from vanishing_points_2017_tpu_torch.models import caffe_export as texport
from vanishing_points_2017_tpu_torch.models import caffe_import as timport
from vanishing_points_2017_tpu_torch.models import cnn as tcnn

INPUT, FC_WIDTH = 120, 64


def _numpy_params(seed: int = 0, low_rank: bool = False) -> dict:
    """The JAX package's fillers as float32 numpy in its layout; with
    ``low_rank``, fc6 as a rank-8 ``u``/``v`` pair."""
    p = jcnn.init_params(jax.random.PRNGKey(seed), input_size=INPUT,
                         fc_width=FC_WIDTH)
    p = {k: {kk: np.asarray(v) for kk, v in d.items()} for k, d in p.items()}
    if low_rank:
        rng = np.random.default_rng(seed)
        w = p["fc6"].pop("w")
        p["fc6"]["u"] = rng.normal(size=(w.shape[0], 8)).astype(np.float32)
        p["fc6"]["v"] = rng.normal(size=(8, w.shape[1])).astype(np.float32)
    return p


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("low_rank", [False, True], ids=["dense", "lowrank"])
@pytest.mark.parametrize("legacy", [False, True], ids=["modern", "v1"])
def test_exporters_write_equal_bytes(tmp_path, legacy, low_rank):
    arrays = _numpy_params(1, low_rank)
    pj, pt = str(tmp_path / "j.caffemodel"), str(tmp_path / "t.caffemodel")
    jexport.params_to_caffemodel(arrays, pj, legacy=legacy)
    texport.params_to_caffemodel(tweights.params_from_numpy(arrays), pt,
                                 legacy=legacy)
    assert _read(pt) == _read(pj)
    # and the file reads back, through either importer, as the dense layers
    back = timport.caffemodel_to_params(pt)
    want = jimport.caffemodel_to_params(pj)
    assert list(back) == list(want)
    for layer, d in want.items():
        assert sorted(back[layer]) == ["b", "w"]
        for k, v in d.items():
            assert back[layer][k].dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], v,
                                          err_msg=f"{layer}/{k}")
    dense = arrays["fc6"]["u"] @ arrays["fc6"]["v"] if low_rank \
        else arrays["fc6"]["w"]
    np.testing.assert_array_equal(back["fc6"]["w"], dense)
    np.testing.assert_array_equal(back["conv2"]["w"], arrays["conv2"]["w"])


@pytest.mark.parametrize("legacy", [False, True], ids=["modern", "v1"])
def test_import_of_a_jax_written_file(tmp_path, legacy):
    arrays = _numpy_params(2)
    path = str(tmp_path / "w.caffemodel")
    jexport.params_to_caffemodel(arrays, path, legacy=legacy)
    raw_t, raw_j = timport.read_caffemodel(path), jimport.read_caffemodel(path)
    assert list(raw_t) == list(raw_j)
    for name in raw_j:
        for a, b in zip(raw_t[name], raw_j[name]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert raw_t["conv2"][0].shape == (256, 48, 5, 5)  # Caffe's OIHW, grouped
    # the legacy dims are always four: an fc blob reads as (1, 1, out, in)
    assert raw_t["fc6"][0].shape[-2:] == (FC_WIDTH,
                                          arrays["fc6"]["w"].shape[0])
    got, want = (m.caffemodel_to_params(path) for m in (timport, jimport))
    for layer, d in want.items():
        for k, v in d.items():
            np.testing.assert_array_equal(got[layer][k], v)
            np.testing.assert_array_equal(got[layer][k], arrays[layer][k])


def test_binaryproto_both_ways(tmp_path):
    mean = np.random.default_rng(3).uniform(0, 255, (INPUT, INPUT)).astype(
        np.float32)
    pj, pt = str(tmp_path / "j.binaryproto"), str(tmp_path / "t.binaryproto")
    jexport.mean_to_binaryproto(mean, pj)
    texport.mean_to_binaryproto(torch.from_numpy(mean), pt)
    assert _read(pt) == _read(pj)
    for path in (pj, pt):
        got = timport.read_mean_binaryproto(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, mean)
        np.testing.assert_array_equal(got, jimport.read_mean_binaryproto(path))


def test_double_data_and_split_fields():
    """A blob with ``double_data`` (field 8) and a BlobShape, and one whose
    float data comes as unpacked 4-byte fields, as old writers emit."""
    vals = np.arange(6, dtype=np.float64) / 3
    shape = b"\x08\x02\x08\x03"  # BlobShape.dim = 2, 3
    blob = (b"\x42" + bytes([48]) + vals.astype("<f8").tobytes()
            + b"\x3a" + bytes([len(shape)]) + shape)
    got = timport._blob_to_array(blob)
    assert got.shape == (2, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, vals.astype(np.float32).reshape(2, 3))
    np.testing.assert_array_equal(got, jimport._blob_to_array(blob))
    unpacked = b"\x08\x02" + b"".join(  # legacy num = 2, then the values
        b"\x2d" + struct.pack("<f", v) for v in (1.5, -2.0))
    np.testing.assert_array_equal(timport._blob_to_array(unpacked).ravel(),
                                  [1.5, -2.0])
    assert timport._blob_to_array(unpacked).shape == (2, 1, 1, 1)
    with pytest.raises(ValueError, match="no data field"):
        timport._blob_to_array(b"\x08\x01")


def test_load_params_and_mean_from_caffe_gives_the_npz_grid(tmp_path):
    """--weights w.caffemodel --mean mean.binaryproto, written by either
    exporter, against the same parameters through the npz/npy route: the
    CNN grids on the CPU are equal bit for bit, and the files are
    fingerprinted like the JAX package's."""
    arrays = _numpy_params(4)
    mean = np.random.default_rng(4).uniform(0, 40, (INPUT, INPUT)).astype(
        np.float32)
    npz, npy = str(tmp_path / "w.npz"), str(tmp_path / "m.npy")
    tweights.params_to_npz(tweights.params_from_numpy(arrays), npz)
    np.save(npy, mean)
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, INPUT, INPUT)).astype(np.uint8))

    def grid(wpath, mpath):
        params, m = tweights.load_params_and_mean(wpath, mpath, device="cpu")
        assert params["conv1"]["w"].shape == (96, 1, 11, 11)
        assert m.shape == (INPUT, INPUT) and m.dtype == torch.float32
        model = tcnn.VPNet(params, compute_dtype=torch.float32).eval()
        with torch.inference_mode():
            return model(tcnn.preprocess(x, m))

    want = grid(npz, npy)
    assert want.shape == (2, 20, 20) and bool(torch.isfinite(want).all())
    for tag, export in (("j", jexport), ("t", texport)):
        wpath = str(tmp_path / f"{tag}.caffemodel")
        mpath = str(tmp_path / f"{tag}.binaryproto")
        if tag == "j":
            export.params_to_caffemodel(arrays, wpath)
            export.mean_to_binaryproto(mean, mpath)
        else:
            export.params_to_caffemodel(tweights.params_from_numpy(arrays),
                                        wpath, legacy=True)
            export.mean_to_binaryproto(mean, mpath)
        assert torch.equal(grid(wpath, mpath), want)
        assert torch.equal(grid(wpath, npy), want)
        assert tweights.weights_identity(wpath) \
            == jweights.weights_identity(wpath) != "none"
        assert tweights.mean_identity(mpath) == jweights.mean_identity(mpath)
    # the JAX package loads the port's file into the same parameters
    back = jimport.caffemodel_to_params(str(tmp_path / "t.caffemodel"))
    for layer, d in arrays.items():
        for k, v in d.items():
            np.testing.assert_array_equal(back[layer][k], v)
