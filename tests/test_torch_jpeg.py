"""The port's JPEG codec (data/jpeg.py) against PIL.

Decoder: pixel equality with PIL (libjpeg's default decode) on the JAX
miniset writer's files at the three data-set sizes, on grayscale files, on
4:4:4 / 4:2:2 / 4:2:0 colour, odd sizes, restart markers, a noise image
and a flat one; arithmetic-coded and CMYK files decode as the JAX package
reads them, corrupt and non-JPEG bytes raise (progressive files:
tests/test_torch_jpeg_progressive.py; the other forms:
tests/test_torch_jpeg_forms.py). Encoder: the same bytes
on two calls, PIL's quantisation tables, PIL's pixels from the port's
file, and an error against the source no worse than 1.05 x PIL's own
quality-92 file.
"""

import io
import time

import numpy as np
import pytest
from PIL import Image

from vanishing_points_2017_tpu.data import minisets as jminisets
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data import jpeg
from vanishing_points_2017_tpu_torch.models import synth
from torch_cpu import torch_threads  # noqa: F401


def _pil_bytes(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_pixels(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)))


def _assert_decodes_like_pil(blob: bytes):
    ref = _pil_pixels(blob)
    got = jpeg.decode_jpeg(blob)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)  # exact
    assert jpeg.jpeg_size(blob) == ref.shape[:2]
    return got


def _noise(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("width,height", [(640, 480), (1024, 768),
                                          (900, 600)])
def test_decoder_equals_pil_on_miniset_files(tmp_path, width, height):
    """Files written by the JAX package's ``minisets._save_jpeg`` (PIL,
    L -> RGB, quality 92) at YUD's, ECD's and HLW's sizes; the 1024x768
    decode must take under 2 s."""
    rng = np.random.default_rng(width)
    scene = synth.make_scene(rng, lines_per_vp=30, outliers=8)
    img = jminisets.render_scene_image_wh(scene, width, height, rng=rng)
    path = str(tmp_path / "a.jpg")
    jminisets._save_jpeg(img, path)
    with open(path, "rb") as fh:
        blob = fh.read()
    jpeg.decode_jpeg(blob[:])  # builds the entropy coder once
    t0 = time.perf_counter()
    got = _assert_decodes_like_pil(blob)
    assert time.perf_counter() - t0 < 2.0
    assert got.shape == (height, width, 3)
    np.testing.assert_array_equal(tio.load_image(path), got)
    assert tio.image_size(path) == (height, width)


@pytest.mark.parametrize("shape", [(480, 640), (23, 37), (1, 1), (16, 17)])
def test_decoder_equals_pil_grayscale(shape):
    _assert_decodes_like_pil(_pil_bytes(_noise(shape), quality=92))


@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("shape", [(23, 37), (1, 1), (16, 17), (96, 80),
                                   (3, 2)])
def test_decoder_equals_pil_colour(shape, subsampling):
    """Odd sizes give partial edge MCUs; planes at most 2 chroma samples
    wide take libjpeg's replication instead of its triangle filter."""
    rgb = _noise(shape + (3,), seed=subsampling)
    for quality in (92, 30, 100):
        _assert_decodes_like_pil(_pil_bytes(rgb, quality=quality,
                                            subsampling=subsampling))


@pytest.mark.parametrize("case", ["restart", "restart_rows", "optimized",
                                  "flat", "smooth"])
def test_decoder_equals_pil_variants(case):
    rgb = _noise((75, 133, 3), seed=5)
    if case == "restart":
        blob = _pil_bytes(rgb, quality=92, restart_marker_blocks=3)
        assert b"\xff\xdd" in blob  # a DRI segment
    elif case == "restart_rows":
        blob = _pil_bytes(rgb, quality=92, restart_marker_rows=1)
    elif case == "optimized":
        blob = _pil_bytes(rgb, quality=92, optimize=True)
    elif case == "flat":
        blob = _pil_bytes(np.full((64, 48, 3), 77, np.uint8))
    else:
        y, x = np.mgrid[0:120, 0:200]
        smooth = np.stack([x % 256, (x + y) % 256, (2 * y) % 256],
                          -1).astype(np.uint8)
        blob = _pil_bytes(smooth, quality=75)
    _assert_decodes_like_pil(blob)


def test_decoder_skips_app_and_comment_segments():
    blob = _pil_bytes(_noise((40, 40, 3)), quality=92,
                      comment=b"made for the test",
                      exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0\0\0\0\0")
    assert b"\xff\xfe" in blob and b"\xff\xe1" in blob
    _assert_decodes_like_pil(blob)


def test_unsupported_files_raise(tmp_path):
    """An arithmetic-coded progressive (SOF10) file of the test writer and
    PIL's CMYK file read as the JAX package reads them (both refused
    until the port read them); SOF10 forged onto Huffman bytes, non-JPEG
    bytes and a file cut inside its scan raise; a Huffman progressive file
    (refused until the port read SOF2) reads as PIL reads it."""
    import jpeg_progressive_writer as W
    from vanishing_points_2017_tpu.data import io as jio

    rgb = _noise((32, 32, 3))
    prog = _pil_bytes(rgb, progressive=True)
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog), _pil_pixels(prog))
    i = prog.index(b"\xff\xc2")
    forged = prog[:i + 1] + b"\xca" + prog[i + 2:]
    with pytest.raises(ValueError, match="corrupt JPEG: an arithmetic"):
        jpeg.decode_jpeg(forged)
    rng = np.random.default_rng(0)
    frame = W.Frame(32, 32, "420")
    qts = {0: rng.integers(1, 40, 64), 1: rng.integers(1, 40, 64)}
    coefs = W.random_coefficients(frame, rng, 0.3, [qts[0], qts[1], qts[1]])
    arith = W.write_jpeg(frame, coefs, qts, W.full_script(3, 1, ((1, 63, 1),)),
                         arithmetic=True, restart=2)
    assert arith[arith.index(b"\xff\xca") + 1] == 0xCA
    np.testing.assert_array_equal(jpeg.decode_jpeg(arith), _pil_pixels(arith))
    assert jpeg.jpeg_size(_pil_bytes(rgb)) == (32, 32)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()),
                                  jio.load_image(str(path)))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG....")
    good = _pil_bytes(rgb)
    with pytest.raises(ValueError, match="JPEG"):
        jpeg.decode_jpeg(good[:len(good) // 2])  # cut inside the scan
    path = tmp_path / "p.jpg"
    path.write_bytes(forged)
    with pytest.raises(ValueError, match="p.jpg.*arithmetic"):
        tio.load_image(str(path))
    path.write_bytes(arith)
    np.testing.assert_array_equal(tio.load_image(str(path)),
                                  _pil_pixels(arith))
    path.write_bytes(prog)
    np.testing.assert_array_equal(tio.load_image(str(path)),
                                  _pil_pixels(prog))


def _scan_bytes(blob: bytes) -> bytes:
    return blob[blob.index(b"\xff\xda"):]


@pytest.mark.parametrize("kind", ["gray_as_rgb", "noise_rgb", "gray"])
@pytest.mark.parametrize("shape", [(480, 640), (600, 900), (37, 23),
                                   (1, 1)])
def test_encoder_against_pil(shape, kind):
    """The same bytes on two calls; PIL reads the port's file to the
    pixels the port's decoder gives; the quantisation tables are PIL's at
    quality 92; the mean absolute error against the source is at most
    1.05 x that of PIL's own quality-92 file. Whether the scan's bytes
    equal PIL's is logged, not gated."""
    rng = np.random.default_rng(3)
    gray = np.clip(rng.normal(200, 25, shape), 0, 255).astype(np.uint8)
    arr = {"gray_as_rgb": np.stack([gray] * 3, -1),
           "noise_rgb": _noise(shape + (3,), seed=9), "gray": gray}[kind]
    mine = jpeg.encode_jpeg(arr, quality=92)
    assert mine == jpeg.encode_jpeg(arr.copy(), quality=92)
    ref = _pil_bytes(arr, quality=92)
    got = _assert_decodes_like_pil(mine)
    assert got.shape == arr.shape
    assert (Image.open(io.BytesIO(mine)).quantization
            == Image.open(io.BytesIO(ref)).quantization)
    err_mine = np.abs(got.astype(int) - arr).mean()
    err_pil = np.abs(_pil_pixels(ref).astype(int) - arr).mean()
    assert err_mine <= 1.05 * err_pil + 1e-12
    print(f"encode {kind} {shape}: scan bytes equal PIL's: "
          f"{_scan_bytes(mine) == _scan_bytes(ref)}; whole file equal: "
          f"{mine == ref}; {len(mine)} vs {len(ref)} bytes")


@pytest.mark.parametrize("quality", [10, 50, 75, 92, 100])
def test_quant_tables_equal_pil(quality):
    arr = _noise((16, 16, 3))
    want = Image.open(io.BytesIO(_pil_bytes(arr, quality=quality))
                      ).quantization
    got = Image.open(io.BytesIO(jpeg.encode_jpeg(arr, quality))
                     ).quantization
    assert got == want


def test_encoder_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match="encode_jpeg"):
            jpeg.encode_jpeg(bad)


def test_png_writer_round_trip():
    for arr in (_noise((19, 31)), _noise((19, 31, 3))):
        blob = tio.encode_png(arr)
        np.testing.assert_array_equal(tio.decode_png(blob), arr)
        np.testing.assert_array_equal(_pil_pixels(blob), arr)
        assert tio.png_size(blob) == (19, 31)


def test_image_size_reads_past_a_large_header(tmp_path):
    """``image_size`` reads the first 64 KiB; a frame header that lies
    beyond them (two full APP2 segments in front) is still found, and a
    file that ends before its frame header raises."""
    blob = _pil_bytes(_noise((23, 37, 3)), quality=92)
    app2 = b"\xff\xe2\xff\xff" + bytes(65533)
    path = tmp_path / "profile.jpg"
    path.write_bytes(blob[:2] + app2 + app2 + blob[2:])
    assert tio.image_size(str(path)) == (23, 37)
    np.testing.assert_array_equal(tio.load_image(str(path)),
                                  _pil_pixels(blob))
    path.write_bytes(blob[:2] + app2 + app2)
    with pytest.raises(ValueError, match="truncated"):
        tio.image_size(str(path))
