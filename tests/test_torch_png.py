"""The port's PNG reader (``data/io.py``) against the JAX package's
``load_image`` (PIL): every colour type and bit depth of the standard,
palette files, Adam7 interlace and the five row filters, shape and pixels
exact.

Files come from PIL where PIL writes the variant, and otherwise from a
small writer in this file (16-bit colour, 2- and 4-bit gray, interlaced
files, chosen filters); PIL reads both kinds, and its pixels are the
oracle.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from vanishing_points_2017_tpu.data import io as jio
from vanishing_points_2017_tpu_torch.data import io as tio
from torch_cpu import torch_threads  # noqa: F401

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filter_row(line: bytes, prev: bytes, ftype: int, bpp: int) -> bytes:
    out = bytearray(len(line))
    for x, v in enumerate(line):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (v - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def _scanlines(samples: np.ndarray, depth: int, rng) -> bytes:
    """(h, w, ch) samples -> filtered scanlines, a random filter per row."""
    h, w, ch = samples.shape
    if h == 0 or w == 0:
        return b""
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = ((samples[..., 0, None].astype(np.uint8)
                 >> np.arange(depth - 1, -1, -1).astype(np.uint8)) & 1)
        rows = np.packbits(bits.reshape(h, w * depth), axis=1)
    bpp = max(1, ch * depth // 8)
    out, prev = b"", bytes(rows.shape[1])
    for row in rows:
        line = row.tobytes()
        out += _filter_row(line, prev, int(rng.integers(0, 5)), bpp)
        prev = line
    return out


def write_png(samples: np.ndarray, depth: int, color: int, interlace=False,
              plte: bytes | None = None, trns: bytes | None = None,
              seed: int = 0) -> bytes:
    """A PNG of (h, w, ch) samples (palette indices for colour type 3)."""
    rng = np.random.default_rng(seed)
    h, w = samples.shape[:2]
    if interlace:
        data = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, rng)
                        for x0, y0, dx, dy in _ADAM7)
    else:
        data = _scanlines(samples, depth, rng)
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                             int(interlace)))
    if plte is not None:
        blob += _chunk(b"PLTE", plte)
    if trns is not None:
        blob += _chunk(b"tRNS", trns)
    # the image data split over two IDAT chunks, as encoders may write it
    z = zlib.compress(data)
    return (blob + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


def _assert_like_jax(tmp_path, blob: bytes, name="f.png") -> np.ndarray:
    path = tmp_path / name
    path.write_bytes(blob)
    want = jio.load_image(str(path))
    got = tio.load_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, (
        got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    assert tio.image_size(str(path)) == want.shape[:2]
    return got


CASES = {  # name -> (colour type, bit depth, channels)
    "gray1": (0, 1, 1), "gray2": (0, 2, 1), "gray4": (0, 4, 1),
    "gray8": (0, 8, 1), "gray16": (0, 16, 1), "rgb8": (2, 8, 3),
    "rgb16": (2, 16, 3), "pal1": (3, 1, 1), "pal2": (3, 2, 1),
    "pal4": (3, 4, 1), "pal8": (3, 8, 1), "la8": (4, 8, 2),
    "la16": (4, 16, 2), "rgba8": (6, 8, 4), "rgba16": (6, 16, 4)}


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("case", list(CASES))
def test_png_variants_equal_jax(tmp_path, case, interlace):
    """Every colour type at every depth, plain and Adam7, at sizes that
    leave passes empty and rows ending inside a byte: shape and pixels
    equal to the JAX package's. Palette files carry fewer entries than
    their indices reach (those pixels are black) and a tRNS chunk (dropped);
    16-bit gray spans values past 255 (PIL clips them)."""
    color, depth, ch = CASES[case]
    for k, (h, w) in enumerate([(1, 1), (3, 5), (13, 11), (40, 50)]):
        rng = np.random.default_rng(100 * k + depth + color)
        top = (1 << depth) - 1
        samples = rng.integers(0, top + 1, (h, w, ch), np.int64)
        if depth == 16 and color == 0:
            samples[0, 0, 0] = 256  # the smallest value PIL clips
        plte = trns = None
        if color == 3:
            n = max(1, min(top + 1, 256) - 1)  # one index past the end
            plte = rng.integers(0, 256, 3 * n, np.uint8).tobytes()
            trns = bytes(range(min(n, 3)))
        blob = write_png(samples, depth, color, interlace, plte, trns, seed=k)
        _assert_like_jax(tmp_path, blob)


def test_la_png_returns_rgb(tmp_path):
    """A gray+alpha PNG: RGB with the gray replicated, as PIL's
    ``convert("RGB")`` gives it (the reader once returned the 2-D gray
    plane: another shape, and ``rgb2gray`` took its 2-D branch)."""
    la = np.random.default_rng(1).integers(0, 256, (40, 50, 2), np.uint8)
    Image.fromarray(la, "LA").save(tmp_path / "la.png")
    got = _assert_like_jax(tmp_path, (tmp_path / "la.png").read_bytes())
    assert got.shape == (40, 50, 3)
    np.testing.assert_array_equal(got, np.repeat(la[..., :1], 3, axis=2))
    old = la[..., 0]  # what the reader returned before
    assert old.shape != got.shape
    np.testing.assert_array_equal(tio.rgb2gray(got),
                                  jio.rgb2gray(jio.load_image(
                                      str(tmp_path / "f.png"))))


@pytest.mark.parametrize("mode,bits", [("1", None), ("L", None),
                                       ("P", 1), ("P", 2), ("P", 4),
                                       ("P", None), ("I;16", None),
                                       ("RGBA", None), ("LA", None),
                                       ("RGB", None)])
def test_pil_written_png_equal_jax(tmp_path, mode, bits):
    """The files PIL itself writes for each mode (its filters, its palette
    depth for ``bits``)."""
    rng = np.random.default_rng(7)
    h, w = 29, 37
    if mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    elif mode == "P":
        im = Image.fromarray(rng.integers(0, 1 << (bits or 8), (h, w),
                                          np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * (1 << (bits or 8)),
                                   np.uint8).tobytes())
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 1 << 16, (h, w), np.uint16))
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = rng.integers(0, 256, (h, w, ch), np.uint8)
        im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    im.save(tmp_path / "pil.png", **({"bits": bits} if bits else {}))
    _assert_like_jax(tmp_path, (tmp_path / "pil.png").read_bytes())


def test_png_16bit_keeps_high_byte_and_clips_gray(tmp_path):
    """What PIL gives for 16-bit files: gray clipped at 255 (256, 1000 and
    65535 all read 255), colour the high byte (0x1234 reads 18)."""
    gray = np.array([[[0], [255], [256], [1000], [65535]]])
    got = _assert_like_jax(tmp_path, write_png(gray, 16, 0))
    np.testing.assert_array_equal(got[0, :, 0], [0, 255, 255, 255, 255])
    rgb = np.array([[[0x1234, 0x00FF, 0xFF00]]])
    got = _assert_like_jax(tmp_path, write_png(rgb, 16, 2))
    np.testing.assert_array_equal(got[0, 0], [0x12, 0, 0xFF])


def test_other_formats_and_broken_pngs_raise(tmp_path):
    """BMP, TIFF and GIF stay refused, and WebP reads as the JAX package
    reads it; depths the standard does not allow and a palette file
    without its palette raise."""
    rgb = np.random.default_rng(0).integers(0, 256, (9, 7, 3), np.uint8)
    for ext in ("bmp", "tiff", "gif"):
        Image.fromarray(rgb).save(tmp_path / f"a.{ext}")
        with pytest.raises(ValueError, match="not a PNG, JPEG or WebP file"):
            tio.load_image(str(tmp_path / f"a.{ext}"))
    Image.fromarray(rgb).save(tmp_path / "a.webp")
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "a.webp")),
                                  jio.load_image(str(tmp_path / "a.webp")))
    samples = np.zeros((2, 2, 3), np.int64)
    with pytest.raises(ValueError, match="bit depth 4, colour type 2"):
        tio.decode_png(write_png(samples[..., :1], 4, 2))
    with pytest.raises(ValueError, match="PLTE"):
        tio.decode_png(write_png(samples[..., :1], 8, 3))
