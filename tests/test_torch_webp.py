"""WebP in the port (``data/webp.py``, ``csrc/webp_decode.cpp``) against
the JAX package's ``load_image`` (PIL 12.1.0, libwebp 1.6.0, then
``convert("RGB")``), every comparison exact (uint8 equality, shapes equal):

* the committed fixtures (``scripts/make_webp_fixtures.py``): file and
  pixel digests, pixels, ``image_size``; the coding tools they reach;
* files PIL writes here from seeded arrays: lossy and lossless, with and
  without alpha, odd sizes, animations;
* truncated and corrupt files: where PIL fails to open or decode one the
  port raises a ``ValueError``, and where PIL decodes one the port gives
  its pixels;
* the fixture script rebuilds the committed files.
"""

import hashlib
import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image, features

from vanishing_points_2017_tpu.data import io as jio
from vanishing_points_2017_tpu_torch import example
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data import webp
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "assets", "examples")
FIXTURES = os.path.join(EXAMPLES, "webp")
SCRIPT = os.path.join(ROOT, "scripts", "make_webp_fixtures.py")
REFERENCE = os.path.join(EXAMPLES, "jax_reference_webp.npz")
_REF = np.load(REFERENCE)
FILES = [str(n) for n in _REF["files"]]


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _script():
    spec = importlib.util.spec_from_file_location("make_webp_fixtures",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_or_error(path: str):
    """The JAX package's pixels of the file, or None where PIL fails."""
    try:
        return jio.load_image(path)
    except Exception:  # PIL's own errors: OSError, SyntaxError, EOFError
        return None


def _assert_like_jax(tmp_path, blob: bytes, name: str = "f.webp"):
    """The port gives the JAX package's pixels and PIL's size; returns
    them, or None where PIL fails and the port raises too."""
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(blob)
    want = _jax_or_error(path)
    if want is None:
        with pytest.raises(ValueError):
            tio.load_image(path)
        return None
    got = tio.load_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with Image.open(path) as im:
        assert tio.image_size(path) == im.size[::-1]
    return got


# ------------------------------------------------- the committed fixtures

@pytest.mark.parametrize("name", FILES)
def test_committed_fixture_equals_jax(name):
    """The file is the committed one; the port's ``load_image`` gives the
    committed digest of the JAX package's pixels and, here, its pixels;
    ``image_size`` and ``webp_size`` give PIL's size."""
    path = os.path.join(FIXTURES, f"{name}.webp")
    with open(path, "rb") as fh:
        blob = fh.read()
    assert hashlib.sha256(blob).hexdigest() == str(
        _REF[f"file_sha256_{name}"])
    got = tio.load_image(path)
    assert _digest(got) == str(_REF[f"sha256_{name}"])
    shape = tuple(int(v) for v in _REF[f"shape_{name}"])
    assert got.shape == shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jio.load_image(path))
    with Image.open(path) as im:
        assert im.size[::-1] == shape[:2]
    assert tio.image_size(path) == webp.webp_size(blob) == shape[:2]


def test_reference_names_the_oracle_here():
    """The digests were taken with this PIL and libwebp; the fixtures
    cover the forms the decoder reads."""
    import PIL

    assert str(_REF["pillow_version"]) == PIL.__version__ == "12.1.0"
    assert str(_REF["libwebp_version"]) == features.version("webp")
    assert features.version("webp") == "1.6.0"
    forms = " | ".join(str(_REF[f"form_{n}"]) for n in FILES)
    for form in ("lossy", "lossless", "alpha", "raw alpha", "palette of 2",
                 "palette of 200", "near-lossless", "simple filter",
                 "normal filter", "8 partitions", "VP8X with ICCP",
                 "animation", "save_all", "1x1", "1x37", "29x1"):
        assert form in forms, form
    for name in _REF["timed"]:
        assert tuple(_REF[f"shape_{name}"])[:2] == (480, 640)


# the tools no libwebp-written file can reach: its encoder never writes
# loop-filter deltas, so the decoder's delta arithmetic goes untested here
UNREACHED = ("lf_deltas",)


def test_fixtures_reach_every_coding_tool(monkeypatch):
    """Every VP8 and VP8L coding tool the decoder implements is used by at
    least one committed fixture: each 16x16, 4x4 and chroma mode, both
    loop filters and none, 1, 2, 4 and 8 partitions, segments and their
    map, the skip probability on and off, probability updates; each of the
    14 predictors, the four transforms, each palette bundling, the colour
    cache, meta codes, one-symbol, simple and normal codes and backward
    references."""
    monkeypatch.setattr(webp, "COVERAGE", {})
    for name in FILES:
        webp.decode_webp(_fixture(name))
    missing = [t for t in webp.VP8_TOOLS + webp.VP8L_TOOLS
               if not webp.COVERAGE.get(t) and t not in UNREACHED]
    assert not missing, missing


# ------------------------------------------- files PIL writes at test time

def _seeded(seed: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / (3 + 4 * c) + c) * 90
                     + np.cos(y / (2 + c)) * 60 + 128
                     for c in range(channels)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


# (seed, height, width, PIL mode, save options)
WRITTEN = [
    (1, 1, 1, "RGB", dict(quality=80)),
    (2, 1, 45, "RGB", dict(quality=30, method=0)),
    (3, 37, 1, "RGBA", dict(quality=95, method=6)),
    (4, 19, 23, "RGB", dict(lossless=True)),
    (5, 31, 17, "RGBA", dict(lossless=True, exact=True, method=6)),
    (6, 33, 47, "RGBA", dict(quality=55, alpha_quality=40, method=3)),
    (7, 47, 33, "L", dict(quality=70)),
    (8, 15, 66, "LA", dict(lossless=True, quality=20, method=1)),
    (9, 50, 51, "P", dict(lossless=True)),
    (10, 17, 17, "RGB", dict(quality=0, method=2)),
    (11, 64, 48, "RGBA", dict(quality=100, lossless=False, exact=True)),
]


def _written_id(case) -> str:
    seed, h, w, mode, opts = case
    kind = "lossless" if opts.get("lossless") else f"q{opts['quality']}"
    return f"{seed}-{w}x{h}-{mode}-{kind}"


@pytest.mark.parametrize("seed,h,w,mode,opts", WRITTEN,
                         ids=[_written_id(c) for c in WRITTEN])
def test_pil_written_files_equal_jax(tmp_path, seed, h, w, mode, opts):
    """Files PIL writes from seeded arrays: lossy and lossless, with and
    without alpha, from gray, palette and RGBA images, at odd sizes."""
    arr = _seeded(seed, h, w, 4)
    im = Image.fromarray(arr, "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "WEBP", **opts)
    assert _assert_like_jax(tmp_path, buf.getvalue()) is not None


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
def test_pil_animation_gives_frame_0(tmp_path, lossless):
    """An animation PIL writes: frame 0, as PIL shows it on open."""
    frames = [Image.fromarray(_seeded(20 + k, 29, 35, 4), "RGBA")
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=lossless, quality=60, duration=50)
    assert _assert_like_jax(tmp_path, buf.getvalue()) is not None


def test_image_size_and_drivers_keep_the_jax_suffixes(tmp_path):
    """``image_size`` reads the header alone (a 30-byte prefix suffices);
    the example driver takes an explicit .webp path and, as the JAX
    driver, lists only .jpg/.jpeg/.png in a directory."""
    for name in ("lossy_63x49_8parts", "lossless_63x49_m2",
                 "extended_metadata", "animation_offset"):
        with open(os.path.join(FIXTURES, f"{name}.webp"), "rb") as fh:
            blob = fh.read()
        assert webp.webp_size(blob[:30]) == tuple(_REF[f"shape_{name}"])[:2]
    path = os.path.join(FIXTURES, "palette_2.webp")
    assert example.image_paths([path]) == [path]
    assert example.image_paths([FIXTURES]) == []


# ----------------------------------------------- truncated and corrupt data

def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, f"{name}.webp"), "rb") as fh:
        return fh.read()


def _resized(blob: bytes) -> bytes:
    """The RIFF size and the last chunk's size set to what the bytes hold,
    so a cut payload reaches the codec."""
    b = bytearray(blob)
    b[4:8] = struct.pack("<I", len(b) - 8)
    pos, last = 12, None
    while pos + 8 <= len(b):
        last = pos
        (n,) = struct.unpack("<I", b[pos + 4:pos + 8])
        pos += 8 + n + (n & 1)
    b[last + 4:last + 8] = struct.pack("<I", len(b) - last - 8)
    return bytes(b)


def _patched(blob: bytes, pos: int, value: bytes) -> bytes:
    return blob[:pos] + value + blob[pos + len(value):]


def _corrupt_cases() -> dict:
    lossy = _fixture("lossy_63x49_8parts")
    lossless = _fixture("lossless_63x49_m6")
    ext = _fixture("extended_metadata")
    anim = _fixture("animation_offset")
    # the VP8 payload starts at byte 20 of a simple file
    return {
        "cut_riff": lossy[:len(lossy) // 2],
        "cut_header": lossy[:18],
        "riff_size_small": _patched(lossy, 4, struct.pack("<I", 4)),
        "not_webp_chunk": _patched(lossy, 12, b"JUNK"),
        "vp8_start_code": _patched(lossy, 23, b"\x9d\x02"),
        "vp8_inter_frame": _patched(lossy, 20, bytes([lossy[20] | 1])),
        "vp8_zero_width": _patched(lossy, 26, b"\x00\x00"),
        "vp8_cut_first_partition": _resized(lossy[:40]),
        "vp8_cut_tokens": _resized(lossy[:len(lossy) - 200]),
        "vp8l_signature": _patched(lossless, 20, b"\x2e"),
        "vp8l_version": _patched(lossless, 24, bytes([lossless[24] | 0x20])),
        "vp8l_cut": _resized(lossless[:len(lossless) // 2]),
        "vp8x_reserved_flag": _patched(ext, 20, bytes([ext[20] | 0x01])),
        "vp8x_canvas_mismatch": _patched(ext, 24, b"\x1f\x00\x00"),
        "anmf_outside_canvas": _patched(anim, anim.index(b"ANMF") + 8,
                                        b"\x05\x00\x00"),
        "chunk_past_riff": _patched(ext, ext.index(b"EXIF") + 4,
                                    struct.pack("<I", 1000)),
        "trailing_bytes_in_riff": _patched(lossy + b"\x00" * 3, 4,
                                           struct.pack("<I", len(lossy) - 5)),
    }


CORRUPT = _corrupt_cases()


@pytest.mark.parametrize("case", list(CORRUPT))
def test_truncated_and_corrupt_files_raise(tmp_path, case):
    """Each file PIL refuses raises a ValueError in the port."""
    path = str(tmp_path / "c.webp")
    with open(path, "wb") as fh:
        fh.write(CORRUPT[case])
    assert _jax_or_error(path) is None, "PIL opens it"
    with pytest.raises(ValueError):
        tio.load_image(path)


@pytest.mark.parametrize("name", ["alpha_filtered_63x49", "lossless_63x49_m6",
                                  "palette_16"])
def test_damaged_files_decode_or_raise_as_pil_does(tmp_path, name):
    """Seeded cuts (sizes set to reach the codec) and single-bit flips:
    where PIL decodes the file the port gives its pixels, where PIL fails
    the port raises."""
    blob = _fixture(name)
    rng = np.random.default_rng(len(name))
    outcomes = set()
    for k, cut in enumerate(rng.integers(21, len(blob), 12)):
        got = _assert_like_jax(tmp_path, _resized(blob[:cut]), f"cut{k}.webp")
        outcomes.add(got is None)
    for k, pos in enumerate(rng.integers(20, len(blob), 24)):
        flipped = _patched(blob, int(pos),
                           bytes([blob[pos] ^ (1 << int(rng.integers(8)))]))
        got = _assert_like_jax(tmp_path, flipped, f"flip{k}.webp")
        outcomes.add(got is None)
    assert outcomes == {True, False}  # both kinds of outcome were met


def test_other_formats_name_the_three_formats(tmp_path):
    """A file of none of the three formats names them."""
    Image.fromarray(_seeded(0, 9, 7)).save(tmp_path / "a.tiff")
    with pytest.raises(ValueError, match="not a PNG, JPEG or WebP file"):
        tio.load_image(str(tmp_path / "a.tiff"))
    with pytest.raises(ValueError, match="not a PNG, JPEG or WebP file"):
        tio.image_size(str(tmp_path / "a.tiff"))


# ------------------------------------------------------ the fixture script

def test_script_rebuilds_the_committed_files(tmp_path):
    """``scripts/make_webp_fixtures.py`` writes the committed files byte for
    byte, and the same digests, forms and shapes (its four driver runs are
    the slow test below)."""
    ref = _script().make(str(tmp_path), drive=False)
    assert [str(n) for n in ref["files"]] == FILES
    for name in FILES:
        with open(tmp_path / "webp" / f"{name}.webp", "rb") as fh:
            assert fh.read() == _fixture(name), name
    for key, value in ref.items():
        np.testing.assert_array_equal(value, _REF[key], err_msg=key)


@pytest.mark.slow
def test_script_rebuilds_the_committed_reference(tmp_path):
    """The whole npz, the JAX driver's runs on the mini included."""
    ref = _script().make(str(tmp_path))
    assert sorted(ref) == sorted(_REF.files)
    for key, value in ref.items():
        np.testing.assert_array_equal(value, _REF[key], err_msg=key)
