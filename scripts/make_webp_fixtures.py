"""Regenerate the WebP fixtures and their JAX reference.

Writes ``assets/examples/webp/*.webp``, WebP files of the forms the port's
decoder (``vanishing_points_2017_tpu_torch/data/webp.py``) reads, and
``assets/examples/jax_reference_webp.npz``, what the JAX package makes of
them:

* three 640x480 files: P1026, the first evaluated image of the seed-101
  York Urban mini (``minisets.make_mini_yud(n_eval=2)``, as
  ``scripts/make_progressive_fixtures.py`` takes it), lossy at quality 75
  (``P1026_lossy``) and lossless (``P1026_lossless``), and a colour array
  made of it (``P1026_colour``, lossy at quality 75): the mini's
  photographs are gray stored as RGB, so their chroma is flat, and this
  one gives the upsampler and the colour conversion real work;
* small seeded files in colour, 1x1 to 63x49, one or a few per coding
  tool: both loop filters at strengths 0-100 and sharpness 0-7, 1-4
  segments and 1-8 partitions, quality 0-100 and methods 0-6, alpha raw
  and compressed, filtered and not; lossless at several methods with
  ``exact`` on and off, palettes of 2, 3, 16 and 200 colours and
  near-lossless;
* extended files assembled here: ICC, EXIF, XMP and an unknown chunk of
  odd size around an image, and an animation whose frame 0 is a VP8
  bitstream smaller than the canvas at a non-zero offset; and an
  animation written by PIL's ``save_all``.

The files come from Pillow's bundled libwebp through ``ctypes`` (its
encoder with every ``WebPConfig`` field set explicitly, one thread, so the
bytes are the same on every run) and from PIL's own writer.

The npz holds, per fixture ``<name>``: ``sha256_<name>`` (of the JAX
package's ``load_image`` pixels, C order), ``shape_<name>``,
``file_sha256_<name>`` (of the file) and ``form_<name>`` (what the file
is); ``files``, ``timed`` (the 640x480 ones, each with its
``quality_<name>``, at which the port's baseline JPEG write of the same
array is timed beside it), ``pillow_version`` and ``libwebp_version``;
and the JAX package's root ``benchmark.py --yud`` on the CPU with the
shipped weights over the mini with P1026 replaced by the lossy file (run
``lossy_york``, host LSD; ``lossy_york_dev``, ``--device_detect``) and by
the lossless file (``lossless_york``, ``lossless_york_dev``), each written
under the ``.jpg`` name the data set's adapter globs: ``<run>_names``,
``<run>_hp1``, ``<run>_hp2``, ``<run>_err`` and ``auc_<run>``.

``chip_smoke.py``'s webp phase holds the port against these on the GPU,
where neither JAX nor PIL is installed. This script is the only place
that makes these files, and runs where PIL with its bundled libwebp is
installed (about 30 s on an 8-core CPU, most of it the four JAX driver
runs):

    python scripts/make_webp_fixtures.py [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import importlib.util
import io
import os
import shutil
import struct
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(ROOT, "assets", "examples")
FIXTURE_DIR = "webp"
REFERENCE = "jax_reference_webp.npz"
PHOTO, QUALITY = "P1026", 75
# the photographs that go through the driver: run prefix -> fixture
DRIVEN = {"lossy": "P1026_lossy", "lossless": "P1026_lossless"}

# name -> (form, seed, (height, width), WebPConfig fields, extras); extras
# as seeded_array takes them. (libwebp's encoder writes more than one
# token partition at methods 0-2 only, and the skip probability only there
# with more than one segment.)
SMALL = {
    "lossy_1x1": ("lossy 1x1", 1, (1, 1), dict(quality=75, method=4), {}),
    "lossy_1x37_simple": ("lossy 1x37, simple filter", 2, (1, 37),
                          dict(quality=60, method=2, filter_type=0,
                               filter_strength=60), {}),
    "lossy_29x1_normal_sharp7": (
        "lossy 29x1, normal filter 100, sharpness 7", 3, (29, 1),
        dict(quality=50, method=3, filter_type=1, filter_strength=100,
             filter_sharpness=7), {}),
    "lossy_15x17_q0_m0": ("lossy 15x17, quality 0, method 0, no filter", 4,
                          (15, 17), dict(quality=0, method=0, segments=1,
                                         filter_strength=0), {}),
    "lossy_16x16_q100_m6": ("lossy 16x16, quality 100, method 6", 5,
                            (16, 16), dict(quality=100, method=6,
                                           segments=4, filter_sharpness=2),
                            {}),
    "lossy_17x15_sharp3_2parts": (
        "lossy 17x15, normal filter, sharpness 3, 2 partitions", 6,
        (17, 15), dict(quality=40, method=1, filter_type=1,
                       filter_strength=40, filter_sharpness=3,
                       partitions=1), {}),
    "lossy_33x65_simple_4parts": (
        "lossy 33x65, simple filter, sharpness 5, 2 segments, 4 "
        "partitions", 7, (33, 65),
        dict(quality=30, method=2, filter_type=0, filter_strength=80,
             filter_sharpness=5, segments=2, partitions=2), {}),
    "lossy_63x49_8parts": (
        "lossy 63x49, 3 segments, 8 partitions", 8, (63, 49),
        dict(quality=60, method=0, segments=3, partitions=3,
             sns_strength=100, filter_type=1, filter_strength=20), {}),
    "lossy_63x49_q10_m1": ("lossy 63x49, quality 10, method 1, 4 segments",
                           9, (63, 49),
                           dict(quality=10, method=1, segments=4,
                                filter_type=1, filter_strength=50,
                                filter_sharpness=1), {}),
    "lossy_49x63_sharp_yuv": ("lossy 49x63, sharp RGB -> YUV", 10, (49, 63),
                              dict(quality=90, method=5, use_sharp_yuv=1,
                                   filter_sharpness=4),
                              {}),
    "lossy_33x65_q95_autofilter": (
        "lossy 33x65, quality 95, autofilter", 11, (33, 65),
        dict(quality=95, method=6, autofilter=1, filter_sharpness=6), {}),
    "lossy_63x49_flat_skip": (
        "lossy 63x49 of flat blocks, skipped macroblocks", 34, (63, 49),
        dict(quality=75, method=1, segments=4), dict(blocks=True)),
    "alpha_raw_17x15": ("lossy 17x15 with raw alpha", 12, (17, 15),
                        dict(quality=70, alpha_compression=0),
                        dict(alpha=True)),
    "alpha_unfiltered_33x65": (
        "lossy 33x65 with compressed alpha, unfiltered", 13, (33, 65),
        dict(quality=70, alpha_compression=1, alpha_filtering=0),
        dict(alpha=True)),
    "alpha_filtered_63x49": (
        "lossy 63x49 with compressed alpha, filtered (best)", 14, (63, 49),
        dict(quality=70, method=5, alpha_compression=1, alpha_filtering=2),
        dict(alpha=True)),
    "alpha_levels_15x17": (
        "lossy 15x17 with compressed alpha at quality 30 (levels)", 15,
        (15, 17), dict(quality=50, alpha_quality=30, alpha_filtering=1),
        dict(alpha=True)),
    "lossless_1x1": ("lossless 1x1", 16, (1, 1),
                     dict(lossless=1, quality=75, method=4), {}),
    "lossless_1x37_m0": ("lossless 1x37, method 0", 17, (1, 37),
                         dict(lossless=1, quality=0, method=0), {}),
    "lossless_29x1_m6": ("lossless 29x1, method 6", 18, (29, 1),
                         dict(lossless=1, quality=100, method=6), {}),
    "lossless_63x49_m2": ("lossless 63x49, method 2", 19, (63, 49),
                          dict(lossless=1, quality=50, method=2), {}),
    "lossless_63x49_m6": ("lossless 63x49, method 6, quality 100", 20,
                          (63, 49), dict(lossless=1, quality=100, method=6),
                          {}),
    "lossless_33x65_flat": ("lossless 33x65, repeated rows", 21, (33, 65),
                            dict(lossless=1, quality=80, method=4),
                            dict(flat=True)),
    "lossless_alpha_exact": ("lossless 33x65 with alpha, exact", 22,
                             (33, 65), dict(lossless=1, method=4, exact=1),
                             dict(alpha=True)),
    "lossless_alpha_inexact": ("lossless 33x65 with alpha, not exact", 23,
                               (33, 65), dict(lossless=1, method=4, exact=0),
                               dict(alpha=True)),
    "lossless_near_60": ("near-lossless 60, 63x49", 24, (63, 49),
                         dict(lossless=1, method=4, near_lossless=60), {}),
    "lossless_63x49_correlated": (
        "lossless 63x49, correlated channels, a black corner", 39, (63, 49),
        dict(lossless=1, quality=75, method=5), dict(correlated=True)),
    "palette_2": ("lossless palette of 2 colours, 33x65", 25, (33, 65),
                  dict(lossless=1, method=4), dict(palette=2)),
    "palette_3": ("lossless palette of 3 colours, 17x15", 26, (17, 15),
                  dict(lossless=1, method=4), dict(palette=3)),
    "palette_16": ("lossless palette of 16 colours, 63x49", 27, (63, 49),
                   dict(lossless=1, method=5), dict(palette=16)),
    "palette_200": ("lossless palette of 200 colours, 63x49", 28, (63, 49),
                    dict(lossless=1, method=6), dict(palette=200)),
    "palette_16_alpha": ("lossless palette of 16 colours with alpha, "
                         "16x16", 29, (16, 16), dict(lossless=1, method=4),
                         dict(palette=16, alpha=True)),
}
# the 640x480 files: name -> (form, WebPConfig fields, colour)
PHOTOS = {
    "P1026_lossy": ("lossy, quality 75", dict(quality=QUALITY, method=4),
                    False),
    "P1026_lossless": ("lossless", dict(lossless=1, quality=75, method=4),
                       False),
    "P1026_colour": ("lossy colour, quality 75",
                     dict(quality=QUALITY, method=4), True),
}

_ENC_ABI = 0x020F  # libwebp 1.x's encoder ABI


def _setup():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")


# ------------------------------------------------- libwebp through ctypes

class _Config(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                 else ctypes.c_int) for n in (
        "lossless", "quality", "method", "image_hint", "target_size",
        "target_PSNR", "segments", "sns_strength", "filter_strength",
        "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
        "alpha_filtering", "alpha_quality", "pass_", "show_compressed",
        "preprocessing", "partitions", "partition_limit",
        "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless",
        "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")] + [
        ("_reserve", ctypes.c_int * 16)]


class _Picture(ctypes.Structure):
    p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    _fields_ = [("use_argb", i), ("colorspace", i), ("width", i),
                ("height", i), ("y", p), ("u", p), ("v", p), ("y_stride", i),
                ("uv_stride", i), ("a", p), ("a_stride", i),
                ("pad1", u32 * 2), ("argb", p), ("argb_stride", i),
                ("pad2", u32 * 3), ("writer", p), ("custom_ptr", p),
                ("extra_info_type", i), ("extra_info", p), ("stats", p),
                ("error_code", i), ("progress_hook", p), ("user_data", p),
                ("pad3", u32 * 3), ("pad4", p), ("pad5", p),
                ("pad6", u32 * 8), ("memory_", p), ("memory_argb_", p),
                ("pad7", p * 2), ("_reserve", ctypes.c_uint8 * 256)]


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


_libwebp = None


def libwebp() -> ctypes.CDLL:
    """Pillow's bundled libwebp (its libsharpyuv loaded first, globally)."""
    global _libwebp
    if _libwebp is None:
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")
        ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0],
                    mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
        cfg, pic = ctypes.POINTER(_Config), ctypes.POINTER(_Picture)
        lib.WebPConfigInitInternal.argtypes = [cfg, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int]
        lib.WebPValidateConfig.argtypes = [cfg]
        lib.WebPPictureInitInternal.argtypes = [pic, ctypes.c_int]
        for name in ("WebPPictureImportRGB", "WebPPictureImportRGBA"):
            getattr(lib, name).argtypes = [pic, ctypes.c_void_p, ctypes.c_int]
        lib.WebPEncode.argtypes = [cfg, pic]
        lib.WebPPictureFree.argtypes = [pic]
        lib.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(_Writer)]
        lib.WebPMemoryWriterClear.argtypes = [ctypes.POINTER(_Writer)]
        _libwebp = lib
    return _libwebp


def encode(arr, **fields) -> bytes:
    """uint8 (H, W, 3) or (H, W, 4) -> a WebP file, every ``WebPConfig``
    field at libwebp's default but those given (one thread)."""
    import numpy as np

    lib = libwebp()
    arr = np.ascontiguousarray(arr)
    cfg = _Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, 75.0, _ENC_ABI):
        raise RuntimeError("libwebp: WebPConfigInit failed")
    for key, value in fields.items():
        setattr(cfg, key, value)
    cfg.thread_level = 0
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the configuration {fields}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ENC_ABI):
        raise RuntimeError("libwebp: WebPPictureInit failed")
    pic.use_argb = cfg.lossless
    pic.height, pic.width = arr.shape[:2]
    load = (lib.WebPPictureImportRGBA if arr.shape[2] == 4
            else lib.WebPPictureImportRGB)
    if not load(ctypes.byref(pic), arr.ctypes.data,
                arr.shape[1] * arr.shape[2]):
        raise RuntimeError("libwebp: picture import failed")
    writer = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(writer)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    data = ctypes.string_at(writer.mem, writer.size)
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    lib.WebPPictureFree(ctypes.byref(pic))
    if not ok:
        raise RuntimeError(f"libwebp: encoding failed ({pic.error_code})")
    return data


# ------------------------------------------------------------- the arrays

def seeded_array(seed: int, shape: tuple, extras: dict):
    """A colour array: per-channel gradients at different angles with
    Gaussian noise. ``extras``: ``alpha`` (an alpha ramp with a transparent
    corner), ``palette`` (that many seeded colours), ``flat`` (repeated
    rows, so the lossless encoder finds long backward references),
    ``blocks`` (a few flat rectangles), ``correlated`` (channels that
    differ by constants and a black corner)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    if extras.get("blocks"):
        arr = np.empty((h, w, 3), np.uint8)
        arr[:] = rng.integers(0, 256, 3, np.uint8)
        for _ in range(3):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            arr[y0:y0 + 8, x0:x0 + 12] = rng.integers(0, 256, 3, np.uint8)
        return arr
    if extras.get("correlated"):
        g = (3 * x + 2 * y) % 256 + rng.normal(0.0, 6.0, shape)
        arr = np.stack([g + 12, g, g - 20], -1) + rng.normal(0, 1.0,
                                                            (h, w, 3))
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        arr[:16, :16] = 0
        return arr
    if "palette" in extras:
        colours = rng.integers(0, 256, (extras["palette"], 4), np.uint8)
        colours[:, 3] = 255
        idx = (x // 3 + y // 2 + rng.integers(0, 2, shape)) % len(colours)
        idx[0, 0] = len(colours) - 1  # every colour present
        idx.flat[:len(colours)] = np.arange(len(colours))
        arr = colours[idx]
        if extras.get("alpha"):
            arr[..., 3] = np.where(idx % 3 == 0, 0, 255)
        return arr if extras.get("alpha") else arr[..., :3]
    base = np.stack([2 * x + 3 * y, 5 * x - y + 60, 120 + x * y / 8.0], -1)
    arr = np.clip(base % 256 + rng.normal(0.0, 14.0, (h, w, 3)), 0, 255)
    arr = arr.astype(np.uint8)
    if extras.get("flat"):
        arr[1:] = arr[:1] if h > 1 else arr[1:]
        arr[h // 2:, ::3] = arr[h // 2:, ::3] // 2
    if extras.get("alpha"):
        alpha = np.clip(255 - 4 * (x + y), 0, 255).astype(np.uint8)
        alpha[: h // 3, : w // 3] = 0
        arr = np.concatenate([arr, alpha[..., None]], -1)
    return arr


def colour_photo(photo, seed: int = 1026):
    """P1026's gray made colour: each channel scaled by its own smooth,
    seeded gain field (0.55-1.45)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = photo.shape[:2]
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    gray = photo[..., 0].astype(np.float64)
    out = []
    for _ in range(3):
        fx, fy, phase = rng.uniform(0.5, 2.5, 3)
        gain = 1.0 + 0.45 * np.sin(2 * np.pi * (fx * x + fy * y) + 6 * phase)
        out.append(np.clip(gray * gain, 0, 255))
    return np.stack(out, -1).astype(np.uint8)


# ---------------------------------------------- files assembled by hand

def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff(chunks: list) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def image_chunks(blob: bytes) -> list:
    """The ALPH, VP8 and VP8L chunks of a file libwebp wrote."""
    out, pos = [], 12
    while pos < len(blob):
        (size,) = struct.unpack("<I", blob[pos + 4:pos + 8])
        tag = blob[pos:pos + 4]
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            out.append(blob[pos:pos + 8 + size + (size & 1)])
        pos += 8 + size + (size & 1)
    return out


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def assembled() -> dict:
    """name -> (form, file) of the files put together here."""
    from PIL import Image

    out = {}
    arr = seeded_array(30, (23, 31), {})
    lossy = image_chunks(encode(arr, quality=70, method=4))
    # ICC (0x20), EXIF (0x08), XMP (0x04) and an unknown chunk of 3 bytes
    out["extended_metadata"] = (
        "VP8X with ICCP, EXIF, XMP and an unknown odd-sized chunk",
        riff([vp8x(0x2C, 31, 23), chunk(b"ICCP", b"\x01" * 7),
              chunk(b"ZZZZ", b"odd"), *lossy, chunk(b"EXIF", b"Exif\0"),
              chunk(b"XMP ", b"<x:xmpmeta/>")]))
    rgba = seeded_array(31, (19, 27), {"alpha": True})
    frame = image_chunks(encode(rgba[2:15, 3:24], quality=80, method=4))
    # frame 0: 21 x 13 at (4, 6) on a 27 x 19 canvas; ANMF: x/2, y/2,
    # width-1, height-1, duration, flags; a second frame follows
    anmf = (bytes.fromhex("020000030000") + (20).to_bytes(3, "little")
            + (12).to_bytes(3, "little") + (100).to_bytes(3, "little")
            + b"\x00")
    second = image_chunks(encode(rgba, lossless=1, method=2))
    full = (b"\0" * 6 + (26).to_bytes(3, "little")
            + (18).to_bytes(3, "little") + (100).to_bytes(3, "little")
            + b"\x02")
    out["animation_offset"] = (
        "animation: frame 0 a VP8 frame with alpha, 21x13 at (4, 6) on a "
        "27x19 canvas",
        riff([vp8x(0x12, 27, 19),
              chunk(b"ANIM", b"\xff\xff\xff\xff\x00\x00"),
              chunk(b"ANMF", anmf + b"".join(frame)),
              chunk(b"ANMF", full + b"".join(second))]))
    frames = [Image.fromarray(seeded_array(32 + k, (21, 26), {"alpha": True}))
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=60, method=4)
    out["animation_pil"] = ("animation written by PIL's save_all, 3 frames",
                            buf.getvalue())
    return out


# ----------------------------------------------------------------- output

def pixel_digest(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _progressive_script():
    spec = importlib.util.spec_from_file_location(
        "make_progressive_fixtures",
        os.path.join(ROOT, "scripts", "make_progressive_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(out_dir: str, drive: bool = True) -> dict:
    """Write the fixtures into ``out_dir/webp`` and return the reference
    file's content (without the driver runs unless ``drive``)."""
    _setup()
    import numpy as np
    import PIL
    from PIL import features

    from vanishing_points_2017_tpu.data import io as jio
    from vanishing_points_2017_tpu_torch.data import minisets

    prog = _progressive_script()
    fixture_dir = os.path.join(out_dir, FIXTURE_DIR)
    os.makedirs(fixture_dir, exist_ok=True)
    ref = {"pillow_version": np.asarray(PIL.__version__),
           "libwebp_version": np.asarray(features.version("webp")),
           "timed": np.array(list(PHOTOS))}
    ref |= {f"quality_{name}": np.asarray(QUALITY) for name in PHOTOS}
    with tempfile.TemporaryDirectory() as tmp:
        mini = os.path.join(tmp, "mini")
        minisets.make_mini_yud(mini, n_eval=prog.N_EVAL, seed=prog.SEED)
        photo_path = os.path.join(mini, PHOTO, f"{PHOTO}.jpg")
        photo = jio.load_image(photo_path)
        made = {}
        for name, (form, fields, colour) in PHOTOS.items():
            made[name] = (form, encode(colour_photo(photo) if colour
                                       else photo, **fields))
        for name, (form, seed, shape, fields, extras) in SMALL.items():
            made[name] = (form, encode(seeded_array(seed, shape, extras),
                                       **fields))
        made |= assembled()
        for name, (form, blob) in made.items():
            path = os.path.join(fixture_dir, f"{name}.webp")
            with open(path, "wb") as fh:
                fh.write(blob)
            pixels = jio.load_image(path)
            ref |= {f"sha256_{name}": np.asarray(pixel_digest(pixels)),
                    f"shape_{name}": np.asarray(pixels.shape),
                    f"file_sha256_{name}": np.asarray(
                        hashlib.sha256(blob).hexdigest()),
                    f"form_{name}": np.asarray(form)}
        ref["files"] = np.array(list(made))
        if drive:
            original = os.path.join(tmp, "P1026_baseline.jpg")
            shutil.copyfile(photo_path, original)
            for prefix, name in DRIVEN.items():
                # the WebP bytes under the name the adapter globs
                shutil.copyfile(os.path.join(fixture_dir, f"{name}.webp"),
                                photo_path)
                for run in prog.RUNS:
                    out = prog.run_outputs(run, mini, os.path.join(
                        tmp, prefix, "results"))
                    ref |= {k.replace(run, f"{prefix}_{run}", 1): v
                            for k, v in out.items()}
            shutil.copyfile(original, photo_path)
    return ref


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=DEFAULT_DIR,
                    help="where webp/ and the .npz go")
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    ref = make(args.out_dir)
    np.savez_compressed(os.path.join(args.out_dir, REFERENCE), **ref)
    runs = [k[4:] for k in ref if k.startswith("auc_")]
    aucs = ", ".join(f"{r} {float(ref[f'auc_{r}']):.4f}" for r in runs)
    print(f"wrote {len(ref['files'])} fixtures and {REFERENCE} into "
          f"{args.out_dir} in {time.time() - t0:.0f} s: AUC {aucs}")


if __name__ == "__main__":
    main()
