"""Host-side image ingest without PIL (``data/io.py`` of the JAX package).

The port does not use PIL, so :func:`load_image` decodes the file itself,
by its signature: PNG with ``zlib`` and numpy (8-bit grayscale,
grayscale+alpha, RGB and RGBA, non-interlaced: everything the bundled
scenes and the usual exported photos use), baseline JPEG through
``data/jpeg.py`` (the datasets' format; progressive files raise); other
formats raise. :func:`encode_png` writes 8-bit grayscale and RGB PNGs.
:func:`resize_max` reproduces Pillow's LANCZOS resize pixel for pixel. :func:`detect_lsd_lines`
runs the host LSD (``lsd.py``) and normalizes its segments.
``rgb2gray`` and ``normalized_horizon_error`` are the JAX package's
``data/io.py`` and ``data/datasets.py`` functions.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

# skimage.color.rgb2gray coefficients (ITU-R 601-2 luma, skimage order)
_LUMA = np.array([0.2125, 0.7154, 0.0721], np.float64)
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples/pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None/Sub/Up/Average/Paeth)."""
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = data[y, 0], data[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 2:
            cur = line + prev  # uint8 wraps, as the filter defines
        elif ftype == 1:
            # Sub: each byte adds the byte bpp to its left; the recurrence
            # is a per-lane prefix sum mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = (np.cumsum(lanes.reshape(-1, bpp).astype(np.uint32), 0)
                   % 256).astype(np.uint8).reshape(-1)[:stride]
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array, (H, W) grayscale or (H, W, C)."""
    if blob[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        ctype = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}); expected 8-bit "
                         "gray/gray+alpha/RGB/RGBA, non-interlaced")
    ch = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def png_size(blob: bytes) -> tuple[int, int]:
    """(height, width) from the IHDR chunk alone."""
    if blob[:8] != _PNG_SIG or blob[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    w, h = struct.unpack(">II", blob[16:24])
    return h, w


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) grayscale or (H, W, 3) RGB -> PNG bytes (filter type
    None on every scanline, zlib level 6)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("encode_png: expected a uint8 (H, W) or (H, W, 3) "
                         "array")
    h, w = img.shape[:2]

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)
    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         0 if img.ndim == 2 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG or JPEG file from its header: the first
    64 KiB are read, and the rest only where a JPEG's frame header lies
    beyond them (after a large embedded profile or thumbnail)."""
    from . import jpeg

    with open(path, "rb") as f:
        blob = f.read(1 << 16)
        if blob[:8] == _PNG_SIG:
            return png_size(blob)
        if blob[:2] != jpeg.JPEG_SIG:
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
        try:
            return jpeg.jpeg_size(blob)
        except ValueError as e:
            rest = f.read()
            if not (rest and str(e).startswith("truncated")):
                raise
        return jpeg.jpeg_size(blob + rest)


def load_image(path: str) -> np.ndarray:
    """PNG or baseline JPEG file -> RGB (or grayscale) uint8 array, by the
    file's signature; a PNG's alpha channel is dropped, like the JAX
    package's ``convert("RGB")``. Any other format raises."""
    from . import jpeg

    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == jpeg.JPEG_SIG:
        try:
            return jpeg.decode_jpeg(blob)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file; the "
                         "PyTorch port reads these two formats")
    img = decode_png(blob)
    if img.ndim == 3:
        img = img[..., :3] if img.shape[2] == 4 else (
            img[..., 0] if img.shape[2] == 2 else img)
    return np.ascontiguousarray(img)


# Pillow's 8-bit resampling (libImaging/Resample.c): coefficients in fixed
# point with 22 fraction bits, a half added before the shift, the result
# clipped to 0..255 after each pass.
_PRECISION_BITS = 22
_LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -_LANCZOS_SUPPORT <= x < _LANCZOS_SUPPORT:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


def _lanczos_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fixed-point Lanczos-3 weights, float64 holding
    integers (Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``,
    in its operation order): the support widens with the downscale factor,
    each row's taps are normalised to sum 1, then rounded half away from
    zero to 22 fraction bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    one = float(1 << _PRECISION_BITS)
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_lanczos((x - center + 0.5) * ss) for x in range(xmin, xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for i, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            mat[xx, xmin + i] = math.trunc(v * one + (-0.5 if v < 0 else 0.5))
    return mat


def _resample_rows(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """One 8-bit pass along axis 1 of (H, W, C) uint8. Products of 8-bit
    pixels and 22-bit weights sum below 2**31, so the float64 product is
    exact whatever the summation order."""
    acc = np.einsum("hwc,ow->hoc", img.astype(np.float64), mat, optimize=True)
    out = np.floor((acc + (1 << (_PRECISION_BITS - 1)))
                   / (1 << _PRECISION_BITS))
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_max(image: np.ndarray, target: int) -> np.ndarray:
    """Resize so the image fits in a target x target box, preserving aspect
    ratio (ImageMagick's ``convert -resize NxN`` semantics), with Pillow's
    ``Image.resize(..., LANCZOS)`` arithmetic on 8-bit L or RGB images:
    the horizontal pass first, then the vertical pass."""
    h, w = image.shape[0], image.shape[1]
    scale = target / max(w, h)
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    if (nw, nh) == (w, h):
        return image
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError("resize_max: expected an 8-bit L or RGB image")
    out = image if image.ndim == 3 else image[..., None]
    if nw != w:
        out = _resample_rows(out, _lanczos_matrix(w, nw))
    if nh != h:
        out = _resample_rows(out.transpose(1, 0, 2),
                             _lanczos_matrix(h, nh)).transpose(1, 0, 2)
    out = np.ascontiguousarray(out)
    return out if image.ndim == 3 else out[..., 0]


def rgb2gray(image: np.ndarray) -> np.ndarray:
    """uint8/float RGB -> float64 grayscale in [0, 1] (skimage-compatible)."""
    if image.ndim == 2:
        g = image.astype(np.float64)
        return g / 255.0 if g.max() > 1.0 else g
    rgb = image[..., :3].astype(np.float64) / 255.0
    return rgb @ _LUMA


def normalize_segments(segments_px: np.ndarray, width: int,
                       height: int) -> np.ndarray:
    """Pixel endpoints -> the pipeline's normalized frame: centre origin,
    +y up, the long axis scaled to [-1, 1] (``evaluation.py:240-249`` of
    the reference)."""
    s = max(width, height) / 2.0
    out = segments_px[:, :4].astype(np.float64).copy()
    out[:, 0] = (out[:, 0] - width / 2.0) / s
    out[:, 2] = (out[:, 2] - width / 2.0) / s
    out[:, 1] = -(out[:, 1] - height / 2.0) / s
    out[:, 3] = -(out[:, 3] - height / 2.0) / s
    return out


def detect_lsd_lines(image_gray: np.ndarray) -> dict:
    """Host LSD on a [0, 1]- or [0, 255]-valued grayscale image.

    Returns {'segments': (N, 4) normalized endpoints, 'nfa': (N,)} like the
    reference's ``detect_lsd_lines`` (``evaluation.py:227-251``)."""
    from .. import lsd

    img = image_gray.astype(np.float64)
    if img.size and np.max(img) <= 1.0:
        img = img * 255.0
    raw = lsd.detect_line_segments(img)
    segments = normalize_segments(raw, img.shape[1], img.shape[0])
    return {"segments": segments, "nfa": raw[:, 6] if raw.size else raw}


def normalized_horizon_error(est_horizon: np.ndarray,
                             true_horizon: np.ndarray,
                             width: int, height: int) -> float:
    """Max horizon deviation at x = +-1, normalized by image height
    (``benchmark.py:245-257`` of the reference)."""
    def at(h, x):
        p = np.cross(h, np.array([1.0 * x, 0.0, 1.0]))
        return p / p[2]

    scale = max(width, height)
    e1 = abs(at(est_horizon, 1)[1] - at(true_horizon, 1)[1])
    e2 = abs(at(est_horizon, -1)[1] - at(true_horizon, -1)[1])
    return max(e1, e2) / 2.0 * scale / height
