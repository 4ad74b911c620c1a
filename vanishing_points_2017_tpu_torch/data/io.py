"""Host-side image ingest without PIL.

The GPU machine this port targets has no PIL, so :func:`load_image` decodes
PNG itself with ``zlib`` and numpy: 8-bit grayscale, grayscale+alpha, RGB
and RGBA, non-interlaced (everything the bundled scenes and the usual
exported photos use). ``rgb2gray`` and ``normalized_horizon_error`` are the
JAX package's ``data/io.py`` and ``data/datasets.py`` functions.
"""

from __future__ import annotations

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


def load_image(path: str) -> np.ndarray:
    """PNG file -> RGB (or grayscale) uint8 array; an alpha channel is
    dropped, like the JAX package's ``convert("RGB")``."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.ndim == 3:
        img = img[..., :3] if img.shape[2] == 4 else (
            img[..., 0] if img.shape[2] == 2 else img)
    return np.ascontiguousarray(img)


def rgb2gray(image: np.ndarray) -> np.ndarray:
    """uint8/float RGB -> float64 grayscale in [0, 1] (skimage-compatible)."""
    if image.ndim == 2:
        g = image.astype(np.float64)
        return g / 255.0 if g.max() > 1.0 else g
    rgb = image[..., :3].astype(np.float64) / 255.0
    return rgb @ _LUMA


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
