"""Host-side image ingest without PIL (``data/io.py`` of the JAX package).

The port does not use PIL, so :func:`load_image` decodes the file itself,
by its signature, to the array the JAX package's ``load_image`` gets from
PIL: PNG with ``zlib`` and numpy (every colour type and bit depth of the
standard, palette included, Adam7-interlaced or not), every JPEG that
PIL 12.1.0 (libjpeg-turbo 3.1.3) opens through ``data/jpeg.py``
(sequential, progressive, arithmetic-coded and 8-bit lossless; gray,
YCbCr, RGB, CMYK and YCCK at any integral sampling; the datasets'
format), and every WebP file that PIL 12.1.0 (libwebp 1.6.0) opens
through ``data/webp.py`` (lossy and lossless, with or without alpha,
simple or extended, frame 0 of an animation); other formats (BMP, TIFF,
GIF, ...) raise. :func:`encode_png` writes 8-bit grayscale and RGB PNGs.
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
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples/pixel
# colour type -> the bit depths the standard allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None/Sub/Up/Average/Paeth)."""
    if len(raw) != h * (stride + 1):
        raise ValueError("corrupt PNG: the image data has the wrong size")
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


def _samples(raw: bytes, h: int, w: int, ch: int, depth: int) -> tuple:
    """One (sub-)image's filtered scanlines -> (H, W, ch) samples (uint16
    at 16 bits, else uint8 as stored), and the bytes it took."""
    stride = (w * ch * depth + 7) // 8
    size = h * (stride + 1)
    rows = _unfilter(raw[:size], h, stride, max(1, ch * depth // 8))
    if depth == 16:
        out = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        out = rows
    else:  # 1, 2 or 4 bits, the leftmost sample in the high bits
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bits.reshape(h, w, depth) * weights).sum(-1, dtype=np.uint8)
    return out.reshape(h, w, ch), size


def png_image(blob: bytes) -> tuple[np.ndarray, str]:
    """PNG bytes -> (samples, mode): the (H, W, C) samples and the mode PIL
    opens the file in ("1", "L", "I;16", "LA", "RGB", "RGBA" or "P").
    Samples are uint8 but for "I;16" (16-bit gray, uint16): other 16-bit
    files keep the high byte, as PIL's unpackers do, 2- and 4-bit gray is
    scaled to 0..255 (x 85, x 17) and 1-bit gray to 0 / 255, and a palette
    file's indices are looked up in its PLTE (RGB; an index past the
    palette gives black; tRNS is ignored)."""
    if blob[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte = 8, [], None, None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        ctype = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = hdr
    if depth not in _DEPTHS.get(color, ()) or interlace > 1:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    if color == 3 and (plte is None or len(plte) % 3 or len(plte) > 768):
        raise ValueError("corrupt PNG: a palette image without a valid PLTE")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        img = _samples(raw, h, w, ch, depth)[0]
    else:
        img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                img[y0::dy, x0::dx], size = _samples(raw, ph, pw, ch, depth)
                raw = raw[size:]
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        return lut[img[..., 0]], "P"
    if color == 0:
        if depth == 16:
            return img, "I;16"
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        return img, "1" if depth == 1 else "L"
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    return img, {2: "RGB", 4: "LA", 6: "RGBA"}[color]


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> the samples of :func:`png_image`, (H, W) for one
    channel, else (H, W, C)."""
    img = png_image(blob)[0]
    return img[..., 0] if img.shape[2] == 1 else img


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


_FORMATS = "the PyTorch port reads PNG, JPEG and WebP"


def _is_webp(blob: bytes) -> bool:
    return blob[:4] == b"RIFF" and blob[8:12] == b"WEBP"


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG, JPEG or WebP file from its header (for a
    JPEG any frame header the decoder reads, SOF0-3 and SOF9-10; for a
    WebP the VP8X canvas or the image's own header): the first 64 KiB are
    read, and the rest only where a JPEG's frame header lies beyond them
    (after a large embedded profile or thumbnail)."""
    from . import jpeg, webp

    with open(path, "rb") as f:
        blob = f.read(1 << 16)
        if blob[:8] == _PNG_SIG:
            return png_size(blob)
        if _is_webp(blob):
            try:
                return webp.webp_size(blob)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
        if blob[:2] != jpeg.JPEG_SIG:
            raise ValueError(f"{path}: not a PNG, JPEG or WebP file; "
                             f"{_FORMATS}")
        try:
            return jpeg.jpeg_size(blob)
        except ValueError as e:
            rest = f.read()
            if not (rest and str(e).startswith("truncated")):
                raise
        return jpeg.jpeg_size(blob + rest)


def load_image(path: str) -> np.ndarray:
    """PNG, JPEG or WebP file -> RGB (or grayscale) uint8 array, by the
    file's signature, as the JAX package's ``load_image`` gets it from PIL:
    "L" and "RGB" files as they are, every other mode through
    ``convert("RGB")`` (alpha dropped, gray replicated, 1-bit gray 0 /
    255, 16-bit gray clipped to 255, CMYK by Pillow's ``cmyk2rgb``; a
    WebP file is always RGB, an animation's frame 0). Any other format
    raises."""
    from . import jpeg, webp

    with open(path, "rb") as f:
        blob = f.read()
    for sig, decode in ((blob[:2] == jpeg.JPEG_SIG, jpeg.decode_jpeg),
                        (_is_webp(blob), webp.decode_webp)):
        if sig:
            try:
                return decode(blob)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG, JPEG or WebP file; "
                         f"{_FORMATS}")
    img, mode = png_image(blob)
    if mode == "L":
        return np.ascontiguousarray(img[..., 0])
    if mode in ("1", "I;16", "LA"):
        img = np.repeat(np.minimum(img[..., :1], 255).astype(np.uint8), 3,
                        axis=2)
    return np.ascontiguousarray(img[..., :3])


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
