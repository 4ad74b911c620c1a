"""WebP without PIL: the port's stand-in for PIL's WebP reader.

The JAX package reads images through PIL, and PIL 12.1.0 reads WebP with
its bundled libwebp 1.6.0: ``WebPAnimDecoder`` over the file's frames, in
RGBA, then ``convert("RGB")``. :func:`decode_webp` gives the same pixels
bit for bit:

* lossy (VP8) key frames, decoded to Y, U and V planes as RFC 6386 and
  libwebp decode them, then turned RGB as libwebp's default output does:
  "fancy" upsampling of the chroma and its 14-bit fixed-point YUV -> RGB;
* lossless (VP8L) images, ARGB to RGB;
* the simple layouts (a ``VP8 `` or ``VP8L`` chunk) and the extended one
  (``VP8X``): its canvas, alpha (``ALPH``, checked as libwebp checks it on
  decoding and then dropped, as ``convert("RGB")`` drops it), ``ICCP``,
  ``EXIF``, ``XMP `` and unknown chunks skipped, odd chunk sizes padded;
* animations (``ANIM``, ``ANMF``): frame 0, the frame PIL shows, placed at
  its offset on a canvas of transparent black (black in RGB).

The container is parsed in Python with libwebp's demuxer's rules: a file
shorter than its RIFF header says, a chunk past the RIFF end, a frame
outside the canvas, a still image whose size is not the canvas's, reserved
VP8X flags, or frames that are not where the layout puts them raise a
``ValueError`` naming what is wrong, where PIL fails to open the file; so
does a bitstream that libwebp refuses (an inter frame, a bad start code, a
partition past the data, data that ends before the image, a prefix code
that is not complete, a backward reference out of the image). The port
never returns a partial image.

The bit-serial and per-block work (the boolean and prefix decoders,
prediction, transforms, loop filter, upsampling, the lossless transforms)
is C++ (``csrc/webp_decode.cpp``), built with g++ at first use into the
git-ignored ``build/webp/``. A failed build raises; nothing falls back.

Set :data:`COVERAGE` to a dict to have each decode add the coding tools its
streams used (names in :data:`VP8_TOOLS` and :data:`VP8L_TOOLS`) to it.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading

import numpy as np

from .. import hostbuild

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "webp_decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "webp")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

RIFF_SIG, WEBP_SIG = b"RIFF", b"WEBP"
_IMAGE_TAGS = (b"VP8 ", b"VP8L")
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_AREA = 1 << 32
# VP8X flags: animation, XMP, EXIF, alpha, ICC profile
_ANIMATION, _ALPHA, _VALID_FLAGS = 0x02, 0x10, 0x3E

_ERRORS = {
    -1: "a VP8 frame header that is not a key frame's (frame tag or start "
        "code)",
    -2: "a VP8 inter frame (a still image is one key frame)",
    -3: "the VP8 first partition runs past the data",
    -4: "the VP8 data ends in the segment header",
    -5: "the VP8 data ends in the filter header",
    -6: "the VP8 token partitions run past the data",
    -7: "the VP8 data ends in the first partition's modes",
    -8: "the VP8 data ends in a token partition",
    -9: "the VP8 frame's size differs from its header's",
    -20: "the VP8L data ends before the image does",
    -21: "a VP8L header with a bad signature, version or size",
    -22: "a VP8L transform given twice",
    -23: "VP8L colour cache bits outside 1..11",
    -24: "a VP8L prefix code that is not complete",
    -25: "a VP8L code-length repeat past the alphabet",
    -26: "a VP8L backward reference out of the image",
    -27: "a VP8L code with more lengths than symbols",
}

# the coverage counters of csrc/webp_decode.cpp, in its order
_BMODES = ("DC", "TM", "VE", "HE", "RD", "VR", "LD", "VL", "HD", "HU")
VP8_TOOLS = (
    *(f"i16_{m}" for m in ("DC", "TM", "V", "H")),
    *(f"i4_{m}" for m in _BMODES),
    *(f"uv_{m}" for m in ("DC", "TM", "V", "H")),
    "filter_simple", "filter_normal", "filter_none",
    *(f"partitions_{n}" for n in (1, 2, 4, 8)),
    "segments", "segment_map", "skip_proba_on", "skip_proba_off",
    "skipped_macroblocks", "proba_updates", "lf_deltas", "sharpness",
    "i4_macroblocks", "i16_macroblocks")
VP8L_TOOLS = (
    *(f"predictor_mode_{m}" for m in range(14)),
    "transform_predictor", "transform_cross_color",
    "transform_subtract_green", "transform_color_indexing",
    *(f"palette_{n}_per_byte" for n in (1, 2, 4, 8)),
    "color_cache", "color_cache_hits", "meta_codes", "one_symbol_codes",
    "simple_codes", "normal_codes", "backward_refs")
COVERAGE: dict | None = None

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(hostbuild.build_shared(SOURCE, FLAGS,
                                                     BUILD_DIR, "libwebp"))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.webp_vp8_decode.restype = i64
            lib.webp_vp8_decode.argtypes = [p, i64, i32, i32, p, p, p, p]
            lib.webp_yuv_to_rgb.restype = None
            lib.webp_yuv_to_rgb.argtypes = [p, p, p, i32, i32, p]
            lib.webp_vp8l_decode.restype = i64
            lib.webp_vp8l_decode.argtypes = [p, i64, i32, i32, i32, p, p]
            for name, tools in (("webp_vp8_stats_size", VP8_TOOLS),
                                ("webp_vp8l_stats_size", VP8L_TOOLS)):
                getattr(lib, name).restype = i32
                if getattr(lib, name)() != len(tools):
                    raise RuntimeError(f"{SOURCE}: {name} disagrees with "
                                       "data/webp.py's counter names")
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _stats(tools: tuple) -> np.ndarray | None:
    return None if COVERAGE is None else np.zeros(len(tools), np.int64)


def _record(tools: tuple, stats: np.ndarray | None) -> None:
    if stats is not None and COVERAGE is not None:
        for name, n in zip(tools, stats.tolist()):
            COVERAGE[name] = COVERAGE.get(name, 0) + n


def _check(rc: int) -> None:
    if rc:
        raise ValueError(_ERRORS.get(rc, f"corrupt WebP data (code {rc})"))


# -------------------------------------------------------------- bitstreams

def _le24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def _bitstream_size(tag: bytes, payload: bytes, size: int) -> tuple:
    """(height, width) from a VP8 or VP8L chunk's first bytes, with the
    checks libwebp's ``WebPGetFeatures`` makes (``size`` is the chunk's
    declared payload size)."""
    if tag == b"VP8 ":
        if len(payload) < 10:
            raise ValueError("a VP8 chunk too short for its frame header")
        bits = _le24(payload)
        if bits & 1:
            raise ValueError("a VP8 inter frame (a still image is one key "
                             "frame)")
        if payload[3:6] != b"\x9d\x01\x2a":
            raise ValueError("a VP8 frame without the key frame start code")
        if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size:
            raise ValueError("a VP8 frame header with a bad profile, an "
                             "invisible frame or a first partition past the "
                             "chunk")
        # 14-bit sizes; the 2 scale bits above them are ignored, as libwebp
        # ignores them
        w = struct.unpack("<H", payload[6:8])[0] & 0x3FFF
        h = struct.unpack("<H", payload[8:10])[0] & 0x3FFF
        if w == 0 or h == 0:
            raise ValueError("a VP8 frame of width or height 0")
        return h, w
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise ValueError("a VP8L chunk without its signature and version 0")
    bits = int.from_bytes(payload[1:5], "little")
    return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1


def _decode_vp8(payload: bytes, h: int, w: int) -> np.ndarray:
    lib = _load()
    data = np.frombuffer(payload, np.uint8)
    y = np.empty((h, w), np.uint8)
    uh, uw = (h + 1) // 2, (w + 1) // 2
    u, v = np.empty((uh, uw), np.uint8), np.empty((uh, uw), np.uint8)
    stats = _stats(VP8_TOOLS)
    _check(lib.webp_vp8_decode(_ptr(data), data.size, w, h, _ptr(y), _ptr(u),
                               _ptr(v), None if stats is None else
                               _ptr(stats)))
    _record(VP8_TOOLS, stats)
    rgb = np.empty((h, w, 3), np.uint8)
    lib.webp_yuv_to_rgb(_ptr(y), _ptr(u), _ptr(v), w, h, _ptr(rgb))
    return rgb


def _decode_vp8l(payload: bytes, h: int, w: int,
                 header: bool = True) -> np.ndarray:
    """A VP8L stream (with its 5-byte header, or an ``ALPH`` chunk's
    headerless one, whose tools are not recorded) -> (h, w) ARGB as
    uint32."""
    lib = _load()
    data = np.frombuffer(payload, np.uint8)
    argb = np.empty((h, w), np.uint32)
    stats = _stats(VP8L_TOOLS) if header else None
    _check(lib.webp_vp8l_decode(_ptr(data), data.size, w, h, int(header),
                                _ptr(argb), None if stats is None else
                                _ptr(stats)))
    _record(VP8L_TOOLS, stats)
    return argb


def _check_alpha(alph: bytes, h: int, w: int) -> None:
    """What libwebp's alpha decoder refuses, which fails the whole decode:
    a bad ``ALPH`` header byte, raw alpha shorter than the image, or a
    lossless alpha stream that does not decode."""
    if len(alph) <= 1:
        raise ValueError("an ALPH chunk without data")
    method, pre, reserved = alph[0] & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError("an ALPH chunk with a bad header byte")
    if method == 0:
        if len(alph) - 1 < h * w:
            raise ValueError("raw alpha shorter than the image")
        return
    _decode_vp8l(alph[1:], h, w, header=False)


# ---------------------------------------------------------------- container

class _Frame:
    """One frame of the demuxed file: its image chunk, the bytes its codec
    reads (the payload, padding included), its alpha payload, offset and
    bitstream size."""

    def __init__(self):
        self.tag = None
        self.payload = b""
        self.alpha = None
        self.alpha_pos = self.image_pos = -1
        self.x = self.y = 0
        self.h = self.w = 0


class _Reader:
    """A cursor over the RIFF payload, ending at the RIFF's end."""

    def __init__(self, blob: bytes, pos: int, end: int):
        self.blob, self.pos, self.end = blob, pos, end

    def left(self) -> int:
        return self.end - self.pos

    def header(self) -> tuple:
        if self.left() < 8:
            raise ValueError("the chunks end inside a chunk header")
        tag = self.blob[self.pos:self.pos + 4]
        (size,) = struct.unpack("<I", self.blob[self.pos + 4:self.pos + 8])
        if size > _MAX_PAYLOAD:
            raise ValueError(f"chunk {tag!r} of {size} bytes")
        padded = size + (size & 1)
        if padded > self.end - self.pos - 8:
            raise ValueError(f"chunk {tag!r} runs past the end of the RIFF "
                             "data")
        return tag, size, padded


def _store_frame(r: _Reader, frame: _Frame) -> None:
    """libwebp's ``StoreFrame``: an optional ``ALPH`` chunk, then the image
    chunk; stops before any other chunk."""
    start0 = r.pos
    while True:
        if r.left() < 8:
            if r.left() == 0 and r.pos != start0:
                return
            raise ValueError("the chunks end where an image chunk should "
                             "be" if r.pos == start0 else
                             "bytes after the last chunk that are no chunk")
        start = r.pos
        tag, size, padded = r.header()
        body = r.blob[start + 8:start + 8 + padded]
        if tag == b"ALPH" and frame.alpha is None:
            frame.alpha, frame.alpha_pos = body[:size], start
        elif tag in _IMAGE_TAGS and frame.tag is None:
            if tag == b"VP8L" and frame.alpha is not None:
                raise ValueError("an ALPH chunk before a VP8L image, which "
                                 "carries its own alpha")
            frame.h, frame.w = _bitstream_size(tag, body, size)
            frame.tag, frame.payload, frame.image_pos = tag, body, start
        else:
            return
        r.pos = start + 8 + padded


def _demux(blob: bytes) -> tuple:
    """(canvas height, width, frames) as libwebp's demuxer parses them."""
    if len(blob) < 12 or blob[:4] != RIFF_SIG or blob[8:12] != WEBP_SIG:
        raise ValueError("not a WebP file (no RIFF WEBP header)")
    first = blob[12:16]
    if first not in (*_IMAGE_TAGS, b"VP8X"):
        raise ValueError(f"a WebP file whose first chunk is {first!r}, not "
                         "VP8, VP8L or VP8X")
    (riff_size,) = struct.unpack("<I", blob[4:8])
    if riff_size < 8 or riff_size > _MAX_PAYLOAD:
        raise ValueError(f"a RIFF size of {riff_size}")
    end = riff_size + 8
    if len(blob) < end:
        raise ValueError(f"truncated: the RIFF header gives {end} bytes, the "
                         f"file has {len(blob)}")
    r = _Reader(blob, 12, end)
    frames: list = []
    if first in _IMAGE_TAGS:  # the simple layout: one image
        frame = _Frame()
        _store_frame(r, frame)
        frame.alpha = None  # alpha only where VP8X says so
        if frame.tag is None:
            raise ValueError("a WebP file without an image")
        return frame.h, frame.w, [frame]

    tag, size, padded = r.header()
    if size < 10:
        raise ValueError("a VP8X chunk shorter than 10 bytes")
    body = blob[20:20 + padded]
    flags = body[0]
    cw, ch = _le24(body[4:7]) + 1, _le24(body[7:10]) + 1
    if cw * ch >= _MAX_AREA:
        raise ValueError(f"a canvas of {cw} x {ch}")
    if flags & ~_VALID_FLAGS:
        raise ValueError(f"VP8X flags 0x{flags:02x} set reserved bits")
    animated = bool(flags & _ANIMATION)
    r.pos = 20 + padded
    anim = 0
    while r.pos < end:
        start = r.pos
        tag, size, padded = r.header()
        if tag == b"VP8X":
            raise ValueError("a second VP8X chunk")
        if tag in (b"ALPH", *_IMAGE_TAGS):
            if anim or animated:
                raise ValueError("an image outside ANMF in an animation")
            if frames:
                raise ValueError("a second image in a still file")
            frame = _Frame()
            _store_frame(r, frame)
            if not flags & _ALPHA:  # alpha only where VP8X says so
                frame.alpha, frame.alpha_pos = None, -1
            if frame.tag is None:
                raise ValueError("an ALPH chunk without its image")
            frames.append(frame)
        elif tag == b"ANIM":
            if padded < 6:
                raise ValueError("an ANIM chunk shorter than 6 bytes")
            anim += 1
            r.pos = start + 8 + padded
        elif tag == b"ANMF":
            if not anim:
                raise ValueError("an ANMF chunk before the ANIM chunk")
            if padded < 16:
                raise ValueError("an ANMF chunk shorter than 16 bytes")
            head = blob[start + 8:start + 24]
            frame = _Frame()
            frame.x, frame.y = 2 * _le24(head[0:3]), 2 * _le24(head[3:6])
            fw, fh = _le24(head[6:9]) + 1, _le24(head[9:12]) + 1
            if fw * fh >= _MAX_AREA:
                raise ValueError(f"an animation frame of {fw} x {fh}")
            r.pos = start + 24
            _store_frame(r, frame)
            if r.pos - (start + 24) > padded - 16:
                raise ValueError("an ANMF frame's chunks run past it")
            if animated and frame.tag is not None:
                frames.append(frame)
            elif animated and frame.alpha is not None:
                raise ValueError("an animation frame without its image")
        else:  # ICCP, EXIF, XMP and unknown chunks
            r.pos = start + 8 + padded
        if r.pos != end and r.left() < 8:
            raise ValueError("bytes after the last chunk that are no chunk")
    if not frames:
        raise ValueError("a WebP file without an image")
    for f in frames:
        if f.alpha_pos > f.image_pos:
            raise ValueError("an ALPH chunk after its image")
        if animated:
            if f.x + f.w > cw or f.y + f.h > ch:
                raise ValueError(f"an animation frame of {f.w} x {f.h} at "
                                 f"({f.x}, {f.y}) outside the {cw} x {ch} "
                                 "canvas")
        elif (f.w, f.h) != (cw, ch):
            raise ValueError(f"an image of {f.w} x {f.h} on a canvas of "
                             f"{cw} x {ch}")
    return ch, cw, frames


def webp_size(blob: bytes) -> tuple[int, int]:
    """(height, width) from the header alone: the VP8X canvas, or the VP8
    frame header's 14-bit sizes, or VP8L's."""
    if len(blob) < 12 or blob[:4] != RIFF_SIG or blob[8:12] != WEBP_SIG:
        raise ValueError("not a WebP file (no RIFF WEBP header)")
    tag = blob[12:16]
    if len(blob) < 20:
        raise ValueError("truncated WebP header")
    (size,) = struct.unpack("<I", blob[16:20])
    if tag == b"VP8X":
        if size < 10 or len(blob) < 30:
            raise ValueError("a VP8X chunk shorter than 10 bytes")
        return _le24(blob[27:30]) + 1, _le24(blob[24:27]) + 1
    if tag in _IMAGE_TAGS:
        return _bitstream_size(tag, blob[20:30], size)
    raise ValueError(f"a WebP file whose first chunk is {tag!r}, not VP8, "
                     "VP8L or VP8X")


def decode_webp(blob: bytes) -> np.ndarray:
    """WebP bytes -> uint8 (H, W, 3) RGB: what PIL 12.1.0 (libwebp 1.6.0)
    shows for frame 0, through ``convert("RGB")``."""
    ch, cw, frames = _demux(blob)
    f = frames[0]
    if f.tag == b"VP8L":
        argb = _decode_vp8l(f.payload, f.h, f.w)
        rgb = argb.view(np.uint8).reshape(f.h, f.w, 4)[..., 2::-1]
    else:
        if f.alpha is not None:
            _check_alpha(f.alpha, f.h, f.w)
        rgb = _decode_vp8(f.payload, f.h, f.w)
    if (f.h, f.w) == (ch, cw):
        return np.ascontiguousarray(rgb)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[f.y:f.y + f.h, f.x:f.x + f.w] = rgb
    return canvas
