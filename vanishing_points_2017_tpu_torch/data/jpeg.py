"""JPEG codec in numpy: the port's stand-in for PIL's.

The JAX package reads the datasets' JPEG files through PIL, that is,
through libjpeg with its default settings. The port uses no PIL, and the
host LSD must see the same pixels in both packages, so :func:`decode_jpeg`
reproduces that decode bit for bit, pinned to what PIL 12.1.0 with its
bundled libjpeg-turbo 3.1.3 gives (filters and conversions differ
between libjpeg and Pillow releases): the integer "islow" inverse DCT
(13-bit constants, 2 extra bits between the passes, the range-limit
table), "fancy" triangle upsampling of h2v1, h2v2 (libjpeg's rounding
biases, plain replication where a plane is at most 2 samples wide) and
h1v2 (its vertical filter, biases 1 above and 2 below, any width), plain
replication for every other integral ratio, and the 16-bit fixed-point
YCbCr -> RGB tables. Each component is dequantised with the table in
force at its first scan, where libjpeg latches it.

Read, as PIL reads them: baseline and extended sequential DCT (SOF0 and
SOF1) and progressive DCT (SOF2), Huffman coded, and both arithmetic
coded (SOF9, SOF10: T.81's QM decoder with the DAC segment's
conditioning or the default); 8-bit lossless (SOF3, Huffman coded:
predictors 1-7, a point transform, restarts of whole MCU rows, the
samples as they are and components replicated, as libjpeg-turbo gives
them); 1, 3 or 4 components, sampling factors 1-4 at integral ratios,
restart intervals, interleaved and non-interleaved scans, any size. A
progressive file's scans (spectral selection and successive
approximation) build the same coefficient arrays a sequential file
carries, then the same output pass runs; where they leave any
coefficient 1-9 (zigzag order) short of its last bit, libjpeg-turbo
3.1.3's block smoothing (``jdcoefct.c``'s ``decompress_smooth_data``: a
5 x 5 block neighbourhood of DC values, DC interpolation where
coefficients 1-9 were never sent) estimates them first. Four components
are CMYK, or YCCK under an Adobe transform other than 0 (turned CMYK
with the YCbCr tables); PIL reads every such file as Adobe's inverted
CMYK and the JAX package's ``load_image`` converts it with Pillow's
``cmyk2rgb``, so :func:`decode_jpeg` returns that RGB.

Refused, as PIL 12.1.0 refuses them (each ``ValueError`` says what the
file is): 12-bit samples and lossless of other than 8 bits,
hierarchical (SOF5-7, SOF13-15) and arithmetic-coded lossless (SOF11)
frames, a height given by a DNL marker, fractional sampling ratios, more
than 10 blocks per MCU in an interleaved scan, lossless YCbCr or YCCK
(libjpeg converts no colour in lossless mode), lossless restarts inside an
MCU row, 2 components. One difference: PIL opens an arithmetic-coded
file only while its scans lie in Pillow's first read block
(``ImageFile.MAXBLOCK``, 64 KiB by default), since libjpeg's arithmetic
decoder cannot wait for more input; the port reads such files whole.

:func:`encode_jpeg` writes what PIL's ``save(quality=q)`` writes with its
defaults (JFIF, 4:2:0 for colour, the standard's Huffman tables, no
optimisation) in integer arithmetic only (libjpeg's quality scaling,
fixed-point RGB -> YCbCr, the h2v2 box downsample with alternating bias,
the "islow" forward DCT, round-half-away quantisation), so one array
gives the same bytes on every machine.

The marker layer, the DCTs, the smoothing, the sampling and the colour
transforms are numpy on whole planes; the bit-serial entropy coders
(Huffman, arithmetic, lossless and its prediction) are C++
(``csrc/jpeg_entropy.cpp``), built with g++ at first use into the
git-ignored ``build/jpeg/``. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import hostbuild

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "jpeg_entropy.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "jpeg")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

JPEG_SIG = b"\xff\xd8"
_TABLE_BYTES = 16 + 256
_ERRORS = {-1: "the data ends inside a scan",
           -2: "a bit string that is no Huffman code",
           -3: "a run past the 64th coefficient",
           -4: "a restart marker is missing or out of sequence",
           -5: "a scan names a Huffman table that was not defined",
           -6: "the output buffer is too small",
           -7: "a coefficient outside the baseline range",
           -8: "an arithmetic-coded magnitude or run past its range"}

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {
    0xC5: "differential sequential DCT (SOF5)",
    0xC6: "differential progressive DCT (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential DCT (SOF13)",
    0xCE: "arithmetic-coded differential progressive DCT (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)"}

# the "islow" DCTs' constants: FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F_0_298, _F_0_390, _F_0_541, _F_0_765 = 2446, 3196, 4433, 6270
_F_0_899, _F_1_175, _F_1_501, _F_1_847 = 7373, 9633, 12299, 15137
_F_1_961, _F_2_053, _F_2_562, _F_3_072 = 16069, 16819, 20995, 25172

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(hostbuild.build_shared(SOURCE, FLAGS,
                                                     BUILD_DIR, "libjpeg"))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.jpeg_decode_scan.restype = i64
            lib.jpeg_decode_scan.argtypes = [p, i64, ctypes.c_int, p, i64,
                                             i64, ctypes.c_int, p, p]
            lib.jpeg_decode_scan_progressive.restype = i64
            lib.jpeg_decode_scan_progressive.argtypes = [
                p, i64, ctypes.c_int, p, i64, i64, ctypes.c_int, p,
                *[ctypes.c_int] * 4, p]
            lib.jpeg_decode_scan_arith.restype = i64
            lib.jpeg_decode_scan_arith.argtypes = [
                p, i64, ctypes.c_int, p, i64, i64, ctypes.c_int, p,
                *[ctypes.c_int] * 5, p]
            lib.jpeg_decode_scan_lossless.restype = i64
            lib.jpeg_decode_scan_lossless.argtypes = [p, i64, ctypes.c_int, p,
                                                      i64, i64, ctypes.c_int,
                                                      p, p]
            lib.jpeg_undifference.restype = None
            lib.jpeg_undifference.argtypes = [p, i64, i64, i64,
                                              *[ctypes.c_int] * 3, p, p]
            lib.jpeg_encode_scan.restype = i64
            lib.jpeg_encode_scan.argtypes = [p, ctypes.c_int, p, i64, i64,
                                             ctypes.c_int, p, p, i64]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


# ------------------------------------------------------------------ frame

class _Component:
    def __init__(self, cid: int, hs: int, vs: int, tq: int):
        self.cid, self.hs, self.vs, self.tq = cid, hs, vs, tq
        self.seen = False
        self.qt = None  # the table latched at the component's first scan
        # lossless: (predictor, point transform, rows that predict from
        # the left alone)
        self.lossless = None
        # the successive-approximation bit last reached for each zigzag
        # coefficient, -1 while it was never coded (libjpeg's coef_bits)
        self.coef_bits = np.full(64, -1, np.int64)


class _Frame:
    """The frame header and the block layout that follows from it."""

    def __init__(self, height: int, width: int, comps: list,
                 progressive: bool = False, arithmetic: bool = False,
                 lossless: bool = False):
        self.height, self.width, self.comps = height, width, comps
        self.progressive, self.arithmetic = progressive, arithmetic
        self.lossless = lossless
        # a lossless frame's "block" is one sample
        self.unit = unit = 1 if lossless else 8
        self.hmax = max(c.hs for c in comps)
        self.vmax = max(c.vs for c in comps)
        self.mcus_x = _ceil_div(width, unit * self.hmax)
        self.mcus_y = _ceil_div(height, unit * self.vmax)
        offset = 0
        for c in comps:
            # the component's own size, and its block array padded to
            # whole MCUs
            c.w = _ceil_div(width * c.hs, self.hmax)
            c.h = _ceil_div(height * c.vs, self.vmax)
            c.bw, c.bh = self.mcus_x * c.hs, self.mcus_y * c.vs
            c.offset = offset
            offset += c.bw * c.bh * unit * unit
        self.n_coefs = offset

    def layout(self, comps: list, tables: list | None = None):
        """The entropy coder's description of a scan over ``comps``:
        (layout array, MCUs across, MCUs down). A scan of one component is
        not interleaved: its MCU is one block, over the component's own
        blocks only."""
        single = len(comps) == 1
        rows = []
        for i, c in enumerate(comps):
            td, ta = tables[i] if tables else (0, 0)
            rows.append([1 if single else c.hs, 1 if single else c.vs,
                         c.bw, c.offset, td, ta])
        if single:
            return (np.array(rows, np.int64),
                    _ceil_div(comps[0].w, self.unit),
                    _ceil_div(comps[0].h, self.unit))
        if sum(c.hs * c.vs for c in comps) > 10:
            raise ValueError("unsupported JPEG: an interleaved scan of more "
                             "than 10 blocks per MCU (libjpeg's limit)")
        return np.array(rows, np.int64), self.mcus_x, self.mcus_y


def _parse_frame(marker: int, seg: bytes) -> _Frame:
    if marker in _SOF_NAMES:
        raise ValueError(f"unsupported JPEG: {_SOF_NAMES[marker]}; the port "
                         "reads sequential and progressive DCT JPEG, "
                         "Huffman or arithmetic-coded, and Huffman-coded "
                         "lossless JPEG, as PIL does")
    precision = seg[0]
    height, width = int.from_bytes(seg[1:3], "big"), int.from_bytes(
        seg[3:5], "big")
    ncomp = seg[5]
    if precision != 8:
        raise ValueError(f"unsupported JPEG: {precision}-bit samples")
    if ncomp not in (1, 3, 4):
        raise ValueError(f"unsupported JPEG: {ncomp} components")
    if height == 0 or width == 0:
        raise ValueError("unsupported JPEG: empty frame or height given by "
                         "a DNL marker")
    if len(seg) < 6 + 3 * ncomp:
        raise ValueError("corrupt JPEG: bad frame header")
    comps = []
    for i in range(ncomp):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
            raise ValueError(f"corrupt JPEG: component {cid} has sampling "
                             f"factors {hv >> 4}x{hv & 15}")
        comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    frame = _Frame(height, width, comps,
                   progressive=marker in (0xC2, 0xCA),
                   arithmetic=marker in (0xC9, 0xCA), lossless=marker == 0xC3)
    for c in comps:
        if ncomp > 1 and (frame.hmax % c.hs or frame.vmax % c.vs):
            raise ValueError(
                f"unsupported JPEG: component {c.cid} sampled {c.hs}x{c.vs} "
                f"in a {frame.hmax}x{frame.vmax} frame (fractional "
                "sampling, which libjpeg does not implement either)")
    return frame


class _Parsed:
    def __init__(self):
        self.frame: _Frame | None = None
        self.qt: dict = {}
        self.jfif = False
        self.adobe_transform: int | None = None
        self.coefs: np.ndarray | None = None
        # the DAC conditioning: DC tables' U << 4 | L (default L = 0,
        # U = 1), then AC tables' K (default 5)
        self.conditioning = np.array([0x10] * 16 + [5] * 16, np.uint8)


def _parse(blob: bytes, header_only: bool = False) -> _Parsed:
    """Walk the markers; decode every scan's coefficients unless
    ``header_only`` (then return at the frame header)."""
    if blob[:2] != JPEG_SIG:
        raise ValueError("not a JPEG file")
    out = _Parsed()
    tables = np.zeros((8, _TABLE_BYTES), np.uint8)
    restart = 0
    data = np.frombuffer(blob, np.uint8)
    pos, n = 2, len(blob)
    while True:
        # the next marker: 0xFF, any fill 0xFF bytes, then its code
        while pos < n and blob[pos] != 0xFF:
            pos += 1
        while pos < n and blob[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("truncated JPEG: no end-of-image marker")
        marker = blob[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0x00, 0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        length = int.from_bytes(blob[pos:pos + 2], "big")
        seg = blob[pos + 2:pos + length]
        if length < 2 or pos + length > n:
            raise ValueError("truncated JPEG: a segment runs past the end")
        pos += length
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if out.frame is not None:
                raise ValueError("unsupported JPEG: more than one frame")
            out.frame = _parse_frame(marker, seg)
            if header_only:
                return out
            out.coefs = np.zeros(out.frame.n_coefs, np.int16)
        elif marker == 0xCC:
            if len(seg) % 2:
                raise ValueError("corrupt JPEG: bad DAC segment")
            for index, value in zip(seg[0::2], seg[1::2]):
                if index >= 32 or (index < 16 and value & 15 > value >> 4):
                    raise ValueError("corrupt JPEG: bad arithmetic "
                                     "conditioning in a DAC segment")
                out.conditioning[index] = value
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                count = sum(seg[i + 1:i + 17])
                if tc > 1 or th > 3 or count > 256:
                    raise ValueError("corrupt JPEG: bad Huffman table")
                t = tables[4 * tc + th]
                t[:] = 0
                t[:16 + count] = np.frombuffer(seg[i + 1:i + 17 + count],
                                               np.uint8)
                i += 17 + count
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + size],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                out.qt[tq] = table
                i += 1 + size
        elif marker == 0xDD:
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            out.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            out.adobe_transform = seg[11]
        elif marker == 0xDA:
            frame = out.frame
            if frame is None:
                raise ValueError("corrupt JPEG: a scan before the frame")
            ns = seg[0] if seg else 0
            if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
                raise ValueError("corrupt JPEG: bad scan header")
            by_id = {c.cid: c for c in frame.comps}
            comps, tabs = [], []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                if cid not in by_id:
                    raise ValueError("corrupt JPEG: a scan names an unknown "
                                     "component")
                comps.append(by_id[cid])
                tabs.append((t >> 4, t & 15))
            for c in comps:
                c.seen = True
                if c.qt is None and not frame.lossless:  # latch_quant_tables
                    if c.tq not in out.qt:
                        raise ValueError(
                            "corrupt JPEG: a component names a quantisation "
                            "table that was not defined")
                    c.qt = out.qt[c.tq]
            layout, mx, my = frame.layout(comps, tabs)
            band = (_progression(comps, *seg[1 + 2 * ns:4 + 2 * ns])
                    if frame.progressive else (0, 63, 0, 0))
            args = (_ptr(data[pos:]), n - pos, ns, _ptr(layout), mx, my,
                    restart)
            if frame.lossless:
                _lossless_scan(comps, mx, my, restart,
                               *seg[1 + 2 * ns:4 + 2 * ns])
                used = _load().jpeg_decode_scan_lossless(
                    *args, _ptr(tables), _ptr(out.coefs))
            elif frame.arithmetic:
                used = _load().jpeg_decode_scan_arith(
                    *args, _ptr(out.conditioning), int(frame.progressive),
                    *band, _ptr(out.coefs))
            elif frame.progressive:
                used = _load().jpeg_decode_scan_progressive(
                    *args, _ptr(tables), *band, _ptr(out.coefs))
            else:
                used = _load().jpeg_decode_scan(*args, _ptr(tables),
                                                _ptr(out.coefs))
            if used < 0:
                raise ValueError(f"corrupt JPEG: {_ERRORS.get(used, used)}")
            pos += used
        # APPn, COM and every other segment are skipped
    if out.frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    if not all(c.seen for c in out.frame.comps):
        raise ValueError("corrupt JPEG: a component has no scan")
    return out


def _progression(comps: list, ss: int, se: int, a: int) -> tuple:
    """A progressive scan's (Ss, Se, Ah, Al), checked as libjpeg's
    ``start_pass_phuff_decoder`` checks them, and the components'
    ``coef_bits`` moved on. A malformed header raises, as there; an
    inconsistent progression (an AC scan before the component's first DC
    scan, an Ah other than the bits already known) is only a warning there,
    and the file is decoded all the same."""
    ah, al = a >> 4, a & 15
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se > 63 or len(comps) != 1
    if (ah and al != ah - 1) or al > 13 or bad:
        raise ValueError(f"corrupt JPEG: bad progression parameters Ss={ss} "
                         f"Se={se} Ah={ah} Al={al}")
    for c in comps:
        c.coef_bits[ss:se + 1] = al
    return ss, se, ah, al


def _lossless_scan(comps: list, mcus_x: int, mcus_y: int, restart: int,
                   ss: int, se: int, a: int) -> None:
    """A lossless scan's predictor (Ss) and point transform (Al), checked
    as libjpeg-turbo checks them, and per component the rows whose
    prediction starts afresh: the first, and the first of each iMCU row
    (``vs`` rows of the component) in which a restart marker falls, where
    libjpeg-turbo's ``decompress_data`` restarts the undifferencing."""
    ah, al = a >> 4, a & 15
    if not 1 <= ss <= 7 or se or ah or al >= 8:
        raise ValueError(f"corrupt JPEG: bad lossless parameters Ss={ss} "
                         f"Se={se} Ah={ah} Al={al}")
    if restart % mcus_x:
        raise ValueError(f"unsupported JPEG: a lossless restart interval "
                         f"({restart}) that is not a whole number of MCU "
                         f"rows ({mcus_x} MCUs), which libjpeg refuses too")
    for c in comps:
        first = np.zeros(c.h, np.uint8)
        first[0] = 1
        if restart:
            # the MCU rows that a marker starts, as rows of the component
            m = np.arange(restart // mcus_x, mcus_y, restart // mcus_x)
            rows = m * c.vs if len(comps) > 1 else m // c.vs * c.vs
            first[rows[rows < c.h]] = 1
        c.lossless = (ss, al, first)


def _smoothing_ok(comps: list) -> bool:
    """libjpeg-turbo's ``smoothing_ok`` at the end of a progressive file:
    every component's table latched and nonzero at the first 10 zigzag
    positions, every DC at least partly known, and some component's
    coefficients 1-9 never coded or short of their last bit."""
    useful = False
    for c in comps:
        if c.qt is None or not c.qt[ZIGZAG[:10]].all() or c.coef_bits[0] < 0:
            return False
        useful = useful or bool((c.coef_bits[1:10] != 0).any())
    return useful


# Block smoothing's estimates of zigzag coefficients 1-9 from the DC values
# of a 5 x 5 block neighbourhood (libjpeg-turbo 3.1.3's
# ``decompress_smooth_data``): per coefficient its natural position and
# the 5 x 5 weights, with DC interpolation (every one of 1-9 never coded;
# the DC is then re-estimated too) and without (K.8 of T.81 on 5 x 5).
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_W_INTERP = np.array([
    [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
     [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],                     # 0,1
    [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0],
     [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]],                     # 1,0
    [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
     [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],                           # 2,0
    [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
     [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],                         # 1,1
    [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
     [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]],                          # 0,2
    [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
     [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],                          # 0,3
    [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
     [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]],                         # 1,2
    [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0],
     [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],                          # 2,1
    [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0],
     [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]]])                       # 3,0
_W_PLAIN = np.zeros((5, 5, 5), np.int64)
_W_PLAIN[0, 2] = [-7, 50, 0, -50, 7]                              # 0,1
_W_PLAIN[1, :, 2] = [-7, 50, 0, -50, 7]                           # 1,0
_W_PLAIN[2, :, 2] = [-1, 13, -24, 13, -1]                         # 2,0
_W_PLAIN[3] = [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
               [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]             # 1,1
_W_PLAIN[4, 2] = [-1, 13, -24, 13, -1]                            # 0,2
_W_DC = np.array([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                  [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                  [-2, -6, -8, -6, -2]])


def _neighbour_rows(frame: _Frame, c: _Component) -> np.ndarray:
    """(5, block rows) indices of the block rows two above to two below
    each real block row of ``c``, as ``decompress_smooth_data`` takes
    them: clamped at the image's edges, where its count of block rows is
    the iMCU rows times the current iMCU row's count (fewer in a partial
    last iMCU row, so its rows see less above them, and full rows near
    the bottom can see the padding rows of the last MCU row)."""
    v, total = c.vs, frame.mcus_y
    height = _ceil_div(c.h, 8)
    out = []
    for y in range(total):
        rows = v if y < total - 1 else (height % v or v)
        for b in range(rows):
            r, i, n = y * v + b, y * rows + b, rows * total
            up = r - 1 if i > 0 else r
            down = r + 1 if i < n - 1 else r
            out.append((r - 2 if i > 1 else up, up, r, down,
                        r + 2 if i < n - 2 else down))
    return np.array(out, np.int64).T


def _smooth(coef: np.ndarray, frame: _Frame, c: _Component) -> np.ndarray:
    """libjpeg-turbo 3.1.3's block smoothing of one component's quantised
    (bh, bw, 64) blocks (natural order) -> its real blocks with estimates
    of the coefficients 1-9 that are zero and not known to their last
    bit, each estimate kept below 1 << Al where Al bits are unknown."""
    bits = c.coef_bits
    interp = bool((bits[1:10] == -1).all())
    rows = _neighbour_rows(frame, c)
    width = _ceil_div(c.w, 8)
    cols = np.clip(np.arange(width)[None] + np.arange(-2, 3)[:, None], 0,
                   width - 1)
    dc = coef[..., 0].astype(np.int64)
    # the 5 x 5 DC values around each real block: (5, 5, rows, cols)
    nb = dc[rows[:, None, :, None], cols[None, :, None, :]]
    out = coef[:rows.shape[1], :width].astype(np.int64).copy()
    q00 = int(c.qt[0])
    weights = _W_INTERP if interp else _W_PLAIN
    for k in range(9 if interp else 5):
        al, pos = int(bits[k + 1]), _SMOOTH_POS[k]
        if al == 0:
            continue
        q = int(c.qt[pos])
        num = q00 * np.einsum("ij,ij...->...", weights[k], nb)
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num < 0, -pred, pred)
        out[..., pos] = np.where(out[..., pos] == 0, pred, out[..., pos])
    if interp:
        num = q00 * np.einsum("ij,ij...->...", _W_DC, nb)
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[..., 0] = np.where(num < 0, -pred, pred)
    return out


# ------------------------------------------------------------------- decode

def _idct_1d(x: list) -> list:
    """The "islow" inverse DCT's butterfly on 8 arrays (scaled by 2**13)."""
    z1 = (x[2] + x[6]) * _F_0_541
    tmp2 = z1 - x[6] * _F_1_847
    tmp3 = z1 + x[2] * _F_0_765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F_1_175
    t0, t1 = t0 * _F_0_298, t1 * _F_2_053
    t2, t3 = t2 * _F_3_072, t3 * _F_1_501
    z1, z2 = -z1 * _F_0_899, -z2 * _F_2_562
    z3, z4 = z5 - z3 * _F_1_961, z5 - z4 * _F_0_390
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _idct_blocks(coef: np.ndarray) -> np.ndarray:
    """Dequantised (..., 8, 8) int64 blocks -> uint8 samples: columns, then
    rows, then libjpeg's range-limit table (an index of 10 bits: values
    beyond [-512, 511] wrap before they are clamped)."""
    ws = [_descale(v, _CONST_BITS - _PASS1_BITS)
          for v in _idct_1d([coef[..., k, :] for k in range(8)])]
    ws = np.stack(ws, axis=-2)
    out = [_descale(v, _CONST_BITS + _PASS1_BITS + 3)
           for v in _idct_1d([ws[..., k] for k in range(8)])]
    v = np.stack(out, axis=-1) & 1023
    v = np.where(v >= 512, v - 1024, v) + 128
    return np.clip(v, 0, 255).astype(np.uint8)


def _upsample_h2(x: np.ndarray, near: int, far: int, shift: int,
                 edge: int) -> np.ndarray:
    """libjpeg's horizontal triangle filter: each sample gives two, 3/4 of
    itself and 1/4 of its neighbour on that side, with bias ``near`` on
    the left output and ``far`` on the right; the outermost outputs take
    ``edge`` times the sample alone."""
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int64)
    out[..., 0] = (x[..., 0] * edge + near) >> shift if edge != 1 \
        else x[..., 0]
    out[..., -1] = (x[..., -1] * edge + far) >> shift if edge != 1 \
        else x[..., -1]
    out[..., 2::2] = (3 * x[..., 1:] + x[..., :-1] + near) >> shift
    out[..., 1:-1:2] = (3 * x[..., :-1] + x[..., 1:] + far) >> shift
    return out


def _upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """A component plane (h, w) at 1/rh x 1/rv of the frame -> (rv h, rh w)
    as libjpeg-turbo's default ("fancy") upsampling gives it: triangle
    filters for h2v1, h2v2 (planes wider than 2 samples) and h1v2 (any
    width), plain replication for every other integral ratio."""
    if rh == rv == 1:
        return plane
    x = plane.astype(np.int64)
    if rh == 1 and rv == 2:
        # h1v2: 3/4 of the nearer row and 1/4 of the further one, bias 1
        # above and 2 below, the rows beyond the plane being copies of
        # its first and last
        xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
        out[0::2] = (3 * x + xp[:-2] + 1) >> 2
        out[1::2] = (3 * x + xp[2:] + 2) >> 2
        return out.astype(np.uint8)
    if rh != 2 or rv > 2 or x.shape[1] <= 2:
        return np.repeat(np.repeat(plane, rv, axis=0), rh, axis=1)
    if rv == 1:
        return _upsample_h2(x, 1, 2, 2, 1).astype(np.uint8)
    # h2v2: the h1v2 column sums, then the horizontal filter
    xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    colsum = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    colsum[0::2] = 3 * x + xp[:-2]
    colsum[1::2] = 3 * x + xp[2:]
    return _upsample_h2(colsum, 8, 7, 4, 4).astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (16 fraction bits)."""
    half = 1 << 15
    y = y.astype(np.int64)
    cb, cr = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """libjpeg's CMYK output as PIL 12.1 makes RGB of it: the samples
    inverted (PIL reads every 4-component JPEG as Adobe's inverted CMYK,
    raw mode "CMYK;I"), then Pillow's ``cmyk2rgb``: each of R, G, B is
    nk - c nk / 255 with nk = 255 - k, the product rounded by its
    ``MULDIV255``."""
    inv = 255 - cmyk.astype(np.int64)
    nk = 255 - inv[..., 3:]
    tmp = inv[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def decode_jpeg(blob: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W) for a one-component file, (H, W, 3) RGB
    for a three-component one, the pixels of libjpeg's default decode;
    (H, W, 3) RGB for a four-component one, as PIL reads it and the JAX
    package's ``load_image`` converts it."""
    parsed = _parse(blob)
    frame = parsed.frame
    if frame.lossless:
        return _decode_lossless(parsed)
    smooth = frame.progressive and _smoothing_ok(frame.comps)
    planes = []
    for c in frame.comps:
        coef = parsed.coefs[c.offset:c.offset + c.bw * c.bh * 64]
        coef = coef.reshape(c.bh, c.bw, 64).astype(np.int64)
        if smooth:
            coef = _smooth(coef, frame, c)
        coef = coef.reshape(coef.shape[:2] + (8, 8))
        px = _idct_blocks(coef * c.qt.reshape(8, 8))
        plane = px.transpose(0, 2, 1, 3).reshape(-1, coef.shape[1] * 8)
        planes.append(plane[:c.h, :c.w])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    full = [_upsample(p, frame.hmax // c.hs, frame.vmax // c.vs)
            [:frame.height, :frame.width]
            for p, c in zip(planes, frame.comps)]
    if len(full) == 4:
        # libjpeg's guess: an Adobe transform other than 0 means YCCK,
        # which it turns into CMYK with the YCbCr tables (K as it is);
        # else plain CMYK
        if parsed.adobe_transform:
            rgb = _ycc_to_rgb(*full[:3]).astype(np.int64)
            full[:3] = [(255 - rgb[..., k]).astype(np.uint8)
                        for k in range(3)]
        return _cmyk_to_rgb(np.stack(full, axis=-1))
    # libjpeg's guess of the colour space: JFIF says YCbCr; else Adobe's
    # transform flag; else component ids R, G, B mean RGB
    ids = bytes(c.cid for c in frame.comps)
    if parsed.jfif:
        rgb = False
    elif parsed.adobe_transform is not None:
        rgb = parsed.adobe_transform == 0
    else:
        rgb = ids == b"RGB"
    if rgb:
        return np.ascontiguousarray(np.stack(full, axis=-1))
    return _ycc_to_rgb(*full)


def _decode_lossless(parsed: _Parsed) -> np.ndarray:
    """A lossless frame's samples, as libjpeg-turbo gives them: no colour
    conversion (a file that would need one, YCbCr by its JFIF or Adobe
    marker or YCCK, is refused there and here; three components are RGB
    otherwise), components upsampled by replication."""
    frame = parsed.frame
    ncomp = len(frame.comps)
    if (ncomp == 3 and (parsed.jfif or parsed.adobe_transform)) or (
            ncomp == 4 and parsed.adobe_transform):
        raise ValueError("unsupported JPEG: a lossless file in YCbCr or "
                         "YCCK, whose colour conversion libjpeg does not "
                         "do in lossless mode")
    planes = []
    for c in frame.comps:
        predictor, pt, first = c.lossless
        plane = np.empty((c.h, c.w), np.uint8)
        _load().jpeg_undifference(
            _ptr(parsed.coefs[c.offset:]), c.bw, c.h, c.w, predictor,
            1 << (7 - pt), pt, _ptr(first), _ptr(plane))
        planes.append(np.repeat(np.repeat(
            plane, frame.vmax // c.vs, axis=0), frame.hmax // c.hs,
            axis=1)[:frame.height, :frame.width])
    if ncomp == 1:
        return planes[0]
    if ncomp == 4:
        return _cmyk_to_rgb(np.stack(planes, axis=-1))
    return np.ascontiguousarray(np.stack(planes, axis=-1))


def jpeg_size(blob: bytes) -> tuple[int, int]:
    """(height, width) from the frame header alone."""
    frame = _parse(blob, header_only=True).frame
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    return frame.height, frame.width


# ------------------------------------------------------------------- encode

# ITU-T T.81 Annex K.1: the example quantisation tables, in natural order
_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])

# Annex K.3: the typical Huffman tables (BITS, HUFFVAL), DC then AC,
# luminance then chrominance
_DC_VALS = list(range(12))
_HUFF_DC = (([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], _DC_VALS),
            ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], _DC_VALS))
_HUFF_AC = (
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
     [1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20,
      50, 129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98,
      114, 130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53,
      54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86,
      87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
      118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146,
      147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167,
      168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
      196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216,
      217, 218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242,
      243, 244, 245, 246, 247, 248, 249, 250]),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
     [0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50,
      129, 8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114,
      209, 10, 22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42,
      53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85,
      86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116,
      117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137,
      138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165,
      166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186,
      194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214,
      215, 216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242,
      243, 244, 245, 246, 247, 248, 249, 250]))


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of a base table (natural order), limited
    to the baseline range 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _fdct_1d(d: list, first: bool) -> list:
    """One pass of the "islow" forward DCT on 8 arrays."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first:
        shift = _CONST_BITS - _PASS1_BITS
        o0 = (tmp10 + tmp11) << _PASS1_BITS
        o4 = (tmp10 - tmp11) << _PASS1_BITS
    else:
        shift = _CONST_BITS + _PASS1_BITS
        o0 = _descale(tmp10 + tmp11, _PASS1_BITS)
        o4 = _descale(tmp10 - tmp11, _PASS1_BITS)
    z1 = (tmp12 + tmp13) * _F_0_541
    o2 = _descale(z1 + tmp13 * _F_0_765, shift)
    o6 = _descale(z1 - tmp12 * _F_1_847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F_1_175
    tmp4, tmp5 = tmp4 * _F_0_298, tmp5 * _F_2_053
    tmp6, tmp7 = tmp6 * _F_3_072, tmp7 * _F_1_501
    z1, z2 = -z1 * _F_0_899, -z2 * _F_2_562
    z3, z4 = z5 - z3 * _F_1_961, z5 - z4 * _F_0_390
    return [o0, _descale(tmp7 + z1 + z4, shift), o2,
            _descale(tmp6 + z2 + z3, shift), o4,
            _descale(tmp5 + z2 + z4, shift), o6,
            _descale(tmp4 + z1 + z3, shift)]


def _quantised_blocks(plane: np.ndarray, qt: np.ndarray, bh: int,
                      bw: int, hs: int) -> np.ndarray:
    """A uint8 plane of whole blocks -> (bh, bw, 64) int16 quantised
    coefficients in natural order, the arrays padded to ``bh`` x ``bw``
    blocks with libjpeg's dummy blocks: all zero but the DC, which repeats
    the block before it in the MCU (``hs`` blocks wide): the one to the
    left at the right edge, the last of the MCU's row above below the
    bottom edge."""
    h, w = plane.shape
    x = plane.astype(np.int64).reshape(h // 8, 8, w // 8, 8).transpose(
        0, 2, 1, 3) - 128
    rows = np.stack(_fdct_1d([x[..., k] for k in range(8)], True), axis=-1)
    out = np.stack(_fdct_1d([rows[..., k, :] for k in range(8)], False),
                   axis=-2)
    # the DCT's output carries a factor 8; quantise to the nearest, halves
    # away from zero
    div = qt.reshape(8, 8) << 3
    q = np.sign(out) * ((np.abs(out) + (div >> 1)) // div)
    coef = np.zeros((bh, bw, 64), np.int16)
    rh, rw = h // 8, w // 8
    coef[:rh, :rw] = q.reshape(rh, rw, 64)
    coef[:rh, rw:, 0] = coef[:rh, rw - 1:rw, 0]
    coef[rh:, :, 0] = coef[rh - 1, np.arange(bw) // hs * hs + hs - 1, 0]
    return coef


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(arr: np.ndarray, quality: int = 92) -> bytes:
    """uint8 (H, W) -> a one-component JPEG, (H, W, 3) RGB -> a YCbCr
    4:2:0 JPEG, as PIL's ``save(quality=quality)`` writes them."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3) or 0 in arr.shape[:2]:
        raise ValueError("encode_jpeg: expected a uint8 (H, W) or (H, W, 3) "
                         "array")
    height, width = arr.shape[:2]
    if max(height, width) > 65535:
        raise ValueError("encode_jpeg: a JPEG side is at most 65535")
    qts = [quant_table(_QT_LUMA, quality)]
    if arr.ndim == 2:
        comps = [_Component(1, 1, 1, 0)]
        sources = [arr]
    else:
        qts.append(quant_table(_QT_CHROMA, quality))
        comps = [_Component(1, 2, 2, 0), _Component(2, 1, 1, 1),
                 _Component(3, 1, 1, 1)]
        r, g, b = (arr[..., k].astype(np.int64) for k in range(3))
        half, mid = 1 << 15, (128 << 16) + (1 << 15) - 1
        sources = [(19595 * r + 38470 * g + 7471 * b + half) >> 16,
                   (-11059 * r - 21709 * g + 32768 * b + mid) >> 16,
                   (32768 * r - 27439 * g - 5329 * b + mid) >> 16]
    frame = _Frame(height, width, comps)
    coefs = np.zeros(frame.n_coefs, np.int16)
    for c, src in zip(comps, sources):
        rh, rw = _ceil_div(c.h, 8), _ceil_div(c.w, 8)  # the real blocks
        if c.hs == frame.hmax:
            plane = _pad_edge(src, rh * 8, rw * 8)
        else:
            # 2x2 box filter, bias 1, 2, 1, 2 along a row; the frame is
            # first widened by copies of its last column and made an even
            # number of rows, the result then lengthened by its last row
            p = _pad_edge(src, height + height % 2, rw * 16)
            bias = 1 + (np.arange(rw * 8) & 1)
            plane = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                     + p[1::2, 1::2] + bias) >> 2
            plane = _pad_edge(plane, rh * 8, rw * 8)
        coefs[c.offset:c.offset + c.bh * c.bw * 64] = _quantised_blocks(
            plane, qts[c.tq], c.bh, c.bw, c.hs).ravel()

    tables = np.zeros((8, _TABLE_BYTES), np.uint8)
    dht = []
    for k in range(len(qts)):
        for tc, (bits, vals) in ((0, _HUFF_DC[k]), (1, _HUFF_AC[k])):
            tables[4 * tc + k, :16] = bits
            tables[4 * tc + k, 16:16 + len(vals)] = vals
            dht.append(_segment(0xC4, bytes([16 * tc + k] + bits + vals)))
    layout, mx, my = frame.layout(comps, [(c.tq, c.tq) for c in comps])
    out = np.empty(frame.n_coefs * 4 + 1024, np.uint8)
    size = _load().jpeg_encode_scan(_ptr(coefs), len(comps), _ptr(layout),
                                    mx, my, 0, _ptr(tables), _ptr(out),
                                    out.size)
    if size < 0:
        raise ValueError(f"encode_jpeg: {_ERRORS.get(size, size)}")

    head = JPEG_SIG + _segment(
        0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))
    for k, qt in enumerate(qts):
        head += _segment(0xDB, bytes([k]) + qt[ZIGZAG].astype(
            np.uint8).tobytes())
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") \
        + bytes([len(comps)])
    sos = bytes([len(comps)])
    for c in comps:
        sof += bytes([c.cid, 16 * c.hs + c.vs, c.tq])
        sos += bytes([c.cid, 17 * c.tq])
    head += _segment(0xC0, sof) + b"".join(dht)
    head += _segment(0xDA, sos + bytes([0, 63, 0]))
    return head + out[:size].tobytes() + b"\xff\xd9"
