"""A coefficient-level JPEG writer for the tests (not part of the port).

Writes given quantised DCT coefficients as a progressive (SOF2) or a
sequential (SOF0) Huffman JPEG under a given scan script, the way
libjpeg's encoder codes each scan kind (``jcphuff.c``): DC first and
refinement scans, interleaved or of one component, AC first scans with
end-of-band runs across blocks, and AC refinement scans with their
correction bits. Huffman tables are made per scan from the symbols' counts
(T.81 Annex K.2, code lengths limited to 16, no code of all one bits).
Restart markers end every ``restart`` MCUs; with ``overrun`` an
end-of-band run cut by a restart marker is written that many blocks
longer than the interval holds, which a decoder must drop at the marker.

With ``arithmetic=True`` the same scans are written arithmetic-coded
instead (SOF9 sequential, SOF10 progressive): T.81's QM coder (Annex D,
the encoder's register layout, carry and byte-stuffing as libjpeg's
``jcarith.c``) under the statistical models of F.1.4 (sequential DC and
AC) and G.1.3 (progressive DC first and refinement, AC first and
refinement), with the conditioning of an optional DAC segment, and the
statistics reset at every restart marker. Nothing else here writes such
files; a test holds them to PIL's decode of the Huffman file of the same
coefficients.

``write_lossless`` writes sample planes as a Huffman-coded lossless
(SOF3) file: predictors 1-7, a point transform, restart intervals, scans
interleaved or of one component, each row's prediction restarted where
libjpeg-turbo restarts it.

Frames of 1, 3 or 4 components take any sampling factors (``SAMPLING``
names the usual ones; a list of (h, v) pairs gives any other), an
optional Adobe APP14 segment (its transform flag: 0 for RGB or CMYK, 1
for YCbCr, 2 for YCCK) and a JFIF APP0 segment unless ``jfif=False``.

A script is a list of scans ``(components, Ss, Se, Ah, Al)``, components
as indices into the frame's list; ``dqt`` maps a scan's index to the
quantisation tables (slot -> 64 values, natural order) to define just
before it.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
SAMPLING = {"gray": [(1, 1)], "444": [(1, 1)] * 3,
            "422": [(2, 1), (1, 1), (1, 1)], "420": [(2, 2), (1, 1), (1, 1)],
            "122": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
            "412": [(4, 2), (1, 1), (1, 1)], "cmyk": [(1, 1)] * 4,
            "ycck": [(2, 2), (1, 1), (1, 1), (2, 2)]}


class Frame:
    """Block geometry of a frame: per component its sampling, its own
    blocks (``nbh`` x ``nbw``, what a one-component scan covers) and its
    block array padded to whole MCUs (``bh`` x ``bw``)."""

    def __init__(self, height: int, width: int, sampling):
        self.height, self.width = height, width
        self.samp = (SAMPLING[sampling] if isinstance(sampling, str)
                     else [tuple(hv) for hv in sampling])
        self.hmax = max(h for h, _ in self.samp)
        self.vmax = max(v for _, v in self.samp)
        self.mcus_x = math.ceil(width / (8 * self.hmax))
        self.mcus_y = math.ceil(height / (8 * self.vmax))
        self.comps = []
        for hs, vs in self.samp:
            w = math.ceil(width * hs / self.hmax)
            h = math.ceil(height * vs / self.vmax)
            self.comps.append(dict(
                hs=hs, vs=vs, nbw=math.ceil(w / 8), nbh=math.ceil(h / 8),
                bw=self.mcus_x * hs, bh=self.mcus_y * vs))

    def mcus(self, comps: list):
        """The blocks of each MCU of a scan over ``comps``, in order."""
        if len(comps) == 1:
            c = self.comps[comps[0]]
            for by in range(c["nbh"]):
                for bx in range(c["nbw"]):
                    yield [(comps[0], by, bx)]
            return
        for my in range(self.mcus_y):
            for mx in range(self.mcus_x):
                yield [(i, my * self.comps[i]["vs"] + y,
                        mx * self.comps[i]["hs"] + x)
                       for i in comps for y in range(self.comps[i]["vs"])
                       for x in range(self.comps[i]["hs"])]


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, T.81's forward DCT in one axis."""
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


def random_coefficients(frame: Frame, rng, sparsity: float,
                        tables: list) -> list:
    """Per component a (bh, bw, 64) int array in natural order: the DCT
    of a random 8-bit picture (a gradient, noise and a few flat
    rectangles) quantised by the component's table, each block cut after a
    random zigzag index, and a share ``sparsity`` of the blocks left with
    no AC at all (long end-of-band runs). Coefficients of real pictures
    keep every decoder's arithmetic in range. The padding blocks of an
    MCU carry a DC value only, as an encoder writes them."""
    dct = _dct_matrix()
    out = []
    for c, qt in zip(frame.comps, tables):
        shape = (c["bh"], c["bw"])
        h, w = 8 * c["bh"], 8 * c["bw"]
        y, x = np.mgrid[0:h, 0:w]
        pic = (rng.uniform(-3, 3) * x + rng.uniform(-3, 3) * y
               + rng.normal(0, rng.uniform(2, 40), (h, w)))
        for _ in range(3):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            pic[y0:y0 + rng.integers(1, 20), x0:x0 + rng.integers(1, 20)] = \
                rng.uniform(0, 255)
        pic = np.clip(pic + rng.uniform(0, 255), 0, 255) - 128
        blocks = pic.reshape(shape[0], 8, shape[1], 8).transpose(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        q = np.rint(f / np.asarray(qt, np.float64).reshape(8, 8))
        zz = q.reshape(shape + (64,))[..., ZIGZAG].astype(np.int64)
        cut = rng.integers(0, 64, shape)
        zz[..., 1:][np.arange(1, 64) > cut[..., None]] = 0
        zz[..., 1:][rng.random(shape) < sparsity] = 0
        zz[c["nbh"]:, :, 1:] = 0
        zz[:, c["nbw"]:, 1:] = 0
        coef = np.zeros_like(zz)
        coef[..., ZIGZAG] = zz
        out.append(coef)
    return out


def pixel_coefficients(frame: Frame, planes: list, tables: list) -> list:
    """Per component a (bh, bw, 64) int array in natural order: the DCT of
    the component's uint8 sample plane (at the component's own size; it is
    widened and lengthened by copies of its last column and row to whole
    MCUs) quantised by the component's table."""
    dct = _dct_matrix()
    out = []
    for c, plane, qt in zip(frame.comps, planes, tables):
        h, w = 8 * c["bh"], 8 * c["bw"]
        p = np.asarray(plane, np.float64)
        p = np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])),
                   mode="edge") - 128
        blocks = p.reshape(c["bh"], 8, c["bw"], 8).transpose(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        q = np.rint(f / np.asarray(qt, np.float64).reshape(8, 8))
        out.append(q.reshape(c["bh"], c["bw"], 64).astype(np.int64))
    return out


def _nbits(v: int) -> int:
    return int(v).bit_length()


def _bits_of(v: int, n: int) -> int:
    """The n bits T.81 sends for the value v (negative: v - 1, two's
    complement, low n bits)."""
    return (v - 1 if v < 0 else v) & ((1 << n) - 1)


class _Scan:
    """The events of one scan: Huffman symbols ("sym", class, table,
    symbol), raw bits ("bits", value, count) and restart markers ("rst",
    n)."""

    def __init__(self, ac_table: int):
        self.events: list = []
        self.eobrun, self.be = 0, []
        self.ac_table = ac_table

    def sym(self, tclass: int, table: int, s: int) -> None:
        self.events.append(("sym", tclass, table, s))

    def bits(self, v: int, n: int) -> None:
        if n:
            self.events.append(("bits", v, n))

    def emit_eobrun(self, extra: int = 0) -> None:
        if self.eobrun > 0:
            run = min(self.eobrun + extra, 0x7FFF)
            n = _nbits(run) - 1
            self.sym(1, self.ac_table, n << 4)
            self.bits(run & ((1 << n) - 1), n)
            for b in self.be:
                self.bits(b, 1)
            self.eobrun, self.be = 0, []

    def dc_first(self, blk, comp: int, pred: list, al: int) -> None:
        t = int(blk[0]) >> al
        diff, pred[comp] = t - pred[comp], t
        n = _nbits(abs(diff))
        self.sym(0, comp, n)
        self.bits(_bits_of(diff, n), n)

    def ac_first(self, blk, ss: int, se: int, al: int) -> None:
        r = 0
        for k in range(ss, se + 1):
            v = int(blk[ZIGZAG[k]])
            t = abs(v) >> al
            if t == 0:
                r += 1
                continue
            self.emit_eobrun()
            while r > 15:
                self.sym(1, self.ac_table, 0xF0)
                r -= 16
            n = _nbits(t)
            self.sym(1, self.ac_table, (r << 4) | n)
            self.bits(_bits_of(-t if v < 0 else t, n), n)
            r = 0
        if r > 0:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun()

    def ac_refine(self, blk, ss: int, se: int, al: int) -> None:
        absv = [abs(int(blk[ZIGZAG[k]])) >> al for k in range(64)]
        eob = max((k for k in range(ss, se + 1) if absv[k] == 1), default=0)
        r, br = 0, []
        for k in range(ss, se + 1):
            t = absv[k]
            if t == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun()
                self.sym(1, self.ac_table, 0xF0)
                r -= 16
                for b in br:
                    self.bits(b, 1)
                br = []
            if t > 1:
                br.append(t & 1)  # a correction bit
                continue
            self.emit_eobrun()
            self.sym(1, self.ac_table, (r << 4) | 1)
            self.bits(0 if blk[ZIGZAG[k]] < 0 else 1, 1)
            for b in br:
                self.bits(b, 1)
            br, r = [], 0
        if r > 0 or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.emit_eobrun()


# ------------------------------------------------------ arithmetic coding

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) per
# state, and a 114th state of fixed probability 1/2 (libjpeg's, for the
# sign and refinement bits)
QE_TABLE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]
FIXED_STATE = 113


class _ArithEncoder:
    """The QM coder's encoder: one statistics bin is one byte, the state
    index in its low 7 bits and the more probable symbol in its top bit."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1  # the last byte out but one, which a carry moves

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _settle(self) -> None:
        """Write the buffered byte and the stacked 0xFF bytes, which no
        carry can reach any more; zero bytes wait in ``zc`` (dropped if
        nothing but zeros follows them)."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer)
        if self.sc:
            self._zeros()
            for _ in range(self.sc):
                self._byte(0xFF)
            self.sc = 0

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc  # the stacked 0xFF bytes turn into zeros
        self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct += 8

    def finish(self) -> None:
        """T.81 D.1.8's termination, the trailing zero bytes dropped."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        self.zc = 0


class _ArithScan:
    """One arithmetic-coded scan: the statistics areas of its tables (DC
    64 bins, AC 256), the DC predictions and contexts, and the coding of
    each block kind as libjpeg's ``jcarith.c`` codes it."""

    def __init__(self, comps: list, progressive: bool, ss: int, se: int,
                 ah: int, al: int, conditioning: dict):
        """``conditioning`` maps a DAC index to its value: DC table t at t
        (U << 4 | L, default L = 0, U = 1), AC table t at 16 + t (K,
        default 5)."""
        self.enc = _ArithEncoder()
        self.comps, self.progressive = comps, progressive
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.cond = conditioning
        self.fixed = bytearray([FIXED_STATE])
        self.restart_stats()

    def restart_stats(self) -> None:
        self.dc = {i: bytearray(64) for i in self.comps}
        self.ac = {i: bytearray(256) for i in self.comps}
        self.pred = dict.fromkeys(self.comps, 0)
        self.ctx = dict.fromkeys(self.comps, 0)

    def _magnitude(self, st: bytearray, at: int, v: int, x1: bytearray,
                   x1_at: int, ac: bool) -> None:
        """F.1.4.3's coding of |v| - 1 > 0 given at bin ``at``: the
        magnitude category, its bins from X1 on, then the bits below the
        top one in the bins 14 further (``v`` is |v| - 1)."""
        enc, m = self.enc, 0
        if v:
            enc.encode(st, at, 1)
            m, v2 = 1, v
            if ac:
                v2 >>= 1
                if v2:
                    enc.encode(st, at, 1)
                    m <<= 1
                    st, at = x1, x1_at
                    while v2 := v2 >> 1:
                        enc.encode(st, at, 1)
                        m <<= 1
                        at += 1
            else:
                st, at = x1, x1_at
                while v2 := v2 >> 1:
                    enc.encode(st, at, 1)
                    m <<= 1
                    at += 1
        enc.encode(st, at, 0)
        at += 14
        while m := m >> 1:
            enc.encode(st, at, 1 if m & v else 0)

    def dc_first(self, blk, i: int, tbl: int) -> None:
        enc, st = self.enc, self.dc[i]
        t = int(blk[0]) >> self.al
        at = self.ctx[i]
        v = t - self.pred[i]
        if v == 0:
            enc.encode(st, at, 0)
            self.ctx[i] = 0
            return
        self.pred[i] = t
        enc.encode(st, at, 1)
        if v > 0:
            enc.encode(st, at + 1, 0)
            at += 2
            ctx = 4
        else:
            v = -v
            enc.encode(st, at + 1, 1)
            at += 3
            ctx = 8
        v -= 1
        m = 1 << max(v.bit_length() - 1, 0) if v else 0
        lu = self.cond.get(tbl, 0x10)  # the DAC value: U << 4 | L
        lo, hi = lu & 15, lu >> 4
        if m < (1 << lo) >> 1:
            ctx = 0
        elif m > (1 << hi) >> 1:
            ctx += 8
        self.ctx[i] = ctx
        self._magnitude(st, at, v, st, 20, ac=False)

    def _ac_value(self, st, at: int, k: int, v: int, tbl: int) -> None:
        kk = self.cond.get(16 + tbl, 5)
        self._magnitude(st, at + 2, v - 1, st, 189 if k <= kk else 217,
                        ac=True)

    def ac_first(self, blk, i: int, tbl: int, ss: int, se: int) -> None:
        enc, st, al = self.enc, self.ac[i], self.al
        vals = [abs(int(blk[ZIGZAG[k]])) >> al for k in range(64)]
        ke = max((k for k in range(ss, se + 1) if vals[k]), default=0)
        k = ss
        while k <= ke:
            at = 3 * (k - 1)
            enc.encode(st, at, 0)  # not the end of the block
            while vals[k] == 0:
                enc.encode(st, at + 1, 0)
                at += 3
                k += 1
            enc.encode(st, at + 1, 1)
            enc.encode(self.fixed, 0, 1 if blk[ZIGZAG[k]] < 0 else 0)
            self._ac_value(st, at, k, vals[k], tbl)
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, blk, i: int, ss: int, se: int) -> None:
        enc, st, al, ah = self.enc, self.ac[i], self.al, self.ah
        absv = [abs(int(blk[ZIGZAG[k]])) for k in range(64)]
        ke = max((k for k in range(ss, se + 1) if absv[k] >> al), default=0)
        kex = max((k for k in range(1, ke + 1) if absv[k] >> ah), default=0)
        k = ss
        while k <= ke:
            at = 3 * (k - 1)
            if k > kex:
                enc.encode(st, at, 0)
            while True:
                v = absv[k] >> al
                if v:
                    if v >> 1:  # nonzero before: its next bit
                        enc.encode(st, at + 2, v & 1)
                    else:
                        enc.encode(st, at + 1, 1)
                        enc.encode(self.fixed, 0,
                                   1 if blk[ZIGZAG[k]] < 0 else 0)
                    break
                enc.encode(st, at + 1, 0)
                at += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def block(self, blk, i: int) -> None:
        ss, se, ah, al = self.ss, self.se, self.ah, self.al
        if not self.progressive:
            self.dc_first(blk, i, i)
            self.ac_first(blk, i, i, 1, 63)
        elif ss == 0 and ah == 0:
            self.dc_first(blk, i, i)
        elif ss == 0:
            self.enc.encode(self.fixed, 0, (int(blk[0]) >> al) & 1)
        elif ah == 0:
            self.ac_first(blk, i, i, ss, se)
        else:
            self.ac_refine(blk, i, ss, se)

    def restart(self, n: int) -> None:
        self.enc.finish()
        self.enc.out += bytes([0xFF, 0xD0 + n])
        self.enc.reset()
        dc = not self.progressive or (self.ss == 0 and self.ah == 0)
        ac = not self.progressive or self.se > 0
        for i in self.comps:
            if dc:
                self.dc[i] = bytearray(64)
                self.pred[i] = self.ctx[i] = 0
            if ac:
                self.ac[i] = bytearray(256)


def _huffman_spec(counts: dict) -> bytes:
    """BITS and HUFFVAL for symbol counts, as libjpeg's
    ``jpeg_gen_optimal_table`` makes them: Huffman code lengths with a
    reserved pseudo-symbol (so no code is all ones), limited to 16 bits by
    Annex K.2's adjustment."""
    heap = [(c, s, [s]) for s, c in counts.items()]
    heap.append((0.5, 256, [256]))  # the pseudo-symbol, the rarest
    heapq.heapify(heap)
    length = dict.fromkeys([s for _, s, _ in heap], 0)
    tie = 1000
    while len(heap) > 1:
        c1, _, g1 = heapq.heappop(heap)
        c2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            length[s] += 1
        heapq.heappush(heap, (c1 + c2, tie, g1 + g2))
        tie += 1
    bits = [0] * 64
    for s, n in length.items():
        bits[n] += 1
    for i in range(63, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the pseudo-symbol's code, the last of the longest
    order = sorted((s for s in length if s != 256),
                   key=lambda s: (length[s], s))
    return bytes(bits[1:17]) + bytes(order)


def _codes(spec: bytes) -> dict:
    code, k, out = 0, 16, {}
    for n in range(1, 17):
        for _ in range(spec[n - 1]):
            out[spec[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _entropy(events: list, codes: dict) -> bytes:
    out, acc, nacc = bytearray(), 0, 0

    def put(v: int, n: int):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | v, nacc + n
        while nacc >= 8:
            b = (acc >> (nacc - 8)) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def flush():
        if nacc:
            put((1 << (8 - nacc)) - 1, 8 - nacc)

    for ev in events:
        if ev[0] == "sym":
            put(*codes[ev[1], ev[2]][ev[3]])
        elif ev[0] == "bits":
            put(ev[1], ev[2])
        else:
            flush()
            out += bytes([0xFF, 0xD0 + ev[1]])
    flush()
    return bytes(out)


def _app_segments(ncomp: int, adobe: int | None, jfif: bool | None) -> bytes:
    if jfif is None:
        jfif = adobe is None and ncomp in (1, 3)
    head = b""
    if jfif:
        head += _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0,
                                                  0]))
    if adobe is not None:
        head += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                 adobe]))
    return head


def _dqt(slot: int, table) -> bytes:
    return _segment(0xDB, bytes([slot]) + bytes(
        np.asarray(table)[ZIGZAG].astype(np.uint8)))


def write_jpeg(frame: Frame, coefs: list, qts: dict, script: list, *,
               progressive: bool = True, restart: int = 0, overrun: int = 0,
               dqt: dict | None = None, arithmetic: bool = False,
               dac: dict | None = None, adobe: int | None = None,
               jfif: bool | None = None) -> bytes:
    """The JPEG file of ``coefs`` (per component (bh, bw, 64), natural
    order) under ``script``; component i reads quantisation table slot i
    (the last slot of ``qts`` for components past it) and entropy tables
    i. ``arithmetic`` writes SOF9 / SOF10 with the DAC segment ``dac``
    (DAC index -> value, see ``_ArithScan``) if given; ``adobe`` adds an
    Adobe APP14 segment with that transform flag; ``jfif`` (by default:
    for 1 or 3 components without ``adobe``) the JFIF APP0 segment."""
    ncomp = len(frame.comps)
    slots = sorted(qts)
    head = b"\xff\xd8" + _app_segments(ncomp, adobe, jfif)
    for slot in slots:
        head += _dqt(slot, qts[slot])
    sof = bytes([8]) + frame.height.to_bytes(2, "big") + \
        frame.width.to_bytes(2, "big") + bytes([ncomp])
    for i, c in enumerate(frame.comps):
        sof += bytes([i + 1, 16 * c["hs"] + c["vs"],
                      slots[min(i, len(slots) - 1)]])
    head += _segment((0xCA if progressive else 0xC9) if arithmetic
                     else (0xC2 if progressive else 0xC0), sof)
    if arithmetic and dac:
        head += _segment(0xCC, b"".join(bytes([k, v])
                                        for k, v in sorted(dac.items())))
    if restart:
        head += _segment(0xDD, restart.to_bytes(2, "big"))
    body = b""
    for n_scan, (comps, ss, se, ah, al) in enumerate(script):
        for slot, table in (dqt or {}).get(n_scan, {}).items():
            body += _dqt(slot, table)
        sos = bytes([len(comps)])
        for i in comps:
            sos += bytes([i + 1, 17 * i])
        sos = _segment(0xDA, sos + bytes([ss, se, 16 * ah + al]))
        if arithmetic:
            body += sos + _arith_entropy(frame, coefs, comps, progressive,
                                         (ss, se, ah, al), restart, dac)
            continue
        scan = _Scan(comps[0])
        pred = [0] * ncomp
        for m, mcu in enumerate(frame.mcus(list(comps))):
            if restart and m and m % restart == 0:
                scan.emit_eobrun(overrun)
                scan.events.append(("rst", (m // restart - 1) & 7))
                pred = [0] * ncomp
            for i, by, bx in mcu:
                blk = coefs[i][by, bx]
                if not progressive:
                    scan.ac_table = i
                    scan.dc_first(blk, i, pred, 0)
                    scan.ac_first(blk, 1, 63, 0)
                    scan.emit_eobrun()  # an EOB closes every block
                elif ss == 0 and ah == 0:
                    scan.dc_first(blk, i, pred, al)
                elif ss == 0:
                    scan.bits((int(blk[0]) >> al) & 1, 1)
                elif ah == 0:
                    scan.ac_first(blk, ss, se, al)
                else:
                    scan.ac_refine(blk, ss, se, al)
        scan.emit_eobrun()
        counts: dict = {}
        for ev in scan.events:
            if ev[0] == "sym":
                key = (ev[1], ev[2])
                counts.setdefault(key, {})
                counts[key][ev[3]] = counts[key].get(ev[3], 0) + 1
        codes = {}
        for (tclass, table), cnt in sorted(counts.items()):
            spec = _huffman_spec(cnt)
            codes[tclass, table] = _codes(spec)
            body += _segment(0xC4, bytes([16 * tclass + table]) + spec)
        body += sos + _entropy(scan.events, codes)
    return head + body + b"\xff\xd9"


def _arith_entropy(frame: Frame, coefs: list, comps: tuple,
                   progressive: bool, band: tuple, restart: int,
                   dac: dict | None) -> bytes:
    """One arithmetic-coded scan's entropy-coded segments."""
    scan = _ArithScan(list(comps), progressive, *band, dac or {})
    for m, mcu in enumerate(frame.mcus(list(comps))):
        if restart and m and m % restart == 0:
            scan.restart((m // restart - 1) & 7)
        for i, by, bx in mcu:
            scan.block(coefs[i][by, bx], i)
    scan.enc.finish()
    return bytes(scan.enc.out)


def full_script(ncomp: int, dc_al: int = 0, bands=((1, 63, 0),)) -> list:
    """A progressive script that sends every bit: an interleaved DC scan
    at ``dc_al`` and its refinements, then per component each band
    ``(Ss, Se, Al)`` and its refinements down to Al = 0."""
    comps = tuple(range(ncomp))
    script = [(comps, 0, 0, 0, dc_al)]
    script += [(comps, 0, 0, a + 1, a) for a in range(dc_al - 1, -1, -1)]
    for i in comps:
        for ss, se, al in bands:
            script.append(((i,), ss, se, 0, al))
            script += [((i,), ss, se, a + 1, a)
                       for a in range(al - 1, -1, -1)]
    return script


def write_lossless(planes: list, height: int, width: int, sampling,
                   scans: list, *, predictor: int = 1, pt: int = 0,
                   restart: int = 0, adobe: int | None = None,
                   jfif: bool | None = None,
                   ids: list | None = None) -> bytes:
    """A Huffman-coded lossless (SOF3) 8-bit file of a ``height`` x
    ``width`` frame from the uint8 sample planes (each cut to its
    component's size, ceil(height v / vmax) x ceil(width h / hmax)) with
    ``scans`` (tuples of component indices; every component in
    one scan), one predictor and point transform for all. ``restart``
    counts MCUs and must be whole MCU rows of every scan. The prediction
    of a row starts afresh (from the left alone, its first sample from
    2**(7 - pt)) at the scan's first row and at the first row of each iMCU
    row (``vs`` rows of a component) that a restart marker falls in."""
    samp = (SAMPLING[sampling] if isinstance(sampling, str)
            else [tuple(hv) for hv in sampling])
    ncomp = len(samp)
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    planes = [np.asarray(p)[:-(-height * v // vmax), :-(-width * h // hmax)]
              for p, (h, v) in zip(planes, samp)]
    ids = ids or list(range(1, ncomp + 1))
    head = b"\xff\xd8" + _app_segments(ncomp, adobe, jfif)
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") \
        + bytes([ncomp])
    for i, (h, v) in enumerate(samp):
        sof += bytes([ids[i], 16 * h + v, 0])
    head += _segment(0xC3, sof)
    if restart:
        head += _segment(0xDD, restart.to_bytes(2, "big"))
    body = b""
    for comps in scans:
        diffs = {}
        for i in comps:
            x = planes[i].astype(np.int64) >> pt
            h, v = samp[i]
            # the MCU rows of the scan, and the rows that start afresh
            if len(comps) > 1:
                mx, my = -(-width // hmax), -(-height // vmax)
                mrow = v
            else:
                mx, my, mrow = x.shape[1], x.shape[0], 1
            first = {0}
            if restart:
                step = restart // mx
                for m in range(step, my, step):
                    first.add(m * v if len(comps) > 1 else m // v * v)
            d = np.zeros(x.shape, np.int64)
            for r in range(x.shape[0]):
                for c in range(x.shape[1]):
                    if r in first:
                        pred = (1 << (7 - pt)) if c == 0 else x[r, c - 1]
                    elif c == 0:
                        pred = x[r - 1, c]
                    else:
                        ra, rb, rc = x[r, c - 1], x[r - 1, c], x[r - 1, c - 1]
                        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                                5: ra + ((rb - rc) >> 1),
                                6: rb + ((ra - rc) >> 1),
                                7: (ra + rb) >> 1}[predictor]
                    d[r, c] = int(x[r, c] - pred)
            diffs[i] = (d, mrow)
        events = []
        if len(comps) > 1:
            mx, my = -(-width // hmax), -(-height // vmax)
            units = [[(i, my_ * samp[i][1] + y, mx_ * samp[i][0] + x)
                      for i in comps for y in range(samp[i][1])
                      for x in range(samp[i][0])]
                     for my_ in range(my) for mx_ in range(mx)]
        else:
            (i,) = comps
            units = [[(i, r, c)] for r in range(planes[i].shape[0])
                     for c in range(planes[i].shape[1])]
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                events.append(("rst", (m // restart - 1) & 7))
            for i, r, c in unit:
                d = diffs[i][0]
                val = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] \
                    else 0  # an MCU's padding sample
                n = _nbits(abs(val))
                events.append(("sym", 0, i, n))
                events.append(("bits", _bits_of(val, n), n))
        counts: dict = {}
        for ev in events:
            if ev[0] == "sym":
                counts.setdefault(ev[2], {})
                counts[ev[2]][ev[3]] = counts[ev[2]].get(ev[3], 0) + 1
        codes = {}
        for table, cnt in sorted(counts.items()):
            spec = _huffman_spec(cnt)
            codes[0, table] = _codes(spec)
            body += _segment(0xC4, bytes([table]) + spec)
        sos = bytes([len(comps)]) + b"".join(bytes([ids[i], 16 * i])
                                             for i in comps)
        body += _segment(0xDA, sos + bytes([predictor, 0, pt]))
        body += _entropy(events, codes)
    return head + body + b"\xff\xd9"
