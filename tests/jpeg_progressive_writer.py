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
            "422": [(2, 1), (1, 1), (1, 1)], "420": [(2, 2), (1, 1), (1, 1)]}


class Frame:
    """Block geometry of a frame: per component its sampling, its own
    blocks (``nbh`` x ``nbw``, what a one-component scan covers) and its
    block array padded to whole MCUs (``bh`` x ``bw``)."""

    def __init__(self, height: int, width: int, sampling: str):
        self.height, self.width = height, width
        self.samp = SAMPLING[sampling]
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


def write_jpeg(frame: Frame, coefs: list, qts: dict, script: list, *,
               progressive: bool = True, restart: int = 0, overrun: int = 0,
               dqt: dict | None = None) -> bytes:
    """The JPEG file of ``coefs`` (per component (bh, bw, 64), natural
    order) under ``script``; component i reads quantisation table slot i
    (the first slot of ``qts`` for gray) and Huffman tables i."""
    ncomp = len(frame.comps)
    slots = sorted(qts)
    head = b"\xff\xd8" + _segment(0xE0, b"JFIF\0" + bytes(
        [1, 1, 0, 0, 1, 0, 1, 0, 0]))
    for slot in slots:
        head += _segment(0xDB, bytes([slot]) + bytes(
            np.asarray(qts[slot])[ZIGZAG].astype(np.uint8)))
    sof = bytes([8]) + frame.height.to_bytes(2, "big") + \
        frame.width.to_bytes(2, "big") + bytes([ncomp])
    for i, c in enumerate(frame.comps):
        sof += bytes([i + 1, 16 * c["hs"] + c["vs"],
                      slots[min(i, len(slots) - 1)]])
    head += _segment(0xC2 if progressive else 0xC0, sof)
    if restart:
        head += _segment(0xDD, restart.to_bytes(2, "big"))
    body = b""
    for n_scan, (comps, ss, se, ah, al) in enumerate(script):
        for slot, table in (dqt or {}).get(n_scan, {}).items():
            body += _segment(0xDB, bytes([slot]) + bytes(
                np.asarray(table)[ZIGZAG].astype(np.uint8)))
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
        sos = bytes([len(comps)])
        for i in comps:
            sos += bytes([i + 1, 17 * i])
        body += _segment(0xDA, sos + bytes([ss, se, 16 * ah + al]))
        body += _entropy(scan.events, codes)
    return head + body + b"\xff\xd9"


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
