"""The JPEG forms beyond 1x1 / 2x1 / 2x2 YCbCr and gray in the port's
decoder (``data/jpeg.py``, ``csrc/jpeg_entropy.cpp``) against the JAX
package's ``load_image`` (PIL 12.1.0, libjpeg-turbo 3.1.3, then
``convert("RGB")`` for CMYK), every comparison exact (uint8 equality,
shapes equal):

* the committed fixtures (``scripts/make_jpeg_forms_fixtures.py``): file
  and pixel digests, pixels, ``image_size``;
* files of the test-only coefficient-level writer
  (``tests/jpeg_progressive_writer.py``), seeded and hypothesis-drawn:
  every sampling ratio libjpeg takes (and the fractional ones it refuses),
  CMYK and YCCK with and without the Adobe marker, block-smoothing
  patterns, arithmetic-coded sequential and progressive files with
  restarts and DAC conditioning (the same pixels as the Huffman file of
  the same coefficients), 8-bit lossless files;
* what PIL refuses (12-bit samples, hierarchical and arithmetic lossless
  frames, a height given by DNL, lossless YCbCr, lossless restarts inside
  an MCU row, more than 10 blocks per MCU) raises a ``ValueError`` that
  names it.
"""

import hashlib
import importlib.util
import io
import os
import tempfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import jpeg_progressive_writer as W
from vanishing_points_2017_tpu.data import io as jio
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data import jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "assets", "examples")
FIXTURES = os.path.join(EXAMPLES, "jpeg_forms")
REFERENCE = os.path.join(EXAMPLES, "jax_reference_jpeg_forms.npz")
_REF = np.load(REFERENCE)
FILES = [str(n) for n in _REF["files"]]


def _jax_pixels(blob: bytes) -> np.ndarray:
    """The JAX package's ``load_image`` of the bytes, through a file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.jpg")
        with open(path, "wb") as fh:
            fh.write(blob)
        return jio.load_image(path)


def _assert_like_jax(blob: bytes) -> np.ndarray:
    want = _jax_pixels(blob)
    got = jpeg.decode_jpeg(blob)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert jpeg.jpeg_size(blob) == want.shape[:2]
    return got


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _frame(rng, shape, sampling, sparsity=0.3):
    """A writer frame, its quantisation tables and seeded coefficients."""
    frame = W.Frame(shape[0], shape[1], sampling)
    n = len(frame.comps)
    qts = {k: rng.integers(1, 48, 64) for k in range(1 if n == 1 else 2)}
    tables = [qts[min(i, len(qts) - 1)] for i in range(n)]
    return frame, qts, W.random_coefficients(frame, rng, sparsity, tables)


# ------------------------------------------------- the committed fixtures

@pytest.mark.parametrize("name", FILES)
def test_committed_fixture_equals_jax(name):
    """The file is the committed one; the port's ``load_image`` gives the
    committed digest of the JAX package's pixels and, here, its pixels;
    ``image_size`` and ``jpeg_size`` read the frame's size."""
    path = os.path.join(FIXTURES, f"{name}.jpg")
    with open(path, "rb") as fh:
        blob = fh.read()
    assert hashlib.sha256(blob).hexdigest() == str(
        _REF[f"file_sha256_{name}"])
    got = tio.load_image(path)
    assert _digest(got) == str(_REF[f"sha256_{name}"])
    shape = tuple(int(v) for v in _REF[f"shape_{name}"])
    assert got.shape == shape
    np.testing.assert_array_equal(got, jio.load_image(path))
    assert tio.image_size(path) == jpeg.jpeg_size(blob) == shape[:2]


def test_reference_names_the_oracle_here():
    """The digests were taken with this PIL and libjpeg-turbo; the
    fixtures cover each form the acceptance list names."""
    import PIL
    from PIL import features

    assert str(_REF["pillow_version"]) == PIL.__version__ == "12.1.0"
    assert str(_REF["libjpeg_version"]) == (
        f"libjpeg-turbo {features.version('libjpeg_turbo')}")
    forms = " | ".join(str(_REF[f"form_{n}"]) for n in FILES)
    for form in ("h1v2", "h4v1", "h4v2", "CMYK without an Adobe marker",
                 "CMYK, Adobe transform 0", "YCCK", "arithmetic sequential",
                 "arithmetic progressive", "lossless"):
        assert form in forms, form
    assert sum(str(_REF[f"form_{n}"]).startswith("smoothing")
               for n in FILES) >= 4
    for name in _REF["timed"]:
        assert tuple(_REF[f"shape_{name}"])[:2] == (480, 640)


# ------------------------------------------------------- sampling ratios

RATIOS = {
    "h1v2": [(1, 2), (1, 1), (1, 1)],
    "h1v4": [(1, 4), (1, 1), (1, 1)],
    "h2v4": [(2, 4), (1, 1), (1, 1)],
    "h3v1": [(3, 1), (1, 1), (1, 1)],
    "h3v3": [(3, 3), (1, 1), (1, 1)],   # 11 blocks: scans of one component
    "h4v1": [(4, 1), (1, 1), (1, 1)],
    "h4v2": [(4, 2), (1, 1), (1, 1)],
    "h4v4": [(4, 4), (2, 2), (1, 1)],   # ratios 4 and 2 in one frame
    "chroma_h1v2_h2v1": [(2, 2), (1, 2), (2, 1)],
    "chroma_h2v1_luma_h1v2": [(2, 2), (2, 1), (2, 1)],
    "cb_full": [(2, 1), (2, 1), (1, 1)],
}


@pytest.mark.parametrize("shape", [(37, 29), (3, 41), (17, 1), (1, 2)],
                         ids=["37x29", "3x41", "17x1", "1x2"])
@pytest.mark.parametrize("ratio", list(RATIOS))
def test_sampling_ratios_equal_pil(ratio, shape):
    """Each integral ratio: h1v2 by libjpeg-turbo's vertical triangle
    filter (any width), h2v1 / h2v2 by theirs, every other one by
    replication; planes one or two samples across or down included. A
    frame of more than 10 blocks per MCU is written one component per
    scan."""
    samp = RATIOS[ratio]
    rng = np.random.default_rng(len(ratio) * 7 + shape[0])
    frame, qts, coefs = _frame(rng, shape, samp)
    if sum(h * v for h, v in samp) <= 10:
        script = [((0, 1, 2), 0, 63, 0, 0)]
    else:
        script = [((i,), 0, 63, 0, 0) for i in range(3)]
    _assert_like_jax(W.write_jpeg(frame, coefs, qts, script,
                                  progressive=False))


def test_upsampling_filters_are_told_apart():
    """On one h1v2 file, replication or the h2v1 filter's biases instead
    of h1v2's would change pixels: the test above can see the filter."""
    rng = np.random.default_rng(5)
    frame, qts, coefs = _frame(rng, (40, 24), RATIOS["h1v2"], 0.0)
    blob = W.write_jpeg(frame, coefs, qts, [((0, 1, 2), 0, 63, 0, 0)],
                        progressive=False)
    want = _assert_like_jax(blob)
    plane = np.random.default_rng(1).integers(0, 256, (20, 24), np.uint8)
    fancy = jpeg._upsample(plane, 1, 2).astype(np.int64)
    assert (fancy != np.repeat(plane, 2, axis=0)).any()
    x = plane.astype(np.int64)
    xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    swapped = np.empty_like(fancy)
    swapped[0::2] = (3 * x + xp[:-2] + 2) >> 2
    swapped[1::2] = (3 * x + xp[2:] + 1) >> 2
    assert (fancy != swapped).any() and want.shape == (40, 24, 3)


# ------------------------------------------------------ CMYK and YCCK

CMYK_CASES = {
    "cmyk_no_marker": ("cmyk", None),
    "cmyk_adobe0": ("cmyk", 0),
    "ycck_adobe2": ("ycck", 2),
    "ycck_adobe1": ("ycck", 1),   # libjpeg warns and takes YCCK
    "ycck_h2v1": ([(2, 1), (1, 1), (1, 1), (2, 1)], 2),
    "cmyk_h1v2_k": ([(1, 2), (1, 2), (1, 2), (1, 1)], None),
}


@pytest.mark.parametrize("case", list(CMYK_CASES))
@pytest.mark.parametrize("coding", ["seq", "prog", "arith"])
def test_cmyk_and_ycck_equal_jax(case, coding):
    """Four components as the JAX package reads them: libjpeg's CMYK (or
    YCCK turned CMYK), inverted as PIL reads every 4-component JPEG, then
    Pillow's ``cmyk2rgb``; with any sampling."""
    samp, adobe = CMYK_CASES[case]
    rng = np.random.default_rng(len(case) + len(coding))
    frame, qts, coefs = _frame(rng, (33, 47), samp)
    prog = coding == "prog"
    script = W.full_script(4, 1, ((1, 5, 1), (6, 63, 0))) if prog else [
        ((0, 1, 2, 3), 0, 63, 0, 0)]
    blob = W.write_jpeg(frame, coefs, qts, script, progressive=prog,
                        arithmetic=coding == "arith", adobe=adobe)
    got = _assert_like_jax(blob)
    assert got.shape == (33, 47, 3)


def test_pil_cmyk_files_equal_jax():
    """PIL's own CMYK files (Adobe marker, transform 0), baseline and
    progressive, odd sizes."""
    for i, shape in enumerate([(30, 41), (1, 1), (17, 9)]):
        arr = np.random.default_rng(i).integers(0, 256, shape + (4,),
                                                np.uint8)
        for prog in (False, True):
            buf = io.BytesIO()
            Image.fromarray(arr, "CMYK").save(buf, format="JPEG",
                                              quality=80 + i,
                                              progressive=prog)
            _assert_like_jax(buf.getvalue())


# ------------------------------------------------------ block smoothing

def _smoothing_script(name: str, n: int) -> list:
    comps = tuple(range(n))
    each = [(i,) for i in comps]
    return {
        "dc_only": [(comps, 0, 0, 0, 0)],
        "dc_al2": [(comps, 0, 0, 0, 2)],
        "ac1_5_al1": [(comps, 0, 0, 0, 0)] + [(c, 1, 5, 0, 1) for c in each]
        + [(c, 6, 63, 0, 0) for c in each],
        "ac9_missing": [(comps, 0, 0, 0, 0)] + [(c, 1, 8, 0, 0) for c in each]
        + [(c, 10, 63, 0, 0) for c in each],
        "ac1_2_only": [(comps, 0, 0, 0, 0)] + [(c, 1, 2, 0, 0) for c in each],
        "half_refined": [(comps, 0, 0, 0, 1)] + [(c, 1, 63, 0, 2)
                                                 for c in each]
        + [(c, 1, 63, 2, 1) for c in each],
        "last_component_al1": W.full_script(n)[:-1] + [((n - 1,), 1, 63, 0,
                                                        1)],
    }[name]


@pytest.mark.parametrize("arith", [False, True], ids=["huffman", "arith"])
@pytest.mark.parametrize("sampling,shape", [("gray", (40, 27)),
                                            ("420", (45, 37)),
                                            ("122", (41, 30))],
                         ids=["gray", "420", "122"])
@pytest.mark.parametrize("pattern", ["dc_only", "dc_al2", "ac1_5_al1",
                                     "ac9_missing", "ac1_2_only",
                                     "half_refined", "last_component_al1"])
def test_smoothing_patterns_equal_pil(pattern, sampling, shape, arith):
    """Progressive files short of their last bits take libjpeg-turbo
    3.1.3's block smoothing (the 5 x 5 DC neighbourhood, DC interpolation
    when coefficients 1-9 were never sent, each estimate gated by its
    known bits), with the rows of a partial last iMCU row as it takes
    them (h1v2 and 4:2:0 at odd heights)."""
    rng = np.random.default_rng(len(pattern) * 3 + shape[0])
    frame, qts, coefs = _frame(rng, shape, sampling)
    script = _smoothing_script(pattern, len(frame.comps))
    blob = W.write_jpeg(frame, coefs, qts, script, arithmetic=arith,
                        restart=3 if arith else 0)
    assert jpeg._smoothing_ok(jpeg._parse(blob).frame.comps)
    _assert_like_jax(blob)


def test_smoothing_rows_of_a_partial_imcu_row_matter():
    """libjpeg-turbo counts the block rows of a partial last iMCU row
    short: with the rows clamped at the image instead, pixels change on
    this 4:2:0 DC-only file."""
    rng = np.random.default_rng(0)
    frame, qts, coefs = _frame(rng, (24, 40), "420")
    blob = W.write_jpeg(frame, coefs, qts, _smoothing_script("dc_only", 3))
    want = _assert_like_jax(blob)
    parsed = jpeg._parse(blob)
    c = parsed.frame.comps[0]
    rows = jpeg._neighbour_rows(parsed.frame, c)
    height = -(-c.h // 8)
    clamped = np.clip(np.arange(height) + np.arange(-2, 3)[:, None], 0,
                      height - 1)
    assert (rows != clamped).any()
    orig = jpeg._neighbour_rows
    try:
        jpeg._neighbour_rows = lambda f, comp: np.clip(
            np.arange(-(-comp.h // 8)) + np.arange(-2, 3)[:, None], 0,
            -(-comp.h // 8) - 1)
        assert (jpeg.decode_jpeg(blob) != want).any()
    finally:
        jpeg._neighbour_rows = orig


# --------------------------------------------------- arithmetic coding

@pytest.mark.parametrize("dac", [None, {0: 0x42, 1: 0x10, 16: 12, 17: 1}],
                         ids=["default", "dac"])
@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("sampling", ["gray", "420", "ycck"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sof9", "sof10"])
def test_arithmetic_equals_pil_and_huffman(progressive, sampling, restart,
                                           dac):
    """SOF9 and SOF10 files: the port's decode equals PIL's, and PIL's
    decode of the Huffman file of the same coefficients (which shows the
    writer's arithmetic coder right); statistics reset at every restart
    marker, DAC conditioning or the default."""
    rng = np.random.default_rng(restart * 5 + len(sampling))
    frame, qts, coefs = _frame(rng, (37, 45), sampling)
    n = len(frame.comps)
    script = (W.full_script(n, 1, ((1, 1, 0), (2, 9, 2), (10, 63, 1)))
              if progressive else [(tuple(range(n)), 0, 63, 0, 0)])
    adobe = 2 if sampling == "ycck" else None
    kw = dict(progressive=progressive, restart=restart, adobe=adobe)
    arith = W.write_jpeg(frame, coefs, qts, script, arithmetic=True,
                         dac=dac, **kw)
    huff = W.write_jpeg(frame, coefs, qts, script, **kw)
    got = _assert_like_jax(arith)
    np.testing.assert_array_equal(_jax_pixels(huff), got)


def test_arithmetic_past_pillows_read_block():
    """PIL opens an arithmetic-coded file only while its scan lies in
    Pillow's first read block (``ImageFile.MAXBLOCK``, 64 KiB by default):
    libjpeg's arithmetic decoder cannot wait for more data. The JAX
    package's ``load_image`` raises on a file whose scan crosses it; the
    port decodes it, to PIL's pixels once the block holds the file."""
    from PIL import ImageFile

    rng = np.random.default_rng(2)
    frame, qts, coefs = _frame(rng, (40, 48), "420")
    blob = W.write_jpeg(frame, coefs, qts, [((0, 1, 2), 0, 63, 0, 0)],
                        progressive=False, arithmetic=True)
    sos = blob.index(b"\xff\xda")
    scan = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    pad = (1 << 16) - 8 - scan - 4  # the scan's data starts 8 bytes short
    crossing = blob[:2] + b"\xff\xfe" + (pad + 2).to_bytes(2, "big") + bytes(
        pad) + blob[2:]
    block = ImageFile.MAXBLOCK
    try:
        ImageFile.MAXBLOCK = 1 << 16
        with pytest.raises(OSError):
            _jax_pixels(crossing)
        ImageFile.MAXBLOCK = 1 << 20
        np.testing.assert_array_equal(_assert_like_jax(crossing),
                                      jpeg.decode_jpeg(blob))
    finally:
        ImageFile.MAXBLOCK = block


def test_arithmetic_restart_out_of_sequence_raises():
    rng = np.random.default_rng(1)
    frame, qts, coefs = _frame(rng, (24, 24), "gray")
    blob = W.write_jpeg(frame, coefs, qts, [((0,), 0, 63, 0, 0)],
                        progressive=False, arithmetic=True, restart=2)
    i = blob.index(b"\xff\xd0")
    with pytest.raises(ValueError, match="restart marker"):
        jpeg.decode_jpeg(blob[:i + 1] + b"\xd3" + blob[i + 2:])


# -------------------------------------------------------------- lossless

def _lossless_case(kind: str, predictor: int, rng):
    h, w = 19, 23
    smooth = np.add.outer(np.arange(h) * 7, np.arange(w) * 3)
    if kind == "gray":
        planes = [(smooth + rng.integers(0, 9, (h, w))) % 256]
        return planes, h, w, "gray", [(0,)], {}
    if kind == "rgb_restart":
        planes = [(smooth * k + rng.integers(0, 9, (h, w))) % 256
                  for k in (1, 2, 3)]
        return planes, h, w, "444", [(0, 1, 2)], dict(restart=2 * w,
                                                      adobe=0)
    if kind == "420_scans":
        planes = [rng.integers(0, 256, (-(-h // v), -(-w // hh)))
                  for hh, v in [(1, 1), (2, 2), (2, 2)]]
        return planes, h, w, "420", [(0,), (1,), (2,)], dict(jfif=False)
    planes = [rng.integers(0, 256, (h, w)) for _ in range(4)]
    return planes, h, w, "cmyk", [(0, 1, 2, 3)], dict(pt=1)


@pytest.mark.parametrize("kind", ["gray", "rgb_restart", "420_scans",
                                  "cmyk"])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_equals_pil(kind, predictor):
    """8-bit lossless (SOF3), which PIL here opens: every predictor, a
    point transform, restart intervals of whole MCU rows, interleaved and
    one-component scans, RGB, replicated chroma, CMYK."""
    rng = np.random.default_rng(predictor)
    planes, h, w, samp, scans, kw = _lossless_case(kind, predictor, rng)
    blob = W.write_lossless([p.astype(np.uint8) for p in planes], h, w,
                            samp, scans, predictor=predictor, **kw)
    _assert_like_jax(blob)


def test_lossless_restart_rows_of_imcu_rows():
    """A one-component scan of a component sampled 2 down with a restart
    every row: libjpeg-turbo restarts the prediction at the first row of
    each iMCU row the marker falls in (the writer does the same); a
    decoder restarting it at the marker's own row differs."""
    rng = np.random.default_rng(3)
    h, w = 14, 9
    planes = [rng.integers(0, 256, (h, w)).astype(np.uint8)]
    blob = W.write_lossless(planes, h, w, [(1, 2)], [(0,)], predictor=2,
                            restart=w)
    got = _assert_like_jax(blob)
    parsed = jpeg._parse(blob)
    c = parsed.frame.comps[0]
    assert c.lossless[2].tolist() == [1, 0] * (h // 2)
    np.testing.assert_array_equal(got, planes[0])
    naive = np.empty((c.h, c.w), np.uint8)
    jpeg._load().jpeg_undifference(
        jpeg._ptr(parsed.coefs[c.offset:]), c.bw, c.h, c.w, 2, 1 << 7, 0,
        jpeg._ptr(np.ones(c.h, np.uint8)), jpeg._ptr(naive))
    assert (naive != got).any()


# -------------------------------------------------- hypothesis, any form

@st.composite
def forms(draw):
    """A frame of 1, 3 or 4 components with sampling factors 1-4 (some
    fractional), a coding, a size, restarts, an Adobe marker or none and,
    for arithmetic coding, DAC conditioning."""
    ncomp = draw(st.sampled_from([1, 3, 4]))
    samp = [(draw(st.integers(1, 4)), draw(st.integers(1, 4)))
            for _ in range(ncomp)]
    coding = draw(st.sampled_from(["seq", "prog", "prog_partial", "arith",
                                   "arith_prog"]))
    shape = (draw(st.integers(1, 36)), draw(st.integers(1, 36)))
    adobe = draw(st.sampled_from([None, 0, 1, 2])) if ncomp > 1 else None
    dac = None
    if coding.startswith("arith") and draw(st.booleans()):
        dac = {}
        for t in range(ncomp):
            lo = draw(st.integers(0, 15))
            dac[t] = draw(st.integers(lo, 15)) << 4 | lo
            dac[16 + t] = draw(st.integers(1, 63))
    restart = draw(st.sampled_from([0, 0, 1, 2, 5]))
    seed = draw(st.integers(0, 2**32 - 1))
    return samp, coding, shape, adobe, dac, restart, seed


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(form=forms())
def test_any_form_equals_jax_or_both_refuse(form):
    samp, coding, shape, adobe, dac, restart, seed = form
    rng = np.random.default_rng(seed)
    frame, qts, coefs = _frame(rng, shape, samp)
    n = len(samp)
    hmax, vmax = max(h for h, _ in samp), max(v for _, v in samp)
    fractional = n > 1 and any(hmax % h or vmax % v for h, v in samp)
    comps = tuple(range(n))
    progressive = "prog" in coding
    if not progressive:
        script = [(comps, 0, 63, 0, 0)]
    elif coding == "prog_partial":
        script = [(comps, 0, 0, 0, 1)] + [((i,), 1, 63, 0, 1) for i in comps]
    else:
        script = W.full_script(n, 1, ((1, 5, 0), (6, 63, 1)))
    if n > 1 and sum(h * v for h, v in samp) > 10:
        # past libjpeg's 10 blocks per MCU: one component per scan
        script = [((i,), *scan[1:]) for scan in script
                  for i in scan[0]]
    blob = W.write_jpeg(frame, coefs, qts, script, progressive=progressive,
                        arithmetic=coding.startswith("arith"), dac=dac,
                        restart=restart, adobe=adobe)
    if fractional:
        with pytest.raises(ValueError, match="fractional sampling"):
            jpeg.decode_jpeg(blob)
        with pytest.raises(OSError):
            _jax_pixels(blob)
        return
    _assert_like_jax(blob)


# ------------------------------------------------ still refused, probed

def _baseline(rng=None):
    rng = rng or np.random.default_rng(0)
    frame, qts, coefs = _frame(rng, (16, 16), "420")
    return W.write_jpeg(frame, coefs, qts, [((0, 1, 2), 0, 63, 0, 0)],
                        progressive=False)


def _refused_files() -> dict:
    base = _baseline()
    i = base.index(b"\xff\xc0")
    out = {"12-bit": (base[:i + 4] + bytes([12]) + base[i + 5:], "12-bit")}
    for code, what in ((0xC5, "differential sequential"),
                       (0xC6, "differential progressive"),
                       (0xC7, "differential lossless"),
                       (0xCB, "arithmetic-coded lossless"),
                       (0xCD, "arithmetic-coded differential sequential"),
                       (0xCE, "arithmetic-coded differential progressive"),
                       (0xCF, "arithmetic-coded differential lossless")):
        out[f"SOF{code - 0xC0}"] = (base[:i + 1] + bytes([code])
                                    + base[i + 2:], f"{what}.*SOF")
    dnl = base[:i + 5] + b"\x00\x00" + base[i + 7:]
    end = dnl.rindex(b"\xff\xd9")
    out["DNL"] = (dnl[:end] + b"\xff\xdc\x00\x04\x00\x10" + dnl[end:],
                  "DNL")
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 256, (9, 11)).astype(np.uint8)
              for _ in range(3)]
    out["lossless_ycbcr"] = (W.write_lossless(planes, 9, 11, "444",
                                              [(0, 1, 2)]),
                             "lossless file in YCbCr")
    out["lossless_restart"] = (W.write_lossless(planes[:1], 9, 11, "gray",
                                                [(0,)], restart=11)
                               .replace(b"\xff\xdd\x00\x04\x00\x0b",
                                        b"\xff\xdd\x00\x04\x00\x05"),
                               "whole number of MCU rows")
    frame = W.Frame(8, 8, [(4, 3), (1, 1), (1, 1)])
    big = W.write_jpeg(frame, W.random_coefficients(
        frame, rng, 0.5, [np.full(64, 9)] * 3), {0: np.full(64, 9)},
        [((0, 1, 2), 0, 63, 0, 0)], progressive=False)
    out["15_blocks_per_mcu"] = (big, "more than 10 blocks")
    return out


REFUSED = _refused_files()


@pytest.mark.parametrize("name", list(REFUSED))
def test_probed_forms_refused_like_pil(name):
    """What PIL 12.1.0 here refuses, the port refuses, its ``ValueError``
    naming the form."""
    blob, message = REFUSED[name]
    with pytest.raises(ValueError, match=message):
        jpeg.decode_jpeg(blob)
    with pytest.raises(OSError):
        _jax_pixels(blob)


@pytest.mark.slow
def test_committed_jpeg_forms_fixtures_are_current(tmp_path):
    """``scripts/make_jpeg_forms_fixtures.py`` run afresh writes the
    committed fixture files byte for byte and the committed reference
    (digests equal, horizons within 1e-6)."""
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_forms_fixtures", os.path.join(
            ROOT, "scripts", "make_jpeg_forms_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.make(str(tmp_path))
    assert sorted(fresh) == sorted(_REF.files)
    for k, v in fresh.items():
        v = np.asarray(v)
        if v.dtype.kind in "US":
            assert v.tolist() == _REF[k].tolist(), k
        else:
            np.testing.assert_allclose(v, _REF[k], atol=1e-6, err_msg=k)
    for name in FILES:
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as a, \
                open(tmp_path / "jpeg_forms" / f"{name}.jpg", "rb") as b:
            assert a.read() == b.read(), name
