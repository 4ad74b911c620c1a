"""Progressive JPEG (SOF2) in the port's decoder (``data/jpeg.py``,
``csrc/jpeg_entropy.cpp``) against the JAX package's ``load_image`` (PIL,
libjpeg-turbo), every comparison exact (uint8 equality, shapes equal).

* PIL's own progressive files: qualities, subsamplings, gray, optimised
  tables, restart markers, sizes from 1x1 to wider than 2048.
* Files of a test-only coefficient-level writer
  (``tests/jpeg_progressive_writer.py``) under hypothesis-drawn scan
  scripts (spectral selection, successive approximation from Al up to 3,
  DC scans interleaved or not, long end-of-band runs, runs cut by restart
  markers): the port's decode equals PIL's decode of the same bytes, and
  the port's decode of a baseline file of the same coefficients.
* What libjpeg only warns about decodes as PIL decodes it; what it refuses
  raises; files that take libjpeg-turbo's block-smoothing path decode as
  PIL decodes them (more patterns: tests/test_torch_jpeg_forms.py);
  quantisation tables are latched at each component's first scan.
* The committed fixtures (``scripts/make_progressive_fixtures.py``) and
  the York Urban adapter and driver on a mini whose evaluated files are
  progressive.
"""

import contextlib
import hashlib
import importlib.util
import io
import os
import shutil

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image, ImageFile

import jpeg_progressive_writer as W
from vanishing_points_2017_tpu.data import datasets as jds
from vanishing_points_2017_tpu.data import io as jio
from vanishing_points_2017_tpu_torch import benchmark as tbench
from vanishing_points_2017_tpu_torch.data import datasets as tds
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data import jpeg
from vanishing_points_2017_tpu_torch.data import minisets as tmini

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "assets", "examples")
FIXTURES = os.path.join(EXAMPLES, "progressive")
REFERENCE = os.path.join(EXAMPLES, "jax_reference_progressive.npz")
# normalized horizon error between the two packages' horizons, the gate
# chip_smoke.py holds the card to (PERF.md section 2)
HORIZON_TOL = 0.02


def _noise(shape, seed=0):
    """Smooth gradients with noise: compresses like a photograph."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    base = (x + 2 * y) % 256 if len(shape) == 2 else (
        (x + 2 * y)[..., None] + np.arange(shape[2]) * 70) % 256
    return np.clip(base + rng.normal(0, 20, shape), 0, 255).astype(np.uint8)


def _pil_progressive(arr, **kw) -> bytes:
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 4 * arr.size)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", progressive=True, **kw)
    return buf.getvalue()


def _pil_pixels(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)))


def _assert_like_jax(tmp_path, blob: bytes) -> np.ndarray:
    """The port's ``load_image`` and ``decode_jpeg`` against the JAX
    package's ``load_image`` on the same file, and the sizes read from
    the header."""
    path = tmp_path / "p.jpg"
    path.write_bytes(blob)
    want = jio.load_image(str(path))
    for got in (tio.load_image(str(path)), jpeg.decode_jpeg(blob)):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert jpeg.jpeg_size(blob) == tio.image_size(str(path)) == want.shape[:2]
    return want


# ------------------------------------------------------ PIL's own files

PIL_CASES = {
    "q50": ((48, 64, 3), dict(quality=50)),
    "q75": ((48, 64, 3), dict(quality=75)),
    "q92": ((48, 64, 3), dict(quality=92)),
    "q100": ((48, 64, 3), dict(quality=100)),
    "444": ((45, 61, 3), dict(quality=92, subsampling=0)),
    "422": ((45, 61, 3), dict(quality=92, subsampling=1)),
    "420": ((45, 61, 3), dict(quality=92, subsampling=2)),
    "gray": ((45, 61), dict(quality=92)),
    "gray_q100": ((45, 61), dict(quality=100)),
    "optimize": ((45, 61, 3), dict(quality=92, optimize=True)),
    "restart_blocks": ((75, 133, 3), dict(quality=92,
                                          restart_marker_blocks=3)),
    "restart_rows": ((75, 133, 3), dict(quality=75, restart_marker_rows=1)),
    "gray_restart": ((75, 133), dict(quality=92, restart_marker_blocks=5)),
    "1x1": ((1, 1, 3), dict(quality=92)),
    "1x1_gray": ((1, 1), dict(quality=92)),
    "37x23": ((23, 37, 3), dict(quality=92)),
    "37x23_444": ((23, 37, 3), dict(quality=92, subsampling=0)),
    "480x640": ((480, 640, 3), dict(quality=92)),
    "wide_2100x40": ((40, 2100, 3), dict(quality=92)),
}


@pytest.mark.parametrize("case", list(PIL_CASES))
def test_pil_progressive_equals_jax(tmp_path, case):
    shape, kw = PIL_CASES[case]
    _assert_like_jax(tmp_path, _pil_progressive(_noise(shape, len(case)),
                                                **kw))


def test_progressive_equals_baseline_of_the_same_array(tmp_path):
    """PIL's progressive and baseline files of one array carry the same
    quantised coefficients, so they decode to the same pixels; the port's
    own writer gives PIL's baseline bytes (4:2:0 and gray)."""
    for arr in (_noise((480, 640, 3), 1), _noise((61, 45), 2)):
        prog = _pil_progressive(arr, quality=92)
        got = _assert_like_jax(tmp_path, prog)
        np.testing.assert_array_equal(
            jpeg.decode_jpeg(jpeg.encode_jpeg(arr, quality=92)), got)


# ------------------------------------------------- crafted scan scripts

def _tables(rng, ncomp: int) -> dict:
    n = 1 if ncomp == 1 else 2
    return {k: rng.integers(1, 48, 64) for k in range(n)}


def _case(rng, shape, sampling, sparsity):
    frame = W.Frame(shape[0], shape[1], sampling)
    qts = _tables(rng, len(frame.comps))
    slots = sorted(qts)
    tables = [qts[slots[min(i, len(slots) - 1)]]
              for i in range(len(frame.comps))]
    return frame, qts, W.random_coefficients(frame, rng, sparsity, tables)


def _check_crafted(frame, qts, coefs, script, restart=0, overrun=0):
    """The port's decode of the progressive file equals PIL's and the
    port's decode of a baseline file of the same coefficients."""
    blob = W.write_jpeg(frame, coefs, qts, script, restart=restart,
                        overrun=overrun)
    want = _pil_pixels(blob)
    got = jpeg.decode_jpeg(blob)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    ncomp = len(frame.comps)
    base = W.write_jpeg(frame, coefs, qts, [(tuple(range(ncomp)), 0, 63, 0,
                                             0)], progressive=False)
    np.testing.assert_array_equal(jpeg.decode_jpeg(base), got)
    return got


@st.composite
def scan_scripts(draw, ncomp: int):
    """A progressive script that sends every bit: DC first at some Al
    (interleaved or one scan per component), its refinements, and per
    component the band 1..63 cut into 1-4 bands, each first sent at some
    Al up to 3 and refined down to 0; the chains interleaved at random,
    every chain's scans kept in order and the DC first scans ahead."""
    comps = tuple(range(ncomp))

    def dc_scans(ah, al):
        if ncomp == 1 or draw(st.booleans()):
            return [(comps, 0, 0, ah, al)]
        return [((i,), 0, 0, ah, al) for i in comps]

    dc_al = draw(st.integers(0, 3))
    script = dc_scans(0, dc_al)
    chains = [sum((dc_scans(a + 1, a) for a in range(dc_al - 1, -1, -1)),
                  [])]
    for i in comps:
        cuts = sorted(draw(st.sets(st.integers(2, 63), max_size=3)))
        edges = [1] + cuts + [64]
        for ss, nxt in zip(edges, edges[1:]):
            al = draw(st.integers(0, 3))
            chains.append([((i,), ss, nxt - 1, 0, al)]
                          + [((i,), ss, nxt - 1, a + 1, a)
                             for a in range(al - 1, -1, -1)])
    chains = [c for c in chains if c]
    while chains:
        chain = chains[draw(st.integers(0, len(chains) - 1))]
        script.append(chain.pop(0))
        chains = [c for c in chains if c]
    return script


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data())
def test_crafted_scripts_equal_pil_and_baseline(data):
    sampling = data.draw(st.sampled_from(["gray", "444", "422", "420"]))
    shape = (data.draw(st.integers(1, 40)), data.draw(st.integers(1, 40)))
    sparsity = data.draw(st.sampled_from([0.0, 0.5, 0.9, 1.0]))
    restart = data.draw(st.sampled_from([0, 0, 1, 2, 3, 7]))
    overrun = data.draw(st.sampled_from([0, 1, 5])) if restart else 0
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    frame, qts, coefs = _case(rng, shape, sampling, sparsity)
    script = data.draw(scan_scripts(len(frame.comps)))
    _check_crafted(frame, qts, coefs, script, restart, overrun)


def _y_bands(script_bands, dc_al=0, ncomp=3):
    return W.full_script(ncomp, dc_al, script_bands)


FIXED = {
    # spectral selection alone: every band at Al = 0
    "spectral_only": (dict(), _y_bands(((1, 1, 0), (2, 9, 0), (10, 63, 0)))),
    # successive approximation from Al = 3 on DC and every band
    "al3_refined": (dict(), _y_bands(((1, 5, 3), (6, 63, 3)), dc_al=3)),
    # one DC scan per component, then its refinement per component
    "noninterleaved_dc": (dict(), [((0,), 0, 0, 0, 1), ((1,), 0, 0, 0, 1),
                                   ((2,), 0, 0, 0, 1)]
                          + [((i,), 0, 0, 1, 0) for i in range(3)]
                          + W.full_script(3)[1:]),
    # all-zero AC everywhere: end-of-band runs over whole scans
    "long_eob_runs": (dict(sparsity=1.0), _y_bands(((1, 63, 2),), 1)),
    # runs cut by restart markers, written too long: the decoder drops
    # the rest of the run at each marker
    "runs_across_restarts": (dict(sparsity=0.9, restart=2, overrun=5),
                             _y_bands(((1, 5, 1), (6, 63, 2)), 1)),
    "restart_every_block": (dict(restart=1, overrun=1),
                            _y_bands(((1, 63, 1),), 2)),
}


@pytest.mark.parametrize("name", list(FIXED))
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_crafted_fixed_scripts(name, sampling):
    """The script kinds the hypothesis test draws, each pinned once at a
    size with partial MCUs (45 x 37)."""
    kw, script = FIXED[name]
    rng = np.random.default_rng(len(name))
    frame, qts, coefs = _case(rng, (45, 37), sampling,
                              kw.get("sparsity", 0.5))
    _check_crafted(frame, qts, coefs, script, kw.get("restart", 0),
                   kw.get("overrun", 0))


def test_end_of_band_run_past_a_restart_is_dropped():
    """Gray, one-block restart intervals, every block's AC zero, runs
    written 5 blocks too long: a decoder that carried the run past a
    marker would skip the next blocks' symbols. Against PIL."""
    rng = np.random.default_rng(3)
    frame, qts, coefs = _case(rng, (24, 40), "gray", 1.0)
    coefs[0][1, 2, 1] = 3  # one block with an AC value after a run
    _check_crafted(frame, qts, coefs, W.full_script(1, 0, ((1, 63, 1),)),
                   restart=1, overrun=5)


# libjpeg only warns (JWRN_BOGUS_PROGRESSION) and decodes all the same
WARNED = {
    # an AC scan of a component before its first DC scan
    "ac_before_dc": [((0,), 1, 63, 0, 0), ((0, 1, 2), 0, 0, 0, 0),
                     ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    # a DC refinement whose Ah is not the bits already known
    "bogus_ah": [((0, 1, 2), 0, 0, 0, 1), ((0, 1, 2), 0, 0, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0)] + W.full_script(3)[1:],
}


@pytest.mark.parametrize("name", list(WARNED))
def test_bogus_progressions_decode_as_pil(name):
    rng = np.random.default_rng(5)
    frame, qts, coefs = _case(rng, (33, 41), "420", 0.5)
    _check_crafted(frame, qts, coefs, WARNED[name])


# files that leave bits unknown: those libjpeg-turbo decodes plainly (no
# smoothing, False) and those it smooths (True)
PARTIAL = {
    # coefficients 10-63 never sent: smoothing estimates 1-9 only
    "band_10_63_missing": ([((0,), 0, 0, 0, 0), ((0,), 1, 9, 0, 0)], False),
    # 10-63 sent to Al = 2 only
    "band_10_63_unrefined": ([((0,), 0, 0, 0, 0), ((0,), 1, 9, 0, 0),
                              ((0,), 10, 63, 0, 2)], False),
    # the DC known to Al = 2 only, every AC bit sent
    "dc_unrefined": ([((0,), 0, 0, 0, 2), ((0,), 1, 63, 0, 0)], False),
    # no DC scan at all: libjpeg does not smooth without DC values
    "no_dc_scan": ([((0,), 1, 63, 0, 0)], False),
    # coefficients 1-5 left at Al = 1: the smoothing path
    "ac_1_5_unrefined": ([((0,), 0, 0, 0, 0), ((0,), 1, 5, 0, 1),
                          ((0,), 6, 63, 0, 0)], True),
    # only the DC sent: 1-9 never coded, the smoothing path
    "dc_only": ([((0,), 0, 0, 0, 0)], True),
    # coefficient 9 never coded
    "ac_9_missing": ([((0,), 0, 0, 0, 0), ((0,), 1, 8, 0, 0),
                      ((0,), 10, 63, 0, 0)], True),
}


@pytest.mark.parametrize("name", list(PARTIAL))
def test_unknown_bits_decode_as_pil_or_raise(name):
    """Where libjpeg-turbo's ``smoothing_ok`` holds (DC at least partly
    known, one of coefficients 1-9 short of its last bit) the port smooths
    the blocks as libjpeg-turbo 3.1.3 does (refused until the port did);
    elsewhere the coefficients are decoded as they stand. Both as PIL
    decodes them; the plain ones also as the IDCT of their coefficients
    alone."""
    script, smooths = PARTIAL[name]
    rng = np.random.default_rng(11)
    frame, qts, coefs = _case(rng, (32, 24), "gray", 0.3)
    blob = W.write_jpeg(frame, coefs, qts, script)
    parsed = jpeg._parse(blob)
    assert jpeg._smoothing_ok(parsed.frame.comps) == smooths
    got = jpeg.decode_jpeg(blob)
    np.testing.assert_array_equal(got, _pil_pixels(blob))
    if not smooths:
        c = parsed.frame.comps[0]
        plain = jpeg._idct_blocks(parsed.coefs.reshape(
            c.bh, c.bw, 8, 8).astype(np.int64) * c.qt.reshape(8, 8))
        np.testing.assert_array_equal(plain.transpose(0, 2, 1, 3).reshape(
            c.bh * 8, c.bw * 8)[:c.h, :c.w], got)


def test_smoothing_refused_in_any_component():
    """A colour file whose luma is complete and whose Cr leaves
    coefficient 1 at Al = 1 takes the smoothing path too (refused until
    the port smoothed): decoded as PIL decodes it."""
    rng = np.random.default_rng(12)
    frame, qts, coefs = _case(rng, (32, 24), "420", 0.3)
    script = W.full_script(3)
    script[-1] = ((2,), 1, 63, 0, 1)
    blob = W.write_jpeg(frame, coefs, qts, script)
    assert jpeg._smoothing_ok(jpeg._parse(blob).frame.comps)
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), _pil_pixels(blob))


@pytest.mark.parametrize("ss,se,ah,al", [(0, 1, 0, 0), (1, 5, 0, 0),
                                         (5, 3, 0, 0), (1, 64, 0, 0),
                                         (0, 0, 2, 0), (0, 0, 0, 14)],
                         ids=["dc_se", "ac_3_comps", "ss_gt_se", "se_64",
                              "ah_al", "al_14"])
def test_bad_progression_parameters_raise(ss, se, ah, al):
    """What libjpeg refuses (``JERR_BAD_PROGRESSION``): Se != 0 on a DC
    scan, an AC scan of more than one component, Ss > Se, Se > 63,
    Ah != 0 with Al != Ah - 1, Al > 13. PIL raises on each too."""
    rng = np.random.default_rng(0)
    frame, qts, coefs = _case(rng, (20, 20), "420", 0.5)
    blob = W.write_jpeg(frame, coefs, qts, W.full_script(3))
    i = blob.index(b"\xff\xda")
    off = i + 5 + 2 * blob[i + 4]  # the first (interleaved DC) scan's Ss
    bad = blob[:off] + bytes([ss, se, 16 * ah + al]) + blob[off + 3:]
    with pytest.raises(ValueError, match="bad progression parameters"):
        jpeg.decode_jpeg(bad)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).load()


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
def test_quant_tables_latched_at_first_scan(progressive):
    """A file that redefines table slot 0 between scans: the component
    scanned before the redefinition keeps the old table, as in libjpeg
    (``latch_quant_tables``); the others take the new one. Against PIL,
    and the old and new tables give different pixels."""
    rng = np.random.default_rng(21)
    frame = W.Frame(40, 48, "444")
    old, new = rng.integers(1, 30, 64), rng.integers(30, 60, 64)
    coefs = W.random_coefficients(frame, rng, 0.2, [old, new, new])
    if progressive:
        script = [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 0),
                  ((1,), 0, 0, 0, 0), ((1,), 1, 63, 0, 0),
                  ((2,), 0, 0, 0, 0), ((2,), 1, 63, 0, 0)]
        at = 2
    else:
        script = [((i,), 0, 63, 0, 0) for i in range(3)]
        at = 1
    blob = W.write_jpeg(frame, coefs, {0: old}, script,
                        progressive=progressive, dqt={at: {0: new}})
    assert blob.count(b"\xff\xdb") == 2
    want = _pil_pixels(blob)
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), want)
    all_new = W.write_jpeg(frame, coefs, {0: new}, script,
                           progressive=progressive)
    assert (jpeg.decode_jpeg(all_new) != want).any()


# ------------------------------------------------- still refused, sizes

def test_other_kinds_still_raise(tmp_path):
    """12-bit samples are still refused, with what the file is in the
    message. Arithmetic-coded files were refused until the port read them:
    SOF9 and SOF10 forged onto these Huffman bytes now decode to PIL's
    garbage (tests/test_torch_jpeg.py has a forged file that raises as
    corrupt, where libjpeg only warns). A progressive
    CMYK file (refused until the port read 4 components) reads as the JAX
    package reads it."""
    rgb = _noise((32, 32, 3))
    base = jpeg.encode_jpeg(rgb)
    prog = _pil_progressive(rgb, quality=92)
    for blob, sof, kind in ((base, 0xC0, 0xC9), (prog, 0xC2, 0xCA)):
        i = blob.index(bytes([0xFF, sof]))
        arith = blob[:i + 1] + bytes([kind]) + blob[i + 2:]
        np.testing.assert_array_equal(jpeg.decode_jpeg(arith),
                                      _pil_pixels(arith))
        twelve = blob[:i + 4] + bytes([12]) + blob[i + 5:]
        with pytest.raises(ValueError, match="12-bit"):
            jpeg.decode_jpeg(twelve)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG",
                                              progressive=True)
    _assert_like_jax(tmp_path, buf.getvalue())


def test_jpeg_size_and_image_size_read_sof2(tmp_path):
    """The frame header of a progressive file, also past 64 KiB of
    application segments."""
    blob = _pil_progressive(_noise((23, 37, 3)), quality=92)
    assert jpeg.jpeg_size(blob) == (23, 37)
    app2 = b"\xff\xe2\xff\xff" + bytes(65533)
    path = tmp_path / "big_header.jpg"
    path.write_bytes(blob[:2] + app2 + app2 + blob[2:])
    assert tio.image_size(str(path)) == (23, 37)
    np.testing.assert_array_equal(tio.load_image(str(path)),
                                  jio.load_image(str(path)))


# ------------------------------------------- committed fixtures, the mini

def _reference():
    return np.load(REFERENCE)


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_committed_fixtures_equal_jax():
    """Every committed fixture decodes to the JAX package's pixels (the
    committed digest and PIL here); each small 4:2:0 or gray one also to
    the port's own baseline write of its source array."""
    ref = _reference()
    for name in ref["files"]:
        path = os.path.join(FIXTURES, f"{name}.jpg")
        with open(path, "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == str(
                ref[f"file_sha256_{name}"]), name
        got = tio.load_image(path)
        assert _digest(got) == str(ref[f"sha256_{name}"]), name
        assert got.shape == tuple(ref[f"shape_{name}"])
        np.testing.assert_array_equal(got, jio.load_image(path))
        key = f"array_{name}"
        if key in ref.files and int(ref[f"subsampling_{name}"]) in (-1, 2):
            base = jpeg.encode_jpeg(ref[key], int(ref[f"quality_{name}"]))
            np.testing.assert_array_equal(jpeg.decode_jpeg(base), got)


@pytest.fixture(scope="module")
def progressive_mini(tmp_path_factory):
    """The seed-101 York Urban mini (2 evaluated images) with the two
    progressive fixtures in place of its evaluated files."""
    root = str(tmp_path_factory.mktemp("mini") / "yud")
    tmini.make_mini_yud(root, n_eval=2)
    for name in ("P1026", "P1027"):
        shutil.copyfile(os.path.join(FIXTURES, f"{name}.jpg"),
                        os.path.join(root, name, f"{name}.jpg"))
    return root


def test_yud_adapter_reads_progressive_mini(progressive_mini):
    """The port's adapter gives the JAX adapter's records, sizes and
    pixels on a mini whose evaluated files are progressive."""
    rt, st_ = tds.yud_records(progressive_mini)
    rj, sj = jds.yud_records(progressive_mini)
    assert st_ == sj == 25 and [r.name for r in rt] == [r.name for r in rj]
    for a, b in zip(rt[st_:], rj[sj:]):
        np.testing.assert_allclose(a.true_horizon, b.true_horizon,
                                   rtol=1e-12)
        with open(a.image_path, "rb") as fh:
            assert jpeg._parse(fh.read(), header_only=True).frame.progressive
        assert tio.image_size(a.image_path) == (480, 640)
        np.testing.assert_array_equal(tio.load_image(a.image_path),
                                      jio.load_image(b.image_path))


@pytest.mark.parametrize("detect", [False, True], ids=["host", "device"])
def test_progressive_mini_through_the_driver(progressive_mini, tmp_path,
                                             detect):
    """The slice as a whole on the CPU: ``benchmark --yud`` of the port on
    the progressive mini, host LSD or ``--device_detect``, against the
    committed JAX run on the same files: every horizon and the AUC within
    0.02 (the pixels are equal; the CNN's bfloat16 products and the EM's
    float32 sums differ between the frameworks: P1026's host-path horizon
    lies 0.0014 from JAX's here)."""
    from vanishing_points_2017_tpu_torch import weights as tw
    from vanishing_points_2017_tpu_torch.data.cache import StageCache
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    ref = _reference()
    run = "york_dev" if detect else "york"
    res_dir = str(tmp_path / "res")
    cache = StageCache(os.path.join(res_dir, "york"),
                       tbench.cache_key(PipelineConfig(), detect))
    stage = "result_w" + tw.weights_identity() + "_m" + tw.mean_identity()
    records, start = tds.yud_records(progressive_mini)
    for rec in records[:start]:  # the skipped split: placeholders
        cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))
    argv = ["--yud", "--dataset_dir", progressive_mini, "--result_dir",
            res_dir, "--run_em", "--batch", "2", "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tbench.main(argv + (["--device_detect"] if detect else []))
    out = buf.getvalue()
    assert rc == 0 and out.count("max_error:") == 2, out
    auc = [float(ln.split()[-1]) for ln in out.splitlines()
           if ln.startswith("AUC:")][0]
    assert abs(auc - float(ref[f"auc_{run}"])) <= 0.02
    for i, rec in enumerate(records[start:]):
        assert str(ref[f"{run}_names"][i]) == rec.name
        r = cache.load(rec.name, stage)
        err = tio.normalized_horizon_error(
            np.cross(r["hp1"].astype(np.float64),
                     r["hp2"].astype(np.float64)),
            np.cross(ref[f"{run}_hp1"][i].astype(np.float64),
                     ref[f"{run}_hp2"][i].astype(np.float64)), 640, 480)
        assert err <= HORIZON_TOL, (rec.name, err)


@pytest.mark.slow
def test_committed_progressive_fixtures_are_current(tmp_path):
    """``scripts/make_progressive_fixtures.py`` run afresh writes the
    committed fixture files byte for byte and the committed reference
    (digests equal, horizons within 1e-6)."""
    spec = importlib.util.spec_from_file_location(
        "make_progressive_fixtures", os.path.join(
            ROOT, "scripts", "make_progressive_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.make(str(tmp_path))
    committed = _reference()
    assert sorted(fresh) == sorted(committed.files)
    for k, v in fresh.items():
        v = np.asarray(v)
        if v.dtype.kind in "US":
            assert v.tolist() == committed[k].tolist(), k
        else:
            np.testing.assert_allclose(v, committed[k], atol=1e-6,
                                       err_msg=k)
    for name in committed["files"]:
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as a, \
                open(tmp_path / "progressive" / f"{name}.jpg", "rb") as b:
            assert a.read() == b.read(), name
