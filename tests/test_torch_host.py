"""Host side of the PyTorch port vs the JAX package: the LSD binding, the
PIL-free Lanczos resize and image reader, the synthetic scenes and their
PIL-free rendering, the AUC and the stage cache."""

import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from vanishing_points_2017_tpu import lsd as jlsd
from vanishing_points_2017_tpu.data import datasets as jds
from vanishing_points_2017_tpu.data import io as jio
from vanishing_points_2017_tpu.metrics import calc_auc as jauc
from vanishing_points_2017_tpu.models import synth as jsynth
from vanishing_points_2017_tpu_torch import lsd as tlsd
from vanishing_points_2017_tpu_torch.data import datasets as tds
from vanishing_points_2017_tpu_torch.data import io as tio
from vanishing_points_2017_tpu_torch.data.cache import StageCache
from vanishing_points_2017_tpu_torch.metrics import calc_auc as tauc
from vanishing_points_2017_tpu_torch.models import synth as tsynth
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = [os.path.join(ROOT, "assets", "examples", f"scene_{i}.png")
          for i in range(4)]


def _scene_images():
    imgs = [jio.rgb2gray(jio.load_image(p)) * 255.0 for p in SCENES]
    recs, _ = jds.synthetic_records(count=3, seed=3)
    return imgs + [r.image.astype(np.float64) for r in recs]


def test_lsd_segments_identical_to_jax():
    """Both bindings compile the one lsd.cpp with the same flags: identical
    (N, 7) segments on the 4 bundled scenes and 3 synthetic images."""
    for img in _scene_images():
        ref = jlsd.detect_line_segments(img)
        got = tlsd.detect_line_segments(img)
        assert got.shape[1] == 7 and got.shape[0] > 50
        np.testing.assert_array_equal(got, ref)


def test_lsd_library_is_built_under_build_dir():
    tlsd.detect_line_segments(np.zeros((16, 16)))
    path = tlsd._lib_path()
    assert os.path.isfile(path)
    assert path.startswith(os.path.join(ROOT, "build", "lsd") + os.sep)
    with pytest.raises(ValueError):
        tlsd.detect_line_segments(np.zeros((4, 4, 3)))


def test_detect_lsd_lines_and_ingest_match_jax():
    """Normalized segments and NFAs of the host ingest equal JAX's."""
    img = jio.load_image(SCENES[0])
    gray_j, gray_t = jio.rgb2gray(img), tio.rgb2gray(tio.load_image(SCENES[0]))
    np.testing.assert_array_equal(gray_t, gray_j)
    ref, got = jio.detect_lsd_lines(gray_j), tio.detect_lsd_lines(gray_t)
    np.testing.assert_array_equal(got["segments"], ref["segments"])
    np.testing.assert_array_equal(got["nfa"], ref["nfa"])
    seg = np.random.default_rng(0).uniform(0, 500, size=(9, 7))
    np.testing.assert_array_equal(tio.normalize_segments(seg, 640, 480),
                                  jio.normalize_segments(seg, 640, 480))


@pytest.mark.parametrize("shape", [(480, 800), (1000, 700), (200, 300),
                                   (641, 480), (123, 457)])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_max_matches_pil(shape, channels):
    """resize_max reproduces Pillow's LANCZOS resize exactly (tolerance 0:
    every pixel equal) on L and RGB images, down- and upscaling."""
    rng = np.random.default_rng(shape[0] + (channels or 0))
    full = shape if channels is None else (*shape, channels)
    img = rng.integers(0, 256, size=full, dtype=np.uint8)
    img = ((img.astype(np.int32) + np.roll(img, 3, 0)) // 2).astype(np.uint8)
    for target in (640, 320, 900):
        got = tio.resize_max(img, target)
        h, w = shape
        scale = target / max(h, w)
        size = (max(1, round(w * scale)), max(1, round(h * scale)))
        ref = img if size == (w, h) else np.asarray(
            Image.fromarray(img).resize(size, Image.LANCZOS))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_load_image_reads_png_and_refuses_jpeg(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (17, 23, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.png")
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "a.png")),
                                  rgb)
    # JPEG is read since the port has its own decoder (data/jpeg.py): the
    # file's pixels are PIL's, progressive and CMYK files' too (CMYK was
    # refused until the port read 4 components); what is refused now is
    # any other format
    Image.fromarray(rgb).save(tmp_path / "a.jpg")
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "a.jpg")),
                                  jio.load_image(str(tmp_path / "a.jpg")))
    Image.fromarray(rgb).save(tmp_path / "p.jpg", progressive=True)
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "p.jpg")),
                                  jio.load_image(str(tmp_path / "p.jpg")))
    Image.fromarray(rgb).convert("CMYK").save(tmp_path / "c.jpg")
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "c.jpg")),
                                  jio.load_image(str(tmp_path / "c.jpg")))
    Image.fromarray(rgb).save(tmp_path / "a.bmp")
    with pytest.raises(ValueError, match="not a PNG, JPEG or WebP file"):
        tio.load_image(str(tmp_path / "a.bmp"))


@pytest.mark.parametrize("seed", [0, 7, 2017])
def test_make_scene_identical_to_jax(seed):
    """Same generator stream, same draws: identical arrays, and the
    generators end in the same state."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for kw in ({}, {"lines_per_vp": 55, "outliers": 0, "noise": 0.01}):
        sj, st = jsynth.make_scene(rj, **kw), tsynth.make_scene(rt, **kw)
        for f in ("segments", "lines", "vps", "vp_assoc", "horizon"):
            np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    assert rj.integers(1 << 30) == rt.integers(1 << 30)


def test_render_scene_image_matches_pil_on_the_protocol():
    """The 50 scenes of the synthetic protocol (seed 7, 640x640) render to
    PIL's pixels exactly (tolerance 0 differing pixels), noise included,
    and the generators stay in step."""
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(50):
        kw = dict(lines_per_vp=int(rj.integers(25, 60)),
                  outliers=int(rj.integers(5, 25)))
        assert kw == dict(lines_per_vp=int(rt.integers(25, 60)),
                          outliers=int(rt.integers(5, 25)))
        sj, st = jsynth.make_scene(rj, **kw), tsynth.make_scene(rt, **kw)
        np.testing.assert_array_equal(tds.render_scene_image(st, rng=rt),
                                      jds.render_scene_image(sj, rng=rj))


def test_wide_lines_match_pil_on_edge_cases():
    """Short, axis-parallel, zero-length and off-canvas lines: the polygon
    fill's corner and horizontal-edge rules, against ImageDraw."""
    rng = np.random.default_rng(1)
    seg = rng.uniform(-30, 100, size=(400, 4))
    k = rng.random(400) < 0.3
    seg[k, 2] = seg[k, 0] + rng.integers(-3, 4, k.sum())
    k = rng.random(400) < 0.3
    seg[k, 3] = seg[k, 1] + rng.integers(-3, 4, k.sum())
    for part in np.split(seg, 8):
        got = np.full((72, 72), 220, np.uint8)
        tds.draw_wide_lines(got, part, 40)
        im = Image.new("L", (72, 72), color=220)
        draw = ImageDraw.Draw(im)
        for x0, y0, x1, y1 in part:
            draw.line([(x0, y0), (x1, y1)], fill=40, width=2)
        np.testing.assert_array_equal(got, np.asarray(im))


def test_synthetic_records_match_jax():
    rj, sj = jds.synthetic_records(count=3, seed=1, size=320)
    rt, st = tds.synthetic_records(count=3, seed=1, size=320)
    # the table holds the real data sets too since the port reads JPEG
    assert sj == st == 0 and tds.DATASETS.keys() == jds.DATASETS.keys()
    assert tds.DATASETS["synthetic"] == (tds.synthetic_records, None)
    for a, b in zip(rj, rt):
        assert a.name == b.name
        np.testing.assert_array_equal(b.image, a.image)
        np.testing.assert_array_equal(b.true_horizon, a.true_horizon)


@pytest.mark.parametrize("errors", [
    np.zeros(10), np.linspace(0.0125, 0.25, 10) - 0.0125 / 2,
    np.array([0.1, 0.4]), np.array([0.5, 0.9]), np.array([0.3, 0.05, 0.2]),
    np.array([0.01]), np.array([0.25, 0.25, 0.1]), np.array([])])
def test_calc_auc_equals_jax_edge_cases(errors):
    auc_t, pts_t = tauc(errors, 0.25)
    auc_j, pts_j = jauc(errors, 0.25)
    assert auc_t == auc_j
    np.testing.assert_array_equal(pts_t, pts_j)


def test_calc_auc_equals_jax_random():
    rng = np.random.default_rng(0)
    for n in (3, 50, 500):
        errors = rng.exponential(0.05, size=n)
        for cutoff in (0.1, 0.25):
            assert tauc(errors, cutoff)[0] == jauc(errors, cutoff)[0]


def test_stage_cache_roundtrip(tmp_path):
    cache = StageCache(str(tmp_path), "cfgkey")
    cache.save("dir/img_001.png", "lines", segments=np.ones((5, 4)),
               image_shape=np.array([480, 640]))
    assert cache.has("img_001", "lines")
    assert not cache.has("img_001", "result")
    got = cache.load("img_001", "lines")
    np.testing.assert_array_equal(got["segments"], np.ones((5, 4)))
    np.testing.assert_array_equal(got["image_shape"], [480, 640])
    assert os.listdir(cache.dir) == ["img_001.lines.npz"]
