"""Regenerate the JPEG-forms fixtures and their JAX reference.

Writes ``assets/examples/jpeg_forms/*.jpg``, JPEG files of the forms the
port's decoder (``vanishing_points_2017_tpu_torch/data/jpeg.py``) reads
beyond 1x1 / 2x1 / 2x2 sampled YCbCr and gray, and ``assets/examples/
jax_reference_jpeg_forms.npz``, what the JAX package makes of them:

* seven 640x480 files of the pixels of P1026, the first evaluated image of
  the seed-101 York Urban mini (``minisets.make_mini_yud(n_eval=2)``, as
  ``scripts/make_progressive_fixtures.py`` takes it): YCCK with 2x2 Y and
  K (``P1026_ycck``), h1v2 YCbCr (``P1026_h1v2``), 4:1:1
  (``P1026_h4v1``), PIL's own CMYK file (``P1026_cmyk``), a progressive
  file whose last refinement scans are left out, so that libjpeg-turbo
  smooths its blocks (``P1026_smooth``), and arithmetic-coded sequential
  and progressive files with restart intervals (``P1026_arith``,
  ``P1026_arith_prog``);
* small files of seeded arrays, one or a few per form: sampling ratios
  (h1v2, h1v4, h3v1, h4v1, h4v2, mixed, narrow planes), CMYK with and
  without the Adobe marker and YCCK, block-smoothing patterns in gray and
  colour (and in an arithmetic-coded file), arithmetic-coded sequential
  and progressive files with restarts and DAC conditioning, and 8-bit
  lossless files (every predictor, a point transform, restarts, RGB,
  replicated chroma, CMYK).

Every file but PIL's CMYK ones comes from the test-only coefficient-level
writer ``tests/jpeg_progressive_writer.py``: the DCT of the component
planes (YCbCr, CMYK or YCCK from the RGB array, box-averaged to each
component's size) quantised by libjpeg's quality-scaled tables.

The npz holds, per fixture ``<name>``: ``sha256_<name>`` (of the JAX
package's ``load_image`` pixels, C order), ``shape_<name>``,
``file_sha256_<name>`` (of the file) and ``form_<name>`` (what the file
is); ``files``, ``timed`` (the 640x480 ones, each with its
``quality_<name>``, at which the port's baseline write of the same array
is timed beside it), ``pillow_version`` and ``libjpeg_version``; and the JAX package's root ``benchmark.py --yud`` on
the CPU with the shipped weights over the mini with P1026 replaced by the
YCCK file (run ``ycck_york``, host LSD; ``ycck_york_dev``,
``--device_detect``) and by the h1v2 file (``h1v2_york``,
``h1v2_york_dev``): ``<run>_names``, ``<run>_hp1``, ``<run>_hp2``,
``<run>_err`` and ``auc_<run>``.

``chip_smoke.py``'s jpeg-forms phase holds the port against these on the
GPU, where neither JAX nor PIL is installed. This script is the only place
that makes these files (about 2 minutes on an 8-core CPU, most of it the
four JAX driver runs and the pure-Python arithmetic coder):

    python scripts/make_jpeg_forms_fixtures.py [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(ROOT, "assets", "examples")
FIXTURE_DIR = "jpeg_forms"
REFERENCE = "jax_reference_jpeg_forms.npz"
PHOTO, QUALITY = "P1026", 85
# the photographs that go through the driver: run prefix -> fixture
DRIVEN = {"ycck": "P1026_ycck", "h1v2": "P1026_h1v2"}

# name -> (form, seed, (height, width), spec); spec keys: sampling,
# colour ("ycc", "gray", "cmyk", "ycck", "rgb"), coding ("seq", "prog",
# "arith", "arith_prog", "lossless", "pil"), script (a progressive script
# name), quality, restart, dac, adobe, jfif, predictor, pt, interleaved
SMALL = {
    "h1v2_37x29": ("sampling h1v2", 11, (37, 29), dict(sampling="122")),
    "h1v2_3x41": ("sampling h1v2, 2 chroma rows", 12, (3, 41),
                  dict(sampling="122")),
    "h1v2_23x1": ("sampling h1v2, 1 column", 13, (23, 1),
                  dict(sampling="122")),
    "h1v4_45x21": ("sampling h1v4", 14, (45, 21),
                   dict(sampling=[(1, 4), (1, 1), (1, 1)])),
    "h3v1_25x40": ("sampling h3v1", 15, (25, 40),
                   dict(sampling=[(3, 1), (1, 1), (1, 1)])),
    "h4v1_45x61": ("sampling h4v1 (4:1:1)", 16, (45, 61),
                   dict(sampling="411")),
    "h4v1_9x5": ("sampling h4v1, 2 chroma columns", 17, (9, 5),
                 dict(sampling="411")),
    "h4v2_33x70": ("sampling h4v2", 18, (33, 70), dict(sampling="412")),
    "mixed_29x37": ("sampling Y 2x2, Cb 1x2, Cr 2x1", 19, (29, 37),
                    dict(sampling=[(2, 2), (1, 2), (2, 1)])),
    "h2v2_1x3": ("sampling h2v2, 1 row, 2 chroma columns", 20, (1, 3),
                 dict(sampling="420")),
    "cmyk_pil_30x41": ("CMYK, PIL's writer (Adobe, transform 0)", 21,
                       (30, 41), dict(colour="cmyk", coding="pil")),
    "cmyk_plain_30x41": ("CMYK without an Adobe marker", 22, (30, 41),
                         dict(sampling="cmyk", colour="cmyk", adobe=None)),
    "cmyk_adobe0_30x41": ("CMYK, Adobe transform 0", 23, (30, 41),
                          dict(sampling="cmyk", colour="cmyk", adobe=0)),
    "ycck_2x2_33x47": ("YCCK, Y and K 2x2", 24, (33, 47),
                       dict(sampling="ycck", colour="ycck", adobe=2)),
    "ycck_h2v1_33x47": ("YCCK, Y and K 2x1", 25, (33, 47),
                        dict(sampling=[(2, 1), (1, 1), (1, 1), (2, 1)],
                             colour="ycck", adobe=2)),
    "ycck_prog_33x47": ("YCCK, progressive", 26, (33, 47),
                        dict(sampling="ycck", colour="ycck", adobe=2,
                             coding="prog", script="full")),
    "smooth_gray_dc_only": ("smoothing: gray, DC only (DC interpolation)",
                            27, (40, 48),
                            dict(sampling="gray", colour="gray",
                                 coding="prog", script="dc_only")),
    "smooth_gray_ac1_5_al1": ("smoothing: gray, coefficients 1-5 at Al 1",
                              28, (40, 48),
                              dict(sampling="gray", colour="gray",
                                   coding="prog", script="ac1_5_al1")),
    "smooth_420_dc_al2": ("smoothing: 4:2:0, DC at Al 2 only", 29,
                          (45, 37), dict(coding="prog", script="dc_al2")),
    "smooth_420_unrefined": ("smoothing: 4:2:0, AC at Al 2 refined to 1",
                             30, (45, 37),
                             dict(coding="prog", script="half_refined")),
    "smooth_444_cr_only": ("smoothing: 4:4:4, Cr's coefficient 1-63 at "
                           "Al 1", 31, (45, 37),
                           dict(sampling="444", coding="prog",
                                script="cr_al1")),
    "smooth_122_dc_only": ("smoothing: h1v2, DC only, partial iMCU row",
                           32, (24, 40),
                           dict(sampling="122", coding="prog",
                                script="dc_only")),
    "smooth_arith_420": ("smoothing: arithmetic-coded 4:2:0, AC at Al 1",
                         33, (45, 37),
                         dict(coding="arith_prog", script="ac_al1",
                              restart=3)),
    "arith_seq_420_dac": ("arithmetic sequential 4:2:0, restarts, DAC",
                          34, (45, 61),
                          dict(coding="arith", restart=4,
                               dac={0: 0x31, 1: 0x20, 16: 8, 17: 2})),
    "arith_seq_gray": ("arithmetic sequential gray", 35, (37, 23),
                       dict(sampling="gray", colour="gray", coding="arith")),
    "arith_prog_420": ("arithmetic progressive 4:2:0, restarts", 36,
                       (45, 61),
                       dict(coding="arith_prog", script="full", restart=5)),
    "arith_prog_444_dac": ("arithmetic progressive 4:4:4, DAC", 37,
                           (33, 40),
                           dict(sampling="444", coding="arith_prog",
                                script="full", dac={0: 0x52, 17: 20})),
    "arith_cmyk": ("arithmetic sequential CMYK, Adobe 0", 38, (30, 41),
                   dict(sampling="cmyk", colour="cmyk", adobe=0,
                        coding="arith", restart=7)),
    "lossless_gray_p1": ("lossless gray, predictor 1", 39, (29, 31),
                         dict(sampling="gray", colour="gray",
                              coding="lossless", predictor=1)),
    "lossless_gray_p4_pt1": ("lossless gray, predictor 4, Pt 1", 40,
                             (29, 31),
                             dict(sampling="gray", colour="gray",
                                  coding="lossless", predictor=4, pt=1)),
    "lossless_gray_p7_restart": ("lossless gray, predictor 7, restarts",
                                 41, (29, 31),
                                 dict(sampling="gray", colour="gray",
                                      coding="lossless", predictor=7,
                                      restart=62)),
    "lossless_rgb_p5": ("lossless RGB (Adobe 0), predictor 5", 42,
                        (23, 27),
                        dict(sampling="444", colour="rgb", adobe=0,
                             coding="lossless", predictor=5, restart=27)),
    "lossless_420_p6": ("lossless 2x2-sampled, no marker, predictor 6",
                        43, (23, 27),
                        dict(colour="rgb", jfif=False, coding="lossless",
                             predictor=6, interleaved=False)),
    "lossless_cmyk_p2": ("lossless CMYK, predictor 2", 44, (23, 27),
                         dict(sampling="cmyk", colour="cmyk",
                              coding="lossless", predictor=2)),
}
# the 640x480 forms of P1026's pixels (spec as above)
PHOTOS = {
    "P1026_ycck": ("YCCK, Y and K 2x2 (Adobe 2)",
                   dict(sampling="ycck", colour="ycck", adobe=2)),
    "P1026_h1v2": ("sampling h1v2", dict(sampling="122")),
    "P1026_h4v1": ("sampling h4v1 (4:1:1)", dict(sampling="411")),
    "P1026_cmyk": ("CMYK, PIL's writer",
                   dict(colour="cmyk", coding="pil", quality=75)),
    "P1026_smooth": ("progressive, smoothed (AC at Al 1 never refined)",
                     dict(coding="prog", script="ac_al1")),
    # PIL opens an arithmetic-coded file only within its first read block
    # (ImageFile.MAXBLOCK, 64 KiB): these stay below it
    "P1026_arith": ("arithmetic sequential 4:2:0, restarts, DAC",
                    dict(coding="arith", restart=40, quality=70,
                         dac={0: 0x31, 1: 0x31, 16: 8, 17: 8})),
    "P1026_arith_prog": ("arithmetic progressive 4:2:0, restarts",
                         dict(coding="arith_prog", script="full",
                              restart=40, quality=70)),
}


def _setup():
    for path in (ROOT, os.path.join(ROOT, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import jax

    jax.config.update("jax_platforms", "cpu")


def _script(name: str, ncomp: int) -> list:
    import jpeg_progressive_writer as W

    comps = tuple(range(ncomp))
    each = [(i,) for i in comps]
    return {
        "full": lambda: W.full_script(ncomp, 1, ((1, 5, 1), (6, 63, 2))),
        "dc_only": lambda: [(comps, 0, 0, 0, 0)],
        "dc_al2": lambda: [(comps, 0, 0, 0, 2)],
        "ac1_5_al1": lambda: [(comps, 0, 0, 0, 0)]
        + [(c, 1, 5, 0, 1) for c in each] + [(c, 6, 63, 0, 0) for c in each],
        "ac_al1": lambda: [(comps, 0, 0, 0, 0)]
        + [(c, 1, 63, 0, 1) for c in each],
        "half_refined": lambda: [(comps, 0, 0, 0, 1)]
        + [(c, 1, 63, 0, 2) for c in each] + [(c, 1, 63, 2, 1) for c in each],
        "cr_al1": lambda: W.full_script(ncomp)[:-1]
        + [((ncomp - 1,), 1, 63, 0, 1)],
    }[name]()


def colour_planes(rgb, colour: str) -> list:
    """Full-size planes of a uint8 RGB array in the file's colour space:
    libjpeg's fixed-point YCbCr; gray (its Y); RGB; CMYK as Adobe stores
    it (inverted, K = 255 - max(R, G, B) before the inversion); YCCK, the
    YCbCr of the CMYK's first three inverted, K as CMYK stores it."""
    import numpy as np

    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))

    def ycc(r, g, b):
        half, mid = 1 << 15, (128 << 16) + (1 << 15) - 1
        return [(19595 * r + 38470 * g + 7471 * b + half) >> 16,
                (-11059 * r - 21709 * g + 32768 * b + mid) >> 16,
                (32768 * r - 27439 * g - 5329 * b + mid) >> 16]

    if colour in ("ycc", "gray"):
        planes = ycc(r, g, b)
        return planes[:1] if colour == "gray" else planes
    if colour == "rgb":
        return [r, g, b]
    white = np.maximum(np.maximum(r, g), b)
    k = 255 - white
    scale = np.maximum(white, 1)
    c, m, y = (255 * (white - v) // scale for v in (r, g, b))
    stored = [255 - c, 255 - m, 255 - y, 255 - k]
    if colour == "cmyk":
        return stored
    return ycc(c, m, y) + [stored[3]]


def component_planes(planes: list, sampling) -> list:
    """Each full-size plane box-averaged (rounded) to its component's size
    under ``sampling``."""
    import numpy as np

    import jpeg_progressive_writer as W

    samp = W.SAMPLING[sampling] if isinstance(sampling, str) else sampling
    hmax, vmax = max(h for h, _ in samp), max(v for _, v in samp)
    out = []
    for p, (h, v) in zip(planes, samp):
        rh, rv = hmax // h, vmax // v
        height, width = p.shape
        ch, cw = -(-height * v // vmax), -(-width * h // hmax)
        q = np.pad(p, ((0, ch * rv - height), (0, cw * rh - width)),
                   mode="edge").astype(np.int64)
        q = q.reshape(ch, rv, cw, rh).sum(axis=(1, 3))
        out.append(((q + rv * rh // 2) // (rv * rh)).astype(np.uint8))
    return out


def write_form(rgb, spec: dict) -> bytes:
    """The file of a uint8 RGB array in the form ``spec`` describes."""
    from PIL import Image

    import jpeg_progressive_writer as W
    from vanishing_points_2017_tpu_torch.data import jpeg

    quality = spec.get("quality", QUALITY)
    colour = spec.get("colour", "ycc")
    coding = spec.get("coding", "seq")
    if coding == "pil":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG",
                                                  quality=quality)
        return buf.getvalue()
    sampling = spec.get("sampling", "420")
    planes = component_planes(colour_planes(rgb, colour), sampling)
    kw = dict(adobe=spec.get("adobe"), jfif=spec.get("jfif"))
    frame = W.Frame(rgb.shape[0], rgb.shape[1], sampling)
    ncomp = len(frame.comps)
    if coding == "lossless":
        scans = ([tuple(range(ncomp))] if spec.get("interleaved", True)
                 else [(i,) for i in range(ncomp)])
        return W.write_lossless(planes, rgb.shape[0], rgb.shape[1], sampling,
                                scans, predictor=spec["predictor"],
                                pt=spec.get("pt", 0),
                                restart=spec.get("restart", 0), **kw)
    # component i reads slot i, or the last: Y (and YCCK's K) the luma
    # table, Cb and Cr the chroma one, CMYK's components all the luma one
    luma = jpeg.quant_table(jpeg._QT_LUMA, quality)
    chroma = jpeg.quant_table(jpeg._QT_CHROMA, quality)
    qts = {"ycc": {0: luma, 1: chroma},
           "ycck": {0: luma, 1: chroma, 2: chroma, 3: luma}}.get(
               colour, {0: luma})
    tables = [qts[min(i, len(qts) - 1)] for i in range(ncomp)]
    coefs = W.pixel_coefficients(frame, planes, tables)
    progressive = coding in ("prog", "arith_prog")
    script = (_script(spec["script"], ncomp) if progressive
              else [(tuple(range(ncomp)), 0, 63, 0, 0)])
    return W.write_jpeg(frame, coefs, qts, script, progressive=progressive,
                        arithmetic=coding.startswith("arith"),
                        restart=spec.get("restart", 0), dac=spec.get("dac"),
                        **kw)


def pixel_digest(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _progressive_script():
    spec = importlib.util.spec_from_file_location(
        "make_progressive_fixtures",
        os.path.join(ROOT, "scripts", "make_progressive_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(out_dir: str) -> dict:
    """Write the fixtures into ``out_dir/jpeg_forms`` and return the
    reference file's content."""
    _setup()
    import numpy as np
    import PIL
    from PIL import features

    from vanishing_points_2017_tpu.data import io as jio
    from vanishing_points_2017_tpu_torch.data import minisets

    prog = _progressive_script()
    fixture_dir = os.path.join(out_dir, FIXTURE_DIR)
    os.makedirs(fixture_dir, exist_ok=True)
    ref = {"pillow_version": np.asarray(PIL.__version__),
           "libjpeg_version": np.asarray(
               f"libjpeg-turbo {features.version('libjpeg_turbo')}"
               if features.check_feature("libjpeg_turbo")
               else f"libjpeg {features.version('jpg')}"),
           "timed": np.array(list(PHOTOS))}
    ref |= {f"quality_{name}": np.asarray(spec.get("quality", QUALITY))
            for name, (_, spec) in PHOTOS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        mini = os.path.join(tmp, "mini")
        minisets.make_mini_yud(mini, n_eval=prog.N_EVAL, seed=prog.SEED)
        photo_path = os.path.join(mini, PHOTO, f"{PHOTO}.jpg")
        photo = jio.load_image(photo_path)
        made = {name: (form, write_form(photo, spec))
                for name, (form, spec) in PHOTOS.items()}
        for name, (form, seed, shape, spec) in SMALL.items():
            arr = prog.seeded_array(seed, shape, 3)
            made[name] = (form, write_form(arr, spec))
        for name, (form, blob) in made.items():
            path = os.path.join(fixture_dir, f"{name}.jpg")
            with open(path, "wb") as fh:
                fh.write(blob)
            pixels = jio.load_image(path)
            ref |= {f"sha256_{name}": np.asarray(pixel_digest(pixels)),
                    f"shape_{name}": np.asarray(pixels.shape),
                    f"file_sha256_{name}": np.asarray(
                        hashlib.sha256(blob).hexdigest()),
                    f"form_{name}": np.asarray(form)}
        ref["files"] = np.array(list(made))
        original = os.path.join(tmp, "P1026_baseline.jpg")
        shutil.copyfile(photo_path, original)
        for prefix, name in DRIVEN.items():
            shutil.copyfile(os.path.join(fixture_dir, f"{name}.jpg"),
                            photo_path)
            for run in prog.RUNS:
                out = prog.run_outputs(run, mini,
                                       os.path.join(tmp, prefix, "results"))
                ref |= {k.replace(run, f"{prefix}_{run}", 1): v
                        for k, v in out.items()}
        shutil.copyfile(original, photo_path)
    return ref


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=DEFAULT_DIR,
                    help="where jpeg_forms/ and the .npz go")
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    ref = make(args.out_dir)
    np.savez_compressed(os.path.join(args.out_dir, REFERENCE), **ref)
    runs = [k[4:] for k in ref if k.startswith("auc_")]
    aucs = ", ".join(f"{r} {float(ref[f'auc_{r}']):.4f}" for r in runs)
    print(f"wrote {len(ref['files'])} fixtures and {REFERENCE} into "
          f"{args.out_dir} in {time.time() - t0:.0f} s: AUC {aucs}")


if __name__ == "__main__":
    main()
