"""Regenerate the progressive-JPEG fixtures and their JAX reference.

Writes ``assets/examples/progressive/*.jpg``, progressive JPEG files saved
by PIL (``progressive=True``), and ``assets/examples/
jax_reference_progressive.npz``, what the JAX package makes of them:

* ``P1026.jpg``, ``P1027.jpg``: the two evaluated images of the seed-101
  York Urban mini (``minisets.make_mini_yud(n_eval=2)``), decoded and
  saved again at quality 92 (640x480, 4:2:0);
* ``P1026_1024.jpg``: P1026's pixels resized to 1024x768 (Lanczos), at
  quality 75, for the decode timing at the Eurasian Cities size;
* small files of seeded arrays: gray, 4:4:4, 4:2:2, an odd-sized 4:2:0
  and a 4:2:0 one with restart markers, at quality 92.

The file holds, per fixture ``<name>``: ``sha256_<name>`` (of the JAX
package's ``load_image`` pixels, C order), ``shape_<name>``,
``file_sha256_<name>`` (of the file), ``quality_<name>`` and
``subsampling_<name>`` (-1 for gray), ``array_<name>`` (the source array,
small files only; the two photographs' arrays are the mini's baseline
files decoded, ``P1026_1024``'s that resized); ``pillow_version`` and
``libjpeg_version``; and the JAX package's root ``benchmark.py --yud`` on
the CPU with the shipped weights over the mini with the two progressive
files in place of its evaluated images, on the host-LSD path (``york``)
and with ``--device_detect`` (``york_dev``): ``<run>_names``,
``<run>_hp1``, ``<run>_hp2``, ``<run>_err`` and ``auc_<run>``.

``chip_smoke.py`` holds the port against these on the GPU, where neither
JAX nor PIL is installed. This script is the only place that makes these
files (about 40 s on an 8-core CPU):

    python scripts/make_progressive_fixtures.py [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(ROOT, "assets", "examples")
FIXTURE_DIR = "progressive"
REFERENCE = "jax_reference_progressive.npz"
SEED, N_EVAL, BATCH = 101, 2, 2
PHOTOS = ("P1026", "P1027")
# name -> (seed, (height, width), channels, subsampling, PIL save extras)
SMALL = {"gray_23x37": (1, (23, 37), 1, -1, {}),
         "rgb444_45x61": (2, (45, 61), 3, 0, {}),
         "rgb422_61x45": (3, (61, 45), 3, 1, {}),
         "rgb420_29x67": (4, (29, 67), 3, 2, {}),
         "rgb420_restart_80x96": (5, (80, 96), 3, 2,
                                  {"restart_marker_blocks": 3})}
# run -> extra flags of the JAX driver
RUNS = {"york": [], "york_dev": ["--device_detect"]}


def _setup():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")


def seeded_array(seed: int, shape: tuple, channels: int):
    """A gradient with Gaussian noise, uint8 (H, W) or (H, W, 3)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    base = (2 * x + 3 * y)[..., None] + np.array([0, 60, 120])[:channels]
    arr = base % 256 + rng.normal(0.0, 12.0, shape + (channels,))
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr[..., 0] if channels == 1 else arr


def pixel_digest(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def fixtures(tmp: str) -> dict:
    """name -> (array, quality, subsampling, PIL save extras, keep array),
    after writing the York Urban mini (seed 101, 2 evaluated images) with
    the port's writer into ``tmp/mini``."""
    _setup()
    from vanishing_points_2017_tpu.data import io as jio
    from vanishing_points_2017_tpu_torch.data import minisets

    mini = os.path.join(tmp, "mini")
    minisets.make_mini_yud(mini, n_eval=N_EVAL, seed=SEED)
    out = {}
    for name in PHOTOS:
        arr = jio.load_image(os.path.join(mini, name, f"{name}.jpg"))
        out[name] = (arr, 92, 2, {}, False)
    out["P1026_1024"] = (jio.resize_max(out["P1026"][0], 1024), 75, 2, {},
                         False)
    for name, (seed, shape, ch, sub, extra) in SMALL.items():
        out[name] = (seeded_array(seed, shape, ch), 92, sub, extra, True)
    return out


def save_progressive(arr, quality: int, subsampling: int, extra: dict,
                     path: str) -> bytes:
    from PIL import Image, ImageFile

    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, arr.size * 2)
    kw = dict(quality=quality, progressive=True, **extra)
    if subsampling >= 0:
        kw["subsampling"] = subsampling
    Image.fromarray(arr).save(path, format="JPEG", **kw)
    with open(path, "rb") as fh:
        return fh.read()


def run_outputs(run: str, directory: str, result_dir: str) -> dict:
    """The JAX package's root driver on the progressive mini."""
    _setup()
    import numpy as np

    import benchmark  # the root driver of the JAX package
    from vanishing_points_2017_tpu import weights as wload
    from vanishing_points_2017_tpu.data import datasets as dsets
    from vanishing_points_2017_tpu.data.cache import StageCache
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    extra = RUNS[run]
    cfg = PipelineConfig()
    key = cfg.cache_key() + ("_devdet_" + cfg.det_key() if extra else "")
    stage = ("result_w" + wload.weights_identity() + "_m"
             + wload.mean_identity())
    cache = StageCache(os.path.join(result_dir, "york"), key)
    records, start = dsets.DATASETS["york"][0](directory)
    for rec in records[:start]:  # the skipped split: placeholders
        cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))
    argv, sys.argv = sys.argv, [
        "benchmark.py", "--yud", "--dataset_dir", directory, "--result_dir",
        result_dir, "--run_cnn", "--batch", str(BATCH), "--no_weights_warn",
        *extra]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = benchmark.main()
    finally:
        sys.argv = argv
    text = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"benchmark.py --yud {extra} failed:\n{text}")
    errs = [float(ln.split()[-1]) for ln in text.splitlines()
            if ln.startswith("max_error:")]
    auc = [float(ln.split()[-1]) for ln in text.splitlines()
           if ln.startswith("AUC:")][-1]
    res = [cache.load(r.name, stage) for r in records[start:]]
    assert len(errs) == len(res) == N_EVAL, text
    return {f"{run}_names": np.array([r.name for r in records[start:]]),
            f"{run}_hp1": np.stack([r["hp1"] for r in res]),
            f"{run}_hp2": np.stack([r["hp2"] for r in res]),
            f"{run}_err": np.array(errs), f"auc_{run}": np.asarray(auc)}


def make(out_dir: str) -> dict:
    """Write the fixtures into ``out_dir/progressive`` and return the
    reference file's content."""
    _setup()
    import numpy as np
    import PIL
    from PIL import features

    from vanishing_points_2017_tpu.data import io as jio

    fixture_dir = os.path.join(out_dir, FIXTURE_DIR)
    os.makedirs(fixture_dir, exist_ok=True)
    ref = {"pillow_version": np.asarray(PIL.__version__),
           "libjpeg_version": np.asarray(
               f"libjpeg-turbo {features.version('libjpeg_turbo')}"
               if features.check_feature("libjpeg_turbo")
               else f"libjpeg {features.version('jpg')}")}
    with tempfile.TemporaryDirectory() as tmp:
        made = fixtures(tmp)
        names = []
        for name, (arr, quality, sub, extra, keep) in made.items():
            path = os.path.join(fixture_dir, f"{name}.jpg")
            blob = save_progressive(arr, quality, sub, extra, path)
            pixels = jio.load_image(path)
            names.append(name)
            ref |= {f"sha256_{name}": np.asarray(pixel_digest(pixels)),
                    f"shape_{name}": np.asarray(pixels.shape),
                    f"file_sha256_{name}": np.asarray(
                        hashlib.sha256(blob).hexdigest()),
                    f"quality_{name}": np.asarray(quality),
                    f"subsampling_{name}": np.asarray(sub)}
            if keep:
                ref[f"array_{name}"] = arr
        ref["files"] = np.array(names)
        mini = os.path.join(tmp, "mini")
        for name in PHOTOS:
            shutil.copyfile(os.path.join(fixture_dir, f"{name}.jpg"),
                            os.path.join(mini, name, f"{name}.jpg"))
        for run in RUNS:
            ref |= run_outputs(run, mini, os.path.join(tmp, "results"))
    return ref


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=DEFAULT_DIR,
                    help="where progressive/ and the .npz go")
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    ref = make(args.out_dir)
    np.savez_compressed(os.path.join(args.out_dir, REFERENCE), **ref)
    aucs = ", ".join(f"{r} {float(ref[f'auc_{r}']):.4f}" for r in RUNS)
    print(f"wrote {len(ref['files'])} fixtures and {REFERENCE} into "
          f"{args.out_dir} in {time.time() - t0:.0f} s: AUC {aucs}")


if __name__ == "__main__":
    main()
