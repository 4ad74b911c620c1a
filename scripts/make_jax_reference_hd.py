"""Regenerate assets/examples/jax_reference_hd.npz.

Draws 4 synthetic frames at 1280x720 and 4 at 1920x1080, one fixed seed
each (``default_rng(seed)``, the port's numpy ``models.synth.make_scene``
and ``data.datasets.render_scene_image_wh`` with sensor noise), runs them
through the JAX package's zero-host-round-trip program
(``pipeline.device_pipeline_full``, via ``Pipeline.process_images``) on
the CPU, one batch of 4 per shape, with the shipped weights and the
default config except ``det_topk="exact"`` (the selection the PyTorch
port implements), and saves the seeds, each frame's sha256, and JAX's
``hp1``, ``hp2``, ``alive`` and segment count. No pixels are stored:
``chip_smoke.py`` re-renders the frames, checks their digests and holds
the port's horizons on the GPU against this file (gradient grids of
719x1279 and 1079x1919, the widths that take K1's wide kernels).

    python scripts/make_jax_reference_hd.py [--out PATH]

About a minute and ~6 GB on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_hd.npz")
# (width, height) -> the seeds of its frames
SHAPES = {(1280, 720): (1, 2, 3, 4), (1920, 1080): (11, 12, 13, 14)}


def frame(seed: int, width: int, height: int):
    """One synthetic frame (height, width) uint8 from ``seed``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import numpy as np

    from vanishing_points_2017_tpu_torch.data.datasets import \
        render_scene_image_wh
    from vanishing_points_2017_tpu_torch.models import synth

    rng = np.random.default_rng(seed)
    return render_scene_image_wh(synth.make_scene(rng), width, height, rng)


def digest(img) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def reference_outputs() -> dict:
    """Seeds, shapes, digests and the JAX outputs, as numpy arrays (the
    frames in SHAPES order)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from vanishing_points_2017_tpu.ops.lines_device import \
        detect_segments_device
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu.weights import load_params_and_mean

    params, mean = load_params_and_mean(warn=False)
    cfg = dataclasses.replace(PipelineConfig(), det_topk="exact")
    pipe = Pipeline(params, mean, cfg)
    rec = {k: [] for k in ("seed", "width", "height", "sha256", "hp1", "hp2",
                           "alive", "segments")}
    for (w, h), seeds in SHAPES.items():
        frames = [frame(s, w, h) for s in seeds]
        out = pipe.process_images(frames)
        for s, img, i in zip(seeds, frames, range(len(seeds))):
            _, mask = detect_segments_device(
                jax.numpy.asarray(img), max_segments=cfg.n_pad,
                min_count=cfg.det_min_count, min_len_px=cfg.det_min_len_px,
                min_density=cfg.det_min_density, ccl_impl=cfg.ccl_impl,
                selection=cfg.det_selection,
                max_records=cfg.det_max_records, topk_impl=cfg.det_topk)
            rec["seed"].append(s)
            rec["width"].append(w)
            rec["height"].append(h)
            rec["sha256"].append(digest(img))
            rec["segments"].append(int(np.asarray(mask).sum()))
            for k in ("hp1", "hp2", "alive"):
                rec[k].append(np.asarray(out[k][i]))
    return {k: np.asarray(v) for k, v in rec.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import numpy as np

    ref = reference_outputs()
    np.savez(args.out, **ref)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k}{tuple(v.shape)}" for k, v in ref.items()))


if __name__ == "__main__":
    main()
