"""Regenerate assets/examples/jax_reference_bench.npz.

Draws the throughput bench's 32 synthetic scenes at 640x640 with the JAX
package's own generators (root ``bench.py``'s draw: ``default_rng(0)``,
``make_scene`` with 30-59 lines per VP and 10-29 outliers, the image
rendered with sensor noise), runs them through the JAX package's
zero-host-round-trip program (``pipeline.device_pipeline_full``, via
``Pipeline.process_images``) on the CPU in batches of 4, with the shipped
weights and the default config except ``det_topk="exact"`` (the selection
the PyTorch port implements), and saves ``hp1`` and ``hp2``.
``chip_smoke.py`` holds the horizons of the port's bench loops against
this file on the GPU, where JAX is not installed.

    python scripts/make_jax_reference_bench.py [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_bench.npz")
KEYS = ("hp1", "hp2")
BATCH, SIZE, CHUNK = 32, 640, 4


def bench_images(batch: int = BATCH, size: int = SIZE):
    """The JAX bench's inputs from the JAX package -> (images (B, size,
    size) uint8, l, lp, mask), as root ``bench.py`` draws them."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import numpy as np

    from vanishing_points_2017_tpu.data.datasets import render_scene_image
    from vanishing_points_2017_tpu.models import synth
    from vanishing_points_2017_tpu.pipeline import PipelineConfig, pad_lines

    n_pad = PipelineConfig().n_pad
    rng = np.random.default_rng(0)
    imgs, ls, lps, masks = [], [], [], []
    for _ in range(batch):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(30, 60)),
                                 outliers=int(rng.integers(10, 30)))
        imgs.append(render_scene_image(scene, size=size, rng=rng))
        l, lp, m = pad_lines(scene.segments, n_pad)
        ls.append(l), lps.append(lp), masks.append(m)
    return (np.stack(imgs).astype(np.uint8), np.stack(ls), np.stack(lps),
            np.stack(masks))


def reference_outputs() -> dict:
    """The JAX outputs on the bench's scenes, as numpy arrays."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu.weights import load_params_and_mean

    params, mean = load_params_and_mean(warn=False)
    cfg = dataclasses.replace(PipelineConfig(), det_topk="exact")
    pipe = Pipeline(params, mean, cfg)
    imgs = bench_images()[0]
    outs = [pipe.process_images(list(imgs[i:i + CHUNK]))
            for i in range(0, len(imgs), CHUNK)]
    return {k: np.concatenate([np.asarray(o[k]) for o in outs])
            for k in KEYS}


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
