"""Regenerate assets/examples/jax_reference_outputs.npz.

Runs the JAX package's zero-host-round-trip program
(``pipeline.device_pipeline_full``) on the CPU over the four bundled scenes
(assets/examples/scene_{0..3}.png) with the shipped weights and the default
config except ``det_topk="exact"`` (the selection the PyTorch port
implements), and saves ``hp1``, ``hp2``, ``vp``, ``alive`` and ``counts``.
``chip_smoke.py`` holds the port's horizons against this file on the GPU,
where JAX is not installed.

    python scripts/make_jax_reference_outputs.py [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_outputs.npz")
KEYS = ("hp1", "hp2", "vp", "alive", "counts")


def reference_outputs() -> dict:
    """The JAX outputs on the bundled scenes, as numpy arrays."""
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
    grays = [pipe.ingest_image(os.path.join(
        ROOT, "assets", "examples", f"scene_{i}.png"))["gray"]
        for i in range(4)]
    out = pipe.process_images(grays)
    return {k: np.asarray(out[k]) for k in KEYS}


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
