"""Regenerate assets/examples/jax_reference_options.npz, the oracle of the
JAX package's non-default detector and EM configurations.

Runs on the CPU, with the JAX package:

* its device detector (``ops/lines_device.py::detect_segments_device``,
  vmapped over each image set) under every entry of ``VARIANTS``: the row
  selection at its default budget and at a binding ``runs_per_row=8``,
  the global selection's prefilter off (``0``) and capped at 1 run per row,
  the approximate top-k (``topk_impl="approx"``, which off the TPU lowers
  to the exact sort), ``tol_deg=15``, ``blur_sigma=0``,
  ``pair_tol_factor=2``, and ``ccl_passes=2`` without and with
  ``check_fixpoint`` (which poisons every image here: two passes do not
  reach the fixpoint on these scenes); and
  the pipeline's own arguments (``global``: ``selection="global"``,
  ``topk_impl="exact"``), on two image sets:

  - ``bench``: scenes ``BENCH_SCENES`` of the JAX bench's 32 scenes (root
    ``bench.py``'s draw, ``default_rng(0)``, 640x640;
    ``make_jax_reference_bench.bench_images``) at 512 segment slots;
    scene 25, a knife edge of the horizon search, is not among them;
  - ``small``: ``tests/test_torch_detector.py``'s 160x160 scenes of seeds
    0 and 1 at 128 slots, the inputs of ``tests/test_torch_options.py``
    (``small_images`` draws them; ``small_images_sha256`` pins them);

  ``{set}_{variant}_segments`` / ``_mask`` hold the outputs;
* its EM with ``EMConfig(loop="phase")``, alone at batch 1 (as
  ``make_jax_reference_em.py`` runs it), on the bench scenes' segments of
  the ``global`` variant, with the EM inputs as JAX's
  ``device_pipeline_batch`` makes them for the four scenes
  (``make_jax_reference_em.stage_inputs``): ``phase_l`` / ``_grid`` /
  ``_sphere`` (the segments are ``bench_global_*``), and the end state's
  ``phase_iterations`` / ``_alive`` / ``_counts`` / ``_hp1`` / ``_hp2``.
  The EM reads the sphere image only through its initial VPs
  (``em/init_vps.py``: per cell of the CNN's 20x20 grid, the mean position
  of the pixels at the cell's maximum), so ``phase_sphere`` keeps the
  pixels at their cell's maximum and zeroes the rest (:func:`em_view`):
  the EM gives the same result on it (checked here on every scene) in a
  few kilobytes instead of 127 KB per image.

``chip_smoke.py``'s options phase holds the port on the card to the bench
set (segments at ``tests/test_torch_detector.py``'s gates, NaN where these
are NaN, phase-loop horizons within 0.02); ``tests/test_torch_options.py``
holds the port on the CPU to the small set and checks (slow) that this
file is current. Takes about 2 minutes on an 8-core CPU.

    python scripts/make_jax_reference_options.py [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_options.npz")
BENCH_SCENES = (0, 1, 2, 3)
SMALL_SIZE, SMALL_SEEDS = 160, (0, 1)
SLOTS = {"bench": 512, "small": 128}
GLOBAL = dict(selection="global", topk_impl="exact")
VARIANTS = {
    "global": GLOBAL,
    "row": dict(selection="row"),
    "row_rpr8": dict(selection="row", runs_per_row=8),
    "prefilter0": dict(GLOBAL, global_prefilter=0),
    "prefilter1": dict(GLOBAL, global_prefilter=1),
    "approx": dict(GLOBAL, topk_impl="approx"),
    "tol15": dict(GLOBAL, tol_deg=15.0),
    "blur0": dict(GLOBAL, blur_sigma=0.0),
    "pair2": dict(GLOBAL, pair_tol_factor=2.0),
    "passes2": dict(GLOBAL, ccl_passes=2),
    "passes2_fixpoint": dict(GLOBAL, ccl_passes=2, check_fixpoint=True),
}
EM_KEYS = ("iterations", "alive", "counts")


def _setup():
    for p in (ROOT, os.path.join(ROOT, "scripts")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax

    jax.config.update("jax_platforms", "cpu")


def small_images():
    """``tests/test_torch_detector.py``'s ``_images(160, (0, 1))``: per
    seed a scene of 30 lines per VP and 8 outliers, rendered at 160x160."""
    _setup()
    import numpy as np

    from vanishing_points_2017_tpu.data.datasets import render_scene_image
    from vanishing_points_2017_tpu.models import synth

    out = []
    for s in SMALL_SEEDS:
        rng = np.random.default_rng(s)
        scene = synth.make_scene(rng, lines_per_vp=30, outliers=8)
        out.append(render_scene_image(scene, size=SMALL_SIZE, rng=rng))
    return np.stack(out)


def sha256(a) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def detect(images, slots: int, kw: dict):
    """The JAX detector on a (B, H, W) set under ``kw`` -> numpy
    (segments, mask)."""
    _setup()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vanishing_points_2017_tpu.ops.lines_device import \
        detect_segments_device

    seg, mask = jax.jit(jax.vmap(lambda im: detect_segments_device(
        im, max_segments=slots, **kw)))(jnp.asarray(images))
    return np.asarray(seg), np.asarray(mask)


def detector_reference(name: str, images) -> dict:
    out = {}
    for v, kw in VARIANTS.items():
        seg, mask = detect(images, SLOTS[name], kw)
        out[f"{name}_{v}_segments"], out[f"{name}_{v}_mask"] = seg, mask
    return out


def em_view(sphere):
    """A uint8 sphere image (S, S) reduced to what the EM reads: in each
    cell of the 20x20 grid, the pixels at the cell's maximum (the EM's
    vertical flip maps cells onto cells)."""
    import numpy as np

    s = sphere.shape[0]
    p = s // 20
    cells = sphere.reshape(20, p, 20, p)
    peak = cells.max(axis=(1, 3), keepdims=True)
    return np.where(cells == peak, cells, 0).reshape(s, s).astype(np.uint8)


def phase_reference(bench: dict) -> dict:
    """JAX's phase-loop EM alone at batch 1 on the bench scenes' global
    segments, with its horizon; the stored sphere is :func:`em_view`'s."""
    _setup()
    import numpy as np

    from make_jax_reference_em import _em_args, horizon, pipeline, \
        stage_inputs
    from vanishing_points_2017_tpu.em import expectation_maximisation

    pipe = pipeline()
    em_cfg = dataclasses.replace(pipe.cfg.em, loop="phase")
    lps, masks = bench["bench_global_segments"], bench["bench_global_mask"]
    rows = []
    for lp, m, x in zip(lps, masks, stage_inputs(pipe, list(lps),
                                                 list(masks))):
        row = {"l": x["l"], "grid": x["grid"], "sphere": em_view(x["sphere"])}
        end = {}
        for sphere in (x["sphere"], row["sphere"]):
            em = expectation_maximisation(*_em_args(
                row | {"lp": lp, "lmask": m, "sphere": sphere}), em_cfg)
            got = {k: np.asarray(getattr(em, k))
                   for k in ("iterations", "alive", "vp", "counts")}
            for k, v in end.items():
                if not np.array_equal(v, got[k]):
                    raise AssertionError(f"em_view moves the EM's {k}")
            end = got
        hz = horizon(pipe, end)
        rows.append(row | {k: end[k] for k in EM_KEYS}
                    | {"hp1": hz["hp1"], "hp2": hz["hp2"]})
    return {f"phase_{k}": np.stack([r[k] for r in rows]) for k in rows[0]}


def reference_outputs() -> dict:
    """Every array of the oracle, as numpy."""
    _setup()
    import numpy as np

    from make_jax_reference_bench import bench_images

    bench = detector_reference(
        "bench", bench_images()[0][list(BENCH_SCENES)])
    small = small_images()
    return (bench | detector_reference("small", small)
            | phase_reference(bench)
            | {"bench_scenes": np.asarray(BENCH_SCENES),
               "small_images_sha256": np.asarray(sha256(small))})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import numpy as np

    ref = reference_outputs()
    np.savez_compressed(args.out, **ref)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes): "
          + ", ".join(f"{k}{tuple(v.shape)}" for k, v in ref.items()))


if __name__ == "__main__":
    main()
