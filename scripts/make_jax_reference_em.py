"""Regenerate assets/examples/jax_reference_em.npz, the oracle of the JAX
EM's own trajectory.

Runs the JAX package's ``em.expectation_maximisation`` (``em/em.py``)
ALONE at batch 1, never under a ``vmap`` (the reference's own vmap moves
its trajectory on knife-edge populations), on the CPU with the shipped
weights and the default config except ``det_topk="exact"`` (the
selection the PyTorch port implements), and saves what the port's EM is
held against:

* 21 segment populations (``names``): the unjittered population and
  K = 2 jitters (a fresh ``default_rng(11)`` per scene, sigma 0.5 px at
  640, 2% dropout; ``scripts/perturb_knife_edge.py``'s draws) of

  - the five pinned knife-edge scenes 12, 15, 27, 31, 38 of the seed-7
    scene set, detected by the JAX package's device detector
    (``jax/12/0`` ... ``jax/38/2``);
  - scenes 15 and 27, detected by the PORT's device detector on the CPU
    (``port/15/0`` ... ``port/27/2``), the populations that
    ``tests/test_torch_tools.py::test_run_populations_match_jax`` draws;

  per population ``lp`` / ``lmask`` (512 segments) and the EM's inputs as
  JAX's ``pipeline.device_pipeline_batch`` makes them for the scene's
  three populations (the batch that ``run_populations`` runs): the
  masked homogeneous lines ``l``, the uint8 sphere image ``sphere`` and
  the bf16 CNN's grid ``grid``;
* the EM on those inputs at ``num_iter`` = 1, 2, 3 (``it1_*`` ...
  ``it3_*``) and at the default 100 (``end_*``): ``iterations``,
  ``alive``, ``vp``, ``counts`` and ``log_sigma``; then ``hp1`` / ``hp2``
  of ``calculate_horizon_and_ortho_vp`` and ``s1`` / ``s2`` /
  ``rel_margin`` of ``triplet_score_margin`` on the end state;
* two traced frames, each with its stage outputs (``{frame}_segments``,
  ``_segment_mask``, ``_l``, ``_sphere``, ``_grid``), the EM's end state
  on them (``_iterations`` ... ``_log_sigma``) and its ``_hp1`` /
  ``_hp2``:

  - ``bench25``: scene 25 of the JAX bench's 32 scenes (root
    ``bench.py``'s draw, ``default_rng(0)``, 640x640) through
    ``pipeline.device_pipeline_full`` in its batch of
    ``make_jax_reference_bench.CHUNK`` scenes, as that script ran it;
  - ``p1026``: ``assets/examples/progressive/P1026.jpg`` through the
    host path (``Pipeline.ingest``: the LSD on the host; then
    ``process_batch`` beside P1027 at the larger line bucket), as the
    York mini of ``scripts/make_progressive_fixtures.py`` runs it; with
    ``p1026_lsd_target``, what the JAX binding's ``-march=native`` LSD
    build resolved to here and the g++ that built it (the segments
    depend on the host's build; ``scripts/compare_lsd_flags.py
    --carried`` prints it).

:func:`perturbed_em` runs the same EM with the operand of the closed-form
3x3 eigensolver (``em/weights.py``'s ``smallest_eigvec_3x3``, the gram
of every VP refit) moved by one ULP: ``tests/test_torch_em_trajectory.py``
shows with it where JAX's own trajectory is a knife edge.

``tests/test_torch_em_trajectory.py`` holds the port's batch-1 EM to this
file on the CPU and checks (slow) that it is current; ``chip_smoke.py``'s
em-trajectory phase reads it on the GPU, where JAX is not installed.
Takes about 90 s on an 8-core CPU.

    python scripts/make_jax_reference_em.py [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_em.npz")
PINNED = (12, 15, 27, 31, 38)
PORT_SCENES = (15, 27)
K, SIGMA_PX, DROP, JITTER_SEED, SIZE = 2, 0.5, 0.02, 11, 640
NUM_ITERS = (1, 2, 3)
EM_KEYS = ("iterations", "alive", "vp", "counts", "log_sigma")
BENCH_SCENE = 25
PHOTOS = tuple(os.path.join(ROOT, "assets", "examples", "progressive",
                            f"{name}.jpg") for name in ("P1026", "P1027"))
# one-ULP moves of the gram: every entry up, every entry down, the
# diagonal up
NUDGES = ("up", "down", "diag_up")


def _setup():
    for p in (ROOT, os.path.join(ROOT, "scripts")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax

    jax.config.update("jax_platforms", "cpu")


def pipeline():
    """The JAX pipeline with the shipped weights (``det_topk="exact"``)."""
    _setup()
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu.weights import load_params_and_mean

    params, mean = load_params_and_mean(warn=False)
    return Pipeline(params, mean,
                    dataclasses.replace(PipelineConfig(), det_topk="exact"))


def _jittered(lp0, m0):
    import numpy as np

    from perturb_knife_edge import jitter_population

    rng = np.random.default_rng(JITTER_SEED)
    pops = [(lp0, m0)]
    for _ in range(K):
        pops.append(jitter_population(rng, lp0, m0, SIGMA_PX * 2.0 / SIZE,
                                      DROP))
    return pops


def populations(pipe, scenes=PINNED, port_scenes=PORT_SCENES) -> list:
    """[(name, lp, lmask)]: the JAX-detected populations of ``scenes``,
    then the port-detected ones of ``port_scenes``, K + 1 per scene."""
    _setup()
    from eval_device_detector import build_scene_set
    from perturb_knife_edge import detect_device

    _, images = build_scene_set(50, size=SIZE)
    out = []
    for i in scenes:
        lp0, m0 = detect_device(pipe, pipe.cfg, images[i])
        out += [(f"jax/{i}/{k}", lp, m)
                for k, (lp, m) in enumerate(_jittered(lp0, m0))]
    if port_scenes:
        import torch

        from vanishing_points_2017_tpu_torch.tools import make_pipeline
        from vanishing_points_2017_tpu_torch.tools import \
            perturb_knife_edge as tknife

        tpipe = make_pipeline(torch.device("cpu"))
        # PyTorch's CPU kernels can round the first call of an operation
        # in a process differently on some of their threads (the port's
        # detector then moves a segment of scene 15 from run to run); a
        # first detection makes the populations the same in every run
        tknife.detect_device(tpipe, tpipe.cfg, images[port_scenes[0]])
        for i in port_scenes:
            lp0, m0 = tknife.detect_device(tpipe, tpipe.cfg, images[i])
            out += [(f"port/{i}/{k}", lp, m)
                    for k, (lp, m) in enumerate(_jittered(lp0, m0))]
    return out


def stage_inputs(pipe, lps, masks) -> list:
    """The EM inputs of a group of populations as JAX's
    ``device_pipeline_batch`` makes them for the group: per item the
    masked homogeneous lines ``l``, the uint8 ``sphere`` and the ``grid``
    (``cfg.cnn_dtype``)."""
    _setup()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vanishing_points_2017_tpu.ops import lines as lineops
    from vanishing_points_2017_tpu.pipeline import device_pipeline_batch

    lp = jnp.asarray(np.stack(lps))
    m = jnp.asarray(np.stack(masks))
    l = jnp.where(m[..., None], jax.vmap(lineops.segments_to_homogeneous)(lp),
                  0.0)
    out = device_pipeline_batch(l, lp, m, pipe.params, pipe.mean, pipe.cfg)
    return [{"l": np.asarray(l[j]),
             "sphere": np.asarray(out["sphere_image"][j]),
             "grid": np.asarray(out["cnn_prediction"][j], np.float32)}
            for j in range(len(lps))]


def _em_args(row: dict):
    import jax.numpy as jnp

    return (jnp.asarray(row["l"]), jnp.asarray(row["lp"]),
            jnp.asarray(row["grid"]),
            jnp.asarray(row["sphere"]).astype(jnp.float32),
            jnp.asarray(row["lmask"]))


def run_em(pipe, row: dict, num_iter: int = 100) -> dict:
    """The JAX EM alone at batch 1 on a row's ``l``, ``lp``, ``grid``,
    ``sphere``, ``lmask`` -> the ``EM_KEYS`` fields."""
    _setup()
    import numpy as np

    from vanishing_points_2017_tpu.em import expectation_maximisation

    cfg = dataclasses.replace(pipe.cfg.em, num_iter=num_iter)
    em = expectation_maximisation(*_em_args(row), cfg)
    return {k: np.asarray(getattr(em, k)) for k in EM_KEYS}


def perturbed_em(pipe, rows: list, num_iter: int, nudge: str) -> list:
    """The JAX EM alone at batch 1 on each row, compiled once as
    ``expectation_maximisation`` with ``smallest_eigvec_3x3``'s operand
    (``em/weights.py``) behind a switch -> ``(off, on)`` per row: ``on``
    moves every gram the EM solves by one ULP (``nudge`` in ``NUDGES``),
    ``off`` runs the same program unmoved. Each holds the ``EM_KEYS``
    fields."""
    _setup()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vanishing_points_2017_tpu.em import em as em_mod
    from vanishing_points_2017_tpu.em import weights as wmod

    if nudge not in NUDGES:
        raise ValueError(f"nudge {nudge!r}: expected one of {NUDGES}")

    def one_ulp(a):
        toward = -jnp.inf if nudge == "down" else jnp.inf
        moved = jnp.nextafter(a, jnp.asarray(toward, a.dtype))
        if nudge == "diag_up":
            return jnp.where(jnp.eye(3, dtype=bool), moved, a)
        return moved

    solver, switch = wmod.smallest_eigvec_3x3, {}
    raw = em_mod.expectation_maximisation.__wrapped__
    cfg = dataclasses.replace(pipe.cfg.em, num_iter=num_iter)

    def program(on, *args):
        switch["on"] = on
        return raw(*args, cfg)

    # a new function, which jit traces anew, through the switched solver
    fn = jax.jit(program)
    wmod.smallest_eigvec_3x3 = lambda a: solver(
        jnp.where(switch["on"], one_ulp(a), a))
    try:
        return [tuple({k: np.asarray(getattr(em, k)) for k in EM_KEYS}
                      for em in (fn(jnp.asarray(on), *_em_args(row))
                                 for on in (False, True)))
                for row in rows]
    finally:
        wmod.smallest_eigvec_3x3 = solver


def horizon(pipe, em: dict) -> dict:
    """``hp1`` / ``hp2`` and the top two triplet scores of an EM state."""
    _setup()
    import jax.numpy as jnp
    import numpy as np

    from vanishing_points_2017_tpu.em.horizon import (
        calculate_horizon_and_ortho_vp, triplet_score_margin)

    cfg = pipe.cfg
    args = (jnp.asarray(em["vp"]), jnp.asarray(em["counts"]),
            jnp.asarray(em["alive"]))
    kw = dict(maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
              pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    hp1, hp2, *_ = calculate_horizon_and_ortho_vp(*args, **kw)
    s1, s2, rel, _ = triplet_score_margin(*args, **kw)
    return {k: np.asarray(v) for k, v in dict(
        hp1=hp1, hp2=hp2, s1=s1, s2=s2, rel_margin=rel).items()}


def em_runs(pipe, row: dict) -> dict:
    """A row's EM at every checkpoint and its end state's horizon."""
    out = {}
    for n in NUM_ITERS:
        out |= {f"it{n}_{k}": v
                for k, v in run_em(pipe, row, num_iter=n).items()}
    end = run_em(pipe, row)
    return out | {f"end_{k}": v for k, v in end.items()} | horizon(pipe, end)


def population_reference(pipe, pops: list) -> dict:
    """The per-population arrays of the oracle, stacked in ``pops``'
    order; each scene's K + 1 populations share one stage batch."""
    import numpy as np

    rows = []
    for g in range(0, len(pops), K + 1):
        group = pops[g:g + K + 1]
        ins = stage_inputs(pipe, [p[1] for p in group], [p[2] for p in group])
        for (name, lp, lmask), x in zip(group, ins):
            row = {"names": name, "lp": lp, "lmask": lmask} | x
            rows.append(row | em_runs(pipe, row))
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}


def _frame(pipe, prefix: str, row: dict) -> dict:
    import numpy as np

    end = run_em(pipe, row)
    keep = {"segments": row["lp"], "segment_mask": row["lmask"],
            "l": row["l"], "sphere": row["sphere"], "grid": row["grid"]}
    keep |= end | {k: v for k, v in horizon(pipe, end).items()
                   if k in ("hp1", "hp2")}
    return {f"{prefix}_{k}": np.asarray(v) for k, v in keep.items()}


def bench_frame(pipe) -> dict:
    """Bench scene 25 through ``device_pipeline_full`` in its chunk of
    ``make_jax_reference_bench.CHUNK`` scenes (the segments from the
    program's own detector under the same vmap); then the EM alone."""
    _setup()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from make_jax_reference_bench import CHUNK, bench_images
    from vanishing_points_2017_tpu.ops import lines as lineops
    from vanishing_points_2017_tpu.ops.lines_device import \
        detect_segments_device
    from vanishing_points_2017_tpu.pipeline import device_pipeline_full

    cfg = pipe.cfg
    lo = BENCH_SCENE - BENCH_SCENE % CHUNK
    imgs = jnp.asarray(bench_images()[0][lo:lo + CHUNK])
    out = device_pipeline_full(imgs, pipe.params, pipe.mean, cfg)
    segs, masks = jax.jit(jax.vmap(lambda img: detect_segments_device(
        img, max_segments=cfg.n_pad, min_count=cfg.det_min_count,
        min_len_px=cfg.det_min_len_px, min_density=cfg.det_min_density,
        ccl_impl=cfg.ccl_impl, selection=cfg.det_selection,
        max_records=cfg.det_max_records, topk_impl=cfg.det_topk)))(imgs)
    j = BENCH_SCENE - lo
    lp, lmask = segs[j], masks[j]
    l = jnp.where(lmask[:, None], lineops.segments_to_homogeneous(lp), 0.0)
    return _frame(pipe, "bench25", {
        "lp": np.asarray(lp), "lmask": np.asarray(lmask), "l": np.asarray(l),
        "sphere": np.asarray(out["sphere_image"][j]),
        "grid": np.asarray(out["cnn_prediction"][j], np.float32)})


def lsd_target() -> str:
    """What the JAX binding's ``-march=native`` LSD build resolves to on
    this host, with the g++ that built it, e.g. ``sapphirerapids (g++
    ... 12.2.0)``."""
    import subprocess

    run = lambda *a: subprocess.run(["g++", *a], capture_output=True,
                                    text=True, check=True).stdout
    march = next(ln.split()[1] for ln in run(
        "-march=native", "-Q", "--help=target").splitlines()
        if ln.split()[:1] == ["-march="])
    return f"{march} ({run('--version').splitlines()[0]})"


def photo_frame(pipe) -> dict:
    """P1026 through the host path in the York mini's batch of two; then
    the EM alone on its stage outputs, and the host LSD's build target."""
    import numpy as np

    bundles = [pipe.ingest(p) for p in PHOTOS]
    out = pipe.process_batch(bundles)
    pad = max(b["lp"].shape[0] for b in bundles) - bundles[0]["lp"].shape[0]
    b = bundles[0]
    return _frame(pipe, "p1026", {
        "lp": np.pad(b["lp"], ((0, pad), (0, 0))),
        "lmask": np.pad(b["lmask"], (0, pad)),
        "l": np.pad(b["l"], ((0, pad), (0, 0))),
        "sphere": np.asarray(out["sphere_image"][0]),
        "grid": np.asarray(out["cnn_prediction"][0], np.float32)}) | {
        "p1026_lsd_target": np.asarray(lsd_target())}


def reference() -> dict:
    pipe = pipeline()
    return (population_reference(pipe, populations(pipe))
            | bench_frame(pipe) | photo_frame(pipe))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    ref = reference()
    np.savez_compressed(args.out, **ref)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{time.time() - t0:.0f} s: end iterations "
          f"{ref['end_iterations'].tolist()}; bench25 "
          f"{int(ref['bench25_iterations'])}, p1026 "
          f"{int(ref['p1026_iterations'])}")


if __name__ == "__main__":
    main()
