"""Regenerate assets/examples/jax_reference_tools.npz.

Runs the JAX package's accuracy harnesses on the CPU with the shipped
weights and the default config except ``det_topk="exact"`` (the selection
the PyTorch port implements), the recipe of ``make_jax_reference_host.py``,
and saves what the port's ``vanishing_points_2017_tpu_torch.tools`` are
held against:

* the AUC decomposition of ``scripts/eval_device_detector.py`` on its
  50-scene set (``build_scene_set``: seed 7, 640x640) in batches of 10,
  the last one padded with copies: per scene ``{host,full,ideal}_hp1`` /
  ``_hp2`` (host LSD -> ``device_pipeline_batch``; ``device_pipeline_full``;
  the device detector's segments with the ideal prior
  ``vp_grid_label(scene.vps)``, the script's ``ideal_one``) and each
  path's AUC@0.25 ``auc_{host,full,ideal}``;
* the knife-edge margins of ``scripts/perturb_knife_edge.py``: every
  scene's device-detected population through one ``run_populations``
  call, ``base_rel_margin`` (50,), and ``picks``, the 5 lowest-margin
  scenes in index order;
* ``tests/test_knife_edge.py``'s flip protocol on the five pinned scenes
  ``pinned`` = 12, 15, 27, 31, 38 (a fresh ``default_rng(11)`` per probe,
  K = 8 jitters of sigma 0.5 px, 2% dropout), with the single EM
  (``single``) and with ``horizon_consensus=8`` in dropout mode
  (``consensus``): ``ke_{mode}_errs`` and ``ke_{mode}_rel_margin`` (5, 9),
  the unjittered population first, and ``ke_{mode}_flips`` (5,), the
  jitters whose horizon error exceeds 0.10.

``chip_smoke.py`` reads this file on the GPU, where JAX is not
installed; ``tests/test_torch_tools.py`` checks it is current. The whole
run took about 5 minutes on an 8-core CPU.

    python scripts/make_jax_reference_tools.py [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_tools.npz")
COUNT, BATCH, SIZE = 50, 10, 640
PINNED = (12, 15, 27, 31, 38)
K, SIGMA_PX, DROP, JITTER_SEED, FLIP_GATE = 8, 0.5, 0.02, 11, 0.10
MODES = ("single", "consensus")


def _setup():
    for p in (ROOT, os.path.join(ROOT, "scripts")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax

    jax.config.update("jax_platforms", "cpu")


def pipelines():
    """(single-EM pipeline, consensus K = 8 pipeline), shipped weights."""
    _setup()
    import numpy as np

    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu.weights import load_params_and_mean

    params, mean = load_params_and_mean(warn=False)
    cfg = dataclasses.replace(PipelineConfig(), det_topk="exact")
    pipe = Pipeline(params, mean, cfg)
    cons = Pipeline(params, np.asarray(mean),
                    dataclasses.replace(cfg, horizon_consensus=8))
    return pipe, cons


def _batched(items, run):
    """``run`` on batches of BATCH items, the last padded with copies of
    its last item -> stacked (hp1, hp2) of the real items."""
    import numpy as np

    hp1, hp2 = [], []
    for i in range(0, len(items), BATCH):
        chunk = items[i:i + BATCH]
        n = len(chunk)
        out = run(chunk + [chunk[-1]] * (BATCH - n))
        hp1 += list(np.asarray(out[0])[:n])
        hp2 += list(np.asarray(out[1])[:n])
    return np.stack(hp1), np.stack(hp2)


def decomposition(pipe, count: int = COUNT) -> dict:
    """The host, full and ideal paths on the first ``count`` scenes."""
    _setup()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from eval_device_detector import build_scene_set
    from vanishing_points_2017_tpu.data import io as dio
    from vanishing_points_2017_tpu.em import expectation_maximisation
    from vanishing_points_2017_tpu.em.horizon import \
        calculate_horizon_and_ortho_vp
    from vanishing_points_2017_tpu.models import synth
    from vanishing_points_2017_tpu.ops import lines as lineops
    from vanishing_points_2017_tpu.ops import sphere as sphere_mod
    from vanishing_points_2017_tpu.ops.lines_device import \
        detect_segments_device
    from vanishing_points_2017_tpu.pipeline import (device_pipeline_batch,
                                                    device_pipeline_full,
                                                    pad_lines)

    cfg = pipe.cfg
    scenes, images = build_scene_set(COUNT, size=SIZE)
    scenes, images = scenes[:count], images[:count]

    def host(chunk):
        out = device_pipeline_batch(
            *(jnp.asarray(np.stack([c[j] for c in chunk])) for j in range(3)),
            pipe.params, pipe.mean, cfg)
        return out["hp1"], out["hp2"]

    def full(chunk):
        out = device_pipeline_full(jnp.asarray(np.stack(chunk).astype(
            np.float32)), pipe.params, pipe.mean, cfg)
        return out["hp1"], out["hp2"]

    # scripts/eval_device_detector.py's ideal_one, with this config
    def ideal_one(img, label):
        lp, lmask = detect_segments_device(
            img, max_segments=cfg.n_pad, min_count=cfg.det_min_count,
            min_len_px=cfg.det_min_len_px, min_density=cfg.det_min_density,
            ccl_impl=cfg.ccl_impl, selection=cfg.det_selection,
            max_records=cfg.det_max_records, topk_impl=cfg.det_topk)
        l = lineops.segments_to_homogeneous(lp)
        l = jnp.where(lmask[:, None], l, 0.0)
        img_u8 = sphere_mod.sphere_image_uint8(l, lmask, size=cfg.sphere_size)
        em = expectation_maximisation(l, lp, label,
                                      img_u8.astype(jnp.float32), lmask,
                                      cfg.em)
        return calculate_horizon_and_ortho_vp(
            em.vp, em.counts, em.alive, maxbest=cfg.maxbest,
            theta_vmin=cfg.theta_vmin,
            pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)

    ideal_batch = jax.jit(jax.vmap(ideal_one))

    def ideal(chunk):
        out = ideal_batch(
            jnp.asarray(np.stack([c[0] for c in chunk]).astype(np.float32)),
            jnp.asarray(np.stack([c[1] for c in chunk])))
        return out[0], out[1]

    res = {}
    bundles = [pad_lines(dio.detect_lsd_lines(img.astype(np.float64))
                         ["segments"], cfg.n_pad) for img in images]
    res["host_hp1"], res["host_hp2"] = _batched(bundles, host)
    res["full_hp1"], res["full_hp2"] = _batched(images, full)
    res["ideal_hp1"], res["ideal_hp2"] = _batched(
        [(img, synth.vp_grid_label(s.vps)) for s, img in zip(scenes, images)],
        ideal)
    return res


def aucs(res: dict) -> dict:
    _setup()
    import numpy as np

    from eval_device_detector import build_scene_set, scene_horizon_errors
    from vanishing_points_2017_tpu.metrics import calc_auc

    scenes, _ = build_scene_set(COUNT, size=SIZE)
    return {f"auc_{p}": np.asarray(calc_auc(scene_horizon_errors(
        scenes, res[f"{p}_hp1"], res[f"{p}_hp2"], SIZE), 0.25)[0])
        for p in ("host", "full", "ideal")}


def populations(pipe, indices) -> dict:
    """Device-detected populations of the given scenes, by index."""
    _setup()
    from eval_device_detector import build_scene_set
    from perturb_knife_edge import detect_device

    _, images = build_scene_set(COUNT, size=SIZE)
    return {i: detect_device(pipe, pipe.cfg, images[i]) for i in indices}


def base_margins(pipe, pops: dict) -> dict:
    """perturb_knife_edge.py's base run over the whole pool."""
    _setup()
    import numpy as np

    from perturb_knife_edge import run_populations

    base = run_populations(pipe, pipe.cfg, [pops[i][0] for i in range(COUNT)],
                           [pops[i][1] for i in range(COUNT)])
    margins = base["rel_margin"]
    return {"base_rel_margin": margins,
            "picks": np.sort(np.argsort(margins)[:5])}


def flip_probes(pipe, pops: dict, indices=PINNED) -> dict:
    """tests/test_knife_edge.py's protocol on ``indices`` ->
    (errs (n, K+1), rel_margin (n, K+1), flips (n,))."""
    _setup()
    import numpy as np

    from eval_device_detector import build_scene_set, scene_horizon_errors
    from perturb_knife_edge import jitter_population, run_populations

    scenes, _ = build_scene_set(COUNT, size=SIZE)
    errs, margins = [], []
    for i in indices:
        lp0, m0 = pops[i]
        rng = np.random.default_rng(JITTER_SEED)
        lps, masks = [lp0], [m0]
        for _ in range(K):
            lp2, m2 = jitter_population(rng, lp0, m0, SIGMA_PX * 2.0 / SIZE,
                                        DROP)
            lps.append(lp2)
            masks.append(m2)
        res = run_populations(pipe, pipe.cfg, lps, masks)
        errs.append(scene_horizon_errors([scenes[i]] * (K + 1), res["hp1"],
                                         res["hp2"], SIZE))
        margins.append(res["rel_margin"])
    errs = np.stack(errs)
    return errs, np.stack(margins), (errs[:, 1:] > FLIP_GATE).sum(1)


def reference() -> dict:
    import numpy as np

    pipe, cons = pipelines()
    res = decomposition(pipe)
    res |= aucs(res)
    pops = populations(pipe, range(COUNT))
    res |= base_margins(pipe, pops)
    res["pinned"] = np.asarray(PINNED)
    for mode, p in zip(MODES, (pipe, cons)):
        (res[f"ke_{mode}_errs"], res[f"ke_{mode}_rel_margin"],
         res[f"ke_{mode}_flips"]) = flip_probes(p, pops)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    ref = reference()
    np.savez(args.out, **ref)
    print(f"wrote {args.out} in {time.time() - t0:.0f} s: AUC host "
          f"{float(ref['auc_host']):.4f}, full {float(ref['auc_full']):.4f}, "
          f"ideal {float(ref['auc_ideal']):.4f}; picks "
          f"{ref['picks'].tolist()}; flips single "
          f"{ref['ke_single_flips'].tolist()}, consensus "
          f"{ref['ke_consensus_flips'].tolist()}")


if __name__ == "__main__":
    main()
