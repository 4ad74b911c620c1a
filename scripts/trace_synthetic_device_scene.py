"""Trace the synthetic device-path scenes whose horizon parts from JAX's.

Runs, on the CPU:

1. the port's device-detector path (``Pipeline.process_images``, the
   default configuration: bf16 CNN) on the 50-scene synthetic protocol
   (seed 7, 640x640, batches of 8 as the JAX reference ran them), and
   lists the scenes whose horizon lies beyond 0.02 of the committed JAX
   one (``assets/examples/jax_reference_host.npz``, ``syn_dev_*``);
2. for each such scene, and each ``--scene`` given: both packages with a
   float32 CNN on that image alone, stage by stage: the detector's
   segments, the sphere image, the CNN grid, the horizon; then the port's
   EM on JAX's own stage outputs (segments, sphere image, grid) and the
   horizons of both packages in bf16 and float32, which tells a fault (the
   port computes something else from the same inputs) from a knife edge
   (the same inputs give the same triplet, and only rounding in front of
   the EM moves it).

With ``--save PATH`` it also writes, for the first traced scene, JAX's
stage outputs in the default configuration (bf16 CNN): the detector's
segments and mask, the sphere image, the CNN grid and hp1/hp2
(``assets/examples/jax_reference_scene12.npz`` is scene 12's, which
``tests/test_torch_knife_edge.py`` reads).

Prints one line per scene and stage, and a JSON summary as the last line.
Takes a few minutes on an 8-core CPU (the JAX device pipeline compiles
once per configuration).

    python scripts/trace_synthetic_device_scene.py [--scene I ...]
        [--skip_search] [--save PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "assets", "examples", "jax_reference_host.npz")
TOL, COUNT, BATCH, SIZE = 0.02, 50, 8, 640


def horizon_err(a1, a2, b1, b2) -> float:
    """Normalized horizon error (640x640) between two (hp1, hp2) pairs."""
    import numpy as np

    from vanishing_points_2017_tpu_torch.data.io import \
        normalized_horizon_error

    def line(h1, h2):
        return np.cross(np.asarray(h1, np.float64), np.asarray(h2, np.float64))
    return normalized_horizon_error(line(a1, a2), line(b1, b2), SIZE, SIZE)


def far_scenes(grays, ref) -> list:
    """Step 1: the port's device path in bf16, scenes beyond TOL of JAX."""
    import numpy as np

    from vanishing_points_2017_tpu_torch.pipeline import Pipeline
    from vanishing_points_2017_tpu_torch.weights import load_params_and_mean

    params, mean = load_params_and_mean(device="cpu")
    pipe = Pipeline(params, mean, device="cpu")
    far = []
    for i in range(0, COUNT, BATCH):
        chunk = grays[i:i + BATCH]
        out = pipe.process_images(chunk + [chunk[-1]] * (BATCH - len(chunk)))
        for j in range(len(chunk)):
            e = horizon_err(out["hp1"][j], out["hp2"][j],
                            ref["syn_dev_hp1"][i + j],
                            ref["syn_dev_hp2"][i + j])
            if e > TOL:
                far.append(i + j)
                print(f"scene {i + j}: port bf16 horizon {e:.4f} from JAX's")
    return far


def trace(i: int, gray, save: str | None = None) -> dict:
    """Step 2 on scene ``i``; with ``save``, JAX's bf16 stage outputs go
    there."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from vanishing_points_2017_tpu import pipeline as jpipe
    from vanishing_points_2017_tpu.ops.lines_device import \
        detect_segments_device as jdet
    from vanishing_points_2017_tpu.weights import load_params_and_mean as jld
    from vanishing_points_2017_tpu_torch import pipeline as tpipe
    from vanishing_points_2017_tpu_torch.em.consensus import em_and_horizon
    from vanishing_points_2017_tpu_torch.ops.lines import \
        segments_to_homogeneous
    from vanishing_points_2017_tpu_torch.weights import load_params_and_mean

    jparams, jmean = jld(warn=False)
    tparams, tmean = load_params_and_mean(device="cpu")
    res = {}
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = jpipe.PipelineConfig(det_topk="exact", cnn_dtype=dtype)
        tcfg = tpipe.PipelineConfig(cnn_dtype=dtype)
        oj = jpipe.device_pipeline_full(jnp.asarray(gray[None]), jparams,
                                        jmean, cfg=jcfg)
        oj = {k: np.asarray(v)[0] for k, v in oj.items()}
        # JAX's full program keeps its segments inside: the detector again,
        # with the configuration's arguments
        lp, lm = jdet(jnp.asarray(gray), max_segments=jcfg.n_pad,
                      min_count=jcfg.det_min_count,
                      min_len_px=jcfg.det_min_len_px,
                      min_density=jcfg.det_min_density,
                      ccl_impl=jcfg.ccl_impl, selection=jcfg.det_selection,
                      max_records=jcfg.det_max_records,
                      topk_impl=jcfg.det_topk)
        oj["segments"], oj["segment_mask"] = np.asarray(lp), np.asarray(lm)
        model = tpipe.build_model(tparams, tcfg)
        ot = tpipe.device_pipeline_full(torch.from_numpy(gray[None]), model,
                                        tmean, tcfg)
        ot = {k: v[0].float().numpy() if v.dtype == torch.bfloat16
              else v[0].numpy() for k, v in ot.items()}
        outs[dtype] = (oj, ot)
        res[f"horizon_{dtype}"] = horizon_err(ot["hp1"], ot["hp2"],
                                              oj["hp1"], oj["hp2"])
    oj, ot = outs["float32"]
    mj, mt = oj["segment_mask"], ot["segment_mask"]
    res["segments"] = (int(mt.sum()), int(mj.sum()))
    res["segments_equal_slots"] = bool(np.array_equal(mt, mj))
    res["segments_max_d"] = float(np.abs(ot["segments"][mt]
                                         - oj["segments"][mj]).max()) \
        if np.array_equal(mt, mj) else None
    du8 = np.abs(ot["sphere_image"].astype(int)
                 - oj["sphere_image"].astype(int))
    res["sphere_u8_max"], res["sphere_u8_frac"] = int(du8.max()), float(
        (du8 > 0).mean())
    res["grid_max_d_f32"] = float(np.abs(ot["cnn_prediction"]
                                         - oj["cnn_prediction"]).max())
    res["grid_max_d_bf16"] = float(np.abs(
        outs["bfloat16"][1]["cnn_prediction"]
        - outs["bfloat16"][0]["cnn_prediction"]).max())
    # the segment whose sphere curve moved most: its homogeneous line's l1
    # (x2 - x1) in both packages; atan(. / l1) flips the curve to the
    # other half of the sphere image where l1 changes sign
    lt = segments_to_homogeneous(torch.from_numpy(ot["segments"]))
    lj = segments_to_homogeneous(torch.from_numpy(oj["segments"].copy()))
    k = int(torch.argmin(torch.minimum(lt[:, 1].abs(), lj[:, 1].abs())
                         + (~torch.from_numpy(mt)) * 1e9))
    res["most_vertical_segment_l1"] = (float(lt[k, 1]), float(lj[k, 1]))

    def em(seg_from, rest_from):
        """The port's EM + horizon on one package's segments and the other
        (or the same) package's sphere image and grid."""
        lp = torch.from_numpy(seg_from["segments"][None].copy())
        lm = torch.from_numpy(seg_from["segment_mask"][None].copy())
        cfg = tpipe.PipelineConfig()
        with torch.inference_mode():
            _, hz = em_and_horizon(
                torch.where(lm[..., None], segments_to_homogeneous(lp), 0.0),
                lp, torch.from_numpy(rest_from["cnn_prediction"][None]
                                     ).float(),
                torch.from_numpy(rest_from["sphere_image"][None]).float(),
                lm, cfg.em, maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
                pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
        return hz[0][0], hz[1][0]

    # the port's EM on JAX's stage outputs (a fault in the EM would show
    # here), then on each mix of the two packages' segments and
    # sphere image + grid, for each CNN type, against JAX's horizon
    for dtype, (oj2, ot2) in outs.items():
        for name, a, b in (("jax_inputs", oj2, oj2),
                           ("port_segments_jax_grid", ot2, oj2),
                           ("jax_segments_port_grid", oj2, ot2)):
            res[f"port_em_on_{name}_{dtype}"] = horizon_err(
                *em(a, b), oj2["hp1"], oj2["hp2"])
    # what the CNN's type alone does to each package's horizon
    res["jax_bf16_vs_f32"] = horizon_err(
        outs["bfloat16"][0]["hp1"], outs["bfloat16"][0]["hp2"],
        oj["hp1"], oj["hp2"])
    res["port_bf16_vs_f32"] = horizon_err(
        outs["bfloat16"][1]["hp1"], outs["bfloat16"][1]["hp2"],
        ot["hp1"], ot["hp2"])
    if save:
        oj2 = outs["bfloat16"][0]
        np.savez_compressed(save, scene=i, **{k: oj2[k] for k in (
            "segments", "segment_mask", "sphere_image", "cnn_prediction",
            "hp1", "hp2")})
    for k, v in res.items():
        print(f"scene {i}: {k} {v}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=int, action="append", default=[])
    ap.add_argument("--skip_search", action="store_true",
                    help="trace the --scene indices only")
    ap.add_argument("--save", help="npz of the first traced scene's JAX "
                    "stage outputs")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.data.datasets import \
        synthetic_records
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline

    torch.set_num_threads(8)
    ref = np.load(REFERENCE)
    records, _ = synthetic_records(count=COUNT, size=SIZE)
    grays = [Pipeline.ingest_image(r.image)["gray"] for r in records]
    far = [] if args.skip_search else far_scenes(grays, ref)
    summary = {"far_bf16_cpu": far}
    for n, i in enumerate(sorted(set(far) | set(args.scene))):
        summary[str(i)] = trace(i, grays[i], args.save if n == 0 else None)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
