"""AUC parity harness: the host-LSD path against the zero-host-round-trip
path (``scripts/eval_device_detector.py`` of the JAX package).

Runs the fixed 50-scene synthetic set (seed 7, the protocol of
``benchmark --synthetic``) through each path and prints its horizon-error
AUC@0.25:

* ``host``: the C++ LSD on the host, the segments padded to
  ``PipelineConfig.n_pad``, then ``pipeline.device_pipeline_batch``;
* ``full``: ``pipeline.device_pipeline_full`` (device detector with K1,
  then the same chain);
* ``ideal``: the device detector's segments with an IDEAL prior, the
  scene's own VP grid label (``models.synth.vp_grid_label``) in place of
  the CNN's grid: homogeneous lines, the K2 sphere image, the EM and the
  horizon search, batched, the EM and the search in the pipeline's fixed
  chunks (``em.consensus.em_and_horizon``).

So the host-vs-full gap splits into what the detector's segments cost and
what the CNN's prior costs. Batches of ``--batch`` images, the last padded
with copies of its last image.

    python -m vanishing_points_2017_tpu_torch.tools.eval_device_detector \\
        [--device cpu] [--count 50] [--batch 10] [--paths host,full,ideal] \\
        [--det_selection global|row] [--det_topk exact|approx] \\
        [--horizon_tol T] [--cnn_dtype float32|bfloat16]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from . import make_pipeline

PATHS = ("host", "full", "ideal")


def build_scene_set(count: int, size: int = 640, seed: int = 7):
    """The 50-scene synthetic AUC protocol's scene set, the JAX script's
    draws in the same order, so the same seed gives the same scenes and
    images -> (scenes, rendered uint8 images)."""
    from ..data.datasets import render_scene_image
    from ..models import synth

    rng = np.random.default_rng(seed)
    scenes, images = [], []
    for _ in range(count):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 60)),
                                 outliers=int(rng.integers(5, 25)))
        scenes.append(scene)
        images.append(render_scene_image(scene, size=size, rng=rng))
    return scenes, images


def scene_horizon_errors(scenes, hp1s, hp2s, size: int) -> np.ndarray:
    """Each scene's normalized horizon error, hp1 x hp2 crossed in float64
    as the JAX script crosses them."""
    from ..data.io import normalized_horizon_error

    errs = []
    for scene, hp1, hp2 in zip(scenes, hp1s, hp2s):
        est = np.cross(np.asarray(hp1, np.float64),
                       np.asarray(hp2, np.float64))
        errs.append(normalized_horizon_error(
            est, scene.horizon.astype(np.float64), width=size, height=size))
    return np.array(errs)


def in_batches(run, items: list, batch: int):
    """``run`` (a list of ``batch`` items -> outputs with ``hp1``/``hp2``)
    on consecutive batches, the last padded with copies of its last item
    -> (hp1 (n, 3), hp2 (n, 3)) of the real items, numpy."""
    hp1, hp2 = [], []
    for i in range(0, len(items), batch):
        chunk = items[i:i + batch]
        n = len(chunk)
        out = run(chunk + [chunk[-1]] * (batch - n))
        hp1.append(out["hp1"][:n].cpu().numpy())
        hp2.append(out["hp2"][:n].cpu().numpy())
    return np.concatenate(hp1), np.concatenate(hp2)


def lsd_bundles(images: list, n_pad: int) -> list:
    """Host LSD on each uint8 image -> padded (l, lp, lmask) numpy
    triples."""
    from ..data import io as dio
    from ..pipeline import pad_lines

    return [pad_lines(dio.detect_lsd_lines(img.astype(np.float64))
                      ["segments"], n_pad) for img in images]


def lines_runner(model, mean: torch.Tensor, cfg):
    """A batch of padded (l, lp, lmask) triples -> the outputs of
    ``device_pipeline_batch`` with ``model`` and ``mean``."""
    from ..pipeline import device_pipeline_batch

    def run(chunk):
        l, lp, m = (torch.from_numpy(np.stack([c[j] for c in chunk]))
                    .to(mean.device) for j in range(3))
        return device_pipeline_batch(l, lp, m, model, mean, cfg)
    return run


@torch.inference_mode()
def ideal_batch(images: torch.Tensor, labels: torch.Tensor, cfg) -> dict:
    """The ideal-prior path on a batch: grayscale images (B, H, W) and
    VP grid labels (B, 20, 20) -> ``hp1``, ``hp2`` (B, 3). The detector
    and the horizon gate are the full path's, so the decomposition
    isolates the prior."""
    from ..em.consensus import em_and_horizon
    from ..ops.lines import segments_to_homogeneous
    from ..ops.lines_device import detect_segments_device
    from ..ops.sphere import sphere_image_uint8

    lp, lmask = detect_segments_device(images, **cfg.det_kwargs())
    l = torch.where(lmask[..., None], segments_to_homogeneous(lp), 0.0)
    img_u8 = sphere_image_uint8(l, lmask, size=cfg.sphere_size)
    _, hz = em_and_horizon(l, lp, labels, img_u8.to(torch.float32), lmask,
                           cfg.em, maxbest=cfg.maxbest,
                           theta_vmin=cfg.theta_vmin,
                           pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    return {"hp1": hz[0], "hp2": hz[1]}


def run_path(path: str, pipe, scenes, images, batch: int, size: int) -> dict:
    """One path on the scene set -> ``hp1``, ``hp2`` (n, 3), ``errors``,
    ``auc`` and host-clock ``seconds`` by step."""
    from ..metrics import calc_auc
    from ..models import synth

    cfg, dev = pipe.cfg, pipe.device
    seconds = {}
    t0 = time.perf_counter()
    if path == "host":
        bundles = lsd_bundles(images, cfg.n_pad)
        seconds["lsd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hp1, hp2 = in_batches(lines_runner(pipe.model, pipe.mean, cfg),
                              bundles, batch)
    elif path == "full":
        hp1, hp2 = in_batches(pipe.process_images, images, batch)
    elif path == "ideal":
        items = [(img, synth.vp_grid_label(s.vps))
                 for s, img in zip(scenes, images)]

        def run(chunk):
            imgs, labels = (torch.from_numpy(np.stack([c[j] for c in chunk]))
                            .to(dev) for j in (0, 1))
            return ideal_batch(imgs, labels, cfg)
        hp1, hp2 = in_batches(run, items, batch)
    else:
        raise ValueError(f"path {path!r}: expected one of {PATHS}")
    seconds["device"] = time.perf_counter() - t0
    errors = scene_horizon_errors(scenes, hp1, hp2, size)
    return {"hp1": hp1, "hp2": hp2, "errors": errors,
            "auc": calc_auc(errors, 0.25)[0], "seconds": seconds}


def path_line(path: str, res: dict, count: int) -> str:
    """The JAX script's line for one path's result."""
    s = res["seconds"]
    if path == "host":
        return (f"host-LSD path:   AUC {res['auc']:.4f}  (lsd {s['lsd']:.1f}s "
                f"+ device {s['device']:.1f}s for {count} imgs)")
    if path == "full":
        return (f"device-full path: AUC {res['auc']:.4f}  (device "
                f"{s['device']:.1f}s incl. the first call for {count} imgs)")
    return f"device segs + ideal prior: AUC {res['auc']:.4f}"


def add_detector_flags(ap: argparse.ArgumentParser) -> None:
    """The JAX scripts' detector flags: overrides of
    ``PipelineConfig.det_selection`` and ``det_topk``."""
    ap.add_argument("--det_selection", default=None,
                    choices=("global", "row"),
                    help="override PipelineConfig.det_selection")
    ap.add_argument("--det_topk", default=None, choices=("exact", "approx"),
                    help="override PipelineConfig.det_topk (approx is the "
                         "one-stage exact top-k off the TPU)")


def detector_overrides(args: argparse.Namespace) -> dict:
    """The ``PipelineConfig`` fields that :func:`add_detector_flags`'
    flags set."""
    return {f"det_{k}": v for k in ("selection", "topk")
            if (v := getattr(args, f"det_{k}")) is not None}


def main(argv: list[str] | None = None) -> int:
    from ..device import require_device
    from ..pipeline import PipelineConfig

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--paths", default="host,full",
                    help="comma list: host, full, ideal")
    add_detector_flags(ap)
    ap.add_argument("--horizon_tol", type=float, default=None,
                    help="override PipelineConfig.horizon_pos_gate_tol "
                         "(inf = exact reference gating)")
    ap.add_argument("--cnn_dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="override PipelineConfig.cnn_dtype")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"--paths {args.paths}: expected a comma list of "
                 f"{', '.join(PATHS)}")

    dev = require_device(args.device)
    cfg = PipelineConfig(**detector_overrides(args))
    if args.horizon_tol is not None:
        cfg = dataclasses.replace(cfg, horizon_pos_gate_tol=args.horizon_tol)
    if args.cnn_dtype:
        cfg = dataclasses.replace(cfg, cnn_dtype=args.cnn_dtype)
    pipe = make_pipeline(dev, cfg)
    scenes, images = build_scene_set(args.count, size=args.size)

    results = {}
    for path in PATHS:
        if path in paths:
            results[path] = run_path(path, pipe, scenes, images, args.batch,
                                     args.size)
            print(path_line(path, results[path], args.count), flush=True)
    if "host" in results and "full" in results:
        gap = results["host"]["auc"] - results["full"]["auc"]
        print(f"gap (host - full): {gap:+.4f}  "
              f"({'OK: within 0.02' if gap <= 0.02 else 'NOT within 0.02'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
