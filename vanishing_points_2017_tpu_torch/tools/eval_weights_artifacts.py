"""Synthetic-AUC comparison of weights artifacts
(``scripts/eval_weights_artifacts.py`` of the JAX package).

Runs the fixed-seed 50-scene host-LSD protocol once per artifact, in one
process, and prints an AUC table. The LSD segments do not depend on the
weights, so they are detected once and the AUC differences isolate the
CNN prior. Each artifact loads through ``weights.load_params_and_mean``,
so ``.npz`` checkpoints of either package and Caffe ``.caffemodel`` files
both work; the mean image is the shipped ``assets/mean.npy``.

    python -m vanishing_points_2017_tpu_torch.tools.eval_weights_artifacts \\
        assets/weights_compact.npz OTHER.npz NET.caffemodel [--count 50] \\
        [--batch 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> int:
    from ..device import require_device
    from ..metrics import calc_auc
    from ..pipeline import PipelineConfig, build_model
    from ..weights import artifact_fingerprint, load_params_and_mean
    from .eval_device_detector import (build_scene_set, in_batches,
                                       lines_runner, lsd_bundles,
                                       scene_horizon_errors)

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("artifacts", nargs="+")
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = PipelineConfig()
    scenes, images = build_scene_set(args.count, size=args.size)
    print(f"detecting (host C++ LSD, {args.count} scenes) ...", flush=True)
    bundles = lsd_bundles(images, cfg.n_pad)

    results = []
    for path in args.artifacts:
        if not os.path.isfile(path):
            print(f"{path}: MISSING")
            continue
        params, mean = load_params_and_mean(path, device=dev)
        hp1, hp2 = in_batches(lines_runner(build_model(params, cfg), mean,
                                           cfg), bundles, args.batch)
        auc = calc_auc(scene_horizon_errors(scenes, hp1, hp2, args.size),
                       0.25)[0]
        mb = os.path.getsize(path) / 1e6
        fp = artifact_fingerprint(path)
        results.append((path, auc, mb, fp))
        print(f"{path:<40s} AUC {auc:.4f}  {mb:7.1f} MB  [{fp}]",
              flush=True)

    if results:
        best = max(r[1] for r in results)
        print("\n| artifact | AUC@0.25 | size MB | vs best |")
        print("|---|---|---|---|")
        for path, auc, mb, fp in results:
            print(f"| {os.path.basename(path)} [{fp}] | {auc:.4f} "
                  f"| {mb:.1f} | {auc - best:+.4f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
