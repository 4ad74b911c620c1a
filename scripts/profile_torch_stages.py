"""Per-stage times of the PyTorch port's zero-host-round-trip pipeline.

Runs the bundled scenes tiled to a batch (default 32 x 640x640) on a CUDA
card through detector -> sphere render -> CNN -> EM -> horizon with
``bench.stage_split``: each stage timed with a host clock around work
that ends in a synchronize (median of a few runs after a warm-up), the
EM's device-to-host syncs counted, and the device busy time, idle share
and top kernels by device time from one ``torch.profiler`` pass (whose
wall time includes the profiler's own overhead). The throughput bench
(``python -m vanishing_points_2017_tpu_torch.bench``) reports the same
split on its synthetic scenes.
Writes the JSON record to ``chiprun_out/profile_torch_stages.json``.

    python scripts/profile_torch_stages.py [--batch 32] [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_stages: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from vanishing_points_2017_tpu_torch import bench
    from vanishing_points_2017_tpu_torch import pipeline as P
    from vanishing_points_2017_tpu_torch.weights import load_params_and_mean

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = P.PipelineConfig()
    params, mean = load_params_and_mean(device=dev)
    model = P.build_model(params, cfg)
    grays = [P.Pipeline.ingest_image(os.path.join(
        ROOT, "assets", "examples", f"scene_{i % 4}.png"))["gray"]
        for i in range(args.batch)]
    host = torch.from_numpy(np.stack(grays)).pin_memory()

    split = bench.stage_split(host, model, mean, cfg, args.iters)
    rec = {"card": card, "batch": args.batch, "image": [640, 640],
           "img_per_s": args.batch / (split["stage_total_ms"] / 1e3),
           **split}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "profile_torch_stages.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
