"""Per-stage times of the PyTorch port's zero-host-round-trip pipeline.

Runs the bundled scenes tiled to a batch (default 32 x 640x640) on a CUDA
card through detector -> sphere render -> CNN -> EM -> horizon, times each
stage with a host clock around work that ends in a synchronize (median of
a few runs after a warm-up), counts the EM's device-to-host syncs, and
prints the device busy time, idle share and top kernels by device time
from one ``torch.profiler`` pass (whose wall time includes the
profiler's own overhead).
Writes the JSON record to ``chiprun_out/profile_torch_stages.json``.

    python scripts/profile_torch_stages.py [--batch 32] [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

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
    from vanishing_points_2017_tpu_torch import pipeline as P
    from vanishing_points_2017_tpu_torch.em import em as em_mod
    from vanishing_points_2017_tpu_torch.em.horizon import \
        calculate_horizon_and_ortho_vp
    from vanishing_points_2017_tpu_torch.models import cnn as cnn_mod
    from vanishing_points_2017_tpu_torch.ops import lines as lineops
    from vanishing_points_2017_tpu_torch.ops import sphere
    from vanishing_points_2017_tpu_torch.ops.lines_device import \
        detect_segments_device
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

    syncs = {"n": 0}
    orig_bool = torch.Tensor.__bool__

    def counting_bool(t):
        if t.is_cuda:
            syncs["n"] += 1
        return orig_bool(t)

    def stages():
        out, t = {}, {}

        def mark(name, t0):
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
            return time.perf_counter()

        with torch.inference_mode():
            t0 = time.perf_counter()
            imgs = host.to(dev, non_blocking=True)
            t0 = mark("h2d", t0)
            lp, lmask = detect_segments_device(
                imgs, max_segments=cfg.n_pad, max_records=cfg.det_max_records)
            t0 = mark("detector", t0)
            l = torch.where(lmask[..., None],
                            lineops.segments_to_homogeneous(lp), 0.0)
            img_u8 = sphere.sphere_image_uint8(l, lmask, cfg.sphere_size)
            t0 = mark("render", t0)
            pred = model(cnn_mod.preprocess(img_u8, mean))
            t0 = mark("cnn", t0)
            syncs["n"] = 0
            torch.Tensor.__bool__ = counting_bool
            try:
                em = em_mod.expectation_maximisation(
                    l, lp, pred, img_u8.float(), lmask, cfg.em)
            finally:
                torch.Tensor.__bool__ = orig_bool
            t0 = mark("em", t0)
            calculate_horizon_and_ortho_vp(
                em.vp, em.counts, em.alive, maxbest=cfg.maxbest,
                theta_vmin=cfg.theta_vmin,
                pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
            mark("horizon", t0)
            out["em_iterations_max"] = int(em.iterations.max())
        return t, out

    stages()  # warm-up
    runs = [stages() for _ in range(args.iters)]
    names = list(runs[0][0])
    med = {k: statistics.median(r[0][k] for r in runs) * 1e3 for k in names}
    total = sum(med.values())

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only (one stream: their durations do not overlap)
    from torch.autograd import DeviceType
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = [{"name": k[:80], "device_ms": ms, "calls": n}
           for k, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]]
    rec = {"card": card, "batch": args.batch, "image": [640, 640],
           "stage_ms_median": med, "total_ms": total,
           "img_per_s": args.batch / (total / 1e3),
           "em_host_syncs": syncs["n"], **runs[-1][1],
           "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "top_kernels_by_device_time": top}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "profile_torch_stages.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
