"""Throughput bench of the PyTorch port: the measurement of the root
``bench.py`` on one CUDA card.

    python -m vanishing_points_2017_tpu_torch.bench [--batch 32] [--iters 8]
        [--size 640] [--repeats 5] [--peak_flops F] [--device cuda]
        [--det_selection global|row]

Times the zero-host-round-trip path (``pipeline.device_pipeline_full``:
uint8 grayscale images in, on-device line detection, sphere render, CNN,
EM, horizon out) on the JAX bench's own inputs (rendered synthetic scenes
drawn from ``default_rng(0)``), with the shipped weights and the default
``PipelineConfig`` (``--det_selection row`` benches the detector's per-row
budget instead; the record keeps the selection as ``det_selection``).
Every rate is images per second: the median over ``--repeats`` repeats of
``--iters`` batches each, with the minimum, the maximum and every repeat's
rate beside it. One warm-up call comes first
(``first_call_s``); each repeat then runs the loops in turns:

* pipelined (the headline ``value``): every batch's host-to-device copy
  (asynchronous, from pinned memory) and compute dispatched back to back,
  the outputs left on the card and all read back at the end;
* serial: the same copy and compute, with ``hp1``/``hp2`` read back to
  the host before the next batch is sent;
* compute-only: the input resident on the card, all read back at the end;
* fused on lines: ``device_pipeline_batch`` on the scenes' padded lines
  (render, CNN, EM, horizon: the host-LSD path's device stage), read back
  per batch.

The EM reads its loop conditions back to the host, so the pipelined loop
can overlap only the copy, the horizon tail and the readback with the
next batch. Beside the loops: the host LSD's ms per image (image 0), the
CNN's FLOPs per image (``models.cnn.flops_per_image``) and the MFU they
give at the pipelined rate against ``--peak_flops``, and a stage split from
separate synchronized passes after the loops (:func:`stage_split`: ms per
stage, the EM's host syncs, the device's busy time, idle share and top
kernels from one ``torch.profiler`` pass) with each kernel's launches per
batch. Progress lines go to stderr; the last line of stdout is one JSON
record.

``--device`` defaults to ``cuda`` and raises without a GPU. ``--device
cpu`` runs the kernels' plain twins on the CPU and marks the record
``degraded``, with no MFU and no idle share (a CPU time is no device
time). ``BENCH_BATCH``, ``BENCH_ITERS``, ``BENCH_IMAGE_SIZE``,
``BENCH_PEAK_FLOPS`` and ``BENCH_DET_SELECTION`` set the defaults of the
flags of the same names.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the documented estimate of the 2017 reference's rate on a CPU (the
# reference cannot run here: Python 2 and Caffe; BASELINE.md)
REFERENCE_IMAGES_PER_SEC = 0.2
# the H100 SXM's published dense peaks at 700 W (NVIDIA's data sheet) for
# the CNN's compute dtype; float32 is the rate outside the tensor cores, as
# TF32 is pinned off (models/cnn.py)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
STAGES = ("h2d", "detector", "render", "cnn", "em", "horizon")
LOOPS = ("pipelined", "serial", "compute", "fused")
TOP_KERNELS = 12


def make_inputs(batch: int, size: int, n_pad: int):
    """The JAX bench's inputs, draw for draw: ``batch`` synthetic scenes
    from ``default_rng(0)``, each rendered at ``size`` x ``size`` and its
    segments padded to ``n_pad`` -> (images (B, size, size) uint8, l
    (B, n_pad, 3), lp (B, n_pad, 4), mask (B, n_pad)) numpy arrays."""
    from .data.datasets import render_scene_image
    from .models import synth
    from .pipeline import pad_lines

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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _readback(out: dict):
    """The horizon's two points copied to the host (on a GPU this waits
    for the batch, as the JAX bench's device-to-host read did)."""
    return out["hp1"].cpu(), out["hp2"].cpu()


def launch_counts() -> dict:
    """Each hand-written kernel's launches so far, by kernel name."""
    from . import kernels

    return {os.path.splitext(k.source)[0]: k.launches
            for k in kernels.all_kernels()}


def em_host_reads(fn) -> int:
    """The EM's host reads over one call of ``fn``, as the EM counts them
    itself (the counter ``em.host_reads``, ``em/reads.py``) in a trace
    session of its own: on a GPU each is a device-to-host sync."""
    from .utils import profiling

    with profiling.trace() as rec:
        fn()
    return rec.counters.get("em.host_reads", 0)


def stage_pass(host: torch.Tensor, model, mean: torch.Tensor, cfg):
    """One batch through the device-detector path with a synchronize
    after each stage (so a stage's time includes its queued work) ->
    (seconds per stage in :data:`STAGES` order, the EM's largest
    iteration count). The EM and the horizon search run in the pipeline's
    fixed chunks (``batching.in_chunks``)."""
    from .batching import in_chunks
    from .em import calculate_horizon_and_ortho_vp, expectation_maximisation
    from .models import cnn as cnn_mod
    from .ops import lines as lineops
    from .ops import sphere
    from .ops.lines_device import detect_segments_device

    dev = mean.device
    t = {}

    def mark(name, t0):
        _sync(dev)
        t[name] = time.perf_counter() - t0
        return time.perf_counter()

    with torch.inference_mode():
        t0 = time.perf_counter()
        imgs = host.to(dev, non_blocking=True)
        t0 = mark("h2d", t0)
        lp, lmask = detect_segments_device(imgs, **cfg.det_kwargs())
        t0 = mark("detector", t0)
        l = torch.where(lmask[..., None],
                        lineops.segments_to_homogeneous(lp), 0.0)
        img_u8 = sphere.sphere_image_uint8(l, lmask, cfg.sphere_size)
        t0 = mark("render", t0)
        pred = model(cnn_mod.preprocess(img_u8, mean))
        t0 = mark("cnn", t0)
        em = in_chunks(lambda *a: expectation_maximisation(*a, cfg.em),
                       [l, lp, pred, img_u8.float(), lmask])
        t0 = mark("em", t0)
        in_chunks(lambda v, c, a: calculate_horizon_and_ortho_vp(
            v, c, a, maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
            pos_gate_ideal_tol=cfg.horizon_pos_gate_tol),
            [em.vp, em.counts, em.alive])
        mark("horizon", t0)
    return t, int(em.iterations.max())


def stage_split(host: torch.Tensor, model, mean: torch.Tensor, cfg,
                repeats: int) -> dict:
    """The stage split of one batch: :func:`stage_pass` after a warm-up,
    ``repeats`` times (median ms per stage), once more for the EM's host
    reads (:func:`em_host_reads`: traced, so untimed), then on a GPU under
    ``torch.profiler`` for the device's busy time (the sum of its kernels'
    and copies' durations: one stream, so they do not overlap), its idle
    share of the profiled pass's wall time (the profiler's own overhead
    included) and the top kernels by device time. On the CPU (not
    profiled), or when the profiler records no device events, the idle
    share is None and ``device_idle_note`` says why."""
    dev = mean.device
    stage_pass(host, model, mean, cfg)
    runs = [stage_pass(host, model, mean, cfg) for _ in range(repeats)]
    reads = em_host_reads(lambda: stage_pass(host, model, mean, cfg))
    stage_ms = {k: statistics.median(r[0][k] for r in runs) * 1e3
                for k in STAGES}
    wall_ms, by_name = None, {}
    if dev.type == "cuda":
        wall_ms, by_name = _profiled_pass(host, model, mean, cfg)
    busy_ms = sum(ms for ms, _ in by_name.values())
    note = None
    if busy_ms <= 0:
        note = ("the profiler recorded no device events" if wall_ms
                else "not profiled: no device (a CPU run)")
    top = [{"name": k[:80], "device_ms": ms, "calls": n}
           for k, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:TOP_KERNELS]]
    return {"stage_ms": stage_ms, "stage_total_ms": sum(stage_ms.values()),
            "em_host_syncs": reads, "em_iterations_max": runs[-1][1],
            "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if note is None else None,
            "device_idle_share": (1.0 - busy_ms / wall_ms
                                  if note is None else None),
            "device_idle_note": note, "top_kernels": top}


def _profiled_pass(host, model, mean, cfg):
    """One :func:`stage_pass` under ``torch.profiler`` (host and GPU) ->
    (wall ms, {device event name: (total device ms, count)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stage_pass(host, model, mean, cfg)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall_ms, by_name


def _card(dev: torch.device) -> tuple[str, str | None]:
    """(device name, power limit): ``nvidia-smi``'s for a GPU."""
    if dev.type != "cuda":
        return "cpu", None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    sys.stderr.write(f"bench: {smi}\n")
    return torch.cuda.get_device_name(idx), smi.split(",")[-1].strip()


def _build_kernels() -> float:
    """Build every hand-written kernel (one nvcc each, in parallel) ->
    wall seconds."""
    from . import kernels

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for fut in [pool.submit(k.build) for k in kernels.all_kernels()]:
            fut.result()
    return time.perf_counter() - t0


def _spread(rates: list) -> dict:
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "runs": rates}


def measure(batch: int = 32, iters: int = 8, size: int = 640,
            repeats: int = 5, device: str = "cuda",
            peak_flops: float | None = None, det_selection: str = "global"):
    """Run the bench -> (record, horizons): the JSON record, and each
    loop's (hp1, hp2) of its last batch as numpy arrays, by loop name
    (:data:`LOOPS`). Raises without a GPU unless ``device`` is the CPU."""
    from . import weights as wload
    from .device import require_device
    from .models import cnn as cnn_mod
    from .pipeline import (Pipeline, PipelineConfig, device_pipeline_batch,
                           device_pipeline_full)

    dev = require_device(device)
    gpu = dev.type == "cuda"
    name, power_limit = _card(dev)
    build_s = _build_kernels() if gpu else None
    cfg = PipelineConfig(det_selection=det_selection)
    weights_fp = wload.weights_identity()
    params, mean = wload.load_params_and_mean(device=dev)
    pipe = Pipeline(params, mean, cfg, device=dev)
    model, mean = pipe.model, pipe.mean

    imgs_np, l_np, lp_np, m_np = make_inputs(batch, size, cfg.n_pad)
    host = torch.from_numpy(imgs_np)
    if gpu:
        host = host.pin_memory()
    resident = host.to(dev)
    lines = [torch.from_numpy(a).to(dev) for a in (l_np, lp_np, m_np)]
    _sync(dev)

    def full(imgs):
        return device_pipeline_full(imgs, model, mean, cfg)

    def pipelined():
        outs = [full(host.to(dev, non_blocking=True)) for _ in range(iters)]
        return [_readback(o) for o in outs][-1]

    def serial():
        for _ in range(iters):
            last = _readback(full(host.to(dev, non_blocking=True)))
        return last

    def compute():
        outs = [full(resident) for _ in range(iters)]
        return [_readback(o) for o in outs][-1]

    def fused():
        for _ in range(iters):
            last = _readback(device_pipeline_batch(*lines, model, mean, cfg))
        return last

    loops = dict(zip(LOOPS, (pipelined, serial, compute, fused)))
    before = launch_counts()
    t0 = time.perf_counter()
    _readback(full(host.to(dev, non_blocking=True)))
    first_call_s = time.perf_counter() - t0
    per_batch = {k: n - before[k] for k, n in launch_counts().items()}
    _readback(device_pipeline_batch(*lines, model, mean, cfg))

    rates = {k: [] for k in LOOPS}
    horizons = {}
    for r in range(repeats):
        for k, fn in loops.items():
            _sync(dev)
            t0 = time.perf_counter()
            hp = fn()
            rates[k].append(batch * iters / (time.perf_counter() - t0))
            horizons[k] = tuple(h.numpy() for h in hp)
        sys.stderr.write(f"bench: repeat {r}: " + ", ".join(
            f"{k} {v[-1]:.2f}" for k, v in rates.items()) + " img/s\n")
    spread = {k: _spread(v) for k, v in rates.items()}

    gray0 = imgs_np[0].astype(np.float64)
    from .data import io as dio
    n_segs = dio.detect_lsd_lines(gray0)["segments"].shape[0]  # builds
    lsd_ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        dio.detect_lsd_lines(gray0)
        lsd_ms.append((time.perf_counter() - t0) * 1e3)

    split = stage_split(host, model, mean, cfg, repeats)

    flops = cnn_mod.flops_per_image(model.params(), cfg.sphere_size)
    if peak_flops is None:
        peak_flops = PEAK_FLOPS[cfg.cnn_dtype]
    e2e = spread["pipelined"]["median"]
    mfu = flops * e2e / peak_flops if gpu else None
    sys.stderr.write(
        f"bench[{dev.type}]: device={name} power_limit={power_limit} "
        f"batch={batch} iters={iters} repeats={repeats} size={size} "
        f"weights={weights_fp} first_call={first_call_s:.2f}s "
        f"e2e={e2e:.2f} img/s (serial={spread['serial']['median']:.2f}, "
        f"compute={spread['compute']['median']:.2f}, "
        f"fused={spread['fused']['median']:.2f}) "
        f"lsd_host={statistics.median(lsd_ms):.1f}ms/img ({n_segs} segs) "
        f"mfu={mfu} idle={split['device_idle_share']}\n")
    record = {
        "metric": "end_to_end_images_per_sec",
        "value": e2e,
        "unit": "images/s",
        "vs_baseline": e2e / REFERENCE_IMAGES_PER_SEC,
        "baseline_note": ("vs_baseline divides by the DOCUMENTED ESTIMATE "
                          "0.2 img/s (reference cannot run here; "
                          "BASELINE.md)"),
        "degraded": not gpu,
        "breakdown": {
            "includes_detection": True,
            "timing_semantics": "pipelined (all H2D+compute dispatched "
                                "back-to-back, all results read back)",
            "platform": "gpu" if gpu else "cpu",
            "device": name,
            "power_limit": power_limit,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "image_size": size,
            "batch": batch,
            "det_selection": cfg.det_selection,
            "iters": iters,
            "repeats": repeats,
            "weights_fingerprint": weights_fp,
            "serial_images_per_sec": spread["serial"]["median"],
            "compute_images_per_sec": spread["compute"]["median"],
            "fused_device_images_per_sec": spread["fused"]["median"],
            "spread": spread,
            "host_lsd_ms_per_image": statistics.median(lsd_ms),
            "kernel_build_s": build_s,
            "first_call_s": first_call_s,
            "flops_per_image": flops,
            "peak_flops": peak_flops,
            "mfu_estimate": mfu,
            "launches_per_batch": per_batch,
            **split,
        },
    }
    return record, horizons


def main(argv: list[str] | None = None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=int(env("BENCH_BATCH", 32)))
    ap.add_argument("--iters", type=int, default=int(env("BENCH_ITERS", 8)),
                    help="batches per timed loop")
    ap.add_argument("--size", type=int,
                    default=int(env("BENCH_IMAGE_SIZE", 640)),
                    help="square image side in pixels")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed repeats of each loop (median reported)")
    ap.add_argument("--peak_flops", type=float,
                    default=(float(env("BENCH_PEAK_FLOPS"))
                             if env("BENCH_PEAK_FLOPS") else None),
                    help="the card's peak FLOP/s for the MFU (default: the "
                         "H100 SXM's dense peak in the CNN's dtype)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--det_selection", choices=("global", "row"),
                    default=env("BENCH_DET_SELECTION") or "global",
                    help="PipelineConfig.det_selection (default global)")
    args = ap.parse_args(argv)
    if min(args.batch, args.iters, args.size, args.repeats) < 1:
        ap.error("--batch, --iters, --size and --repeats must be >= 1")
    record, _ = measure(args.batch, args.iters, args.size, args.repeats,
                        args.device, args.peak_flops, args.det_selection)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
