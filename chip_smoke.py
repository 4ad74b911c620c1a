"""GPU smoke run of the PyTorch port, with the shipped weights.

Builds the CUDA kernels and the host LSD, holds each kernel against its
plain PyTorch twin on the card (K2 also at the host path's line buckets,
N = 1024 and 2048), and drives every path of the port, each checked
against the JAX package's committed outputs. The pipeline and the weights
are made without a device argument, so the entry points' default (the
GPU) is what runs:

* the zero-host-round-trip path (image -> horizon) on the four bundled
  scenes, then timed at batch 32, 640x640, where every tile must give its
  scene's B = 4 VP set (the CNN runs in fixed chunks, so its grid is
  bit-identical at B = 1, 4, 32 and 33);
* the host path (C++ LSD, then render -> CNN -> EM -> horizon) on the
  bundled scenes, and the consensus horizon (K = 8) on the same lines;
* the 50-scene synthetic protocol (seed 7, 640x640, batch 8) through the
  benchmark driver's functions on both paths: each path's AUC@0.25
  within 0.02 of JAX's, at most 2 of 50 horizons beyond 0.02 of JAX's.

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a), nvcc and g++. Exits non-zero, printing no
result, when there is no GPU or any phase fails. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before the
last is the per-kernel JSON record: ``launches`` adds up the runs of
every path (comparison launches excluded), ``launches_per_batch`` is the
main path's count for its one batch, and ``bound_ms`` is the least time
the card could take for the timed call's work (bytes over the memory
rate or operations over the float32 rate, whichever is larger).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = [os.path.join(ROOT, "assets", "examples", f"scene_{i}.png")
          for i in range(4)]
REFERENCE = os.path.join(ROOT, "assets", "examples",
                         "jax_reference_outputs.npz")
HOST_REFERENCE = os.path.join(ROOT, "assets", "examples",
                              "jax_reference_host.npz")
HORIZON_TOL = 0.02      # normalized horizon error vs the JAX reference
AUC_TOL = 0.02          # the repo's AUC parity gate (BASELINE.md)
K2_ATOL = 1e-4          # float image; only the f32 sum order differs
K2_U8_FRAC = 1e-3       # uint8 images: off by <= 1 on <= 0.1% of pixels
BATCH = 32
SYN_COUNT, SYN_BATCH, SYN_MAX_FAR = 50, 8, 2
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3, and float32
# outside the tensor cores, the sheet's only rate for scalar arithmetic,
# used for K1's integer min/select operations too
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def reset(kernel_list) -> None:
    for k in kernel_list:
        k.launches = 0


def count(kernel_list, total: dict, path: str, need) -> None:
    """Add the launches since :func:`reset` to ``total``; fail when a
    kernel of the path was not launched."""
    got = {k.source: k.launches for k in kernel_list}
    log(f"launches in the {path} run: {got}")
    for k in need:
        if k.launches < 1:
            raise AssertionError(f"{k.source} not launched in the {path} "
                                 "run")
    for src, n in got.items():
        total[src] = total.get(src, 0) + n


def horizon_err(hp1, hp2, ref_hp1, ref_hp2) -> float:
    """Normalized horizon error (640x640) between two (hp1, hp2) pairs."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.data.io import \
        normalized_horizon_error

    def line(a, b):
        return np.cross(*(torch.as_tensor(x).cpu().double().numpy()
                          for x in (a, b)))

    return normalized_horizon_error(line(hp1, hp2), line(ref_hp1, ref_hp2),
                                    640, 640)


def k2_diff(got, ref):
    """(max |d|, max uint8 difference, share of uint8 pixels that differ)."""
    import torch

    du8 = (torch.floor(got * 255).to(torch.int32)
           - torch.floor(ref * 255).to(torch.int32)).abs()
    return (float((got - ref).abs().max()), int(du8.max()),
            float((du8 > 0).float().mean()))


def bound(n_bytes: float, n_ops: float):
    """(least ms, "bytes" or "operations"): the larger of the two times;
    logs both counts."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"  bound: {n_bytes:.4g} bytes ({t_bytes * 1e3:.4f} ms), {n_ops:.4g} "
        f"operations ({t_ops * 1e3:.4f} ms): {by}")
    return max(t_bytes, t_ops) * 1e3, by


def k2_work(l, mask, size: int, linewidth: float):
    """(bytes, float operations) of the sphere render on these lines: each
    input read once and the image written once; 12 operations per masked
    (line, column) for the curve (two products, a difference, the
    quotient, atan, the row centre's product and difference, the slope's
    difference and product, 1 + m^2, rsqrt), 7 per pixel that a line
    covers (difference, abs, product, coverage, clamp pair, sum) and 3
    per output pixel (product, exp, difference)."""
    import torch

    from vanishing_points_2017_tpu_torch.ops.sphere import curve_beta

    b, n = mask.shape
    cols = torch.arange(size, dtype=torch.float32, device=l.device)
    alphas = (cols - 0.5 * size + 0.5) * (math.pi / size)
    cov_c = 0.5 + 0.5 * linewidth
    covered = 0
    for c in range(0, n, 64):
        rc = 0.5 * size - 0.5 - curve_beta(l[:, c:c + 64], alphas) * (
            size / math.pi)
        rc = torch.where(torch.isnan(rc), -1e6, rc)
        m = torch.cat([rc[..., 1:2] - rc[..., :1],
                       0.5 * (rc[..., 2:] - rc[..., :-2]),
                       rc[..., -1:] - rc[..., -2:-1]], dim=-1)
        half = cov_c * torch.sqrt(1.0 + m * m)
        lo = torch.clamp(torch.floor(rc - half) + 1, min=0)
        hi = torch.clamp(torch.ceil(rc + half) - 1, max=size - 1)
        rows = torch.clamp(hi - lo + 1, min=0) * mask[:, c:c + 64, None]
        covered += int(rows.sum())
    n_bytes = l.numel() * 4 + mask.numel() + 2 * size * 4 + b * size * size * 4
    n_ops = 12 * int(mask.sum()) * size + 7 * covered + 3 * b * size * size
    return n_bytes, n_ops


def packed_of(ld, imgs):
    """K1's input on the main path: the packed edge bit-plane of a batch
    of grayscale images (``ld`` is the port's ``ops.lines_device``)."""
    import numpy as np

    _, active, ux, uy = ld.gradient_front(imgs)
    return ld.pack_edge_masks(active, ux, uy,
                              float(np.cos(np.radians(ld.TOL_DEG))))


def detected_lines(pkg, imgs, n_pad: int):
    """K2's input on the main path: the device detector's homogeneous
    lines and their mask, (B, n_pad, 3) and (B, n_pad), contiguous
    (``pkg`` is the port's package)."""
    import torch

    with torch.inference_mode():
        seg, mask = pkg.ops.lines_device.detect_segments_device(
            imgs, max_segments=n_pad)
    lines = torch.where(mask[..., None],
                        pkg.ops.lines.segments_to_homogeneous(seg), 0.0)
    return lines.contiguous(), mask.contiguous()


def bucket_lines(lines, mask, n: int, b: int = 8):
    """K2's input at a host-path line bucket: ``b`` images of ``n`` real
    lines each, cycled from the first four images' detected lines."""
    import torch

    pool = [lines[i][mask[i]] for i in range(4)]
    reps = n // min(len(p) for p in pool) + 1
    ln = torch.stack([torch.cat([pool[(i + j) % 4] for j in range(reps)])[:n]
                      for i in range(b)])
    return ln.contiguous(), torch.ones(ln.shape[:2], dtype=torch.bool,
                                       device=ln.device)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import vanishing_points_2017_tpu_torch as port
    from vanishing_points_2017_tpu_torch import batching, kernels
    from vanishing_points_2017_tpu_torch.data import io as dio
    from vanishing_points_2017_tpu_torch import lsd
    from vanishing_points_2017_tpu_torch.em.consensus import em_and_horizon
    from vanishing_points_2017_tpu_torch.models import cnn as cnn_mod
    from vanishing_points_2017_tpu_torch.ops import lines_device as ld
    from vanishing_points_2017_tpu_torch.ops import sphere
    from vanishing_points_2017_tpu_torch.ops.lines import \
        segments_to_homogeneous
    from vanishing_points_2017_tpu_torch.pipeline import (Pipeline,
                                                           PipelineConfig)
    from vanishing_points_2017_tpu_torch.weights import (
        artifact_fingerprint, default_weights_path, load_params_and_mean)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")

    # ---- build: the two kernels in parallel threads (each nvcc is its own
    # process), the host LSD beside them
    ccl_k, sph_k = kernels_all = kernels.all_kernels()
    total: dict = {}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(k.build) for k in kernels_all]
        lsd_build = pool.submit(lsd.detect_line_segments,
                                np.zeros((8, 8)))
        for k, fut in zip(kernels_all, builds):
            log(f"build {k.source}: {fut.result():.2f} s")
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
        lsd_build.result()
    log(f"builds done in {time.perf_counter() - t0:.2f} s (host LSD "
        "included)")

    cfg = PipelineConfig()
    grays = [Pipeline.ingest_image(p)["gray"] for p in SCENES]
    imgs4 = torch.from_numpy(np.stack(grays)).to(dev)
    imgs32 = imgs4.repeat(BATCH // 4, 1, 1)
    records = {}

    # ---- K1: raster CCL vs its twin, bit-exact at B = 4 and B = 32
    for imgs in (imgs4, imgs32):
        packed = packed_of(ld, imgs)
        got = ld.connected_components_cuda(packed, 8)
        ref = ld.connected_components_ref(packed, 8)
        torch.cuda.synchronize()
        n_bad = int((got != ref).sum())
        log(f"K1 B={imgs.shape[0]} {tuple(packed.shape[1:])}: "
            f"{n_bad} labels differ")
        if n_bad:
            raise AssertionError(f"K1 not bit-exact at B={imgs.shape[0]}")
    packed = packed_of(ld, imgs32)
    k1_ms = cuda_ms(lambda: ld.connected_components_cuda(packed, 8), 10)
    k1_plain = cuda_ms(lambda: ld.connected_components_ref(packed, 8), 1)
    # each pixel and half pass: three injection mins, the two scans' mins
    # and the final min; the plane read once, the labels written once
    k1_bound, k1_by = bound(2 * packed.numel() * 4, 6 * 8 * packed.numel())
    log(f"K1 time B={BATCH}: kernel {k1_ms:.3f} ms, twin {k1_plain:.3f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_by})")
    records["ccl_raster"] = dict(max_abs_err=0.0, ms=k1_ms, plain_ms=k1_plain,
                                 bound_ms=k1_bound, bound_by=k1_by)

    # ---- K2: sphere render of the detected lines vs its twin
    lines, mask = detected_lines(port, imgs32, cfg.n_pad)
    log(f"K2 input: {tuple(lines.shape)} lines, "
        f"{mask.sum(1).tolist()[:4]} valid in the first scenes")
    worst = 0.0
    for b in (4, BATCH):
        got = sphere.sphere_render_cuda(lines[:b].contiguous(),
                                        mask[:b].contiguous(), 500)
        ref = sphere.sphere_render_ref(lines[:b], mask[:b], 500)
        err, du8_max, frac = k2_diff(got, ref)
        log(f"K2 B={b}: max|d| {err:.3g}, uint8 max {du8_max} on "
            f"{frac:.2e} of pixels")
        if not (err <= K2_ATOL and du8_max <= 1 and frac <= K2_U8_FRAC):
            raise AssertionError(f"K2 disagrees with its twin at B={b}")
        worst = max(worst, err)
    k2_ms = cuda_ms(lambda: sphere.sphere_render_cuda(lines, mask, 500), 10)
    k2_plain = cuda_ms(lambda: sphere.sphere_render_ref(lines, mask, 500), 3)
    k2_bound, k2_by = bound(*k2_work(lines, mask, 500,
                                     sphere.DEFAULT_LINEWIDTH_PX))
    log(f"K2 time B={BATCH}: kernel {k2_ms:.3f} ms, twin {k2_plain:.3f} ms, "
        f"bound {k2_bound:.4f} ms ({k2_by})")
    records["sphere_render"] = dict(max_abs_err=worst, ms=k2_ms,
                                    plain_ms=k2_plain, bound_ms=k2_bound,
                                    bound_by=k2_by)

    # ---- end to end on the 4 scenes through both kernels, with the entry
    # points' default device
    params, mean = load_params_and_mean()
    log(f"weights {artifact_fingerprint(default_weights_path())}")
    pipe = Pipeline(params, mean, cfg)
    if not (pipe.device.type == mean.device.type == "cuda"
            and params["conv1"]["w"].is_cuda):
        raise AssertionError("the entry points' default is not the GPU")
    reset(kernels_all)
    out = pipe.process_images(grays)
    torch.cuda.synchronize()
    per_batch = {k.source: k.launches for k in kernels_all}
    count(kernels_all, total, "main-path", need=kernels_all)
    for key in ("hp1", "hp2", "vp", "cnn_prediction", "counts"):
        if not bool(torch.isfinite(out[key].float()).all()):
            raise AssertionError(f"non-finite {key}")
    if tuple(out["hp1"].shape) != (4, 3) or \
            tuple(out["cnn_prediction"].shape) != (4, 20, 20):
        raise AssertionError("unexpected output shapes")
    jax_ref = np.load(REFERENCE)
    for i in range(4):
        e_jax = horizon_err(out["hp1"][i], out["hp2"][i], jax_ref["hp1"][i],
                            jax_ref["hp2"][i])
        gt = np.load(SCENES[i].replace(".png", ".horizon.npy"))
        e_gt = dio.normalized_horizon_error(
            np.cross(out["hp1"][i].cpu().double().numpy(),
                     out["hp2"][i].cpu().double().numpy()),
            gt.astype(np.float64), 640, 640)
        log(f"scene {i}: {int(out['segment_mask'][i].sum())} segments, "
            f"{int(out['alive'][i].sum())} VPs, {int(out['iterations'][i])} "
            f"EM iters; horizon err vs JAX {e_jax:.5f}, vs ground truth "
            f"{e_gt:.5f}")
        if not e_jax <= HORIZON_TOL:
            raise AssertionError(f"scene {i}: horizon {e_jax} from JAX's")

    # ---- end-to-end throughput at b32 / 640^2 (information only)
    grays32 = [grays[i % 4] for i in range(BATCH)]
    times = []
    for it in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out32 = pipe.process_images(grays32)
        torch.cuda.synchronize()
        if it:
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"e2e b{BATCH}/640^2: median {med * 1e3:.1f} ms/batch = "
        f"{BATCH / med:.2f} img/s over {len(times)} runs ({card})")

    # ---- the timed batch's outputs. Every tile's horizon lies within
    # HORIZON_TOL of JAX's for its scene, and the tiles of one scene agree
    # exactly (no cross-talk between the images of a batch).
    worst = 0.0
    for i in range(BATCH):
        e_jax = horizon_err(out32["hp1"][i], out32["hp2"][i],
                            jax_ref["hp1"][i % 4], jax_ref["hp2"][i % 4])
        worst = max(worst, e_jax)
        if not e_jax <= HORIZON_TOL:
            raise AssertionError(f"b{BATCH} tile {i}: horizon {e_jax} from "
                                 "JAX's")
    for key in ("alive", "counts", "iterations", "hp1", "hp2"):
        tiles = out32[key].reshape(BATCH // 4, 4, *out32[key].shape[1:])
        if not bool((tiles == tiles[:1]).all()):
            raise AssertionError(f"b{BATCH}: tiles of one scene differ in "
                                 f"{key}")
    # The EM stage runs in fixed chunks: fed the B = 4 run's own inputs
    # tiled to b32, it gives the B = 4 run's VPs exactly.
    idx = [i % 4 for i in range(BATCH)]
    lp, lm = out["segments"][idx], out["segment_mask"][idx]
    with torch.inference_mode():
        em, _ = em_and_horizon(
            torch.where(lm[..., None], segments_to_homogeneous(lp), 0.0), lp,
            out["cnn_prediction"][idx], out["sphere_image"][idx].float(), lm,
            cfg.em)
    if not (torch.equal(em.alive, out["alive"][idx])
            and torch.equal(em.counts, out["counts"][idx])):
        raise AssertionError(f"EM at b{BATCH} differs from the B=4 run on "
                             "the same inputs")
    log(f"b{BATCH} outputs: worst horizon err vs JAX {worst:.5f} over "
        f"{BATCH} tiles; EM on the B=4 inputs tiled: VPs identical")

    # ---- the CNN runs in fixed chunks, so its grid and the VP sets do not
    # depend on the batch size: the scenes' grids are bit-identical at
    # B = 1, 4, 32 and 33 and at any position, and every b32 tile ends
    # with its scene's B = 4 VP set
    x4 = cnn_mod.preprocess(out["sphere_image"], pipe.mean)
    with torch.inference_mode():
        ref = [pipe.model(x4[s:s + 1])[0] for s in range(4)]
        for rows in (list(range(4)), [(3 * i + i // 4) % 4 for i in range(32)],
                     [(7 * i) % 4 for i in range(33)]):
            grid = pipe.model(x4[rows])
            for pos, s in enumerate(rows):
                if not torch.equal(grid[pos], ref[s]):
                    raise AssertionError(f"CNN grid of scene {s} at B="
                                         f"{len(rows)}, row {pos}, differs "
                                         "from B=1")
    for i in range(BATCH):
        for key in ("alive", "counts"):
            if not torch.equal(out32[key][i], out[key][i % 4]):
                raise AssertionError(f"b{BATCH} tile {i}: {key} differ from "
                                     "the B=4 run")
    cnn_ms = cuda_ms(lambda: pipe.model(x4[idx]), 10)
    log(f"CNN: grids bit-identical at B=1,4,32,33; b{BATCH} VP sets equal "
        f"B=4's; CNN stage b{BATCH} {cnn_ms:.3f} ms/batch (chunk "
        f"{batching.default_chunk(x4)})")

    # ---- K2 at the host path's line buckets, B = 8: every slot holds a
    # real line (the bundled scenes' detected lines, cycled)
    for n in (1024, 2048):
        ln, mk = bucket_lines(lines, mask, n)
        got = sphere.sphere_render_cuda(ln, mk, 500)
        ref_img = sphere.sphere_render_ref(ln, mk, 500)
        err, du8_max, frac = k2_diff(got, ref_img)
        t_k = cuda_ms(lambda: sphere.sphere_render_cuda(ln, mk, 500), 10)
        t_p = cuda_ms(lambda: sphere.sphere_render_ref(ln, mk, 500), 2)
        t_b, _ = bound(*k2_work(ln, mk, 500, sphere.DEFAULT_LINEWIDTH_PX))
        log(f"K2 B=8 N={n}: max|d| {err:.3g}, uint8 max {du8_max} on "
            f"{frac:.2e} of pixels; kernel {t_k:.3f} ms, twin {t_p:.3f} ms, "
            f"bound {t_b:.4f} ms")
        if not (err <= K2_ATOL and du8_max <= 1 and frac <= K2_U8_FRAC):
            raise AssertionError(f"K2 disagrees with its twin at N={n}")
        records["sphere_render"]["max_abs_err"] = max(
            records["sphere_render"]["max_abs_err"], err)

    # ---- the host path (C++ LSD on the host) on the 4 bundled scenes
    host_ref = np.load(HOST_REFERENCE)
    t0 = time.perf_counter()
    bundles = [pipe.ingest(p) for p in SCENES]
    lsd_s = time.perf_counter() - t0
    reset(kernels_all)
    host = pipe.process_batch(bundles)
    torch.cuda.synchronize()
    count(kernels_all, total, "host path", need=(sph_k,))
    for i in range(4):
        e_jax = horizon_err(host["hp1"][i], host["hp2"][i],
                            host_ref["host_hp1"][i], host_ref["host_hp2"][i])
        log(f"host path scene {i}: {bundles[i]['segments'].shape[0]} LSD "
            f"segments (bucket {bundles[i]['l'].shape[0]}), "
            f"{int(host['alive'][i].sum())} VPs; horizon err vs JAX "
            f"{e_jax:.5f}")
        if not e_jax <= HORIZON_TOL:
            raise AssertionError(f"host path scene {i}: horizon {e_jax} "
                                 "from JAX's")
    bundles32 = [bundles[i % 4] for i in range(BATCH)]
    times = []
    for it in range(4):
        t0 = time.perf_counter()
        pipe.process_batch(bundles32)
        torch.cuda.synchronize()
        if it:
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"host ingest (PNG decode + LSD): {lsd_s / 4 * 1e3:.1f} ms/img; "
        f"host-path device stage b{BATCH}: median {med * 1e3:.1f} ms/batch "
        f"= {BATCH / med:.2f} img/s over {len(times)} runs ({card})")

    # ---- consensus K = 8 on the host path's bundles: member 0 is the
    # untouched population, so it reproduces the single-EM run exactly
    cpipe = Pipeline(params, mean, dataclasses.replace(
        cfg, horizon_consensus=8))
    reset(kernels_all)
    cons = cpipe.process_batch(bundles)
    torch.cuda.synchronize()
    count(kernels_all, total, "consensus", need=(sph_k,))
    for key in ("hp1", "hp2", "consensus_yl", "consensus_yr"):
        if not bool(torch.isfinite(cons[key]).all()):
            raise AssertionError(f"consensus: non-finite {key}")
    if not (torch.equal(cons["consensus_yl"][:, 0], host["hp1"][:, 1])
            and torch.equal(cons["consensus_yr"][:, 0], host["hp2"][:, 1])):
        raise AssertionError("consensus member 0 differs from the single EM")
    log(f"consensus K=8: member 0 equals the single EM; picks "
        f"{cons['consensus_pick'].tolist()}, spread "
        f"{[round(v, 4) for v in cons['consensus_spread'].tolist()]}")

    # ---- the 50-scene synthetic protocol through the benchmark driver's
    # functions, host-LSD path and device-detector path
    from vanishing_points_2017_tpu_torch import benchmark as bench
    from vanishing_points_2017_tpu_torch.data.cache import StageCache
    from vanishing_points_2017_tpu_torch.data.datasets import \
        synthetic_records
    from vanishing_points_2017_tpu_torch.metrics import calc_auc

    syn, _ = synthetic_records(count=SYN_COUNT)
    for path, detect in (("host", False), ("dev", True)):
        # the benchmark's per-image lines go to a buffer, not to this log
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()):
            cache = StageCache(tmp, bench.cache_key(cfg, detect))
            ingest_s = bench.ingest_stage(pipe, syn, cache, None, detect)
            reset(kernels_all)
            n_done, dev_s = bench.device_stage(pipe, syn, cache, "result",
                                               SYN_BATCH, detect)
            torch.cuda.synchronize()
            errors, _ = bench.horizon_errors(syn, cache, "result", detect)
            res = [cache.load(r.name, "result") for r in syn]
        count(kernels_all, total, f"synthetic {path}",
              need=(sph_k,) if path == "host" else (ccl_k, sph_k))
        auc = calc_auc(errors, 0.25)[0]
        jax_auc = float(host_ref[f"auc_{path}"])
        far = []
        for i, r in enumerate(res):
            e = horizon_err(r["hp1"], r["hp2"], host_ref[f"syn_{path}_hp1"][i],
                            host_ref[f"syn_{path}_hp2"][i])
            if e > HORIZON_TOL:
                far.append(i)
                log(f"synthetic {path} image {i}: horizon {e:.4f} from JAX's")
        log(f"synthetic {path}: AUC {auc:.5f} vs JAX {jax_auc:.5f}; "
            f"{len(far)} of {SYN_COUNT} horizons beyond {HORIZON_TOL} of "
            f"JAX's; host ingest {ingest_s / SYN_COUNT * 1e3:.1f} ms/img; "
            f"device stage {n_done / dev_s:.1f} img/s at batch {SYN_BATCH} "
            f"({card})")
        if not abs(auc - jax_auc) <= AUC_TOL:
            raise AssertionError(f"synthetic {path}: AUC {auc} vs JAX "
                                 f"{jax_auc}")
        if len(far) > SYN_MAX_FAR:
            raise AssertionError(f"synthetic {path}: {len(far)} horizons "
                                 "beyond the gate")

    # no single PyTorch call computes either function: library_ms is null
    kernel_info = [
        dict(name="ccl_raster", route="cuda",
             source="vanishing_points_2017_tpu_torch/csrc/ccl_raster.cu",
             replaces="vanishing_points_2017_tpu/ops/ccl_pallas.py:44",
             launches=total[ccl_k.source],
             launches_per_batch=per_batch[ccl_k.source],
             library_ms=None, **records["ccl_raster"]),
        dict(name="sphere_render", route="cuda",
             source="vanishing_points_2017_tpu_torch/csrc/sphere_render.cu",
             replaces="vanishing_points_2017_tpu/ops/sphere_pallas.py:53",
             launches=total[sph_k.source],
             launches_per_batch=per_batch[sph_k.source],
             library_ms=None, **records["sphere_render"]),
    ]
    for k in kernel_info:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    log(json.dumps({"kernels": kernel_info}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
