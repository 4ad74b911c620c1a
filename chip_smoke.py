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
  within 0.02 of JAX's, at most 2 of 50 horizons beyond 0.02 of JAX's;
* the training path: the seed-0 batch rendered by K2 against JAX's
  (labels equal, images within K2's uint8 gate) and two train steps from
  the shipped compact weights on JAX's batch with JAX's dropout masks,
  in float32 (losses within 1e-4 of JAX's) and in bfloat16 (losses and
  per-parameter updates within the gates stated below); compact
  and dense full-width training at b32 (the dense loss must fall over 50
  steps from scratch), timed; then ``train_cnn`` (20 steps, snapshots,
  ``--resume``) and ``compress_weights`` (5 steps) run as commands into a
  temporary directory (each must report a K2 launch for every batch it
  drew), the compressed weights served on the bundled scenes, and nothing
  under ``assets/`` touched;
* the real data sets' path on miniature York Urban, Eurasian Cities and
  Horizon Lines in the Wild sets (8 evaluated images each) written by the
  port's own generators and JPEG writer into a temporary directory: every
  JPEG's sha256 equals the committed one, K1 is bit-exact on the three
  non-square grids, and ``benchmark.main`` runs ``--yud``, ``--ecd``,
  ``--hlw`` (host LSD, batch 4) and ``--yud --device_detect``: 8
  ``max_error`` lines each, each AUC within 0.02 of JAX's on the same
  files (and, on the host path, of the committed golden), at most 1 of 8
  horizons beyond 0.02 of JAX's;
* the reference-shaped entry points (``em/compat.py``): ``renew_cnn_result``
  and ``run_em_single`` on bundled scene 0's LSD lines (K2 launched once,
  the horizon of the returned VPs within 0.02 of JAX's);
* Caffe artifacts at full width: the shipped weights exported (low-rank
  layers densified, fc6 57600 x 4096) as a ``.caffemodel`` and the mean as
  a ``.binaryproto``, both loaded through ``load_params_and_mean``, and the
  CNN's grids on the bundled scenes' sphere images bit-identical to those
  of the same densified parameters used directly;
* K1's wide kernel (grids past 1024 columns): bit-exact on random planes
  1025-4031 wide and on 720p / 1080p gradient grids (timed), and a
  1280x720 frame through ``process_images``;
* ``parallel/``: ranks spawned over gloo that share the card run sharded
  serving on the scenes tiled to b32 at (dp, tp) = (2, 1) (every output
  equal to the single-process run's), (1, 2) and (2, 2) (CNN grid within
  2e-2, horizons within 0.02 of JAX's), one float32 train step of the
  compact weights on a 2 x 2 mesh (loss and parameters within 1e-5 of the
  single-process step) and the sharded line similarity at N = 2048 (within
  2e-6 of the dense one); then one nccl rank serves the scenes. Ranks
  report their kernel launches back; their wall times are information
  only (ranks sharing a card say nothing about scaling).

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a), nvcc and g++. Exits non-zero, printing no
result, when there is no GPU or any phase fails. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before the
last is the per-kernel JSON record: ``launches`` adds up the runs of
every path (comparison launches excluded; the drivers' as they report
them), ``launches_per_batch`` is the main path's count for its one batch,
``launches_per_train_step`` the dense training run's count over its
steps, ``launches_sharded`` the sharded serving runs' (all ranks),
K1's ``ms_by_wide_grid`` its time at B = 4 on 720p and 1080p gradient
grids, and ``bound_ms`` is the least time
the card could take for the timed call's work (bytes over the memory
rate or operations over the float32 rate, whichever is larger).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
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
TRAIN_REFERENCE = os.path.join(ROOT, "assets", "examples",
                               "jax_reference_train.npz")
MINI_REFERENCE = os.path.join(ROOT, "assets", "examples",
                              "jax_reference_minisets.npz")
HORIZON_TOL = 0.02      # normalized horizon error vs the JAX reference
AUC_TOL = 0.02          # the repo's AUC parity gate (BASELINE.md)
K2_ATOL = 1e-4          # float image; only the f32 sum order differs
K2_U8_FRAC = 1e-3       # uint8 images: off by <= 1 on <= 0.1% of pixels
BATCH = 32
SYN_COUNT, SYN_BATCH, SYN_MAX_FAR = 50, 8, 2
# the miniature data sets: the JAX package's golden AUCs for the three
# formats (tests/test_minisets.py, +-0.02), 8 evaluated images, batch 4,
# at most 1 of 8 horizons beyond HORIZON_TOL of JAX's (the EM's triplet
# search sits on a knife edge for some scenes)
MINI_GOLDEN = {"yud": 0.9750, "ecd": 0.9695, "hlw": 0.9461}
MINI_N_EVAL, MINI_BATCH, MINI_MAX_FAR = 8, 4, 1
# run -> (data set, its name in data.datasets.DATASETS, --device_detect)
MINI_RUNS = {"yud": ("yud", "york", False), "ecd": ("ecd", "eurasian", False),
             "hlw": ("hlw", "horizon", False), "yud_dev": ("yud", "york", True)}
# training parity with JAX's two steps: the CPU tests' gates
# (tests/test_torch_train_grads.py), but for the second bfloat16 loss. It
# follows the first step's bf16 update and moves with where the bf16
# convolutions sum: JAX's own float32 and bfloat16 second losses lie 2.0%
# apart, and scripts/probe_train_bf16.py finds the card 3.1e-2 from JAX
# with cuDNN's bf16 convolutions and 1.4e-2 with the same convolutions
# summed in float32 (cuBLAS's reduced-precision reduction changes no bit).
# So the card is held to 5e-2 there, and in float32 to 1e-4 on both losses.
TRAIN_LOSS_RTOL, TRAIN_LOSS2_RTOL, TRAIN_F32_RTOL = 2e-2, 5e-2, 1e-4
TRAIN_UPD_COS, TRAIN_UPD_NORM = 0.99, 0.05
DENSE_STEPS, COMPACT_STEPS, DENSE_LR = 50, 12, 5e-4
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3, and float32
# outside the tensor cores, the sheet's only rate for scalar arithmetic,
# used for K1's integer min/select operations too
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K1's wide kernel (more than 1024 columns): random planes of these widths
WIDE_WIDTHS = (1025, 1279, 1919, 2049, 4031)
# the parallel phase: the tp CNN's grid against the single process (bf16
# products, fc7's sums split over tp), the sharded lsim's N, and a
# deadline per group of ranks
TP_GRID_TOL = 2e-2
LSIM_N = 2048
RANK_TIMEOUT = 300


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


def checker(failed: list):
    """``check(ok, what)``: log a check that did not hold and note it in
    ``failed``, so a phase runs all its checks before it fails."""
    def check(ok: bool, what: str) -> None:
        if not ok:
            log(f"FAILED: {what}")
            failed.append(what)
    return check


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


def assets_mtimes() -> dict:
    """Modification time of every file under assets/."""
    out = {}
    for d, _, files in os.walk(os.path.join(ROOT, "assets")):
        for f in files:
            out[os.path.join(d, f)] = os.stat(os.path.join(d, f)).st_mtime_ns
    return out


def cosine(a, b) -> float:
    import numpy as np

    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def parity_batch(ref, mean, dev):
    """JAX's seed-0 training input from the committed reference ``ref``:
    its images less ``mean`` (2, 1, 500, 500), its labels, and its fc6 and
    fc7 keep masks for each of the two steps."""
    import numpy as np
    import torch

    x = (torch.from_numpy(ref["images"]).to(dev).float() - mean)[:, None]
    y = torch.from_numpy(ref["labels"]).to(dev)
    keep = [[torch.from_numpy(k).to(dev) for k in step]
            for step in np.unpackbits(ref["keep"], axis=-1).astype(bool)]
    return x, y, keep


def replay_steps(params: dict, dtype, batch):
    """JAX's two train steps replayed from ``params`` on ``batch`` (from
    :func:`parity_batch`) with products in ``dtype``: (state, losses)."""
    from vanishing_points_2017_tpu_torch.models import train

    x, y, keep = batch
    state = train.init_state(params)
    state.model.compute_dtype = dtype
    losses = [float(train.train_step(state, x, y, keep=k)) for k in keep]
    return state, losses


def update_agreement(shipped: dict, state, ref) -> dict:
    """Per parameter ``layer/key``: (cosine of the update's first values to
    JAX's, the update's norm over JAX's); the update is the trained
    parameters less ``shipped`` (JAX layout)."""
    import numpy as np

    from vanishing_points_2017_tpu_torch import weights as W

    got = W.params_to_numpy(state.model.params())
    out = {}
    for layer, d in shipped.items():
        for k, v in d.items():
            upd = (got[layer][k] - v).ravel()
            head = ref[f"head/{layer}/{k}"]
            out[f"{layer}/{k}"] = (
                cosine(upd[:head.size], head),
                float(np.linalg.norm(upd) / ref[f"norm/{layer}/{k}"]))
    return out


def train_run(state, rng, steps: int, mean, dev, seed: int = 1):
    """``steps`` train steps, each on a fresh batch of BATCH from
    make_batch, as the drivers run them: per step the loss, the host ms of
    make_batch (to the rendered batch on the card), the step's ms between
    CUDA events, and its wall ms (batch and step)."""
    import torch

    from vanishing_points_2017_tpu_torch.models import train

    losses, host_ms, step_ms, wall_ms = [], [], [], []
    for s in range(steps):
        t0 = time.perf_counter()
        x, y = train.make_batch(rng, BATCH, mean, device=dev)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = train.train_step(state, x, y,
                                train.step_generator(seed, state.step, dev))
        end.record()
        losses.append(float(loss))
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, host_ms, step_ms, wall_ms


def log_train_times(name: str, host_ms, step_ms, wall_ms, card: str,
                    skip: int = 2) -> None:
    """Medians over the steps after the first ``skip`` (warm-up)."""
    h, s, w = (statistics.median(v[skip:]) for v in (host_ms, step_ms,
                                                     wall_ms))
    log(f"{name} b{BATCH}: {BATCH / w * 1e3:.2f} train img/s (median wall "
        f"{w:.2f} ms/step over {len(wall_ms) - skip} steps); host "
        f"make_batch {h:.2f} ms vs device step {s:.2f} ms (CUDA events); "
        f"first step {step_ms[0]:.1f} ms ({card})")


def training_phase(dev, card: str, kernels_all, sph_k, total: dict,
                   grays) -> dict:
    """The port's training path on the card; returns each kernel's
    launches per step of the dense run, by source. Every check runs and
    logs before the phase fails on the first that did not hold."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import weights as W
    from vanishing_points_2017_tpu_torch.models import cnn, train
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline

    failed: list = []
    check = checker(failed)

    ref = np.load(TRAIN_REFERENCE)
    shipped = W.params_npz_numpy(W.default_weights_path())
    mean = torch.from_numpy(np.load(W.default_mean_path())).to(dev)

    # ---- 1. parity with JAX: the batch of seed 0 rendered by K2, then
    # two steps on JAX's images with JAX's dropout masks, in float32 and in
    # bfloat16 (the trainer's); the updates checked are the bfloat16 run's
    reset(kernels_all)
    x, y = train.make_batch(np.random.default_rng(0), 2, device=dev)
    torch.cuda.synchronize()
    count(kernels_all, total, "training batch", need=(sph_k,))
    d = np.abs(x[:, 0].cpu().numpy() - ref["images"].astype(np.float32))
    log(f"training batch (K2) vs JAX's: labels equal "
        f"{np.array_equal(y.cpu().numpy(), ref['labels'])}; uint8 max "
        f"{d.max():.0f} on {(d > 0).mean():.2e} of pixels")
    check(np.array_equal(y.cpu().numpy(), ref["labels"]), "labels differ")
    check(d.max() <= 1 and (d > 0).mean() <= K2_U8_FRAC,
          "training images beyond K2's gate")
    batch = parity_batch(ref, mean, dev)
    for dtype, key, gates in (
            (torch.float32, "losses_f32", (TRAIN_F32_RTOL,) * 2),
            (torch.bfloat16, "losses", (TRAIN_LOSS_RTOL, TRAIN_LOSS2_RTOL))):
        state, losses = replay_steps(W.params_from_numpy(shipped, dev),
                                     dtype, batch)
        for s, loss in enumerate(losses):
            want = float(ref[key][s])
            rel = abs(loss - want) / want
            log(f"parity {dtype} step {s}: loss {loss:.5f} vs JAX "
                f"{want:.5f} (rel {rel:.2e}, gate {gates[s]:g})")
            check(rel <= gates[s], f"parity {dtype} step {s}: loss")
    agree = update_agreement(shipped, state, ref)
    for name, (c, r) in agree.items():
        log(f"  update {name}: cosine {c:.5f}, norm ratio {r:.4f}")
        check(c >= TRAIN_UPD_COS and abs(r - 1) <= TRAIN_UPD_NORM,
              f"parity update {name}")
    log(f"parity: lowest update cosine "
        f"{min(c for c, _ in agree.values()):.5f}, largest norm deviation "
        f"{max(abs(r - 1) for _, r in agree.values()):.4f}")

    # ---- 2a. the compress_weights configuration at b32: compact weights
    reset(kernels_all)
    rng = np.random.default_rng(1)
    losses, host_ms, step_ms, wall_ms = train_run(state, rng, COMPACT_STEPS,
                                                  mean, dev)
    torch.cuda.synchronize()
    count(kernels_all, total, "compact training", need=(sph_k,))
    check(bool(np.isfinite(losses).all()), "compact training: loss")
    log_train_times("compact (rank-256) training", host_ms, step_ms,
                    wall_ms, card)
    del state

    # ---- 2b. dense full-width training from scratch, the README's recipe
    t0 = time.perf_counter()
    state = train.init_state(W.params_from_numpy(cnn.init_params(0), dev),
                             base_lr=DENSE_LR)
    log(f"dense init (host numpy fillers, to the card): "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset(kernels_all)
    losses, host_ms, step_ms, wall_ms = train_run(state, rng, DENSE_STEPS,
                                                  mean, dev)
    torch.cuda.synchronize()
    per_step = {k.source: k.launches / DENSE_STEPS for k in kernels_all}
    count(kernels_all, total, "dense training", need=(sph_k,))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    log(f"dense training {DENSE_STEPS} steps: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, mean of first 10 {first:.3f}, of last 10 "
        f"{last:.3f}; launches per step {per_step}")
    log(f"  losses {[round(v, 3) for v in losses]}")
    check(bool(np.isfinite(losses).all()), "dense training: loss")
    check(last < first, "dense training: the loss did not fall")
    log_train_times("dense training", host_ms, step_ms, wall_ms, card)
    log(f"dense training peak memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    del state
    torch.cuda.empty_cache()

    # ---- 3. the drivers as users run them, writing to a temporary dir
    before = assets_mtimes()
    with tempfile.TemporaryDirectory() as tmp:
        w, m, c = (os.path.join(tmp, f) for f in ("w.npz", "m.npy", "c.npz"))

        def run(mod, steps: int, *args):
            """Run a driver; its last line gives its K2 launches, which
            must cover its ``steps`` batches and go into the total."""
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"vanishing_points_2017_tpu_torch.{mod}",
                 *args], cwd=ROOT, capture_output=True, text=True,
                timeout=300)
            log(f"{mod} {' '.join(args)}: exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s")
            for line in proc.stdout.splitlines()[-6:]:
                log(f"  | {line}")
            if proc.returncode:
                log(proc.stderr[-3000:])
            check(proc.returncode == 0, f"{mod} exit {proc.returncode}")
            last = (proc.stdout.strip().splitlines() or [""])[-1]
            n = (int(last.rsplit(":", 1)[1])
                 if "sphere kernel launches:" in last else 0)
            log(f"launches in the {mod} run: {{'{sph_k.source}': {n}}}")
            check(n >= steps, f"{mod}: {n} K2 launches for {steps} batches")
            total[sph_k.source] += n
            return proc.stdout

        run("train_cnn", 20, "--steps", "20", "--batch", str(BATCH),
            "--snapshot", "10", "--display", "10", "--out", w,
            "--mean_out", m)
        step = int(np.load(w)["__step__"]) if os.path.isfile(w) else None
        check(step == 20 and os.path.isfile(m), f"train_cnn: __step__ {step}")
        out = run("train_cnn", 2, "--steps", "22", "--batch", str(BATCH),
                  "--display", "1", "--out", w, "--mean_out", m,
                  "--resume", w)
        step = int(np.load(w)["__step__"]) if os.path.isfile(w) else None
        check(step == 22 and "step 21  loss" in out
              and "step 20  loss" not in out and "estimating" not in out,
              f"train_cnn --resume: __step__ {step}")
        run("compress_weights", 5, "--weights", w, "--steps", "5",
            "--out", c)
        if os.path.isfile(c):
            params, cmean = W.load_params_and_mean(weights_path=c,
                                                   mean_path=m)
            check("u" in params["fc6"] and params["fc6"]["u"].is_cuda,
                  "compressed weights: fc6 not factorized on the card")
            reset(kernels_all)
            res = Pipeline(params, cmean).process_images(grays)
            torch.cuda.synchronize()
            count(kernels_all, total, "compressed-weights pipeline",
                  need=kernels_all)
            fin = bool(torch.isfinite(res["hp1"]).all()
                       and torch.isfinite(res["hp2"]).all())
            log(f"pipeline with the compressed weights: horizons finite "
                f"{fin}, VPs per scene {res['alive'].sum(1).tolist()}")
            check(fin, "compressed weights: non-finite horizons")
        else:
            check(False, "compress_weights wrote no file")
    after = assets_mtimes()
    check(after == before, "files under assets/ changed")
    log(f"assets/ untouched by the drivers: {after == before} "
        f"({len(after)} files)")
    if failed:
        raise AssertionError(f"training phase: {failed}")
    return per_step


def miniset_phase(dev, card: str, kernels_all, ccl_k, sph_k, total: dict,
                  ld) -> None:
    """The real data sets' path on the card: minis written by the port,
    K1 on their non-square grids, then ``benchmark.main`` per run of
    MINI_RUNS, each held against the committed JAX outputs. Every check
    runs and logs before the phase fails on the first that did not hold."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import benchmark as bench
    from vanishing_points_2017_tpu_torch import weights as W
    from vanishing_points_2017_tpu_torch.data import datasets as dsets
    from vanishing_points_2017_tpu_torch.data import io as dio
    from vanishing_points_2017_tpu_torch.data import minisets
    from vanishing_points_2017_tpu_torch.data.cache import StageCache
    from vanishing_points_2017_tpu_torch.pipeline import (Pipeline,
                                                           PipelineConfig)

    failed: list = []
    check = checker(failed)

    ref = np.load(MINI_REFERENCE)
    cfg = PipelineConfig()
    stage = "result_w" + W.weights_identity() + "_m" + W.mean_identity()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the three minis, and their files against the committed digests
        roots = {}
        for name in ("yud", "ecd", "hlw"):
            roots[name] = os.path.join(tmp, "minis", name)
            t0 = time.perf_counter()
            getattr(minisets, f"make_mini_{name}")(roots[name],
                                                   n_eval=MINI_N_EVAL)
            write_s = time.perf_counter() - t0
            files = [str(f) for f in ref[f"files_{name}"]]
            digests = []
            for f in files:
                path = os.path.join(roots[name], f)
                if not os.path.isfile(path):
                    digests.append("missing")
                    continue
                with open(path, "rb") as fh:
                    digests.append(hashlib.sha256(fh.read()).hexdigest())
            n_bad = sum(a != b for a, b in zip(digests, ref[f"sha256_{name}"]))
            log(f"mini {name}: {len(files)} JPEG files written in "
                f"{write_s:.1f} s ({write_s / len(files) * 1e3:.0f} ms/img, "
                f"drawing and encoding); {n_bad} digests differ from the "
                "committed ones")
            check(n_bad == 0, f"mini {name}: {n_bad} JPEG digests differ")

        # ---- K1 on the data sets' grids: 479 x 639 (York Urban), 599 x 799
        # and 532 x 799 (the other two after the resize to 800), at the
        # driver's batch
        for name, table in (("yud", "york"), ("ecd", "eurasian"),
                            ("hlw", "horizon")):
            adapter, target = dsets.DATASETS[table]
            records, start = adapter(roots[name])
            grays = [Pipeline.ingest_image(r.image_path, target)["gray"]
                     for r in records[start:start + MINI_BATCH]]
            packed = packed_of(ld, torch.from_numpy(np.stack(grays)).to(dev))
            got = ld.connected_components_cuda(packed, 8)
            want = ld.connected_components_ref(packed, 8)
            torch.cuda.synchronize()
            n_bad = int((got != want).sum())
            log(f"K1 on {name}'s grid B={packed.shape[0]} "
                f"{tuple(packed.shape[1:])}: {n_bad} labels differ")
            check(n_bad == 0, f"K1 not bit-exact on {name}'s grid")

        # ---- the benchmark driver, as a user runs it, per run
        for run, (name, table, detect) in MINI_RUNS.items():
            adapter, target = dsets.DATASETS[table]
            records, start = adapter(roots[name])
            evaluated = records[start:]
            res_dir = os.path.join(tmp, "results", run)
            cache = StageCache(os.path.join(res_dir, table),
                               bench.cache_key(cfg, detect))
            # the protocol's skipped split gets placeholder results, so the
            # device stage runs on the evaluated images only
            for rec in records[:start]:
                cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))
            # the host's share per evaluated image, timed apart
            dec_s = lsd_s = 0.0
            for rec in evaluated:
                t0 = time.perf_counter()
                img = dio.load_image(rec.image_path)
                t1 = time.perf_counter()
                if target is not None:
                    img = dio.resize_max(img, target)
                gray = dio.rgb2gray(img)
                t2 = time.perf_counter()
                if not detect:
                    dio.detect_lsd_lines(gray)
                dec_s += t1 - t0
                lsd_s += time.perf_counter() - t2
            argv = [f"--{name}", "--dataset_dir", roots[name], "--result_dir",
                    res_dir, "--run_em", "--batch", str(MINI_BATCH)]
            argv += ["--device_detect"] if detect else []
            buf = io.StringIO()
            reset(kernels_all)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = bench.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            count(kernels_all, total, f"mini {run}",
                  need=(ccl_k, sph_k) if detect else (sph_k,))
            text = buf.getvalue().splitlines()
            n_err = sum(ln.startswith("max_error:") for ln in text)
            aucs = [float(ln.split()[-1]) for ln in text
                    if ln.startswith("AUC:")]
            stage_line = next((ln for ln in text
                               if ln.startswith("device stage:")), "none")
            check(rc == 0 and len(aucs) == 1, f"mini {run}: exit {rc}")
            check(n_err == MINI_N_EVAL, f"mini {run}: {n_err} max_error lines")
            check(f"device stage: {MINI_N_EVAL} imgs" in stage_line,
                  f"mini {run}: {stage_line}")
            if not aucs:
                log("\n".join(text[-20:]))
                continue
            auc, jax_auc = aucs[0], float(ref[f"auc_{run}"])
            far = []
            shape = None
            for i, rec in enumerate(evaluated):
                if str(ref[f"{run}_names"][i]) != rec.name:
                    check(False, f"mini {run}: record {i} is {rec.name}")
                    continue
                r = cache.load(rec.name, stage)
                shape = cache.load(rec.name, "gray" if detect
                                   else "lines")["image_shape"]
                e = dio.normalized_horizon_error(
                    np.cross(r["hp1"].astype(np.float64),
                             r["hp2"].astype(np.float64)),
                    np.cross(ref[f"{run}_hp1"][i].astype(np.float64),
                             ref[f"{run}_hp2"][i].astype(np.float64)),
                    int(shape[1]), int(shape[0]))
                if not e <= HORIZON_TOL:
                    far.append(i)
                    log(f"mini {run} image {rec.name}: horizon {e:.4f} from "
                        "JAX's")
            log(f"mini {run} (images {tuple(int(v) for v in shape)} at the "
                f"detector): "
                f"AUC {auc:.5f} vs JAX {jax_auc:.5f}, golden "
                f"{MINI_GOLDEN[name]}; {len(far)} of {MINI_N_EVAL} horizons "
                f"beyond {HORIZON_TOL} of JAX's; host per image: JPEG decode "
                f"{dec_s / MINI_N_EVAL * 1e3:.1f} ms, "
                + ("no LSD" if detect
                   else f"LSD {lsd_s / MINI_N_EVAL * 1e3:.1f} ms")
                + f"; {stage_line}, first batch included, at batch "
                f"{MINI_BATCH}; driver wall {wall_s:.1f} s for "
                f"{len(records)} records ({card})")
            check(abs(auc - jax_auc) <= AUC_TOL,
                  f"mini {run}: AUC {auc} vs JAX {jax_auc}")
            # the goldens are the host path's; with --device_detect the
            # York Urban mini's image P1031 is a knife-edge scene (JAX's own
            # error 0.0775) that puts the AUC 0.018 from the golden, 0.002
            # inside the gate, so that run is held to JAX's AUC on the same
            # files only
            check(detect or abs(auc - MINI_GOLDEN[name]) <= AUC_TOL,
                  f"mini {run}: AUC {auc} vs golden {MINI_GOLDEN[name]}")
            check(len(far) <= MINI_MAX_FAR,
                  f"mini {run}: {len(far)} horizons beyond the gate")
    if failed:
        raise AssertionError(f"miniset phase: {failed}")


def compat_phase(card: str, kernels_all, sph_k, total: dict, params, mean,
                 bundle: dict, ref_hp1, ref_hp2) -> None:
    """The reference-shaped one-image entry points on one scene's LSD lines
    (``bundle`` from ``Pipeline.ingest``), with the default device."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.em import compat
    from vanishing_points_2017_tpu_torch.em.horizon import \
        calculate_horizon_and_ortho_vp
    from vanishing_points_2017_tpu_torch.ops import sphere

    n, n_pad = int(bundle["lmask"].sum()), int(bundle["l"].shape[0])
    lines, seg = bundle["l"][:n], bundle["lp"][:n]  # the main path's own
    reset(kernels_all)
    t0 = time.perf_counter()
    img, pred = compat.renew_cnn_result(params, mean, lines)
    renders = sph_k.launches
    res = compat.run_em_single(lines, seg, pred, img, n_pad=n_pad)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count(kernels_all, total, "compat", need=(sph_k,))
    if renders != 1:
        raise AssertionError(f"renew_cnn_result: {renders} K2 launches")
    # the image this path rendered on the card against the plain twin on
    # the same (1, 512, 3) padded lines
    padded = np.zeros((1, max(512, 1 << (n - 1).bit_length()), 3),
                      np.float32)
    padded[0, :n] = lines[:, :3]
    twin = sphere.sphere_render_ref(
        torch.from_numpy(padded).cuda(),
        torch.from_numpy(np.arange(padded.shape[1]) < n)[None].cuda(),
        img.shape[0])
    du8 = np.abs(torch.floor(twin[0] * 255).cpu().numpy().astype(np.int32)
                 - img.astype(np.int32))
    log(f"compat K2 B=1 {padded.shape[1:]}: uint8 max {int(du8.max())} on "
        f"{float((du8 > 0).mean()):.2e} of pixels against the plain twin")
    if not (du8.max() <= 1 and (du8 > 0).mean() <= K2_U8_FRAC):
        raise AssertionError("compat: K2's image disagrees with its twin")
    keys = ["vp", "vp_assoc", "counts", "counts_weighted", "count_id",
            "decision_metric", "sigma", "iterations", "distribution"]
    if list(res) != keys or res["vp"] is None:
        raise AssertionError(f"run_em_single: keys {list(res)}")
    m = res["vp"].shape[0]
    dist = res["distribution"]
    shapes_ok = (
        img.shape == (500, 500) and img.dtype == np.uint8
        and pred.shape == (20, 20) and res["vp"].shape == (m, 3)
        and res["vp_assoc"].shape == (n,) and res["counts"].shape == (m,)
        and res["sigma"].shape == (m,)
        and res["decision_metric"].shape[0] == m
        and dist.lv.shape == (n, m) and dist.vl.shape == (m, n)
        and dist.l.shape == (n,) and dist.angles.shape == (m, 2)
        and int(res["vp_assoc"].max()) < m)
    finite = all(bool(np.isfinite(getattr(dist, f)).all())
                 for f in dist._fields)
    t = [torch.from_numpy(np.asarray(a, np.float32))[None]
         for a in (res["vp"], res["counts"])]
    hp1, hp2, *_ = calculate_horizon_and_ortho_vp(
        t[0], t[1], torch.ones((1, m), dtype=torch.bool))
    e_jax = horizon_err(hp1[0], hp2[0], ref_hp1, ref_hp2)
    log(f"compat scene 0: {n} lines, {m} VPs after {res['iterations']} EM "
        f"iterations, counts {res['counts'].astype(int).tolist()[:6]}; "
        f"shapes ok {shapes_ok}, distribution finite {finite}; horizon err "
        f"vs JAX {e_jax:.5f}; renew_cnn_result + run_em_single "
        f"{wall * 1e3:.0f} ms ({card})")
    if not (shapes_ok and finite and e_jax <= HORIZON_TOL):
        raise AssertionError("compat phase: see the line above")


def caffe_phase(dev, card: str, cfg, sphere_u8) -> None:
    """The shipped weights as Caffe artifacts at full width, there and
    back; ``sphere_u8`` are the bundled scenes' sphere images on the card."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import weights as W
    from vanishing_points_2017_tpu_torch.models import caffe_export
    from vanishing_points_2017_tpu_torch.models import cnn as cnn_mod
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline

    before = assets_mtimes()
    params, mean = W.load_params_and_mean()
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "weights.caffemodel")
        mpath = os.path.join(tmp, "mean.binaryproto")
        t0 = time.perf_counter()
        caffe_export.params_to_caffemodel(params, wpath)
        caffe_export.mean_to_binaryproto(mean, mpath)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(wpath)
        t0 = time.perf_counter()
        cparams, cmean = W.load_params_and_mean(wpath, mpath)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        fingerprints = (W.weights_identity(wpath), W.mean_identity(mpath))
    if not (cparams["fc6"]["w"].is_cuda and cmean.is_cuda
            and tuple(cparams["fc6"]["w"].shape) == (57600, 4096)
            and "none" not in fingerprints):
        raise AssertionError("Caffe import: fc6 is not the dense matrix on "
                             "the card")
    # the same densified parameters without the files: the exporter's
    # host product u @ v, through params_from_numpy
    arrays = W.params_to_numpy(params)
    for layer in arrays.values():
        if "u" in layer:
            layer["w"] = layer.pop("u") @ layer.pop("v")
    dense = W.params_from_numpy(arrays, dev)
    del arrays
    with torch.inference_mode():
        grids = [Pipeline(p, m, cfg).model(cnn_mod.preprocess(sphere_u8, m))
                 for p, m in ((cparams, cmean), (dense, mean), (params, mean))]
    same = torch.equal(grids[0], grids[1]) and torch.equal(cmean, mean)
    finite = bool(torch.isfinite(grids[0].float()).all())
    after = assets_mtimes()
    log(f"Caffe at full width: .caffemodel of {size / 1e9:.3f} GB exported "
        f"in {export_s:.1f} s, loaded to the card in {import_s:.1f} s; CNN "
        f"grids of the 4 scenes bit-identical to the densified parameters "
        f"used directly: {same}; max |d| to the factorized weights' grids "
        f"{float((grids[0].float() - grids[2].float()).abs().max()):.3g}; "
        f"assets/ untouched: {after == before} ({card})")
    if not (same and finite and after == before
            and tuple(grids[0].shape) == (4, 20, 20)):
        raise AssertionError("Caffe phase: see the line above")


def wide_grid_phase(dev, card: str, pipe, kernels_all, total: dict,
                    ld) -> dict:
    """K1 past 1024 columns (its wide kernel): bit-exact against the twin
    on random planes at WIDE_WIDTHS and on drawn-line 720p / 1080p
    gradient grids at B = 4, timed there; then one 1280 x 720 frame
    through ``process_images``. Returns the times by grid."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.data.datasets import \
        render_scene_image_wh
    from vanishing_points_2017_tpu_torch.models import synth

    failed: list = []
    check = checker(failed)
    rng = np.random.default_rng(1)
    for w in WIDE_WIDTHS:
        packed = torch.from_numpy(rng.integers(0, 256, (2, 9, w)).astype(
            np.int32)).to(dev)
        packed[1] = 0xFF  # every edge set: one component per row band
        got = ld.connected_components_cuda(packed, 8)
        n_bad = int((got != ld.connected_components_ref(packed, 8)).sum())
        log(f"K1 B=2 (9, {w}): {n_bad} labels differ")
        check(n_bad == 0, f"K1 not bit-exact at W={w}")
    times = {}
    for width, height in ((1280, 720), (1920, 1080)):
        frames = [render_scene_image_wh(synth.make_scene(rng), width, height,
                                        rng) for _ in range(4)]
        packed = packed_of(ld, torch.from_numpy(np.stack(frames)).to(dev))
        got = ld.connected_components_cuda(packed, 8)
        n_bad = int((got != ld.connected_components_ref(packed, 8)).sum())
        ms = cuda_ms(lambda: ld.connected_components_cuda(packed, 8), 5)
        b_ms, by = bound(2 * packed.numel() * 4, 6 * 8 * packed.numel())
        times[f"{packed.shape[1]}x{packed.shape[2]}"] = (ms, b_ms, by)
        log(f"K1 B=4 {tuple(packed.shape[1:])}: {n_bad} labels differ; "
            f"kernel {ms:.3f} ms, bound {b_ms:.4f} ms ({by}) ({card})")
        check(n_bad == 0, f"K1 not bit-exact on {tuple(packed.shape[1:])}")
    # a 1280 x 720 frame through the entry point users call
    frame = render_scene_image_wh(synth.make_scene(rng), 1280, 720, rng)
    reset(kernels_all)
    out = pipe.process_images([frame])
    torch.cuda.synchronize()
    count(kernels_all, total, "1280x720 frame", need=kernels_all)
    fin = bool(torch.isfinite(out["hp1"]).all()
               and torch.isfinite(out["hp2"]).all())
    log(f"1280x720 frame through process_images: {int(out['segment_mask'][0].sum())} "
        f"segments, {int(out['alive'][0].sum())} VPs, horizon finite {fin}")
    check(fin, "1280x720 frame: non-finite horizon")
    if failed:
        raise AssertionError(f"wide-grid phase: {failed}")
    return times


def _rank_setup(init_method: str):
    """A rank of the parallel phase: gloo over the shared card, the kernels
    loaded from the builds under build/, the shipped weights, and the four
    scenes tiled to BATCH on the card."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import kernels
    from vanishing_points_2017_tpu_torch.parallel import distributed
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline
    from vanishing_points_2017_tpu_torch.weights import load_params_and_mean

    dev = distributed.initialize(init_method, backend="gloo")
    kernels_all = kernels.all_kernels()
    for k in kernels_all:
        k.build()
    params, mean = load_params_and_mean(device=dev)
    grays = [Pipeline.ingest_image(p)["gray"] for p in SCENES]
    imgs = torch.from_numpy(np.stack([grays[i % 4] for i in range(BATCH)]))
    return dev, kernels_all, params, mean, imgs.to(dev)


def _serve(mesh, model, mean, imgs, kernels_all) -> dict:
    """One sharded serving run: this rank's launches and wall seconds, and
    on rank 0 the outputs gathered over dp (numpy)."""
    import torch
    import torch.distributed as dist

    from vanishing_points_2017_tpu_torch.parallel import mesh as pm
    from vanishing_points_2017_tpu_torch.parallel.inference import \
        sharded_pipeline_full
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    reset(kernels_all)
    dist.barrier()
    t0 = time.perf_counter()
    out = sharded_pipeline_full(mesh, imgs, model, mean, PipelineConfig())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.source: k.launches for k in kernels_all}
    full = pm.gather_outputs(out, mesh)
    res = {"launches": launches, "wall_s": wall}
    if dist.get_rank() == 0:
        res["out"] = {k: v.cpu().numpy() for k, v in full.items()}
    return res


def rank_two(init_method: str, lsim_path: str) -> dict:
    """2 ranks: serving at (dp, tp) = (2, 1) and (1, 2) on the scenes tiled
    to b32, and the sharded lsim at N = LSIM_N (rank 0 returns it
    gathered)."""
    import torch

    from vanishing_points_2017_tpu_torch.parallel import mesh as pm
    from vanishing_points_2017_tpu_torch.parallel import tp as ptp
    from vanishing_points_2017_tpu_torch.parallel.sharded_lsim import \
        calc_lsim_sharded
    from vanishing_points_2017_tpu_torch.pipeline import (PipelineConfig,
                                                           build_model)

    dev, kernels_all, params, mean, imgs = _rank_setup(init_method)
    model = build_model(params, PipelineConfig())
    res = {}
    for dp, tp in ((2, 1), (1, 2)):
        mesh = pm.make_mesh(dp=dp, tp=tp)
        res[f"{dp}x{tp}"] = _serve(
            mesh, ptp.shard_model(model, mesh) if tp > 1 else model, mean,
            imgs, kernels_all)
    lp, mask = (t.to(dev) for t in torch.load(lsim_path))
    mesh = pm.make_mesh(dp=2, tp=1)
    strip = calc_lsim_sharded(lp, mask, mesh, 1.0)
    full = pm.gather_outputs(strip, mesh)
    if torch.distributed.get_rank() == 0:
        res["lsim"] = full.cpu()
    return res


def rank_four(init_method: str, train_path: str) -> dict:
    """4 ranks: serving at (2, 2) on the scenes tiled to b32, then one
    float32 train step of the compact weights on a 2 x 2 mesh (rank 0
    returns the loss and the parameters gathered)."""
    import torch

    from vanishing_points_2017_tpu_torch.models import train
    from vanishing_points_2017_tpu_torch.parallel import mesh as pm
    from vanishing_points_2017_tpu_torch.parallel import tp as ptp
    from vanishing_points_2017_tpu_torch.pipeline import (PipelineConfig,
                                                           build_model)

    dev, kernels_all, params, mean, imgs = _rank_setup(init_method)
    mesh = pm.make_mesh(dp=2, tp=2)
    model = ptp.shard_model(build_model(params, PipelineConfig()), mesh)
    res = {"2x2": _serve(mesh, model, mean, imgs, kernels_all)}
    del model
    x, y, keep = (v.to(dev) if isinstance(v, torch.Tensor)
                  else [k.to(dev) for k in v]
                  for v in torch.load(train_path))
    state = train.init_state(params, mesh=mesh)
    state.model.compute_dtype = torch.float32
    xs, ys = pm.shard_batch([x, y], mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = train.train_step(state, xs, ys, keep=keep, mesh=mesh)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    got = pm.gather_params(state.model.params(), mesh)
    if torch.distributed.get_rank() == 0:
        res["loss"] = float(loss)
        res["params"] = {n: {k: v.detach().cpu() for k, v in d.items()}
                         for n, d in got.items()}
    return res


def parallel_phase(dev, card: str, kernels_all, total: dict, params, mean,
                   out32, jax_ref) -> dict:
    """The parallel/ package on the card: ranks that share it over gloo
    (spawned by ``parallel.launch.run_ranks``), then one nccl rank. Returns
    each kernel's launches in the sharded serving runs, all ranks summed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vanishing_points_2017_tpu_torch.models import train
    from vanishing_points_2017_tpu_torch.ops.lines import calc_lsim
    from vanishing_points_2017_tpu_torch.parallel import distributed
    from vanishing_points_2017_tpu_torch.parallel import mesh as pm
    from vanishing_points_2017_tpu_torch.parallel.inference import \
        sharded_pipeline_full
    from vanishing_points_2017_tpu_torch.parallel.launch import run_ranks
    from vanishing_points_2017_tpu_torch.pipeline import (Pipeline,
                                                           PipelineConfig)

    failed: list = []
    check = checker(failed)
    log("parallel phase: ranks share one card over gloo with CUDA tensors; "
        "their wall times are information only and say nothing about "
        f"scaling ({card})")
    sharded = {k.source: 0 for k in kernels_all}

    def tally(name: str, runs: list) -> None:
        """Every rank must have launched both kernels in its run."""
        for r, run in enumerate(runs):
            for src, n in run["launches"].items():
                sharded[src] += n
                check(n >= 1, f"{name} rank {r}: {src} not launched")
        log(f"sharded {name}: launches {[run['launches'] for run in runs]}; "
            f"wall {max(run['wall_s'] for run in runs):.2f} s ({card})")

    def equal_outputs(name: str, got: dict) -> None:
        """Every output key equal to the single-process b32 run's."""
        same = [k for k in out32 if k in got
                and np.array_equal(got[k], out32[k])]
        log(f"sharded {name}: {len(same)} of {len(out32)} output keys "
            "equal to the single-process b32 run")
        check(set(got) == set(out32) and len(same) == len(out32),
              f"sharded {name}: differ in {sorted(set(out32) - set(same))}")

    def horizons(name: str, out: dict) -> None:
        worst = max(horizon_err(out["hp1"][i], out["hp2"][i],
                                jax_ref["hp1"][i % 4], jax_ref["hp2"][i % 4])
                    for i in range(BATCH))
        grid = float(np.abs(out["cnn_prediction"].astype(np.float32)
                            - out32["cnn_prediction"].astype(np.float32)
                            ).max())
        log(f"sharded {name}: CNN grid max |d| {grid:.3g} to the single "
            f"process (gate {TP_GRID_TOL}); worst horizon err vs JAX "
            f"{worst:.5f} over {BATCH} tiles")
        check(grid <= TP_GRID_TOL, f"sharded {name}: CNN grid")
        check(worst <= HORIZON_TOL, f"sharded {name}: horizons")

    # inputs: random segments for the lsim, the train step's batch and the
    # masks drawn for it, and the single-process step on them
    rng = np.random.default_rng(3)
    lp = torch.from_numpy(rng.uniform(-1, 1, (LSIM_N, 4)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=LSIM_N) < 0.9)
    x, y = train.make_batch(np.random.default_rng(2), BATCH, mean,
                            device=dev)
    state = train.init_state(params)
    state.model.compute_dtype = torch.float32
    keep = train.dropout_masks(state.model, BATCH,
                               train.step_generator(1, 0, dev))
    want_loss = float(train.train_step(state, x, y, keep=keep))
    want = {n: {k: v.detach().cpu() for k, v in d.items()}
            for n, d in state.model.params().items()}
    del state
    with tempfile.TemporaryDirectory() as tmp:
        lsim_path = os.path.join(tmp, "lsim.pt")
        train_path = os.path.join(tmp, "train.pt")
        torch.save((lp, mask), lsim_path)
        torch.save((x.cpu(), y.cpu(), [k.cpu() for k in keep]), train_path)
        for world, fn, arg in ((2, rank_two, lsim_path),
                               (4, rank_four, train_path)):
            work = os.path.join(tmp, f"ranks{world}")
            os.makedirs(work)
            t0 = time.perf_counter()
            res = run_ranks(fn, world, (arg,), work_dir=work,
                            timeout=RANK_TIMEOUT, threads=2)
            log(f"{world} ranks: {time.perf_counter() - t0:.1f} s, start-up "
                "and kernel loads included")
            if world == 2:
                tally("serving dp=2 tp=1", [r["2x1"] for r in res])
                equal_outputs("dp=2 tp=1", res[0]["2x1"]["out"])
                tally("serving dp=1 tp=2", [r["1x2"] for r in res])
                horizons("dp=1 tp=2", res[0]["1x2"]["out"])
                dense = calc_lsim(lp.to(dev), mask.to(dev), 1.0).cpu()
                err = float((res[0]["lsim"] - dense).abs().max())
                log(f"sharded lsim N={LSIM_N} over 2 ranks: max |d| {err:.3g} "
                    "to the dense calc_lsim")
                check(err <= 2e-6, "sharded lsim")
            else:
                tally("serving dp=2 tp=2", [r["2x2"] for r in res])
                horizons("dp=2 tp=2", res[0]["2x2"]["out"])
                rel = abs(res[0]["loss"] - want_loss) / abs(want_loss)
                worst = max(
                    float((res[0]["params"][n][k] - v).abs().max()
                          / v.abs().max().clamp_min(1e-30))
                    for n, d in want.items() for k, v in d.items())
                log(f"sharded train step 2x2 b{BATCH} float32 (compact): loss "
                    f"{res[0]['loss']:.6f} vs single process {want_loss:.6f} "
                    f"(rel {rel:.2e}); updated parameters max |d| / max |p| "
                    f"{worst:.2e}; step {max(r['train_s'] for r in res):.2f} "
                    f"s ({card})")
                check(rel <= 1e-5, "sharded train step: loss")
                check(worst <= 1e-5, "sharded train step: parameters")

        # one nccl rank through the sharded serving path (NCCL's code path;
        # one rank per card) on the b32 batch: every output key equal to
        # the single-process run's
        store = "file://" + os.path.join(tmp, "nccl_store")
        distributed.initialize(store, world_size=1, rank=0, backend="nccl")
        try:
            mesh = pm.make_mesh(dp=1, tp=1)
            grays = [Pipeline.ingest_image(p)["gray"] for p in SCENES]
            imgs = torch.from_numpy(np.stack(
                [grays[i % 4] for i in range(BATCH)])).to(dev)
            reset(kernels_all)
            out = pm.gather_outputs(sharded_pipeline_full(
                mesh, imgs, Pipeline(params, mean).model, mean,
                PipelineConfig()), mesh)
            torch.cuda.synchronize()
            launches = {k.source: k.launches for k in kernels_all}
            for src, n in launches.items():
                sharded[src] += n
                check(n >= 1, f"nccl rank: {src} not launched")
            log(f"one nccl rank ({dist.get_backend()}): launches {launches}")
            equal_outputs(f"{dist.get_backend()} dp=1",
                          {k: v.cpu().numpy() for k, v in out.items()})
        finally:
            dist.destroy_process_group()
    if failed:
        raise AssertionError(f"parallel phase: {failed}")
    for src, n in sharded.items():
        total[src] = total.get(src, 0) + n
    return sharded


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
    from vanishing_points_2017_tpu_torch.data import jpeg
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
    # process), the host LSD and the JPEG entropy coder (g++) beside them
    ccl_k, sph_k = kernels_all = kernels.all_kernels()
    total: dict = {}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(k.build) for k in kernels_all]
        lsd_build = pool.submit(lsd.detect_line_segments,
                                np.zeros((8, 8)))
        jpeg_build = pool.submit(jpeg.encode_jpeg,
                                 np.zeros((8, 8), np.uint8))
        for k, fut in zip(kernels_all, builds):
            log(f"build {k.source}: {fut.result():.2f} s")
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
        lsd_build.result()
        jpeg_build.result()
    log(f"builds done in {time.perf_counter() - t0:.2f} s (host LSD and "
        "JPEG coder included)")

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
    for b in (1, 4, BATCH):
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

    # ---- K1's wide kernel: grids past 1024 columns, a 1280x720 frame
    t0 = time.perf_counter()
    wide_ms = wide_grid_phase(dev, card, pipe, kernels_all, total, ld)
    log(f"wide-grid phase: {time.perf_counter() - t0:.1f} s")

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

    # ---- the training path: parity with JAX, dense and compact training
    # at b32, and the two drivers
    t0 = time.perf_counter()
    per_step = training_phase(dev, card, kernels_all, sph_k, total, grays)
    log(f"training phase: {time.perf_counter() - t0:.1f} s")

    # ---- the real data sets' path on the three minis, both detectors
    t0 = time.perf_counter()
    miniset_phase(dev, card, kernels_all, ccl_k, sph_k, total, ld)
    log(f"miniset phase: {time.perf_counter() - t0:.1f} s")

    # ---- the reference-shaped entry points on scene 0's LSD lines
    compat_phase(card, kernels_all, sph_k, total, params, mean, bundles[0],
                 host_ref["host_hp1"][0], host_ref["host_hp2"][0])

    # ---- Caffe artifacts at full width, there and back
    t0 = time.perf_counter()
    caffe_phase(dev, card, cfg, out["sphere_image"])
    log(f"Caffe phase: {time.perf_counter() - t0:.1f} s")

    # ---- parallel/: sharded serving, training and lsim in ranks sharing
    # the card, then one nccl rank
    t0 = time.perf_counter()
    per_sharded = parallel_phase(
        dev, card, kernels_all, total, params, mean,
        {k: v.cpu().numpy() for k, v in out32.items()}, jax_ref)
    log(f"parallel phase: {time.perf_counter() - t0:.1f} s")

    # no single PyTorch call computes either function: library_ms is null
    kernel_info = [
        dict(name="ccl_raster", route="cuda",
             source="vanishing_points_2017_tpu_torch/csrc/ccl_raster.cu",
             replaces="vanishing_points_2017_tpu/ops/ccl_pallas.py:44",
             launches=total[ccl_k.source],
             launches_per_batch=per_batch[ccl_k.source],
             launches_per_train_step=per_step[ccl_k.source],
             launches_sharded=per_sharded[ccl_k.source],
             ms_by_wide_grid={g: t[0] for g, t in wide_ms.items()},
             library_ms=None, **records["ccl_raster"]),
        dict(name="sphere_render", route="cuda",
             source="vanishing_points_2017_tpu_torch/csrc/sphere_render.cu",
             replaces="vanishing_points_2017_tpu/ops/sphere_pallas.py:53",
             launches=total[sph_k.source],
             launches_per_batch=per_batch[sph_k.source],
             launches_per_train_step=per_step[sph_k.source],
             launches_sharded=per_sharded[sph_k.source],
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
