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
* progressive JPEG: every file of ``assets/examples/progressive/``
  (PIL's progressive saves, ``scripts/make_progressive_fixtures.py``)
  decodes to the JAX package's pixels (the committed digests), the 4:2:0
  and gray ones also to the port's own baseline write of the same array;
  the host decode is timed, progressive against baseline of the same
  array, at 640x480 and 1024x768; then the York Urban mini (2 evaluated
  images) with the two progressive photographs in place of its evaluated
  files runs through ``benchmark.main`` on both paths (host LSD, and
  ``--device_detect``): every horizon and the AUC within 0.02 of JAX's on
  the same files;
* the other JPEG forms: every file of ``assets/examples/jpeg_forms/``
  (``scripts/make_jpeg_forms_fixtures.py``: sampling ratios, CMYK and
  YCCK, block-smoothed progressive files, arithmetic coding, lossless)
  decodes to the JAX package's pixels (the committed digests) by the
  decode path its form names; each 640x480 form is timed against the
  port's baseline write of the same array; then the same mini with P1026
  as YCCK (2x2 Y and K) and then as h1v2 runs through ``benchmark.main``
  on both paths: every horizon and the AUC within 0.02 of JAX's;
* WebP: every file of ``assets/examples/webp/``
  (``scripts/make_webp_fixtures.py``: lossy at every filter, segment and
  partition setting, lossless with every transform and palette size,
  alpha, extended and animated files) decodes to the JAX package's pixels
  (the committed digests) and ``image_size`` gives PIL's size; each
  640x480 file is timed against the port's baseline JPEG write of the same
  array at the same quality; then the same mini with P1026 as lossy and
  then as lossless WebP (under its ``.jpg`` name) runs through
  ``benchmark.main`` on both paths: the AUC within 0.02 of JAX's and at
  most 1 horizon beyond 0.02 of JAX's;
* the reference-shaped entry points (``em/compat.py``): ``renew_cnn_result``
  and ``run_em_single`` on bundled scene 0's LSD lines (K2 launched once,
  the horizon of the returned VPs within 0.02 of JAX's);
* Caffe artifacts at full width: the shipped weights exported (low-rank
  layers densified, fc6 57600 x 4096) as a ``.caffemodel`` and the mean as
  a ``.binaryproto``, both loaded through ``load_params_and_mean``, and the
  CNN's grids on the bundled scenes' sphere images bit-identical to those
  of the same densified parameters used directly;
* K1 at every width of its table (4, 8, 16 and 32 warps per image, the
  group kernel past 5120): the kernel it launches (as the profiler names
  it) changes at each width of ``K1_SWITCH_WIDTHS`` and nowhere between;
  bit-exact on random planes at every such width +-1 (127-5121) and 8192
  / 8193 at B = 1, 4 and 32, and on 720p / 1080p gradient grids at B = 4 and 32 (timed, with
  the time of a row step); a 1280x720 frame through ``process_images``;
  and the HD gate: the 4 1280x720 and 4 1920x1080 frames of
  ``assets/examples/jax_reference_hd.npz`` (re-rendered from their seeds,
  digests checked) through ``process_images`` at batch 4 per shape, at
  most 1 of 8 horizons beyond 0.02 of JAX's;
* the accuracy harnesses (``vanishing_points_2017_tpu_torch.tools``) on
  the same 50 scenes, against ``assets/examples/jax_reference_tools.npz``:
  the knife-edge flip protocol (K = 8 jitters of sigma 0.5 px, 2%
  dropout, ``default_rng(11)`` per probe) on JAX's five pinned scenes with
  the single EM and with consensus K = 8, at most JAX's flips (0 of 8);
  the host / full / ideal-prior AUC decomposition at batch 10 (each AUC
  within 0.02 of JAX's, at most 2 of 50 horizons beyond 0.02; host and
  full bit-identical to the synthetic run at batch 8); the detector
  re-validation gate with ``--skip_pins``; the detector's sub-stage times
  and ``profile_e2e``'s round trip, detector, post-detector program and
  price of one EM iteration (information only);
* the throughput bench (``python -m vanishing_points_2017_tpu_torch.bench``)
  through its measurement at b32 / 640x640 on its synthetic scenes (8
  batches a loop, 3 repeats): the record's keys, platform and card; the
  pipelined, serial and compute-only loops' horizons bit-identical to each
  other and to ``Pipeline.process_images`` on the same images, at most 2
  of 32 beyond 0.02 of JAX's on the same scenes
  (``assets/examples/jax_reference_bench.npz``), both kernels launched;
* the EM against the JAX EM's own batch-1 trajectory
  (``assets/examples/jax_reference_em.npz``,
  ``scripts/make_jax_reference_em.py``): the 21 populations' JAX stage
  inputs through ``em_and_horizon`` at the main path's chunk of 32 after
  1, 2, 3 and 100 iterations, every end horizon within 0.02 of JAX's (the
  agreement on iterations, alive sets and VPs is printed per checkpoint,
  not gated: the card sums in other orders than either CPU run); then
  bench scene 25 (device path) and P1026 (host path) traced stage by
  stage against JAX's stage outputs (segments, K2 on JAX's lines, the CNN
  on JAX's sphere image, the EM on JAX's inputs, the horizon), with the
  first stage that departs by more than float noise;
* the JAX package's other configurations
  (``assets/examples/jax_reference_options.npz``,
  ``scripts/make_jax_reference_options.py``): K1 at 2 and 16 passes
  bit-exact against its twin at B = 4 (and the 2-pass fixpoint residual
  equal to the twin's); the detector's row selection, prefilter caps,
  approximate top-k, ``tol_deg``, ``blur_sigma``, ``pair_tol_factor`` and
  ``ccl_passes`` (with ``check_fixpoint``) on four bench scenes against
  JAX's (valid counts within 1, matched segments within 1e-3, NaN where
  JAX's are); ``EMConfig(loop="phase")`` on JAX's EM inputs within 0.02
  of JAX's phase loop; at b32 the row selection and the phase loop bit
  for bit against the global selection and the uniform loop; the stage
  split of each configuration (information only);
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
``launches_bench`` the bench phase's (every loop, warm-up and stage pass),
``launches_progressive`` the progressive phase's two driver runs,
``launches_jpeg_forms`` the jpeg-forms phase's four driver runs,
``launches_webp`` the webp phase's four driver runs,
``launches_tools`` the tools phase's (probes, paths, gate and profiles),
``launches_hd`` the HD gate's, ``launches_em_trajectory`` the
em-trajectory phase's (the traced frames' own paths and K2 on JAX's
lines), ``launches_options`` the options phase's (K1's comparison
launches excluded), K1's ``ms_by_wide_grid`` its time at
B = 4 and 32 on 720p and 1080p gradient grids (``plain_ms_by_wide_grid``
the twin's at B = 4, ``bound_ms_by_wide_grid`` the bound) and
``us_per_row_step`` the time of one row step there and on the main
path's grid (ms over 8 half passes x H rows), and ``bound_ms`` is the
least time the card could take for the timed call's work (bytes over
the memory rate or operations over the float32 rate, whichever is
larger).
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
import re
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
BENCH_REFERENCE = os.path.join(ROOT, "assets", "examples",
                               "jax_reference_bench.npz")
PROG_REFERENCE = os.path.join(ROOT, "assets", "examples",
                              "jax_reference_progressive.npz")
PROG_DIR = os.path.join(ROOT, "assets", "examples", "progressive")
TOOLS_REFERENCE = os.path.join(ROOT, "assets", "examples",
                               "jax_reference_tools.npz")
HD_REFERENCE = os.path.join(ROOT, "assets", "examples",
                            "jax_reference_hd.npz")
EM_REFERENCE = os.path.join(ROOT, "assets", "examples",
                            "jax_reference_em.npz")
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
# the progressive phase: the York Urban mini's evaluated images (seed 101,
# 2 evaluated), its runs (name in the reference -> --device_detect), the
# fixtures timed against their baseline twins, decodes per timing
PROG_PHOTOS = ("P1026", "P1027")
PROG_RUNS = {"york": False, "york_dev": True}
PROG_TIMED, PROG_DECODES = ("P1026", "P1026_1024"), 5
# the jpeg-forms phase: the fixtures of scripts/make_jpeg_forms_fixtures.py
# and, per driven photograph, the fixture that takes P1026's place in the
# same mini (run prefix in the reference -> file)
FORMS_REFERENCE = os.path.join(ROOT, "assets", "examples",
                               "jax_reference_jpeg_forms.npz")
FORMS_DIR = os.path.join(ROOT, "assets", "examples", "jpeg_forms")
FORMS_DRIVEN = {"ycck": "P1026_ycck", "h1v2": "P1026_h1v2"}
# the webp phase: the fixtures of scripts/make_webp_fixtures.py (which also
# makes the colour array of the timed colour file) and, per driven
# photograph, the file that takes P1026's place in the same mini
WEBP_REFERENCE = os.path.join(ROOT, "assets", "examples",
                              "jax_reference_webp.npz")
WEBP_DIR = os.path.join(ROOT, "assets", "examples", "webp")
WEBP_SCRIPT = os.path.join(ROOT, "scripts", "make_webp_fixtures.py")
WEBP_DRIVEN = {"lossy": "P1026_lossy", "lossless": "P1026_lossless"}
# the bench phase: batches per loop, repeats, and how many of its 32
# horizons may lie beyond HORIZON_TOL of JAX's (the synthetic protocol's
# knife-edge allowance)
BENCH_ITERS, BENCH_REPEATS, BENCH_MAX_FAR = 8, 3, 2
# what the bench record must hold, beside the JAX record's own keys
BENCH_KEYS = ("serial_images_per_sec", "compute_images_per_sec",
              "fused_device_images_per_sec", "host_lsd_ms_per_image",
              "flops_per_image", "mfu_estimate", "power_limit", "stage_ms",
              "em_host_syncs", "device_idle_share", "top_kernels",
              "launches_per_batch", "spread", "first_call_s",
              "kernel_build_s")
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
# K1's switch widths: the last width of each (warps, columns per lane)
# variant of its width table (csrc/ccl_raster.cu, warps_for): 4 warps to
# 1024, 8 to 2048, 16 to 4096, 32 to 5120, the group kernel past it. The
# wide-grid phase checks on the card that the launched kernel changes at
# each and nowhere between them.
K1_SWITCH_WIDTHS = (128, 256, 384, 512, 640, 768, 896, 1024, 1280, 1536,
                    1792, 2048, 2560, 3072, 3584, 4096, 5120)
# K1's random planes: each switch width +-1, 720p's and 1080p's gradient
# widths, 4031, 8192 and 8193 (the group kernel), at these batches;
# the HD gate's batch and how many of its 8 horizons may lie beyond
# HORIZON_TOL of JAX's (the EM's knife edge)
WIDE_EXTRA = (1279, 1919, 4031, 8192, 8193)
WIDE_BATCHES = (1, 4, 32)
HD_BATCH, HD_MAX_FAR = 4, 1
# the parallel phase: the tp CNN's grid against the single process (bf16
# products, fc7's sums split over tp), the sharded lsim's N, and a
# deadline per group of ranks
TP_GRID_TOL = 2e-2
LSIM_N = 2048
RANK_TIMEOUT = 300
# the tools phase: tests/test_knife_edge.py's flip protocol (a fresh
# default_rng(11) per probe, K jitters of sigma 0.5 px at 640, 2% dropout,
# a flip is a horizon error above 0.10) on JAX's five pinned scenes, the
# consensus K of the consensus probes, and the decomposition's batch
KNIFE_SCENES, KNIFE_K, KNIFE_SEED = (12, 15, 27, 31, 38), 8, 11
KNIFE_SIGMA_PX, KNIFE_DROP, KNIFE_GATE = 0.5, 0.02, 0.10
KNIFE_CONSENSUS, TOOLS_BATCH = 8, 10
# the em-trajectory phase: the oracle's checkpoints (num_iter), the VP
# agreement it prints (1 - |cos|), the bench scene it traces, and float
# noise per traced stage: the CPU detector test's endpoint gap
# (tests/test_torch_detector.py, normalized units; the count may differ
# by 1) and the bf16 CNN test's grid gate (tests/test_torch_cnn.py)
EM_CHECKPOINTS = (("it1", 1), ("it2", 2), ("it3", 3), ("end", 100))
EM_VP_TOL, EM_BENCH_SCENE = 1e-6, 25
SEG_GAP_TOL, GRID_TOL = 1e-3, 2e-2
# the options phase: JAX's outputs under the detector's other arguments
# and its phase loop (scripts/make_jax_reference_options.py, whose
# VARIANTS table the phase runs; the script imports JAX only inside its
# functions), K1's other pass counts, the stage split's repeats
OPTIONS_SCRIPT = os.path.join(ROOT, "scripts",
                              "make_jax_reference_options.py")
OPTIONS_REFERENCE = os.path.join(ROOT, "assets", "examples",
                                 "jax_reference_options.npz")
OPTION_PASSES, OPTION_REPEATS, OPTION_ROUNDS = (2, 16), 3, 8


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


def horizon_err(hp1, hp2, ref_hp1, ref_hp2, shape=(640, 640)) -> float:
    """Normalized horizon error between two (hp1, hp2) pairs, at an
    image's (width, height)."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.data.io import \
        normalized_horizon_error

    def line(a, b):
        return np.cross(*(torch.as_tensor(x).cpu().double().numpy()
                          for x in (a, b)))

    return normalized_horizon_error(line(hp1, hp2), line(ref_hp1, ref_hp2),
                                    *shape)


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


def detected_lines(pkg, imgs, cfg):
    """K2's input on the main path: the device detector's homogeneous
    lines and their mask under ``cfg``, (B, n_pad, 3) and (B, n_pad),
    contiguous (``pkg`` is the port's package)."""
    import torch

    with torch.inference_mode():
        seg, mask = pkg.ops.lines_device.detect_segments_device(
            imgs, **cfg.det_kwargs())
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


def progressive_phase(card: str, kernels_all, ccl_k, sph_k,
                      total: dict) -> dict:
    """Progressive JPEG files through the decoder and both serving paths,
    held against ``assets/examples/jax_reference_progressive.npz``. Every
    check runs and logs before the phase fails on the first that did not
    hold. Returns the phase's launches per kernel source."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import benchmark as bench
    from vanishing_points_2017_tpu_torch import weights as W
    from vanishing_points_2017_tpu_torch.data import datasets as dsets
    from vanishing_points_2017_tpu_torch.data import io as dio
    from vanishing_points_2017_tpu_torch.data import jpeg, minisets
    from vanishing_points_2017_tpu_torch.data.cache import StageCache
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    failed: list = []
    check = checker(failed)
    ref = np.load(PROG_REFERENCE)
    cfg = PipelineConfig()
    stage = "result_w" + W.weights_identity() + "_m" + W.mean_identity()
    phase: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "yud")
        minisets.make_mini_yud(root, n_eval=len(PROG_PHOTOS))
        # the arrays PIL saved progressive: the mini's baseline photographs
        # decoded, and P1026's resized to 1024x768
        sources = {n: dio.load_image(os.path.join(root, n, f"{n}.jpg"))
                   for n in PROG_PHOTOS}
        sources["P1026_1024"] = dio.resize_max(sources["P1026"], 1024)

        # ---- every fixture against JAX's pixels, and the baseline twins
        blobs = {}
        for name in (str(n) for n in ref["files"]):
            with open(os.path.join(PROG_DIR, f"{name}.jpg"), "rb") as fh:
                blobs[name] = fh.read()
            check(hashlib.sha256(blobs[name]).hexdigest()
                  == str(ref[f"file_sha256_{name}"]),
                  f"progressive {name}: not the committed file")
            px = dio.load_image(os.path.join(PROG_DIR, f"{name}.jpg"))
            same = (hashlib.sha256(np.ascontiguousarray(px).tobytes())
                    .hexdigest() == str(ref[f"sha256_{name}"])
                    and px.shape == tuple(ref[f"shape_{name}"]))
            src = (ref[f"array_{name}"] if f"array_{name}" in ref.files
                   else sources[name])
            twin = "none (the port writes 4:2:0 and gray only)"
            if int(ref[f"subsampling_{name}"]) in (-1, 2):
                base = jpeg.decode_jpeg(jpeg.encode_jpeg(
                    src, int(ref[f"quality_{name}"])))
                twin = str(base.shape == px.shape and (base == px).all())
                check(twin == "True", f"progressive {name}: pixels differ "
                      "from the port's baseline write of the same array")
            log(f"progressive {name} {px.shape}: pixels equal JAX's: "
                f"{same}; equal the baseline twin's: {twin}")
            check(same, f"progressive {name}: pixels differ from JAX's")

        # ---- host decode, progressive against baseline of the same array
        for name in PROG_TIMED:
            base = jpeg.encode_jpeg(sources[name],
                                    int(ref[f"quality_{name}"]))
            ms = {}
            for kind, blob in (("progressive", blobs[name]),
                               ("baseline", base)):
                jpeg.decode_jpeg(blob)
                times = []
                for _ in range(PROG_DECODES):
                    t0 = time.perf_counter()
                    jpeg.decode_jpeg(blob)
                    times.append((time.perf_counter() - t0) * 1e3)
                ms[kind] = statistics.median(times)
            h, w = sources[name].shape[:2]
            log(f"host decode {w}x{h}: progressive {ms['progressive']:.2f} "
                f"ms, baseline {ms['baseline']:.2f} ms per image (median "
                f"of {PROG_DECODES}; {len(blobs[name])} / {len(base)} "
                f"bytes) ({card})")

        # ---- the mini with the progressive photographs, both paths
        for name in PROG_PHOTOS:
            with open(os.path.join(root, name, f"{name}.jpg"), "wb") as fh:
                fh.write(blobs[name])
        adapter, target = dsets.DATASETS["york"]
        records, start = adapter(root)
        evaluated = records[start:]
        for run, detect in PROG_RUNS.items():
            res_dir = os.path.join(tmp, "results", run)
            cache = StageCache(os.path.join(res_dir, "york"),
                               bench.cache_key(cfg, detect))
            for rec in records[:start]:  # the skipped split: placeholders
                cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))
            argv = ["--yud", "--dataset_dir", root, "--result_dir", res_dir,
                    "--run_em", "--batch", str(len(PROG_PHOTOS))]
            argv += ["--device_detect"] if detect else []
            buf = io.StringIO()
            reset(kernels_all)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = bench.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            for k in kernels_all:
                phase[k.source] = phase.get(k.source, 0) + k.launches
            count(kernels_all, total, f"progressive {run}",
                  need=(ccl_k, sph_k) if detect else (sph_k,))
            text = buf.getvalue().splitlines()
            aucs = [float(ln.split()[-1]) for ln in text
                    if ln.startswith("AUC:")]
            n_err = sum(ln.startswith("max_error:") for ln in text)
            check(rc == 0 and len(aucs) == 1 and n_err == len(evaluated),
                  f"progressive {run}: exit {rc}, {n_err} max_error lines")
            if not aucs:
                log("\n".join(text[-20:]))
                continue
            errs = []
            for i, rec in enumerate(evaluated):
                check(str(ref[f"{run}_names"][i]) == rec.name,
                      f"progressive {run}: record {i} is {rec.name}")
                r = cache.load(rec.name, stage)
                errs.append(dio.normalized_horizon_error(
                    np.cross(r["hp1"].astype(np.float64),
                             r["hp2"].astype(np.float64)),
                    np.cross(ref[f"{run}_hp1"][i].astype(np.float64),
                             ref[f"{run}_hp2"][i].astype(np.float64)),
                    640, 480))
            jax_auc = float(ref[f"auc_{run}"])
            log(f"progressive {run}: AUC {aucs[0]:.5f} vs JAX "
                f"{jax_auc:.5f}; horizons from JAX's "
                f"{[round(float(e), 5) for e in errs]}; driver wall "
                f"{wall_s:.1f} s "
                f"for {len(records)} records ({card})")
            check(abs(aucs[0] - jax_auc) <= AUC_TOL,
                  f"progressive {run}: AUC {aucs[0]} vs JAX {jax_auc}")
            check(all(e <= HORIZON_TOL for e in errs),
                  f"progressive {run}: horizons {errs} beyond {HORIZON_TOL}")
    if failed:
        raise AssertionError(f"progressive phase: {failed}")
    return phase


def median_ms(decode, blob: bytes) -> float:
    """Median host ms of ``decode(blob)`` over PROG_DECODES calls after a
    warm-up."""
    decode(blob)
    times = []
    for _ in range(PROG_DECODES):
        t0 = time.perf_counter()
        decode(blob)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def drive_york_mini(what: str, root: str, driven: dict, blobs: dict, ref,
                    card: str, kernels_all, ccl_k, sph_k, total: dict,
                    phase: dict, check, tmp: str, max_far: int) -> None:
    """The York Urban mini at ``root`` with P1026's file replaced by each
    driven fixture's bytes (run prefix -> fixture; under the ``.jpg`` name
    the adapter globs) through ``benchmark.main`` on both paths, against
    the JAX package's runs in ``ref`` (``<prefix>_<run>_*``): the AUC
    within AUC_TOL of JAX's and at most ``max_far`` horizons beyond
    HORIZON_TOL. Adds each run's launches to ``phase``; K1 and K2 must
    launch on the device path, K2 on the host path."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import benchmark as bench
    from vanishing_points_2017_tpu_torch import weights as W
    from vanishing_points_2017_tpu_torch.data import datasets as dsets
    from vanishing_points_2017_tpu_torch.data import io as dio
    from vanishing_points_2017_tpu_torch.data.cache import StageCache
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    cfg = PipelineConfig()
    stage = "result_w" + W.weights_identity() + "_m" + W.mean_identity()
    adapter, _ = dsets.DATASETS["york"]
    for prefix, fixture in driven.items():
        with open(os.path.join(root, "P1026", "P1026.jpg"), "wb") as fh:
            fh.write(blobs[fixture])
        records, start = adapter(root)
        evaluated = records[start:]
        for run, detect in PROG_RUNS.items():
            key = f"{prefix}_{run}"
            res_dir = os.path.join(tmp, "results", key)
            cache = StageCache(os.path.join(res_dir, "york"),
                               bench.cache_key(cfg, detect))
            for rec in records[:start]:  # the skipped split
                cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))
            argv = ["--yud", "--dataset_dir", root, "--result_dir", res_dir,
                    "--run_em", "--batch", str(len(evaluated))]
            argv += ["--device_detect"] if detect else []
            buf = io.StringIO()
            reset(kernels_all)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = bench.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            for k in kernels_all:
                phase[k.source] = phase.get(k.source, 0) + k.launches
            count(kernels_all, total, f"{what} {key}",
                  need=(ccl_k, sph_k) if detect else (sph_k,))
            text = buf.getvalue().splitlines()
            aucs = [float(ln.split()[-1]) for ln in text
                    if ln.startswith("AUC:")]
            n_err = sum(ln.startswith("max_error:") for ln in text)
            check(rc == 0 and len(aucs) == 1 and n_err == len(evaluated),
                  f"{what} {key}: exit {rc}, {n_err} max_error lines")
            if not aucs:
                log("\n".join(text[-20:]))
                continue
            errs = []
            for i, rec in enumerate(evaluated):
                check(str(ref[f"{key}_names"][i]) == rec.name,
                      f"{what} {key}: record {i} is {rec.name}")
                r = cache.load(rec.name, stage)
                errs.append(dio.normalized_horizon_error(
                    np.cross(r["hp1"].astype(np.float64),
                             r["hp2"].astype(np.float64)),
                    np.cross(ref[f"{key}_hp1"][i].astype(np.float64),
                             ref[f"{key}_hp2"][i].astype(np.float64)),
                    640, 480))
            jax_auc = float(ref[f"auc_{key}"])
            log(f"{what} {key}: AUC {aucs[0]:.5f} vs JAX {jax_auc:.5f}; "
                f"horizons from JAX's {[round(float(e), 5) for e in errs]}; "
                f"driver wall {wall_s:.1f} s for {len(records)} records "
                f"({card})")
            check(abs(aucs[0] - jax_auc) <= AUC_TOL,
                  f"{what} {key}: AUC {aucs[0]} vs JAX {jax_auc}")
            check(sum(not e <= HORIZON_TOL for e in errs) <= max_far,
                  f"{what} {key}: horizons {errs}, more than {max_far} "
                  f"beyond {HORIZON_TOL}")


def jpeg_forms_phase(card: str, kernels_all, ccl_k, sph_k,
                     total: dict) -> dict:
    """The JPEG forms past 1x1 / 2x1 / 2x2 YCbCr and gray through the
    decoder and both serving paths, held against
    ``assets/examples/jax_reference_jpeg_forms.npz``: every fixture's
    pixels, the decode time per form at 640x480 against the port's
    baseline write of the same array, and the York Urban mini with P1026
    as YCCK and as h1v2. Every check runs and logs before the phase fails
    on the first that did not hold. Returns the phase's launches per
    kernel source."""
    import numpy as np

    from vanishing_points_2017_tpu_torch.data import io as dio
    from vanishing_points_2017_tpu_torch.data import jpeg, minisets

    failed: list = []
    check = checker(failed)
    ref = np.load(FORMS_REFERENCE)
    phase: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "yud")
        minisets.make_mini_yud(root, n_eval=len(PROG_PHOTOS))
        photo = os.path.join(root, "P1026", "P1026.jpg")
        source = dio.load_image(photo)

        # ---- every fixture against JAX's pixels, and the decode path the
        # form names
        blobs = {}
        for name in (str(n) for n in ref["files"]):
            path = os.path.join(FORMS_DIR, f"{name}.jpg")
            form = str(ref[f"form_{name}"])
            with open(path, "rb") as fh:
                blobs[name] = fh.read()
            check(hashlib.sha256(blobs[name]).hexdigest()
                  == str(ref[f"file_sha256_{name}"]),
                  f"jpeg-forms {name}: not the committed file")
            px = dio.load_image(path)
            shape = tuple(int(v) for v in ref[f"shape_{name}"])
            same = (hashlib.sha256(np.ascontiguousarray(px).tobytes())
                    .hexdigest() == str(ref[f"sha256_{name}"])
                    and px.shape == shape)
            frame = jpeg._parse(blobs[name]).frame
            path_ok = (("arithmetic" not in form or frame.arithmetic)
                       and ("lossless" not in form or frame.lossless)
                       and ("smooth" not in form
                            or jpeg._smoothing_ok(frame.comps)))
            log(f"jpeg-forms {name} {px.shape} ({form}): pixels equal "
                f"JAX's: {same}; decode path as named: {path_ok}")
            check(same, f"jpeg-forms {name}: pixels differ from JAX's")
            check(path_ok, f"jpeg-forms {name}: not decoded as {form}")
            check(dio.image_size(path) == shape[:2],
                  f"jpeg-forms {name}: image_size")

        # ---- host decode per form at 640x480, against the port's baseline
        # write of the same array (the mini's P1026) at the form's quality
        baseline: dict = {}
        for name in (str(n) for n in ref["timed"]):
            quality = int(ref[f"quality_{name}"])
            if quality not in baseline:
                base = jpeg.encode_jpeg(source, quality)
                baseline[quality] = (len(base),
                                     median_ms(jpeg.decode_jpeg, base))
            ms = median_ms(jpeg.decode_jpeg, blobs[name])
            size, base_ms = baseline[quality]
            log(f"host decode 640x480 {name} ({ref[f'form_{name}']}, "
                f"quality {quality}): {ms:.2f} ms vs baseline 4:2:0 "
                f"{base_ms:.2f} ms per image (x{ms / base_ms:.2f}; median "
                f"of {PROG_DECODES}; {len(blobs[name])} / {size} bytes) "
                f"({card})")

        # ---- the mini with P1026 in each driven form, both paths
        drive_york_mini("jpeg-forms", root, FORMS_DRIVEN, blobs, ref, card,
                        kernels_all, ccl_k, sph_k, total, phase, check, tmp,
                        max_far=0)
    if failed:
        raise AssertionError(f"jpeg-forms phase: {failed}")
    return phase


def webp_phase(card: str, kernels_all, ccl_k, sph_k, total: dict) -> dict:
    """WebP files through the decoder and both serving paths, held against
    ``assets/examples/jax_reference_webp.npz``: every fixture's pixels and
    ``image_size`` (lossy, lossless, alpha, extended, animated), the decode
    time of each 640x480 file against the port's baseline JPEG write of
    the same array at the same quality, and the York Urban mini with P1026
    as lossy and as lossless WebP. Every check runs and logs before the
    phase fails on the first that did not hold. Returns the phase's
    launches per kernel source."""
    import importlib.util

    import numpy as np

    from vanishing_points_2017_tpu_torch.data import io as dio
    from vanishing_points_2017_tpu_torch.data import jpeg, minisets, webp

    # the colour array of the fixture script (numpy only; the script
    # imports JAX and PIL only when it writes the fixtures)
    spec = importlib.util.spec_from_file_location("make_webp_fixtures",
                                                  WEBP_SCRIPT)
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)

    failed: list = []
    check = checker(failed)
    ref = np.load(WEBP_REFERENCE)
    phase: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "yud")
        minisets.make_mini_yud(root, n_eval=len(PROG_PHOTOS))
        source = dio.load_image(os.path.join(root, "P1026", "P1026.jpg"))
        sources = {"P1026_lossy": source, "P1026_lossless": source,
                   "P1026_colour": fixtures.colour_photo(source)}

        # ---- every fixture against JAX's pixels and PIL's size
        blobs = {}
        for name in (str(n) for n in ref["files"]):
            path = os.path.join(WEBP_DIR, f"{name}.webp")
            with open(path, "rb") as fh:
                blobs[name] = fh.read()
            check(hashlib.sha256(blobs[name]).hexdigest()
                  == str(ref[f"file_sha256_{name}"]),
                  f"webp {name}: not the committed file")
            px = dio.load_image(path)
            shape = tuple(int(v) for v in ref[f"shape_{name}"])
            same = (hashlib.sha256(np.ascontiguousarray(px).tobytes())
                    .hexdigest() == str(ref[f"sha256_{name}"])
                    and px.shape == shape)
            log(f"webp {name} {px.shape} ({ref[f'form_{name}']}): pixels "
                f"equal JAX's: {same}")
            check(same, f"webp {name}: pixels differ from JAX's")
            check(dio.image_size(path) == shape[:2],
                  f"webp {name}: image_size")

        # ---- host decode of each 640x480 file, against the port's
        # baseline JPEG write of the same array at the same quality
        for name in (str(n) for n in ref["timed"]):
            quality = int(ref[f"quality_{name}"])
            base = jpeg.encode_jpeg(sources[name], quality)
            base_ms = median_ms(jpeg.decode_jpeg, base)
            ms = median_ms(webp.decode_webp, blobs[name])
            log(f"host decode 640x480 {name} ({ref[f'form_{name}']}): "
                f"{ms:.2f} ms vs baseline JPEG 4:2:0 at quality {quality} "
                f"{base_ms:.2f} ms per image (x{ms / base_ms:.2f}; median "
                f"of {PROG_DECODES}; {len(blobs[name])} / {len(base)} "
                f"bytes) ({card})")

        # ---- the mini with P1026 as lossy and as lossless WebP, both paths
        drive_york_mini("webp", root, WEBP_DRIVEN, blobs, ref, card,
                        kernels_all, ccl_k, sph_k, total, phase, check, tmp,
                        max_far=MINI_MAX_FAR)
    if failed:
        raise AssertionError(f"webp phase: {failed}")
    return phase


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


def hd_frames() -> dict:
    """The HD reference's frames re-rendered from their seeds with the
    port's generators: {(width, height): [frames]} in the file's order.
    Raises when a frame's sha256 is not the committed one."""
    import numpy as np

    from vanishing_points_2017_tpu_torch.data import datasets as ds
    from vanishing_points_2017_tpu_torch.models import synth

    ref = np.load(HD_REFERENCE)
    out: dict = {}
    for seed, w, h, digest in zip(ref["seed"], ref["width"], ref["height"],
                                  ref["sha256"]):
        rng = np.random.default_rng(int(seed))
        img = ds.render_scene_image_wh(synth.make_scene(rng), int(w), int(h),
                                       rng)
        if hashlib.sha256(img.tobytes()).hexdigest() != str(digest):
            raise AssertionError(f"HD frame seed {seed}: sha256 differs")
        out.setdefault((int(w), int(h)), []).append(img)
    return out


def k1_launched_kernels(ld, dev, widths) -> dict:
    """The first kernel K1 launches at each of ``widths`` (B = 1, 2 rows,
    one pass pair), as the profiler names it, template arguments and all:
    {width: name}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    planes = [torch.zeros((1, 2, w), dtype=torch.int32, device=dev)
              for w in widths]
    ld.connected_components_cuda(planes[0], 2)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for pl in planes:
            ld.connected_components_cuda(pl, 2)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [m.group(0) for e in events
             if (m := re.search(r"ccl_half_pass\w*<[^>]*>", e.name))]
    if len(names) != 2 * len(widths):
        raise AssertionError(f"K1: the profiler saw {len(names)} launches "
                             f"of 2 x {len(widths)}")
    return dict(zip(widths, names[::2]))


def k1_switch_faults(names: dict) -> list:
    """What contradicts K1_SWITCH_WIDTHS in {width: launched kernel} (see
    :func:`k1_launched_kernels`; each switch width +-1): no change of
    kernel at a switch width, or one between two."""
    faults = []
    for s, nxt in zip(K1_SWITCH_WIDTHS, K1_SWITCH_WIDTHS[1:] + (None,)):
        if names[s - 1] != names[s] or names[s] == names[s + 1]:
            faults.append(f"K1: no switch of kernel at W={s}: "
                          f"{names[s - 1]}, {names[s]}, {names[s + 1]}")
        if nxt is not None and names[s + 1] != names[nxt]:
            faults.append(f"K1: a switch of kernel between W={s + 1} and "
                          f"{nxt}: {names[s + 1]}, {names[nxt]}")
    return faults


def wide_grid_phase(dev, card: str, pipe, kernels_all, total: dict, ld,
                    k1_ms: float, k1_rows: int) -> tuple:
    """K1 at every width of its table: the kernel it launches changes at
    each of K1_SWITCH_WIDTHS and nowhere between; bit-exact against the
    twin on random planes at every switch width +-1 and at WIDE_EXTRA, at
    each of
    WIDE_BATCHES, and on drawn-line 720p / 1080p gradient grids at B = 4
    and 32, timed there (the twin once at B = 4); then one 1280 x 720
    frame through ``process_images``; then the HD gate. ``k1_ms`` and
    ``k1_rows`` are the main path's grid's time and rows. Returns K1's
    (times, bounds) by grid, the twin's times, K1's microseconds per row
    step by grid and the HD gate's launches."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.data.datasets import \
        render_scene_image_wh
    from vanishing_points_2017_tpu_torch.data.io import \
        normalized_horizon_error
    from vanishing_points_2017_tpu_torch.models import synth

    failed: list = []
    check = checker(failed)
    rng = np.random.default_rng(1)
    widths = sorted({w + d for w in K1_SWITCH_WIDTHS for d in (-1, 0, 1)}
                    | set(WIDE_EXTRA))
    names = k1_launched_kernels(ld, dev, widths)
    log("K1's kernel at each switch width and the next: " + ", ".join(
        f"{w} {names[w]} -> {names[w + 1]}" for w in K1_SWITCH_WIDTHS))
    for fault in k1_switch_faults(names):
        check(False, fault)
    bmax = max(WIDE_BATCHES)
    for w in widths:
        packed = torch.from_numpy(rng.integers(0, 256, (bmax, 9, w)).astype(
            np.int32)).to(dev)
        packed[1] = 0xFF  # every edge set: one component per row band
        packed[2] = 0     # none: every pixel its own
        ref = ld.connected_components_ref(packed, 8)
        bad = {}
        for b in WIDE_BATCHES:
            got = ld.connected_components_cuda(packed[:b].contiguous(), 8)
            bad[b] = int((got != ref[:b]).sum())
            check(bad[b] == 0, f"K1 not bit-exact at B={b}, W={w}")
        log(f"K1 (9, {w}): labels differing from the twin at B = "
            f"{', '.join(f'{b}: {n}' for b, n in bad.items())}")
    times, plain = {}, {}
    per_row = {f"B={BATCH} 639x639": k1_ms * 1e3 / (8 * k1_rows)}
    for width, height in ((1280, 720), (1920, 1080)):
        frames = [render_scene_image_wh(synth.make_scene(rng), width, height,
                                        rng) for _ in range(4)]
        p4 = packed_of(ld, torch.from_numpy(np.stack(frames)).to(dev))
        got4 = ld.connected_components_cuda(p4, 8)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref4 = ld.connected_components_ref(p4, 8)
        end.record()
        torch.cuda.synchronize()
        plain[f"4x{p4.shape[1]}x{p4.shape[2]}"] = start.elapsed_time(end)
        n_bad = int((got4 != ref4).sum())
        check(n_bad == 0, f"K1 not bit-exact on 4 x {tuple(p4.shape[1:])}")
        p32 = p4.repeat(BATCH // 4, 1, 1)
        n_bad32 = int((ld.connected_components_cuda(p32, 8)
                       != got4.repeat(BATCH // 4, 1)).sum())
        check(n_bad32 == 0, f"K1 at B={BATCH} on {tuple(p4.shape[1:])} "
              "differs from B=4")
        for pl, nb in ((p4, n_bad), (p32, n_bad32)):
            ms = cuda_ms(lambda: ld.connected_components_cuda(pl, 8), 5)
            b_ms, by = bound(2 * pl.numel() * 4, 6 * 8 * pl.numel())
            key = f"{pl.shape[0]}x{pl.shape[1]}x{pl.shape[2]}"
            times[key] = (ms, b_ms, by)
            per_row[key] = ms * 1e3 / (8 * pl.shape[1])
            twin = f", twin {plain[key]:.1f} ms" if key in plain else ""
            log(f"K1 B={pl.shape[0]} {tuple(pl.shape[1:])}: {nb} labels "
                f"differ; kernel {ms:.3f} ms = {per_row[key]:.3f} us per "
                f"row step{twin}, bound {b_ms:.4f} ms ({by}) ({card})")
    log("K1 us per row step: " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in per_row.items()))
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

    # the HD gate: JAX's horizons on the same frames
    ref = np.load(HD_REFERENCE)
    by_shape = hd_frames()
    reset(kernels_all)
    runs = {}
    for (width, height), frames in by_shape.items():
        t0 = time.perf_counter()
        runs[(width, height)] = [pipe.process_images(frames[i:i + HD_BATCH])
                                 for i in range(0, len(frames), HD_BATCH)]
        torch.cuda.synchronize()
        log(f"HD {width}x{height}: {len(frames)} frames through "
            f"process_images at batch {HD_BATCH} in "
            f"{time.perf_counter() - t0:.2f} s, first batch included "
            f"({card})")
    per_hd = {k.source: k.launches for k in kernels_all}
    count(kernels_all, total, "HD gate", need=kernels_all)
    far, i = [], 0
    for (width, height), outs in runs.items():
        for o in outs:
            for j in range(o["hp1"].shape[0]):
                est = np.cross(*(o[k][j].cpu().double().numpy()
                                 for k in ("hp1", "hp2")))
                e = normalized_horizon_error(
                    est, np.cross(ref["hp1"][i].astype(np.float64),
                                  ref["hp2"][i].astype(np.float64)),
                    width, height)
                segs = int(o["segment_mask"][j].sum())
                log(f"HD seed {int(ref['seed'][i])} ({width}x{height}): "
                    f"horizon {e:.5f} from JAX's; {segs} segments (JAX "
                    f"{int(ref['segments'][i])}), "
                    f"{int(o['alive'][j].sum())} VPs")
                check(bool(np.isfinite(est).all()),
                      f"HD seed {int(ref['seed'][i])}: non-finite horizon")
                if not e <= HORIZON_TOL:
                    far.append(int(ref["seed"][i]))
                i += 1
    log(f"HD gate: {len(far)} of {i} horizons beyond {HORIZON_TOL} of JAX's "
        f"{far}")
    check(i == len(ref["seed"]), f"HD gate: {i} frames run")
    check(len(far) <= HD_MAX_FAR, f"HD gate: {far} beyond {HORIZON_TOL}")
    if failed:
        raise AssertionError(f"wide-grid phase: {failed}")
    return times, plain, per_row, per_hd


def tools_phase(card: str, pipe, kernels_all, total: dict,
                syn_out: dict) -> dict:
    """The accuracy harnesses (``vanishing_points_2017_tpu_torch.tools``)
    with the shipped weights, against ``jax_reference_tools.npz``: the
    knife-edge flip protocol on JAX's five pinned scenes (single EM and
    consensus K = 8, at most JAX's flips), the host / full / ideal AUC
    decomposition (each AUC within AUC_TOL of JAX's, at most SYN_MAX_FAR
    horizons beyond HORIZON_TOL; host and full bit-identical to the
    synthetic phase's ``syn_out``), the re-validation gate with
    ``--skip_pins``, and the detector and end-to-end profiles (no time
    gate). Runs every check and logs before the phase fails on the first
    that did not hold. Returns the phase's launches per kernel source."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.bench import make_inputs
    from vanishing_points_2017_tpu_torch.metrics import calc_auc
    from vanishing_points_2017_tpu_torch.tools import (
        eval_device_detector as ted, perturb_knife_edge as tke,
        profile_detector as tpd, profile_e2e as tpe,
        revalidate_detector as trv)

    failed: list = []
    check = checker(failed)
    ref = np.load(TOOLS_REFERENCE)
    cfg = pipe.cfg
    reset(kernels_all)

    # ---- knife edge: the pool's base margins, then the pinned probes
    t0 = time.perf_counter()
    scenes, images = ted.build_scene_set(SYN_COUNT)
    pops = [tke.detect_device(pipe, cfg, img) for img in images]
    base = tke.run_populations(pipe, cfg, [p[0] for p in pops],
                               [p[1] for p in pops])
    margins = base["rel_margin"]
    picks = sorted(int(i) for i in np.argsort(margins)[:5])
    log(f"knife edge: the card's 5 lowest-margin scenes {picks} (margins "
        f"{[round(float(margins[i]), 5) for i in picks]}), JAX's "
        f"{ref['picks'].tolist()} (margins "
        f"{[round(float(ref['base_rel_margin'][i]), 5) for i in ref['picks']]}"
        f"); pool median {float(np.median(margins)):.4f} (JAX "
        f"{float(np.median(ref['base_rel_margin'])):.4f})")
    sigma_norm = KNIFE_SIGMA_PX * 2.0 / 640
    cfg_c = dataclasses.replace(cfg, horizon_consensus=KNIFE_CONSENSUS)
    for mode, c in (("single", cfg), ("consensus", cfg_c)):
        for j, i in enumerate(KNIFE_SCENES):
            lps, masks = tke.jittered_populations(
                np.random.default_rng(KNIFE_SEED), *pops[i], KNIFE_K,
                sigma_norm, KNIFE_DROP)
            res = tke.run_populations(pipe, c, lps, masks)
            errs = ted.scene_horizon_errors([scenes[i]] * (KNIFE_K + 1),
                                            res["hp1"], res["hp2"], 640)
            flips = int((errs[1:] > KNIFE_GATE).sum())
            jax_flips = int(ref[f"ke_{mode}_flips"][j])
            row = tke.probe_row(f"scene_{i:02d}", res, errs)
            log(f"  {mode:<9} {tke.row_line(row, KNIFE_K)}; JAX base "
                f"{float(ref[f'ke_{mode}_errs'][j, 0]):.3f} flips "
                f"{jax_flips}/{KNIFE_K} margin base "
                f"{float(ref[f'ke_{mode}_rel_margin'][j, 0]):.3f}")
            check(flips <= jax_flips, f"knife edge {mode} scene {i}: "
                  f"{flips} of {KNIFE_K} flips, JAX {jax_flips}")
    log(f"knife-edge probes: {time.perf_counter() - t0:.1f} s")

    # ---- the AUC decomposition: host LSD, device-full, ideal prior
    t0 = time.perf_counter()
    for path in ("host", "full", "ideal"):
        r = ted.run_path(path, pipe, scenes, images, TOOLS_BATCH, 640)
        jax_auc = float(ref[f"auc_{path}"])
        far = [i for i in range(SYN_COUNT) if horizon_err(
            r["hp1"][i], r["hp2"][i], ref[f"{path}_hp1"][i],
            ref[f"{path}_hp2"][i]) > HORIZON_TOL]
        note = ""
        if path in ("host", "full"):
            s_hp1, s_hp2 = syn_out["host" if path == "host" else "dev"]
            same = (np.array_equal(r["hp1"], s_hp1)
                    and np.array_equal(r["hp2"], s_hp2))
            s_auc = calc_auc(ted.scene_horizon_errors(scenes, s_hp1, s_hp2,
                                                      640), 0.25)[0]
            note = (f"; synthetic phase (batch {SYN_BATCH}) AUC {s_auc:.5f}, "
                    f"horizons {'bit-identical' if same else 'DIFFER'}")
            check(same and s_auc == r["auc"], f"tools {path}: batch "
                  f"{TOOLS_BATCH} differs from the synthetic phase's "
                  f"batch {SYN_BATCH}")
        log(f"{ted.path_line(path, r, SYN_COUNT)}; JAX {jax_auc:.5f}, "
            f"card {r['auc']:.5f}; {len(far)} of {SYN_COUNT} horizons "
            f"beyond {HORIZON_TOL} of JAX's {far}{note} ({card})")
        check(abs(r["auc"] - jax_auc) <= AUC_TOL,
              f"tools {path}: AUC {r['auc']} vs JAX {jax_auc}")
        check(len(far) <= SYN_MAX_FAR, f"tools {path}: {len(far)} horizons "
              "beyond the gate")
    log(f"AUC decomposition: {time.perf_counter() - t0:.1f} s")

    # ---- the re-validation gate, as a user runs it on a detector change
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trv.main(["--skip_pins"])
    for line in buf.getvalue().splitlines():
        log(f"  {line}")
    check(rc == 0 and "A real photos: SKIPPED" in buf.getvalue(),
          f"revalidate_detector --skip_pins: exit {rc}")
    log(f"re-validation: {time.perf_counter() - t0:.1f} s")

    # ---- profiles (information only)
    t0 = time.perf_counter()
    log(f"detector sub-stages, b16 640^2, CUDA events ({card}):")
    dev = pipe.device
    tpd.profile(torch.from_numpy(make_inputs(16, 640, cfg.n_pad)[0]).to(dev),
                iters=5, budgets=(cfg.det_max_records, 16384),
                log=lambda m: log(f"  {m}"))
    e2e = tpe.measure(dev, batches=(16, 32), iters=5)
    log(f"profile_e2e ({card}): {json.dumps(e2e)}")
    log(f"profiles: {time.perf_counter() - t0:.1f} s")

    phase = {k.source: k.launches for k in kernels_all}
    count(kernels_all, total, "tools", need=kernels_all)
    if failed:
        raise AssertionError(f"tools phase: {failed}")
    return phase


def bench_phase(card: str, pipe, kernels_all, total: dict) -> dict:
    """The bench's measurement at b32 / 640x640 on the card; -> its
    launches per kernel source. Runs every check and logs before the phase
    fails on the first that did not hold."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import bench

    reset(kernels_all)
    record, horizons = bench.measure(batch=BATCH, iters=BENCH_ITERS,
                                     size=640, repeats=BENCH_REPEATS,
                                     device="cuda")
    torch.cuda.synchronize()
    launches = {k.source: k.launches for k in kernels_all}
    count(kernels_all, total, "bench", need=kernels_all)
    log(f"bench record: {json.dumps(record)}")
    failed: list = []
    check = checker(failed)
    bd = record["breakdown"]
    check({"metric", "value", "unit", "vs_baseline", "breakdown"}
          <= set(record) and set(BENCH_KEYS) <= set(bd),
          "bench record: keys missing")
    check(bd.get("platform") == "gpu" and not record.get("degraded"),
          f"bench record: platform {bd.get('platform')}")
    check(bd.get("device") == torch.cuda.get_device_name(0),
          f"bench record: device {bd.get('device')}")
    check(record.get("value", 0) > 0 and bd.get("mfu_estimate") is not None,
          "bench record: no throughput or MFU")
    check(all(n >= 1 for n in bd.get("launches_per_batch", {}).values())
          and len(bd.get("launches_per_batch", {})) == len(kernels_all),
          f"bench record: launches per batch {bd.get('launches_per_batch')}")
    imgs = bench.make_inputs(BATCH, 640, pipe.cfg.n_pad)[0]
    ref = pipe.process_images(list(imgs))
    ref = tuple(ref[k].cpu().numpy() for k in ("hp1", "hp2"))
    for loop in ("pipelined", "serial", "compute"):
        check(all(np.array_equal(h, r) for h, r in zip(horizons[loop], ref)),
              f"bench {loop} loop: horizons differ from process_images")
    jax_ref = np.load(BENCH_REFERENCE)
    errs = [horizon_err(ref[0][i], ref[1][i], jax_ref["hp1"][i],
                        jax_ref["hp2"][i]) for i in range(BATCH)]
    far = [i for i, e in enumerate(errs) if e > HORIZON_TOL]
    log(f"bench scenes: {len(far)} of {BATCH} horizons beyond {HORIZON_TOL} "
        f"of JAX's ({far}; worst {max(errs):.5f})")
    check(len(far) <= BENCH_MAX_FAR, f"bench scenes: {len(far)} horizons "
          "beyond the gate")
    spread = bd["spread"]
    log(f"bench b{BATCH}/640^2 ({card}): pipelined {record['value']:.2f} "
        f"img/s (min {spread['pipelined']['min']:.2f}, max "
        f"{spread['pipelined']['max']:.2f}), serial "
        f"{bd['serial_images_per_sec']:.2f}, compute-only "
        f"{bd['compute_images_per_sec']:.2f}, fused on lines "
        f"{bd['fused_device_images_per_sec']:.2f}; MFU "
        f"{bd['mfu_estimate']} at {bd['flops_per_image']} FLOP/img; "
        f"idle share {bd['device_idle_share']}")
    if failed:
        raise AssertionError(f"bench phase: {failed}")
    return launches


def _closest_gaps(ref_seg, got_seg) -> list:
    """Per segment of ``ref_seg``, the distance (largest coordinate,
    endpoint order free) to the closest segment of ``got_seg``; inf if
    none."""
    import numpy as np

    if len(got_seg) == 0:
        return [math.inf] * len(ref_seg)
    gaps = []
    for s in ref_seg:
        d1 = np.abs(got_seg - s).max(axis=1)
        d2 = np.abs(got_seg - s[[2, 3, 0, 1]]).max(axis=1)
        gaps.append(float(np.minimum(d1, d2).min()))
    return gaps


def _segment_gap(ref_seg, got_seg) -> float:
    """Max over ``ref_seg`` of the distance to the closest segment of
    ``got_seg`` (:func:`_closest_gaps`)."""
    return max(_closest_gaps(ref_seg, got_seg), default=0.0)


def _matched_gap(a, b) -> float:
    """The largest endpoint gap between matched segments of ``a`` and
    ``b``, both ways: a side with more segments than the other leaves out
    that many of its farthest (the count may differ by one)."""
    worst = 0.0
    for x, y in ((a, b), (b, a)):
        gaps = sorted(_closest_gaps(x, y))
        worst = max(worst, max(gaps[:len(gaps) - max(0, len(x) - len(y))],
                               default=0.0))
    return worst


def em_trajectory_phase(card: str, pipe, kernels_all, total: dict) -> dict:
    """The port's EM against the JAX EM's own batch-1 trajectory
    (``assets/examples/jax_reference_em.npz``): the 21 populations on JAX's
    stage inputs through ``em_and_horizon`` at the main path's chunk, at
    ``num_iter`` = 1, 2, 3 and 100 (every end horizon within HORIZON_TOL
    of JAX's; the agreement on iterations, alive sets and VPs is printed,
    not gated: the card's reductions run in other orders than either CPU
    run); then the stage-by-stage trace of bench scene 25 (device path)
    and P1026 (host path) against JAX's stage outputs, one line per stage
    and the first stage that departs by more than float noise. ->
    the phase's launches per kernel source."""
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch.bench import make_inputs
    from vanishing_points_2017_tpu_torch.em import EMConfig
    from vanishing_points_2017_tpu_torch.em.consensus import em_and_horizon
    from vanishing_points_2017_tpu_torch.em.horizon import \
        triplet_score_margin
    from vanishing_points_2017_tpu_torch.models import cnn as cnn_mod
    from vanishing_points_2017_tpu_torch.ops import sphere

    failed: list = []
    check = checker(failed)
    ref = dict(np.load(EM_REFERENCE))
    cfg, dev = pipe.cfg, pipe.device
    hz = dict(maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
              pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    reset(kernels_all)

    def run_em(inputs, num_iter=100):
        """The port's EM and horizon on JAX's stage inputs (l, lp, grid,
        sphere, lmask with a batch dim)."""
        l, lp, grid, sph, m = (t(a) for a in inputs)
        return em_and_horizon(l, lp, grid, sph.float(), m,
                              EMConfig(num_iter=num_iter), **hz)

    def agree(em, tag, idx):
        """(same iterations, same alive set, and VPs within EM_VP_TOL)."""
        it = em.iterations.cpu().numpy() == ref[f"{tag}_iterations"][idx]
        alive = em.alive.cpu().numpy()
        same = (alive == ref[f"{tag}_alive"][idx]).all(-1)
        cos = np.abs(np.sum(em.vp.cpu().double().numpy()
                            * ref[f"{tag}_vp"][idx], -1))
        vp_ok = np.where(alive & same[:, None], 1.0 - cos, 0.0).max(-1) \
            <= EM_VP_TOL
        return it, same, it & same & vp_ok

    # ---- the 21 populations at the main path's chunk
    t0 = time.perf_counter()
    names = [str(n) for n in ref["names"]]
    idx = np.arange(len(names))
    pops = [ref[k] for k in ("l", "lp", "grid", "sphere", "lmask")]
    for tag, num_iter in EM_CHECKPOINTS:
        em, h = run_em(pops, num_iter)
        it, alive, full = agree(em, tag, idx)
        log(f"em-trajectory {tag} (num_iter {num_iter}): iterations equal "
            f"on {int(it.sum())} of {len(names)}, alive sets on "
            f"{int(alive.sum())}, all three (VPs within {EM_VP_TOL}) on "
            f"{int(full.sum())}; parting: "
            f"{[names[i] for i in np.flatnonzero(~full)]} ({card})")
    errs = [horizon_err(h[0][i], h[1][i], ref["hp1"][i], ref["hp2"][i])
            for i in idx]
    far = [names[i] for i in idx if errs[i] > HORIZON_TOL]
    log(f"em-trajectory: end horizons within {max(errs):.5f} of JAX's "
        f"batch-1 horizons (beyond {HORIZON_TOL}: {far}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(not far, f"em-trajectory: horizons {far} beyond {HORIZON_TOL}")

    # ---- the traced frames, stage by stage against JAX's stage outputs
    t0 = time.perf_counter()
    imgs = make_inputs(BATCH, 640, cfg.n_pad)[0]
    own = pipe.process_images(list(imgs))
    bundles = [pipe.ingest(os.path.join(PROG_DIR, f"{name}.jpg"))
               for name in PROG_PHOTOS]
    own_host = pipe.process_batch(bundles)
    bench_ref, prog_ref = np.load(BENCH_REFERENCE), np.load(PROG_REFERENCE)
    frames = {
        "bench25": dict(
            seg=own["segments"][EM_BENCH_SCENE].cpu().numpy(),
            mask=own["segment_mask"][EM_BENCH_SCENE].cpu().numpy(),
            out={k: v[EM_BENCH_SCENE:EM_BENCH_SCENE + 1]
                 for k, v in own.items()},
            gate=(bench_ref["hp1"][EM_BENCH_SCENE],
                  bench_ref["hp2"][EM_BENCH_SCENE]), shape=(640, 640)),
        "p1026": dict(
            seg=bundles[0]["lp"], mask=bundles[0]["lmask"],
            out={k: v[:1] for k, v in own_host.items()},
            gate=(prog_ref["york_hp1"][0], prog_ref["york_hp2"][0]),
            shape=(640, 480)),
    }
    for name, fr in frames.items():
        p = f"{name}_"
        herr = lambda *hps: horizon_err(*hps, shape=fr["shape"])
        stages = []
        # the detector: the port's own segments against JAX's
        js = ref[p + "segments"][ref[p + "segment_mask"]]
        ts = fr["seg"][fr["mask"]]
        gap = max(_segment_gap(js, ts), _segment_gap(ts, js))
        what = (f"{len(ts)} vs JAX's {len(js)}, largest endpoint gap "
                f"{gap:.3g} ({gap * max(fr['shape']) / 2:.3g} px)")
        stages.append(("segments", abs(len(ts) - len(js)) > 1 or
                       gap > SEG_GAP_TOL, what))
        # the render: K2 on JAX's own lines against JAX's uint8 image
        l, m = t(ref[p + "l"])[None], t(ref[p + "segment_mask"])[None]
        img = sphere.sphere_image_uint8(l, m, size=cfg.sphere_size)
        du8 = (img[0].int() - t(ref[p + "sphere"]).int()).abs()
        share = float((du8 > 0).float().mean())
        stages.append(("sphere", share > K2_U8_FRAC or int(du8.max()) > 1,
                       f"K2 on JAX's lines: {int((du8 > 0).sum())} of "
                       f"{du8.numel()} uint8 pixels differ (max step "
                       f"{int(du8.max())})"))
        # the CNN on JAX's own sphere image against JAX's grid
        with torch.inference_mode():
            grid = pipe.model(cnn_mod.preprocess(t(ref[p + "sphere"])[None],
                                                 pipe.mean))
        gd = float((grid[0].float() - t(ref[p + "grid"])).abs().max())
        stages.append(("grid", gd > GRID_TOL,
                       f"CNN on JAX's sphere image: largest difference "
                       f"{gd:.3g} (gate {GRID_TOL})"))
        # the EM on JAX's own stage inputs
        em, h = run_em([ref[p + k][None] for k in (
            "l", "segments", "grid", "sphere", "segment_mask")])
        it = int(em.iterations[0])
        same = bool((em.alive[0].cpu().numpy() == ref[p + "alive"]).all())
        stages.append(("em", it != int(ref[p + "iterations"]) or not same,
                       f"on JAX's inputs: {it} iterations vs JAX's "
                       f"{int(ref[p + 'iterations'])}, alive set "
                       f"{'equal' if same else 'differs'}"))
        e_jax_in = herr(h[0][0], h[1][0], ref[p + "hp1"], ref[p + "hp2"])
        own_out = fr["out"]
        e_own = herr(own_out["hp1"][0], own_out["hp2"][0], ref[p + "hp1"],
                     ref[p + "hp2"])
        e_gate = herr(own_out["hp1"][0], own_out["hp2"][0], *fr["gate"])
        margins = [float(triplet_score_margin(*vca, **hz)[2][0]) for vca in (
            [t(ref[p + k])[None] for k in ("vp", "counts", "alive")],
            (em.vp, em.counts, em.alive),
            (own_out["vp"], own_out["counts"], own_out["alive"]))]
        stages.append(("horizon", e_jax_in > HORIZON_TOL,
                       f"from JAX's inputs {e_jax_in:.5f} of JAX's; the "
                       f"port's own path {e_own:.5f} of JAX's batch-1 "
                       f"horizon, {e_gate:.5f} of the gate's reference; "
                       f"triplet margins (s1 - s2) / s1: JAX's EM "
                       f"{margins[0]:.5f}, the port's on JAX's inputs "
                       f"{margins[1]:.5f}, the port's own path "
                       f"{margins[2]:.5f}"))
        for stage, departs, what in stages:
            log(f"trace {name} {stage}: {what}"
                f"{' DEPARTS' if departs else ''} ({card})")
        first = next((s for s, d, _ in stages if d), None)
        log(f"trace {name}: first stage that departs from JAX's by more "
            f"than float noise: {first or 'none'}")
    log(f"em-trajectory traces: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    phase = {k.source: k.launches for k in kernels_all}
    count(kernels_all, total, "em-trajectory", need=kernels_all)
    if failed:
        raise AssertionError(f"em-trajectory phase: {failed}")
    return phase


def identical(a, b) -> bool:
    """Same shape and the same values, NaN equal to NaN."""
    import torch

    if a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def em_bodies(pass_fn) -> int:
    """How many EM loop bodies (``em.em._iteration`` calls) ``pass_fn()``
    runs."""
    from vanishing_points_2017_tpu_torch.em import em as em_mod

    orig, n = em_mod._iteration, [0]

    def counted(*args, **kwargs):
        n[0] += 1
        return orig(*args, **kwargs)

    em_mod._iteration = counted
    try:
        pass_fn()
    finally:
        em_mod._iteration = orig
    return n[0]


def options_phase(card: str, pipe, kernels_all, total: dict, ld) -> dict:
    """The JAX package's other detector and EM configurations on the card:
    K1 at 2 and 16 passes bit-exact against its twin at B = 4 on four of
    the bench's scenes, the fixpoint residual of the 2-pass labels equal
    to the twin's; every detector variant of ``OPTIONS_SCRIPT``'s
    ``VARIANTS`` on those scenes against JAX's (``OPTIONS_REFERENCE``:
    valid counts within 1, matched segments within SEG_GAP_TOL, NaN on
    the images where JAX's are NaN); the phase loop on JAX's EM inputs within HORIZON_TOL of JAX's
    phase loop, and bit-identical to the uniform loop; at b32 on the
    bench's 32 scenes the row selection bit-identical to the global one
    and ``device_pipeline_full`` with ``loop="phase"`` to ``"uniform"``;
    then per configuration ``bench.stage_split`` (EM host syncs and loop
    bodies, idle share) and OPTION_ROUNDS stage passes in turns (EM,
    detector and total ms): information only. -> the phase's
    launches per kernel source, K1's comparison launches excluded."""
    import importlib.util

    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import bench
    from vanishing_points_2017_tpu_torch.em.consensus import em_and_horizon
    from vanishing_points_2017_tpu_torch.pipeline import device_pipeline_full

    spec = importlib.util.spec_from_file_location("options", OPTIONS_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    failed: list = []
    check = checker(failed)
    ref = dict(np.load(OPTIONS_REFERENCE))
    cfg, dev = pipe.cfg, pipe.device
    imgs32 = torch.from_numpy(bench.make_inputs(BATCH, 640, cfg.n_pad)[0]).to(
        dev)
    scenes = [int(i) for i in ref["bench_scenes"]]
    imgs4 = imgs32[scenes].contiguous()

    # ---- K1 at other pass counts against its twin
    packed = packed_of(ld, imgs4)
    for passes in OPTION_PASSES:
        got = ld.connected_components_cuda(packed, passes)
        twin = ld.connected_components_ref(packed, passes)
        n_bad = int((got != twin).sum())
        log(f"K1 B={len(scenes)} {tuple(packed.shape[1:])} passes={passes}: "
            f"{n_bad} labels differ")
        check(n_bad == 0, f"K1 not bit-exact at {passes} passes")
        if passes == 2:
            res = [int(ld.ccl_fixpoint_residual(packed[:1], lab[:1])[0])
                   for lab in (got, twin)]
            log(f"fixpoint residual at 2 passes, bench scene {scenes[0]}: "
                f"K1 {res[0]}, twin {res[1]} pixels")
            check(res[0] == res[1], "K1's fixpoint residual differs from "
                  "the twin's")

    reset(kernels_all)
    # ---- the detector's variants against JAX's on the four scenes
    for name, kw in script.VARIANTS.items():
        with torch.inference_mode():
            seg, mask = ld.detect_segments_device(
                imgs4, max_segments=cfg.n_pad, **kw)
        seg, mask = seg.cpu().numpy(), mask.cpu().numpy()
        js, jm = ref[f"bench_{name}_segments"], ref[f"bench_{name}_mask"]
        worst, poisoned = 0.0, []
        for i in range(len(scenes)):
            tv, jv = seg[i][mask[i]], js[i][jm[i]]
            tnan, jnan = np.isnan(tv).any(1), np.isnan(jv).any(1)
            check(tnan.all() == jnan.all() and tnan.any() == jnan.any()
                  and not np.any(seg[i][~mask[i]]),
                  f"options {name} scene {scenes[i]}: NaN where JAX's are "
                  "not, or the other way")
            if jnan.all():
                poisoned.append(scenes[i])
                continue
            worst = max(worst, _matched_gap(jv, tv))
        dn = np.abs(mask.sum(1) - jm.sum(1)).max()
        log(f"options detector {name}: valid {mask.sum(1).tolist()} vs JAX "
            f"{jm.sum(1).tolist()}, worst endpoint gap {worst:.3g}, NaN "
            f"images {poisoned} ({card})")
        check(dn <= 1 and worst <= SEG_GAP_TOL,
              f"options {name}: counts {dn} apart, gap {worst}")

    # ---- the phase loop on JAX's EM inputs against JAX's phase loop
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    hz = dict(maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
              pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    ins = [t(ref["phase_l"]), t(ref["bench_global_segments"]),
           t(ref["phase_grid"]), t(ref["phase_sphere"]).float(),
           t(ref["bench_global_mask"])]
    phase_em = dataclasses.replace(cfg.em, loop="phase")
    with torch.inference_mode():
        em_p, h_p = em_and_horizon(*ins, phase_em, **hz)
        em_u, h_u = em_and_horizon(*ins, cfg.em, **hz)
    errs = [horizon_err(h_p[0][i], h_p[1][i], ref["phase_hp1"][i],
                        ref["phase_hp2"][i]) for i in range(len(scenes))]
    same_alive = (em_p.alive.cpu().numpy() == ref["phase_alive"]).all(1)
    log(f"phase loop on JAX's inputs: iterations {em_p.iterations.tolist()} "
        f"vs JAX {ref['phase_iterations'].tolist()}, alive sets equal on "
        f"{int(same_alive.sum())} of {len(scenes)}, horizon errors vs JAX's "
        f"phase loop {[round(float(e), 5) for e in errs]} ({card})")
    check(max(errs) <= HORIZON_TOL, f"phase loop: horizon {max(errs)} from "
          "JAX's")
    check(all(identical(a, b) for a, b in zip((*em_p, *h_p), (*em_u, *h_u))),
          "phase loop differs from the uniform loop on JAX's inputs")

    # ---- row against global, phase against uniform, at b32
    row_cfg = dataclasses.replace(cfg, det_selection="row")
    phase_cfg = dataclasses.replace(cfg, em=phase_em)
    with torch.inference_mode():
        g = ld.detect_segments_device(imgs32, **cfg.det_kwargs())
        r = ld.detect_segments_device(imgs32, **row_cfg.det_kwargs())
    out_u = device_pipeline_full(imgs32, pipe.model, pipe.mean, cfg)
    out_p = device_pipeline_full(imgs32, pipe.model, pipe.mean, phase_cfg)
    diff = [k for k in out_u if not identical(out_u[k], out_p[k])]
    row_same = identical(g[0], r[0]) and identical(g[1], r[1])
    log(f"b{BATCH}: row selection {'equals' if row_same else 'DIFFERS'} "
        f"global ({int(g[1].sum())} segments); phase loop differs from "
        f"uniform in {diff or 'no output'}; iterations max "
        f"{int(out_p['iterations'].max())}")
    check(row_same, f"b{BATCH}: row selection differs from global")
    check(not diff, f"b{BATCH}: phase loop differs from uniform in {diff}")

    # ---- per configuration (information only): one profiled stage split
    # (syncs, idle share), then OPTION_ROUNDS rounds of synchronized
    # stage passes in turns, forward then backward
    host = imgs32.cpu().pin_memory()
    configs = {"global detector, uniform EM": cfg,
               "global detector, phase EM": phase_cfg,
               "row detector, uniform EM": row_cfg}
    for tag, c in configs.items():
        sp = bench.stage_split(host, pipe.model, pipe.mean, c, OPTION_REPEATS)
        bodies = em_bodies(lambda: bench.stage_pass(host, pipe.model,
                                                    pipe.mean, c))
        log(f"options stage split b{BATCH}/640^2, {tag} ({card}): "
            f"{sp['em_host_syncs']} EM host syncs, {bodies} loop bodies, "
            f"{sp['em_iterations_max']} iterations max; EM "
            f"{sp['stage_ms']['em']:.2f} ms, detector "
            f"{sp['stage_ms']['detector']:.2f} ms, total "
            f"{sp['stage_total_ms']:.2f} ms; idle share "
            f"{sp['device_idle_share']}")
    ms = {tag: {"EM": [], "detector": [], "total": []} for tag in configs}
    for rnd in range(OPTION_ROUNDS):
        for tag in (list(configs) if rnd % 2 == 0 else list(configs)[::-1]):
            secs = bench.stage_pass(host, pipe.model, pipe.mean,
                                    configs[tag])[0]
            for k, v in (("EM", secs["em"]), ("detector", secs["detector"]),
                         ("total", sum(secs.values()))):
                ms[tag][k].append(v * 1e3)
    for tag, row in ms.items():
        log(f"options in turns b{BATCH}/640^2, {tag}, {OPTION_ROUNDS} "
            f"passes ({card}): " + "; ".join(
                f"{k} ms median {statistics.median(v):.2f} (runs "
                f"{', '.join(f'{x:.2f}' for x in v)})"
                for k, v in row.items()))
    torch.cuda.synchronize()
    launches = {k.source: k.launches for k in kernels_all}
    count(kernels_all, total, "options", need=kernels_all)
    if failed:
        raise AssertionError(f"options phase: {failed}")
    return launches


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
    start = time.perf_counter()
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
            usage = kernels.ptxas_usage(k.build_log)
            for u in usage:
                log(f"  ptxas: {u['name']}: {u.get('registers')} registers, "
                    f"{u.get('spill_stores')} bytes spill stores, "
                    f"{u.get('spill_loads')} bytes spill loads")
            spilled = [u["name"] for u in usage
                       if u.get("spill_stores") or u.get("spill_loads")]
            if spilled or not usage:
                raise AssertionError(f"{k.source}: register spills in "
                                     f"{spilled} (or no ptxas report)")
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
    lines, mask = detected_lines(port, imgs32, cfg)
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

    # ---- K1 past 1024 columns, a 1280x720 frame and the HD gate
    t0 = time.perf_counter()
    wide_ms, wide_plain, per_row, per_hd = wide_grid_phase(
        dev, card, pipe, kernels_all, total, ld, k1_ms, packed.shape[1])
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
    syn_out = {}
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
        syn_out[path] = tuple(np.stack([r[k] for r in res])
                              for k in ("hp1", "hp2"))
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

    # ---- the accuracy harnesses (tools/) on the same scenes, and the
    # detector and end-to-end profiles
    t0 = time.perf_counter()
    per_tools = tools_phase(card, pipe, kernels_all, total, syn_out)
    log(f"tools phase: {time.perf_counter() - t0:.1f} s")

    # ---- the throughput bench: its loops at b32 / 640^2
    t0 = time.perf_counter()
    per_bench = bench_phase(card, pipe, kernels_all, total)
    log(f"bench phase: {time.perf_counter() - t0:.1f} s")

    # ---- the EM against JAX's own batch-1 trajectory, and the traces of
    # bench scene 25 and P1026 stage by stage
    t0 = time.perf_counter()
    per_em = em_trajectory_phase(card, pipe, kernels_all, total)
    log(f"em-trajectory phase: {time.perf_counter() - t0:.1f} s")

    # ---- the detector's other arguments and the EM's phase loop
    t0 = time.perf_counter()
    per_opt = options_phase(card, pipe, kernels_all, total, ld)
    log(f"options phase: {time.perf_counter() - t0:.1f} s")

    # ---- the training path: parity with JAX, dense and compact training
    # at b32, and the two drivers
    t0 = time.perf_counter()
    per_step = training_phase(dev, card, kernels_all, sph_k, total, grays)
    log(f"training phase: {time.perf_counter() - t0:.1f} s")

    # ---- the real data sets' path on the three minis, both detectors
    t0 = time.perf_counter()
    miniset_phase(dev, card, kernels_all, ccl_k, sph_k, total, ld)
    log(f"miniset phase: {time.perf_counter() - t0:.1f} s")

    # ---- progressive JPEG: the decoder, then both paths on the York mini
    t0 = time.perf_counter()
    per_prog = progressive_phase(card, kernels_all, ccl_k, sph_k, total)
    log(f"progressive phase: {time.perf_counter() - t0:.1f} s")

    # ---- the other JPEG forms: the decoder, then both paths on the York
    # mini with P1026 as YCCK and as h1v2
    t0 = time.perf_counter()
    per_forms = jpeg_forms_phase(card, kernels_all, ccl_k, sph_k, total)
    log(f"jpeg-forms phase: {time.perf_counter() - t0:.1f} s")

    # ---- WebP: the decoder, then both paths on the York mini with P1026
    # as lossy and as lossless WebP
    t0 = time.perf_counter()
    per_webp = webp_phase(card, kernels_all, ccl_k, sph_k, total)
    log(f"webp phase: {time.perf_counter() - t0:.1f} s")

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
             launches_bench=per_bench[ccl_k.source],
             launches_progressive=per_prog[ccl_k.source],
             launches_jpeg_forms=per_forms[ccl_k.source],
             launches_webp=per_webp[ccl_k.source],
             launches_tools=per_tools[ccl_k.source],
             launches_hd=per_hd[ccl_k.source],
             launches_em_trajectory=per_em[ccl_k.source],
             launches_options=per_opt[ccl_k.source],
             ms_by_wide_grid={g: t[0] for g, t in wide_ms.items()},
             plain_ms_by_wide_grid=wide_plain,
             bound_ms_by_wide_grid={g: t[1] for g, t in wide_ms.items()},
             us_per_row_step=per_row,
             library_ms=None, **records["ccl_raster"]),
        dict(name="sphere_render", route="cuda",
             source="vanishing_points_2017_tpu_torch/csrc/sphere_render.cu",
             replaces="vanishing_points_2017_tpu/ops/sphere_pallas.py:53",
             launches=total[sph_k.source],
             launches_per_batch=per_batch[sph_k.source],
             launches_per_train_step=per_step[sph_k.source],
             launches_sharded=per_sharded[sph_k.source],
             launches_bench=per_bench[sph_k.source],
             launches_progressive=per_prog[sph_k.source],
             launches_jpeg_forms=per_forms[sph_k.source],
             launches_webp=per_webp[sph_k.source],
             launches_tools=per_tools[sph_k.source],
             launches_hd=per_hd[sph_k.source],
             launches_em_trajectory=per_em[sph_k.source],
             launches_options=per_opt[sph_k.source],
             library_ms=None, **records["sphere_render"]),
    ]
    for k in kernel_info:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
    log(json.dumps({"kernels": kernel_info}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
