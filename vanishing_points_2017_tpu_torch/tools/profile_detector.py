"""Sub-stage times inside the device line detector
(``scripts/profile_detector.py`` of the JAX package).

Times, each on its own after a first call, on the card with CUDA events
(on the CPU with the host clock), at ``--batch`` images (default 16) of
``--size`` x ``--size`` (default 640) drawn from ``default_rng(0)`` as the
bench draws them (``bench.make_inputs``):

* front: blur, 2x2 gradient, activation and directions
  (``ops.lines_device.gradient_front``);
* pack: the 8 directed edge masks into one int32 bit-plane
  (``pack_edge_masks``);
* K1's raster CCL at 8, 4 and 2 passes (``connected_components``);
* stats: run records, the global top-k selection, the canonical sort and
  the per-component moments (``_component_stats``), then the same with
  the row selection at ``runs_per_row`` 64 and 32 (the JAX script's
  ``stats runs_per_row`` rows);
* the whole detector (``detect_segments_device``) at each record budget
  of ``--budgets``, exact and approximate top-k (``"approx"`` is the
  one-stage exact top-k off the TPU), with the row selection, and at 4
  and 2 CCL passes.

The sub-stages should roughly add up to the whole detector at the shipped
budget; the line ``sum of sub-stages`` gives the ratio (the rest: the
weights, the NFA gates and the re-rank). The JAX script's Pallas CCL rows
and its ``PROF_BISECT`` prefixes of ``_component_stats`` have no
counterpart: the port has one CCL (K1 on a GPU, its plain twin on the
CPU) and no stop points inside the stats.

    python -m vanishing_points_2017_tpu_torch.tools.profile_detector \\
        [--device cpu] [--batch 16] [--iters 8] [--size 640] \\
        [--budgets 32768,16384]

``PROF_BATCH``, ``PROF_ITERS``, ``PROF_IMAGE_SIZE`` and ``PROF_BUDGETS``
set the defaults of the flags, as the JAX script's environment does.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from . import card


def timer(dev: torch.device, iters: int):
    """``time(fn)`` -> (ms per call over ``iters`` calls after a first
    call, the first call's seconds): CUDA events on a GPU, the host clock
    on the CPU."""
    def time_it(fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / iters, first_s, out
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters, first_s, out
    return time_it


@torch.inference_mode()
def profile(images: torch.Tensor, iters: int, budgets=(32768,),
            n_pad: int = 512, log=print) -> dict:
    """The detector's sub-stages on a (B, H, W) uint8 batch -> {row name:
    ms per batch}; each row is logged as it is timed."""
    from ..ops import lines_device as ld

    dev = images.device
    b, h, w = images.shape
    time_it = timer(dev, iters)
    rows = {}

    def bench(name, fn):
        ms, first_s, out = time_it(fn)
        rows[name] = ms
        log(f"{name:>34}: {ms / b:7.3f} ms/img ({ms:8.2f} ms/batch, "
            f"first call {first_s:.1f}s)")
        return out

    cos_tol = math.cos(math.radians(ld.TOL_DEG))
    mag, active, ux, uy = bench("front (blur+grad)",
                                lambda: ld.gradient_front(images))
    packed = bench("pack (edge bit-plane)",
                   lambda: ld.pack_edge_masks(active, ux, uy, cos_tol))
    for passes in (8, 4, 2):
        bench(f"ccl passes={passes}",
              lambda p=passes: ld.connected_components(packed, p))
    root = ld.connected_components(packed, ld.CCL_PASSES)
    wgt = torch.where(active, mag / 255.0, 0.0).reshape(b, -1)
    s = max(h, w) / 2.0
    shipped = budgets[0]
    stats_args = (root, wgt, n_pad, (h - 1, w - 1), (float(w), float(h), s))
    bench(f"stats budget={shipped}", lambda: ld._component_stats(
        *stats_args, selection="global", max_records=shipped))
    for rpr in (64, 32):
        bench(f"stats runs_per_row={rpr}", lambda k=rpr: ld._component_stats(
            *stats_args, runs_per_row=k, selection="row"))
    whole = dict(max_segments=n_pad, selection="global")
    for budget in budgets:
        for topk in ("exact", "approx"):
            tag = "" if topk == "exact" else " topk=approx"
            bench(f"whole detector budget={budget}{tag}",
                  lambda r=budget, t=topk: ld.detect_segments_device(
                      images, **whole, max_records=r, topk_impl=t))
    bench("whole detector selection=row", lambda: ld.detect_segments_device(
        images, max_segments=n_pad, selection="row"))
    for passes in (4, 2):
        bench(f"whole detector ccl_passes={passes}",
              lambda p=passes: ld.detect_segments_device(
                  images, **whole, max_records=shipped, ccl_passes=p))
    parts = (rows["front (blur+grad)"] + rows["pack (edge bit-plane)"]
             + rows[f"ccl passes={ld.CCL_PASSES}"]
             + rows[f"stats budget={shipped}"])
    rows["sum_of_substages_over_whole"] = (
        parts / rows[f"whole detector budget={shipped}"])
    log(f"sum of sub-stages (front, pack, ccl passes={ld.CCL_PASSES}, "
        f"stats): {parts:.2f} ms/batch = "
        f"{rows['sum_of_substages_over_whole']:.3f} of the whole detector")
    return rows


def main(argv: list[str] | None = None) -> int:
    from ..bench import make_inputs
    from ..device import require_device

    env = os.environ.get
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--batch", type=int, default=int(env("PROF_BATCH", "16")))
    ap.add_argument("--iters", type=int, default=int(env("PROF_ITERS", "8")))
    ap.add_argument("--size", type=int,
                    default=int(env("PROF_IMAGE_SIZE", "640")))
    ap.add_argument("--budgets", default=env("PROF_BUDGETS", "32768,16384"),
                    help="comma list of record budgets for the whole "
                         "detector; the first is the stats row's")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    budgets = tuple(int(x) for x in args.budgets.split(","))
    imgs = make_inputs(args.batch, args.size, 512)[0]
    print(f"device: {card(dev)}; batch {args.batch}, {args.size}x"
          f"{args.size}, {args.iters} iterations per row", flush=True)
    profile(torch.from_numpy(imgs).to(dev), args.iters, budgets,
            log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
