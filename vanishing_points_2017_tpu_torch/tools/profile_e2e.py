"""The end-to-end terms the throughput bench does not give
(``scripts/profile_e2e.py`` of the JAX package, less the loops that
``python -m vanishing_points_2017_tpu_torch.bench`` already runs):

  - rtt: one host -> device -> host round trip (a scalar add read back);
  - det: the device detector and the homogeneous lines on resident images;
  - post: render, CNN, EM and horizon (``device_pipeline_batch``) on the
    detector's resident output, with the EM's host reads (syncs) counted;
  - the EM's iterations per batch (median, max, mean): the batch runs in
    lockstep until its slowest image ends;
  - post at ``EMConfig(num_iter=K)``: the time it saves over the full
    program, per EM iteration it cuts, prices one iteration; on a GPU one
    ``torch.profiler`` pass of each also counts the device's kernels per
    EM iteration, and the post program's device busy time gives its idle
    milliseconds per host sync.

Times are host-clock milliseconds per call ending in a synchronize, the
median of ``--iters`` calls after a first call. Inputs are the bench's
(``bench.make_inputs``: scenes drawn from ``default_rng(0)``). Progress
goes to stderr; the last line of stdout is one JSON record.

    python -m vanishing_points_2017_tpu_torch.tools.profile_e2e \\
        [--device cpu] [--batches 16,32] [--iters 8] [--size 640] \\
        [--em_variant_iters 5]

``PROF_BATCHES``, ``PROF_ITERS``, ``PROF_SIZE`` and
``PROF_EM_VARIANT_ITERS`` (0 skips the variant) set the flags' defaults,
as the JAX script's environment does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from . import card, make_pipeline


def log(msg: str) -> None:
    sys.stderr.write(f"profile_e2e[{time.strftime('%H:%M:%S')}]: {msg}\n")
    sys.stderr.flush()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device, iters: int):
    """(first call's seconds, median ms of ``iters`` further calls, the
    last output); each call ends in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    first_s = time.perf_counter() - t0
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return first_s, statistics.median(ms), out


def device_work(fn):
    """One call of ``fn`` under ``torch.profiler`` -> (device kernel and
    copy events, their summed device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def measure(dev: torch.device, batches=(16, 32), iters: int = 8,
            size: int = 640, em_variant_iters: int = 5) -> dict:
    from ..bench import host_reads, make_inputs
    from ..ops.lines import segments_to_homogeneous
    from ..ops.lines_device import detect_segments_device
    from ..pipeline import device_pipeline_batch

    pipe = make_pipeline(dev)
    cfg, model, mean = pipe.cfg, pipe.model, pipe.mean
    results = {"device": card(dev), "iters": iters, "size": size,
               "batches": {}}
    log(f"device={results['device']} batches={list(batches)} "
        f"iters={iters} size={size}")

    z = torch.zeros((), device=dev)
    float(z + 1.0)
    t0 = time.perf_counter()
    n_rtt = 20
    for _ in range(n_rtt):
        float(z + 1.0)
    results["rtt_ms"] = (time.perf_counter() - t0) * 1e3 / n_rtt
    log(f"rtt = {results['rtt_ms']:.3f} ms")

    for batch in batches:
        imgs = torch.from_numpy(make_inputs(batch, size, cfg.n_pad)[0]).to(
            dev)

        @torch.inference_mode()
        def det():
            lp, lm = detect_segments_device(imgs, **cfg.det_kwargs())
            return (torch.where(lm[..., None], segments_to_homogeneous(lp),
                                0.0), lp, lm)

        det_first, det_ms, (l, lp, lm) = timed(det, dev, iters)

        def post(c=cfg):
            return device_pipeline_batch(l, lp, lm, model, mean, c)

        post_first, post_ms, out = timed(post, dev, iters)
        with host_reads(dev) as reads:
            post()
        it = out["iterations"].cpu().numpy()
        rec = {"det_first_call_s": det_first, "det_ms": det_ms,
               "post_first_call_s": post_first, "post_ms": post_ms,
               "em_host_syncs": reads["n"],
               "em_iterations": {"median": float(np.median(it)),
                                 "max": int(it.max()),
                                 "mean": float(it.mean())}}
        results["batches"][str(batch)] = rec
        log(f"[b{batch}] {json.dumps(rec)}")

        if em_variant_iters and batch == batches[0]:
            cfg_k = dataclasses.replace(cfg, em=dataclasses.replace(
                cfg.em, num_iter=em_variant_iters))
            _, post_k_ms, out_k = timed(lambda: post(cfg_k), dev, iters)
            with host_reads(dev) as reads_k:
                post(cfg_k)
            full_it = int(out["iterations"].max())
            capped_it = int(out_k["iterations"].max())
            d_it = max(full_it - capped_it, 1)
            var = {"num_iter": em_variant_iters, "post_ms": post_k_ms,
                   "batch_max_iters_full": full_it,
                   "batch_max_iters_capped": capped_it,
                   "per_em_iter_ms_per_batch": (post_ms - post_k_ms) / d_it,
                   "host_syncs_capped": reads_k["n"],
                   "host_syncs_per_em_iter": (reads["n"] - reads_k["n"])
                   / d_it}
            if dev.type == "cuda":
                n_full, busy = device_work(post)
                n_capped, _ = device_work(lambda: post(cfg_k))
                var |= {"device_events_per_em_iter":
                        (n_full - n_capped) / d_it,
                        "post_device_busy_ms": busy,
                        "post_idle_ms_per_host_sync":
                        (post_ms - busy) / max(reads["n"], 1)}
            results["em_variant"] = var
            log(f"[b{batch}] em_variant {json.dumps(var)}")
    return results


def main(argv: list[str] | None = None) -> int:
    from ..device import require_device

    env = os.environ.get
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--batches", default=env("PROF_BATCHES", "16,32"))
    ap.add_argument("--iters", type=int, default=int(env("PROF_ITERS", "8")))
    ap.add_argument("--size", type=int, default=int(env("PROF_SIZE", "640")))
    ap.add_argument("--em_variant_iters", type=int,
                    default=int(env("PROF_EM_VARIANT_ITERS", "5")))
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    print(json.dumps(measure(
        dev, tuple(int(b) for b in args.batches.split(",")), args.iters,
        args.size, args.em_variant_iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
