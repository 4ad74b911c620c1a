"""Which chunk sizes keep the port's results independent of the batch, and
what do they cost at other batch sizes?

The CNN and the EM + horizon search run in fixed chunks of images
(``batching.in_chunks``). On the four bundled scenes this script reports:

1. per CNN chunk size, whether each scene's grid is bit-identical
   (``torch.equal``) alone, at batch 4, 32 and 33 and at any position,
   and the CNN stage's ms at batch 32 (unchunked too);
2. per EM chunk size, the same for the EM + horizon search on the device
   path's and the host path's inputs (VP set, counts, VPs and horizon);
3. the device stage (``Pipeline.process_images`` on the device path,
   ``Pipeline.process_batch`` on the host path) in ms/batch at batch 8,
   32 and 64, for each chunk setting and unchunked: the median of
   ``--rounds`` rounds, the settings interleaved within each round.

    python scripts/probe_chunks.py [--chunks 1,8,32] [--rounds 5]

Needs one CUDA GPU. Writes the timings to ``chiprun_out/probe_chunks.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = [os.path.join(ROOT, "assets", "examples", f"scene_{i}.png")
          for i in range(4)]
# the scene of each row, per batch layout
LAYOUTS = {"B=4": list(range(4)),
           "B=32": [(3 * i + i // 4) % 4 for i in range(32)],
           "B=33": [(i * 7) % 4 for i in range(33)]}
# (name, CNN chunk, EM chunk); None runs the stage on the whole batch
SETTINGS = [("unchunked", None, None), ("32", 32, 32), ("8", 8, 8),
            ("cnn32/em8", 32, 8)]


@contextlib.contextmanager
def chunked(cnn_chunk, em_chunk):
    """Run the CNN and the EM stage in chunks of the given sizes."""
    from vanishing_points_2017_tpu_torch import batching
    from vanishing_points_2017_tpu_torch.em import consensus
    from vanishing_points_2017_tpu_torch.models import cnn

    def fixed(c):
        def run(fn, tensors, chunk=None):
            return fn(*tensors) if c is None else batching.in_chunks(
                fn, tensors, c)
        return run

    saved = cnn.in_chunks, consensus.in_chunks
    cnn.in_chunks, consensus.in_chunks = fixed(cnn_chunk), fixed(em_chunk)
    try:
        yield
    finally:
        cnn.in_chunks, consensus.in_chunks = saved


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def first_difference(run, ref) -> str | None:
    """Run every layout; the first row whose outputs differ from its
    scene's B = 1 outputs, or None."""
    import torch

    for name, rows in LAYOUTS.items():
        got = run(rows)
        for pos, s in enumerate(rows):
            for key, want in ref[s].items():
                if not torch.equal(got[key][pos], want):
                    return f"{name} row {pos} (scene {s}): {key}"
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="1,8,32")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_chunks: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vanishing_points_2017_tpu_torch.em.consensus import em_and_horizon
    from vanishing_points_2017_tpu_torch.models import cnn
    from vanishing_points_2017_tpu_torch.ops.lines import \
        segments_to_homogeneous
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline
    from vanishing_points_2017_tpu_torch.weights import load_params_and_mean

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    params, mean = load_params_and_mean(device=dev)
    pipe = Pipeline(params, mean, device=dev)
    grays = [Pipeline.ingest_image(p)["gray"] for p in SCENES]
    bundles = [pipe.ingest(p) for p in SCENES]
    record: dict = {"card": card, "identical": {}, "cnn_b32_ms": {},
                    "device_stage_ms": {}}
    chunks = [int(v) for v in args.chunks.split(",")]

    # ---- 1. the CNN grid
    with chunked(32, 32):
        out = pipe.process_images(grays)
    x4 = cnn.preprocess(out["sphere_image"], pipe.mean)
    model = pipe.model
    x32 = x4[[i % 4 for i in range(32)]]
    with torch.inference_mode():
        ms = cuda_ms(lambda: model.forward_unchunked(x32))
        record["cnn_b32_ms"]["unchunked"] = ms
        print(f"CNN unchunked b32: {ms:.3f} ms/batch", flush=True)
        for c in chunks:
            with chunked(c, None):
                ref = [{"grid": model(x4[s:s + 1])[0]} for s in range(4)]
                diff = first_difference(
                    lambda rows: {"grid": model(x4[rows])}, ref)
                ms = cuda_ms(lambda: model(x32))
            record["identical"][f"cnn chunk {c}"] = diff is None
            record["cnn_b32_ms"][str(c)] = ms
            print(f"CNN chunk {c}: bit-identical at B=1,4,32,33: "
                  f"{diff is None}{'' if diff is None else ' (' + diff + ')'}"
                  f"; b32 {ms:.3f} ms/batch", flush=True)

    # ---- 2. the EM + horizon search, on each path's B = 4 inputs
    def host_inputs():
        n = max(b["l"].shape[0] for b in bundles)
        l, lp, m = (torch.from_numpy(np.stack([np.pad(
            b[k], [(0, n - b[k].shape[0])] + [(0, 0)] * (b[k].ndim - 1))
            for b in bundles])).to(dev) for k in ("l", "lp", "lmask"))
        with chunked(32, 32):
            o = pipe.process_batch(bundles)
        return l, lp, o["cnn_prediction"], o["sphere_image"].float(), m

    lm = out["segment_mask"]
    inputs = {"device": (torch.where(lm[..., None], segments_to_homogeneous(
        out["segments"]), 0.0), out["segments"], out["cnn_prediction"],
        out["sphere_image"].float(), lm), "host": host_inputs()}
    for path, ins in inputs.items():
        for c in [c for c in chunks if c > 1] or chunks:
            def run(rows):
                with chunked(None, c), torch.inference_mode():
                    em, hz = em_and_horizon(*(t[rows] for t in ins),
                                            pipe.cfg.em)
                return {"alive": em.alive, "counts": em.counts, "vp": em.vp,
                        "hp1": hz[0], "hp2": hz[1]}
            ref = [{k: v[0] for k, v in run([s]).items()} for s in range(4)]
            diff = first_difference(run, ref)
            record["identical"][f"em chunk {c} {path}"] = diff is None
            print(f"EM chunk {c}, {path} path: bit-identical at "
                  f"B=1,4,32,33: {diff is None}"
                  f"{'' if diff is None else ' (' + diff + ')'}", flush=True)

    # ---- 3. the device stage at batch 8, 32, 64 per chunk setting
    calls = {
        "device": lambda b: pipe.process_images(
            [grays[i % 4] for i in range(b)]),
        "host": lambda b: pipe.process_batch(
            [bundles[i % 4] for i in range(b)]),
    }
    cells = [(path, b, name, cc, ec) for path in calls for b in (8, 32, 64)
             for name, cc, ec in SETTINGS]
    times: dict = {c[:3]: [] for c in cells}
    for rnd in range(args.rounds + 1):  # round 0 warms every shape up
        for path, b, name, cc, ec in cells:
            with chunked(cc, ec):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls[path](b)
                torch.cuda.synchronize()
                if rnd:
                    times[(path, b, name)].append(time.perf_counter() - t0)
    for (path, b, name), ts in times.items():
        med = statistics.median(ts) * 1e3
        record["device_stage_ms"][f"{path} b{b} {name}"] = {
            "median": med, "min": min(ts) * 1e3, "max": max(ts) * 1e3}
        print(f"device stage, {path} path, b{b}, chunks {name}: median "
              f"{med:.1f} ms/batch ({min(ts) * 1e3:.1f}-{max(ts) * 1e3:.1f}) "
              f"= {b / med * 1e3:.1f} img/s", flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_chunks.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
