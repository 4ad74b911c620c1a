"""Time the port's two CUDA kernels at the main path's shapes, optionally
against another checkout's kernels in the same process.

K1 (raster CCL) runs on the bundled scenes' packed edge plane tiled to
batch 32 (639x639 grid, 8 half passes); K2 (sphere render) on the device
detector's lines for the same batch (N = 512) and on B = 8 x N = 1024 and
2048 lines cycled from them (the host path's line buckets). Each time is
the mean over ``--iters`` launches between CUDA events, after a warm-up.

With ``--parent DIR`` the package of the checkout at DIR is loaded under
another name beside this one; every shape is then timed in turns, parent,
this, this, parent, for ``--rounds`` rounds, and the two kernels' outputs
are compared bit for bit on the same inputs. The inputs and the timer are
``chip_smoke.py``'s, so both scripts time the same work the same way.

    python scripts/time_kernels.py [--parent DIR] [--iters 20] [--rounds 2]

Needs one CUDA GPU. Writes the record to ``chiprun_out/time_kernels.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (bucket_lines, cuda_ms, detected_lines,  # noqa: E402
                        packed_of)

PKG = "vanishing_points_2017_tpu_torch"
BATCH = 32


def load_package(root: str, name: str):
    """The port's package of the checkout at ``root``, imported as
    ``name`` (its modules import each other relatively)."""
    init = os.path.join(root, PKG, "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("kernels", "ops.lines_device", "ops.sphere", "ops.lines",
                "pipeline"):
        importlib.import_module(f"{name}.{sub}")
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose kernels to compare")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    pkgs = {"this": load_package(ROOT, "vp_torch_this")}
    if args.parent:
        pkgs["parent"] = load_package(os.path.abspath(args.parent),
                                      "vp_torch_parent")
    this = pkgs["this"]
    dev = torch.device("cuda")

    grays = [this.pipeline.Pipeline.ingest_image(os.path.join(
        ROOT, "assets", "examples", f"scene_{i % 4}.png"))["gray"]
        for i in range(BATCH)]
    imgs = torch.from_numpy(np.stack(grays)).to(dev)
    packed = packed_of(this.ops.lines_device, imgs)
    lines, mask = detected_lines(this, imgs, 512)
    cases = [("ccl_raster", f"B={BATCH} {tuple(packed.shape[1:])} 8 passes",
              lambda p: p.ops.lines_device.connected_components_cuda(
                  packed, 8))]
    cases.append(("sphere_render", f"B={BATCH} N=512 S=500",
                  lambda p: p.ops.sphere.sphere_render_cuda(lines, mask,
                                                            500)))
    for n in (1024, 2048):
        ln, mk = bucket_lines(lines, mask, n)
        cases.append(("sphere_render", f"B=8 N={n} S=500",
                      lambda p, ln=ln, mk=mk: p.ops.sphere.sphere_render_cuda(
                          ln, mk, 500)))

    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    rec = {"card": card, "torch": torch.__version__, "iters": args.iters,
           "cases": []}
    for name, shape, fn in cases:
        times = {k: [] for k in pkgs}
        for _ in range(args.rounds):
            for k in order:
                times[k].append(cuda_ms(lambda: fn(pkgs[k]), args.iters))
        row = {"kernel": name, "shape": shape,
               **{f"{k}_ms": v for k, v in times.items()},
               **{f"{k}_ms_median": statistics.median(v)
                  for k, v in times.items()}}
        if args.parent:
            a, b = fn(pkgs["parent"]), fn(pkgs["this"])
            row["bit_identical"] = bool(torch.equal(a, b))
            row["max_abs_diff"] = float(
                (a.double() - b.double()).abs().max())
        print(json.dumps(row), flush=True)
        rec["cases"].append(row)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_kernels.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
