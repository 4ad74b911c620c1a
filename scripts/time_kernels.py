"""Time the port's two CUDA kernels at the main path's shapes, optionally
against another checkout's kernels in the same process.

K1 (raster CCL) runs on the bundled scenes' packed edge plane tiled to
batch 32 (639x639 grid, 8 half passes); K2 (sphere render) on the device
detector's lines for the same batch (N = 512) and on B = 8 x N = 1024 and
2048 lines cycled from them (the host path's line buckets). Each time is
the mean over ``--iters`` launches between CUDA events, after a warm-up.
K1's rows also give the time of one row step (ms over 8 half passes x H
rows), the figure its design moves.

With ``--wide``, K1 also runs at the HD frames' grids: the four 1280x720
and the four 1920x1080 frames of ``assets/examples/jax_reference_hd.npz``
(re-rendered from their seeds; gradient grids 719x1279 and 1079x1919) at
B = 4 and tiled to B = 32, each checked against the twin. For this
checkout it also builds K1 once per warp count N with ``-DCCL_WARPS=N``
(``csrc/ccl_raster.cu``: every width N warps hold through
``ccl_half_pass_wide<N, C>``) and times each build, checked against the
width table's kernels, at 639x639, at the HD grids and on random planes
of B = 4 x 300 rows at the widths of TABLE_WIDTHS: the evidence for the
source's width table (and, at N = 4 on 639x639, for keeping the 4-warp
``ccl_half_pass`` apart). The builds' ptxas reports (registers and spill
bytes per kernel) are printed first.

With ``--parent DIR`` the package of the checkout at DIR is loaded under
another name beside this one; every shape is then timed in turns, parent,
this, this, parent, for ``--rounds`` rounds, and the two kernels' outputs
are compared bit for bit on the same inputs. The inputs and the timer are
``chip_smoke.py``'s, so both scripts time the same work the same way.

    python scripts/time_kernels.py [--parent DIR] [--wide] [--iters 20]
                                   [--rounds 2]

Needs one CUDA GPU. Writes the record to ``chiprun_out/time_kernels.json``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (bucket_lines, cuda_ms, detected_lines,  # noqa: E402
                        hd_frames, packed_of)

PKG = "vanishing_points_2017_tpu_torch"
BATCH = 32
# --wide: widths around the width table's switches, data sets' and
# cameras' gradient grids (639, 799: 640 and 800 wide; 1279, 1919, 3839:
# 720p, 1080p and 2160p)
TABLE_WIDTHS = (639, 640, 641, 700, 799, 800, 1024, 1025, 1279, 1536, 1919,
                2048, 2049, 2560, 3839, 4096, 4097, 5120)
# --wide: the warp counts of K1's register kernels, and the widest grid
# each holds (8 columns per lane, 5 at 32 warps)
WARPS_WIDEST = ((4, 1024), (8, 2048), (16, 4096), (32, 5120))


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


def forced_k1(pkg, warps: int):
    """K1's library built with ``-DCCL_WARPS=warps`` beside the package's
    own (its flags, and the define): every width that many warps hold
    goes through ``ccl_half_pass_wide<warps, C>``."""
    ld = pkg.ops.lines_device
    return pkg.kernels.CudaKernel(
        ld.CCL_KERNEL.source, ld.CCL_KERNEL.symbol, ld.CCL_KERNEL.argtypes,
        extra_flags=("-Xptxas", "--register-usage-level=10",
                     f"-DCCL_WARPS={warps}"))


def run_k1(pkg, kern, packed):
    """``connected_components_cuda(packed, 8)`` through the library
    ``kern``: (B, H, W) -> (B, H * W) labels."""
    import torch

    k = pkg.kernels
    b, h, w = packed.shape
    labels, scratch = torch.empty_like(packed), torch.empty_like(packed)
    kern.launch(k.ptr(packed), k.ptr(labels), k.ptr(scratch), b, h, w, 8,
                k.stream_of(packed))
    return labels.reshape(b, h * w)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose kernels to compare")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--wide", action="store_true",
                    help="K1 also at 720p / 1080p, and at each warp "
                    "count")
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
    lines, mask = detected_lines(this, imgs, this.pipeline.PipelineConfig())
    builds = {k: pkg.ops.lines_device.CCL_KERNEL for k, pkg in pkgs.items()}
    if args.wide:
        builds.update({f"CCL_WARPS={n}": forced_k1(this, n)
                       for n, _ in WARPS_WIDEST})
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(lambda k: k.build(), builds.values()))
    for k, ccl in builds.items():
        for u in this.kernels.ptxas_usage(ccl.build_log):
            print(f"ptxas ({k}): {u['name']}: {u.get('registers')} registers,"
                  f" {u.get('spill_stores')} / {u.get('spill_loads')} bytes "
                  "spill stores / loads", flush=True)
    # (kernel, shape, rows of the grid or None, the packages to time, fn)
    both = list(pkgs)
    cases = [("ccl_raster", f"B={BATCH} {tuple(packed.shape[1:])} 8 passes",
              packed.shape[1], both,
              lambda p: p.ops.lines_device.connected_components_cuda(
                  packed, 8))]
    cases.append(("sphere_render", f"B={BATCH} N=512 S=500", None, both,
                  lambda p: p.ops.sphere.sphere_render_cuda(lines, mask,
                                                            500)))
    for n in (1024, 2048):
        ln, mk = bucket_lines(lines, mask, n)
        cases.append(("sphere_render", f"B=8 N={n} S=500", None, both,
                      lambda p, ln=ln, mk=mk: p.ops.sphere.sphere_render_cuda(
                          ln, mk, 500)))
    checks = []
    if args.wide:
        ld = this.ops.lines_device
        planes = {}
        for (w, h), frames in hd_frames().items():
            p4 = packed_of(ld, torch.from_numpy(np.stack(frames)).to(dev))
            planes[(w, h)] = (p4, p4.repeat(BATCH // 4, 1, 1))
            got = ld.connected_components_cuda(p4, 8)
            checks.append({"grid": list(p4.shape), "twin_equal": bool(
                torch.equal(got, ld.connected_components_ref(p4, 8)))})
            checks.append({"grid": [BATCH, *p4.shape[1:]], "tiled_equal": bool(
                torch.equal(ld.connected_components_cuda(planes[(w, h)][1], 8),
                            got.repeat(BATCH // 4, 1)))})
            print(json.dumps(checks[-2]), json.dumps(checks[-1]), flush=True)
        for pl in [q for pair in planes.values() for q in pair]:
            cases.append(("ccl_raster",
                          f"B={pl.shape[0]} {tuple(pl.shape[1:])} 8 passes",
                          pl.shape[1], both,
                          lambda p, pl=pl:
                          p.ops.lines_device.connected_components_cuda(pl, 8)))

        def per_warp(pl, name):
            """Each forced warp count that holds pl's width, checked
            against the width table's kernels and queued for timing."""
            ref = ld.connected_components_cuda(pl, 8)
            for warps, widest in WARPS_WIDEST:
                if pl.shape[2] > widest:
                    continue
                kern = builds[f"CCL_WARPS={warps}"]
                got = run_k1(this, kern, pl)
                checks.append({"grid": list(pl.shape), "warps": warps,
                               "equal_to_table": bool(torch.equal(got, ref))})
                cases.append((f"{name} warps={warps}",
                              f"B={pl.shape[0]} {tuple(pl.shape[1:])} 8 "
                              "passes", pl.shape[1], ["this"],
                              lambda p, pl=pl, kern=kern: run_k1(p, kern,
                                                                 pl)))

        for pl in [packed] + [pair[0] for pair in planes.values()]:
            per_warp(pl, "ccl_raster")
        rng = np.random.default_rng(0)
        for w in TABLE_WIDTHS:
            pl = torch.from_numpy(rng.integers(0, 256, (4, 300, w)).astype(
                np.int32)).to(dev)
            cases.append(("ccl_raster table", f"B=4 (300, {w}) 8 passes",
                          300, ["this"], lambda p, pl=pl:
                          p.ops.lines_device.connected_components_cuda(pl, 8)))
            per_warp(pl, "ccl_raster table")

    rec = {"card": card, "torch": torch.__version__, "iters": args.iters,
           "checks": checks, "cases": []}
    for name, shape, rows, who, fn in cases:
        order = ["parent", "this", "this", "parent"] if len(who) > 1 \
            else who * 2
        times = {k: [] for k in who}
        for _ in range(args.rounds):
            for k in order:
                times[k].append(cuda_ms(lambda: fn(pkgs[k]), args.iters))
        row = {"kernel": name, "shape": shape,
               **{f"{k}_ms": v for k, v in times.items()},
               **{f"{k}_ms_median": statistics.median(v)
                  for k, v in times.items()}}
        if rows is not None:  # K1: one row step, 8 half passes of `rows`
            row.update({f"{k}_us_per_row_step":
                        statistics.median(v) * 1e3 / (8 * rows)
                        for k, v in times.items()})
        if len(who) > 1:
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
    if not all(all(v for k, v in c.items() if k.endswith("equal"))
               for c in rec["checks"]) or not all(
            r.get("bit_identical", True) for r in rec["cases"]):
        raise SystemExit("time_kernels: outputs differ (see above)")


if __name__ == "__main__":
    main()
