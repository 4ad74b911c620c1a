"""Arbitrate the device detector's noise gates and record budget
(``scripts/sweep_detector_gates.py`` of the JAX package).

Runs each detector variant (selection, record budget, min_count,
min_len_px, min_density) over two protocols at once:

* the 2017 reference's three example photographs with an in-frame horizon
  (``$VP_TPU_REFERENCE_EXAMPLES``; skipped when they are not at hand),
  scoring each photograph's largest horizon-row error against the
  reference's published figures;
* ``--count`` rendered synthetic scenes of the seed-7 set with exact
  ground-truth horizons, scoring AUC@0.25.

Each variant's detector feeds the one lines-in device program
(``pipeline.device_pipeline_batch``). The JAX script's ``VARIANTS``
table: ``row`` rows (the row selection, the budget is ``runs_per_row``),
``global`` rows (the exact global top-k, the budget is ``max_records``)
and the ``global!`` row (``topk_impl="approx"``: JAX's TPU PartialReduce,
which off the TPU, and so on the card, is the one-stage exact top-k over
every run end).

    python -m vanishing_points_2017_tpu_torch.tools.sweep_detector_gates \\
        [--device cpu] [--count 16] [--size 640]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import REFERENCE_HORIZONS, make_pipeline, reference_examples

# (selection, runs_per_row / max_records, min_count, min_len_px,
# min_density); "global!" = global with topk_impl="approx"
VARIANTS = [
    ("row", 64, 15, 12.0, 0.70),     # row fallback
    ("row", 64, 15, 10.0, 0.70),
    ("row", 64, 15, 12.0, 0.00),     # density gate off
    ("row", 48, 15, 12.0, 0.70),     # budget too small for real photos
    ("global", 32768, 15, 12.0, 0.70),   # shipped defaults
    ("global", 16384, 15, 12.0, 0.70),
    ("global!", 32768, 15, 12.0, 0.70),  # approx top-k
]


def variant_kwargs(sel: str, budget: int, cnt: int, ln: float, dens: float,
                   n_pad: int) -> dict:
    """A ``VARIANTS`` row -> the detector's arguments, as the JAX script
    maps it."""
    kw = dict(max_segments=n_pad, min_count=cnt, min_len_px=ln,
              min_density=dens, selection=sel.rstrip("!"),
              topk_impl="approx" if sel.endswith("!") else "exact")
    kw["max_records" if sel.startswith("global") else "runs_per_row"] = budget
    return kw


def main(argv: list[str] | None = None) -> int:
    from ..data.io import normalized_horizon_error
    from ..device import require_device
    from ..metrics import calc_auc
    from ..ops.lines import segments_to_homogeneous
    from ..ops.lines_device import detect_segments_device
    from ..pipeline import device_pipeline_batch
    from .eval_device_detector import build_scene_set

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--count", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    pipe = make_pipeline(dev)
    cfg = pipe.cfg

    photos = []
    examples = reference_examples()
    if os.path.isdir(examples):
        for name, rl, rr in REFERENCE_HORIZONS:
            host = pipe.ingest_image(os.path.join(examples, name),
                                     target_size=args.size)
            photos.append((name, rl, rr, host["gray"], host["image_shape"]))
    scenes, simgs = build_scene_set(args.count, size=args.size)

    def detect(images, kw):
        """Each image alone (the photographs' shapes differ) -> stacked
        (lp, lmask) on the device."""
        with torch.inference_mode():
            outs = [detect_segments_device(
                torch.from_numpy(np.asarray(im)[None]).to(dev), **kw)
                for im in images]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def run_lines(lp, m):
        with torch.inference_mode():
            l = torch.where(m[..., None], segments_to_homogeneous(lp), 0.0)
            out = device_pipeline_batch(l, lp, m, pipe.model, pipe.mean, cfg)
        return {k: out[k].cpu().numpy() for k in ("hp1", "hp2", "em_valid")}

    def frac_rows(hp1, hp2, shape):
        h, w = shape
        s = max(h, w) / 2.0
        return ((h / 2.0 - float(hp1[1]) * s) / h,
                (h / 2.0 - float(hp2[1]) * s) / h)

    print(f"{'sel':>7} {'budget':>6} {'cnt':>3} {'len':>4} {'dens':>4} "
          "| photo errs -> worst | synthAUC")
    for sel, budget, cnt, ln, dens in VARIANTS:
        kw = variant_kwargs(sel, budget, cnt, ln, dens, cfg.n_pad)
        errs = []
        if photos:
            out = run_lines(*detect([p[3] for p in photos], kw))
            for i, (name, rl, rr, _, shape) in enumerate(photos):
                if not bool(out["em_valid"][i]):
                    errs.append(float("nan"))
                    continue
                fl, fr = frac_rows(out["hp1"][i], out["hp2"][i], shape)
                errs.append(max(abs(fl - rl), abs(fr - rr)))
        sout = run_lines(*detect(simgs, kw))
        serrs = [normalized_horizon_error(
            np.cross(sout["hp1"][j], sout["hp2"][j]),
            scenes[j].horizon.astype(np.float64), width=args.size,
            height=args.size) for j in range(len(simgs))]
        auc = calc_auc(np.asarray(serrs), 0.25)[0]
        estr = " ".join(f"{e:5.3f}" for e in errs) if errs else "(no photos)"
        # np.max propagates NaN: a photograph that lost EM validity reads
        # as a failed variant
        worst = float(np.max(errs)) if errs else float("nan")
        print(f"{sel:>7} {budget:>6} {cnt:>3} {ln:>4.1f} {dens:>4.2f} "
              f"| {estr} -> {worst:5.3f} | {auc:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
