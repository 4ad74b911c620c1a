"""Readings that the limits of ``correct`` are set from.

    python3 -m vpbench.calibrate --workload <cell> --seeds 1,2,3
                                 [--control] [--out FILE]

In one process, per seed: the pool a run of that seed draws, the pool
batches that such a run judges sent once each through the timed path's
call (the serving job's ``make_step``, at the cell's own batch and
sizes), and the outputs judged as a run judges them
(``vpbench/judge.py``); with ``--control``, also the control: the plain
reference put in the program's place and computed one precision step
below what the configuration states (``reference.pipeline.PRECISIONS``),
judged the same way. Prints one JSON line per seed and side, with each
number, its limit and the per-image readings; ``--out`` writes them all.
Needs the card (``--device cpu`` for the tests).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import judge, run, scenes, weights
from .jobs.serve import make_step, pipeline_config
from .reference.pipeline import Reference


def readings(wl_name: str, seeds: list, control: bool, device: str = "cuda",
             config: dict | None = None, traffic: dict | None = None,
             root: str = run.ROOT) -> list:
    """-> one record per seed and side: ``{"seed", "side", "numbers",
    "limits", "correct", "per_image"}``."""
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline

    _, wl, cfg_file, traffic_file = run.load_cell(wl_name, root)
    config = config or cfg_file
    traffic = traffic or traffic_file
    dev = torch.device(device)
    cfg = pipeline_config(config)
    params, mean = weights.load(config, root, dev)
    pipe = Pipeline(params, mean, cfg, device=dev)
    step = make_step(pipe.model, mean, cfg, dev)
    ref = Reference(config, params, mean)
    width, height = config["image"]["width"], config["image"]["height"]
    out = []
    for seed in seeds:
        pool = scenes.draw_pool(traffic, width, height, seed, dev)
        order, judged = run.window_order(traffic, seed)
        batches = [{n: t.to(dev) for n, t in pool.batch(order[i]).items()}
                   for i in judged]
        sides = [("program", [step(b) for b in batches])]
        if control:
            sides.append(("control", [ref.chain(b, "control")
                                      for b in batches]))
        for side, o in sides:
            numbers, per = judge.judge(ref, batches, o,
                                       traffic["judge"]["check"], width,
                                       height)
            limits = {k: traffic["judge"]["limits"][k] for k in numbers}
            rec = {"seed": seed, "side": side, "numbers": numbers,
                   "limits": limits,
                   "correct": run.verdict(numbers, limits),
                   "per_image": per}
            sys.stderr.write(json.dumps(rec) + "\n")
            out.append(rec)
    return out


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("vpbench.calibrate: no CUDA card\n")
        return 2
    recs = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.control, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
