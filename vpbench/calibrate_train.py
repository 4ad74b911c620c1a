"""Readings that the limits of a training cell's ``correct`` are set from.

    python3 -m vpbench.calibrate_train --workload <cell> --seeds 1,2,3
                                       [--control] [--out FILE]

In one process, per seed: the cell's job built as a run of that seed
builds it (``vpbench/jobs/train.py``), its warm-up, the window's steps up
to the last judged one, each judged step kept as a run keeps it, and the
kept steps judged as a run judges them; with ``--control``, also the
control: the plain reference (``vpbench/reference/train.py``) with float8
e4m3 operands, one precision step below the configuration's bfloat16, in
the program's place: its render, its loss and its momentum after Caffe's
update, from each judged step's starting state, batch and masks, judged
the same way; the control renders its input in bfloat16, a step below
the float32 render, as serving's control does. ``--control`` also judges
a sound bfloat16 step summed in another order: the reference in the
program's place with the batch in 4 blocks (``SIDES``). With it the
program's record also gives ``decay_share``: the largest, over the
judged steps and the parameter tensors, share of the reference's step
term that weight decay makes, which is what ``step_off`` would read for
a program that left the decay out. Prints one JSON line per seed and
side on stderr, with each number and its limit; ``--out`` writes them
all. Needs the card
(``--device cpu`` for the tests).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run
from .reference import train as ref


def side_kept(work, kept: list, precision: str, render_dtype,
              blocks: int = 1) -> list:
    """``kept`` with each judged step's outputs replaced by the plain
    reference's in the program's place, computed from the state the step
    started from: its input rendered in ``render_dtype``, its loss and
    gradients with ``precision`` products over the batch in ``blocks``
    blocks (each block's loss and gradients weighted by its share
    of the batch, summed in float32), and its momentum after Caffe's
    update and its parameters after it."""
    by_i = {k["i"]: k for k in kept}
    out = []
    for k in kept:
        if k["i"] not in work.steps_judged:
            out.append(k)
            continue
        theta = (work.before0 if k["i"] == 0 else by_i[k["i"] - 1])
        l, lm, labels = (t.to(work.dev) for t in work.pool.batch(k["batch"]))
        with torch.no_grad():
            x = ref.input_images(l, lm, work.mean, work.size, render_dtype)
        n = -(-x.shape[0] // blocks)
        loss, grads = 0.0, None
        for b in range(0, x.shape[0], n):
            part = slice(b, b + n)
            lb, gb = ref.loss_and_grads(theta["theta_next"], x[part],
                                        labels[part],
                                        [m[part] for m in k["keep"]],
                                        precision)
            w = x[part].shape[0] / x.shape[0]
            loss += float(lb) * w
            gb = {a: {c: w * g for c, g in d.items()} for a, d in gb.items()}
            grads = gb if grads is None else {
                a: {c: grads[a][c] + g for c, g in d.items()}
                for a, d in gb.items()}
        terms = ref.step_terms(theta["theta_next"], grads, work.solver,
                               k["step"])
        del grads
        v_after = {a: {c: work.solver["momentum"] * theta["v_next"][a][c]
                       - t for c, t in d.items()}
                   for a, d in terms.items()}
        theta_after = {a: {c: theta["theta_next"][a][c] + v
                           for c, v in d.items()}
                       for a, d in v_after.items()}
        out.append(dict(k, images=x, loss=loss, theta_after=theta_after,
                        v_after=v_after))
    return out


# the sides judged beside the program with --control: (precision, the
# render's dtype, blocks). The control is one precision step below the
# configuration's; the blocked side is a sound bfloat16 step that sums
# the batch's gradients in another order, the bfloat16 noise a limit
# must leave room for
SIDES = {"control": ("fp8", torch.bfloat16, 1),
         "blocked": ("bf16", torch.float32, 4)}


def decay_share(work, kept: list) -> float:
    """The largest share, over the judged steps and the parameter
    tensors, of the reference's step term that weight decay makes:
    |local_lr * local_wd * theta| / |local_lr * (grad + local_wd * theta)|
    in L2."""
    by_i = {k["i"]: k for k in kept}
    share = 0.0
    for j in work.steps_judged:
        k = by_i[j]
        theta = (work.before0 if j == 0 else by_i[j - 1])["theta_next"]
        _, grads = ref.loss_and_grads(theta, k["images"], (
            work.pool.batch(k["batch"])[2]).to(work.dev), k["keep"], "bf16")
        terms = ref.step_terms(theta, grads, work.solver, k["step"])
        zero = {n: {key: torch.zeros_like(g) for key, g in d.items()}
                for n, d in grads.items()}
        decay = ref.step_terms(theta, zero, work.solver, k["step"])
        for n, d in terms.items():
            for key, t in d.items():
                share = max(share, float(decay[n][key].norm()
                                         / t.norm().clamp(min=1e-30)))
    return share


def readings(wl_name: str, seeds: list, control: bool, device: str = "cuda",
             config: dict | None = None, traffic: dict | None = None,
             root: str = run.ROOT) -> list:
    """-> one record per seed and side: ``{"seed", "side", "numbers",
    "limits", "correct"}``."""
    _, _, cfg_file, traffic_file = run.load_cell(wl_name, root)
    config = config or cfg_file
    traffic = traffic or traffic_file
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    module = run.job(traffic["job"], root)
    recs = []
    for seed in seeds:
        work = module.build(config, traffic, seed, dev, root, lambda n: None)
        work.warm_up()
        kept = []
        for i in range(work.judged[-1] + 1):
            o = work.step(i)
            if i in work.judged:
                kept.append(work.keep(i, o))
        del o
        work.free()
        sides = [("program", kept)]
        if control:
            sides += [(name, side_kept(work, kept, *how))
                      for name, how in SIDES.items()]
        for side, k in sides:
            numbers = work.judge(k)
            limits = {n: traffic["judge"]["limits"][n] for n in numbers}
            rec = {"seed": seed, "side": side, "numbers": numbers,
                   "limits": limits,
                   "correct": run.verdict(numbers, limits)}
            if control and side == "program":
                rec["decay_share"] = decay_share(work, kept)
            sys.stderr.write(json.dumps(rec) + "\n")
            recs.append(rec)
        del work, kept, sides
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


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
        sys.stderr.write("vpbench.calibrate_train: no CUDA card\n")
        return 2
    recs = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.control, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
