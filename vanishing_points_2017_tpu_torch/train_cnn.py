"""Train the VP-grid CNN on synthetic Manhattan scenes (the root
``train_cnn.py`` of the JAX package, on a GPU).

Each step's scenes, lines and labels are drawn on the host
(``models/train.draw_batch``); the device step
(``models/train.device_step``) copies them in, renders them on the card
by the sphere kernel, subtracts the mean, draws the dropout masks and
runs Caffe's SGD (``models/train.py``: base_lr 1e-4, x0.1 every 200k
steps, momentum 0.9, weight decay 5e-4, batch 5 by default). The mean image is estimated from ``--mean_samples`` rendered
images unless ``--mean_out`` exists. Checkpoints (``.npz``, read by both
packages) are written every ``--snapshot`` steps and at the end to
``--out``; ``--resume`` takes the parameters and step of one and starts
with zero momentum. The last line gives the step reached and how many
times the sphere kernel was launched (0 on the CPU, where its plain
PyTorch version renders).

    python -m vanishing_points_2017_tpu_torch.train_cnn --steps 16000 \\
        --batch 32 --base_lr 5e-4

The default ``--out`` is ``assets/weights.npz``: a dense file there that is
newer than ``assets/weights_compact.npz`` takes over every later run of
both packages (``weights.default_weights_path``), so pass ``--out`` and
``--mean_out`` elsewhere for trial runs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import weights
from .device import require_device
from .models import cnn, train
from .ops.sphere import SPHERE_KERNEL


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400_000)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--base_lr", type=float, default=None,
                    help="override the solver base_lr (default 1e-4)")
    ap.add_argument("--lr_stepsize", type=int, default=None,
                    help="override the x0.1 decay step (default 200k)")
    ap.add_argument("--snapshot", type=int, default=10_000)
    ap.add_argument("--display", type=int, default=100)
    ap.add_argument("--out", default="assets/weights.npz")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' to run "
                         "on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mean_out", default="assets/mean.npy")
    ap.add_argument("--mean_samples", type=int, default=64)
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    rng_np = np.random.default_rng(args.seed)
    # estimate the training mean image (the reference subtracts a mean blob)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if os.path.isfile(args.mean_out):
        mean = torch.from_numpy(np.load(args.mean_out).astype(np.float32))
    else:
        print("estimating mean image ...")
        imgs, _ = train.make_batch(rng_np, args.mean_samples, device=dev)
        mean = imgs[:, 0].mean(dim=0).cpu()
        np.save(args.mean_out, mean.numpy())
    mean = mean.to(dev)

    if args.resume:
        params, step0 = weights.params_from_npz(args.resume, with_step=True,
                                                device=dev)
    else:
        params = weights.params_from_numpy(cnn.init_params(args.seed), dev)
        step0 = 0
    state = train.init_state(
        params, step0,
        base_lr=train.BASE_LR if args.base_lr is None else args.base_lr,
        lr_stepsize=(train.LR_STEPSIZE if args.lr_stepsize is None
                     else args.lr_stepsize))
    del params

    t0 = time.time()
    running = []
    for step in range(state.step, args.steps):
        lines, lmask, labels = train.draw_batch(rng_np, args.batch)
        out = train.device_step(state, lines, lmask, labels, mean,
                                args.seed + 1)
        running.append(float(out.loss))
        if (step + 1) % args.display == 0:
            rate = args.display * args.batch / (time.time() - t0)
            lr = train.learning_rate(state.step, state.base_lr,
                                     state.lr_stepsize)
            print(f"step {step + 1}  loss {np.mean(running):.4f}  "
                  f"{rate:.1f} img/s  lr {lr:.2e}", flush=True)
            running, t0 = [], time.time()
        if (step + 1) % args.snapshot == 0 or step + 1 == args.steps:
            weights.params_to_npz(state.model.params(), args.out,
                                  step=step + 1)
            print(f"snapshot -> {args.out}", flush=True)
    print(f"done at step {state.step}; sphere kernel launches: "
          f"{SPHERE_KERNEL.launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
