"""Compress a trained dense CNN into a committable artifact (the JAX
package's ``scripts/compress_weights.py``, on a GPU).

Factorizes fc6/fc7 with a truncated randomized SVD on the host
(``models/factorize.py``), fine-tunes the factorized network with Caffe's
SGD at batch 32 to recover the sigmoid-grid fit, and writes float16 npz
(tens of MB; both packages read it). This is how the shipped
``assets/weights_compact.npz`` was made. The last line names the file and
how many times the fine-tune's batches launched the sphere kernel.

    python -m vanishing_points_2017_tpu_torch.compress_weights     # factorize + fine-tune
    python -m vanishing_points_2017_tpu_torch.compress_weights --steps 0   # factorize only

The default ``--out`` is the shipped artifact itself: pass ``--out``
elsewhere for trial runs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import weights
from .device import require_device
from .models import factorize, train
from .ops.sphere import SPHERE_KERNEL


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="assets/weights.npz")
    ap.add_argument("--out", default="assets/weights_compact.npz")
    ap.add_argument("--rank6", type=int, default=256)
    ap.add_argument("--rank7", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3000,
                    help="fine-tune steps (batch 32)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    print(f"loading {args.weights} ...")
    # host numpy: the randomized SVD runs on the host
    params = weights.params_npz_numpy(args.weights)
    ranks = {"fc6": args.rank6, "fc7": args.rank7}
    print(f"factorizing {ranks} ...")
    t0 = time.time()
    fac = factorize.factorize_params(params, ranks, seed=args.seed)
    print(f"  done in {time.time() - t0:.1f}s")
    fac = weights.params_from_numpy(fac, dev)

    if args.steps > 0:
        mean = torch.from_numpy(np.load(weights.default_mean_path())).to(dev)
        rng_np = np.random.default_rng(args.seed)
        state = train.init_state(fac, base_lr=args.lr)
        t0, running = time.time(), []
        for step in range(args.steps):
            imgs, labels = train.make_batch(rng_np, args.batch, mean,
                                            device=dev)
            loss = train.train_step(state, imgs, labels, train.step_generator(
                args.seed + 1, step, dev))
            running.append(float(loss))
            if (step + 1) % 200 == 0:
                rate = 200 * args.batch / (time.time() - t0)
                print(f"step {step + 1}  loss {np.mean(running):.4f}  "
                      f"{rate:.1f} img/s", flush=True)
                running, t0 = [], time.time()
        fac = state.model.params()

    weights.params_to_npz(fac, args.out, dtype=np.float16)
    sz = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({sz:.1f} MB float16); sphere kernel "
          f"launches: {SPHERE_KERNEL.launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
