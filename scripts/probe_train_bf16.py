"""Where the port's bfloat16 train step parts from JAX's.

Replays ``chip_smoke.py``'s parity steps (JAX's seed-0 batch and dropout
masks from ``assets/examples/jax_reference_train.npz``, two steps from the
shipped compact weights) under several numerics, and prints for each its
two losses against JAX's bfloat16 and float32 losses and the lowest
update cosine and largest norm deviation against JAX's bfloat16 update:

* ``default``: the trainer as it runs (bfloat16 products, PyTorch's
  defaults);
* ``no_reduced_reduction``: cuBLAS's bfloat16 reduced-precision
  reductions off (``allow_bf16_reduced_precision_reduction``);
* ``conv_f32_sum``, ``fc_f32_sum``, ``both_f32_sum``: the convolutions,
  the fc products or both computed in float32 (TF32 off) from their
  bfloat16-rounded operands, the result rounded back to bfloat16: the same
  roundings as a bfloat16 product, with a float32 sum inside;
* ``float32``: float32 products throughout (JAX's ``losses_f32``).

    python scripts/probe_train_bf16.py [--device cpu]

Needs one CUDA GPU unless ``--device cpu``. Writes the record to
``chiprun_out/probe_train_bf16.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (TRAIN_REFERENCE, parity_batch,  # noqa: E402
                        replay_steps, update_agreement)

VARIANTS = ("default", "no_reduced_reduction", "conv_f32_sum", "fc_f32_sum",
            "both_f32_sum", "float32")


@contextlib.contextmanager
def numerics(variant: str):
    """The process-wide settings and patches of one variant, undone
    afterwards."""
    import torch
    import torch.nn.functional as F

    from vanishing_points_2017_tpu_torch.models import cnn

    conv, matmul = F.conv2d, torch.Tensor.__matmul__
    flag = torch.backends.cuda.matmul
    prev = flag.allow_bf16_reduced_precision_reduction
    try:
        if variant == "no_reduced_reduction":
            flag.allow_bf16_reduced_precision_reduction = False
        if variant in ("conv_f32_sum", "both_f32_sum"):
            F.conv2d = lambda x, w, *a, **k: conv(
                x.float(), w.float(), *a, **k).to(x.dtype)
        if variant in ("fc_f32_sum", "both_f32_sum"):
            torch.Tensor.__matmul__ = lambda a, b: torch.matmul(
                a.float(), b.float()).to(a.dtype)
        with (cnn.tf32_disabled() if variant.endswith("_f32_sum")
              else contextlib.nullcontext()):
            yield
    finally:
        F.conv2d, torch.Tensor.__matmul__ = conv, matmul
        flag.allow_bf16_reduced_precision_reduction = prev


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import numpy as np
    import torch

    from vanishing_points_2017_tpu_torch import weights as W
    from vanishing_points_2017_tpu_torch.device import require_device

    dev = require_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ref = np.load(TRAIN_REFERENCE)
    shipped = W.params_npz_numpy(W.default_weights_path())
    mean = torch.from_numpy(np.load(W.default_mean_path())).to(dev)
    batch = parity_batch(ref, mean, dev)
    record = {"card": card, "jax_losses": ref["losses"].tolist(),
              "jax_losses_f32": ref["losses_f32"].tolist(), "variants": {}}
    for variant in VARIANTS:
        dtype = torch.float32 if variant == "float32" else torch.bfloat16
        with numerics(variant):
            state, losses = replay_steps(W.params_from_numpy(shipped, dev),
                                         dtype, batch)
        agree = update_agreement(shipped, state, ref)
        low = min(agree, key=lambda n: agree[n][0])
        far = max(agree, key=lambda n: abs(agree[n][1] - 1))
        rel = [float(abs(a - b) / b) for a, b in zip(losses, ref["losses"])]
        rel32 = [float(abs(a - b) / b)
                 for a, b in zip(losses, ref["losses_f32"])]
        record["variants"][variant] = dict(
            losses=losses, rel_to_jax_bf16=rel, rel_to_jax_f32=rel32,
            lowest_cosine=[low, agree[low][0]],
            largest_norm_ratio=[far, agree[far][1]])
        print(f"{variant:>21}: losses {losses[0]:.5f} / {losses[1]:.5f}; "
              f"rel to JAX bf16 {rel[0]:.2e} / {rel[1]:.2e}, to JAX f32 "
              f"{rel32[0]:.2e} / {rel32[1]:.2e}; lowest update cosine "
              f"{agree[low][0]:.5f} ({low}), norm ratio {agree[far][1]:.4f} "
              f"({far})", flush=True)
        del state
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_train_bf16.json"),
              "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
