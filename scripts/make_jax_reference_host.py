"""Regenerate assets/examples/jax_reference_host.npz.

Runs the JAX package on the CPU with the shipped weights and the default
config except ``det_topk="exact"`` (the selection the PyTorch port
implements), the recipe of ``make_jax_reference_outputs.py``, and saves:

* ``host_hp1``, ``host_hp2``, ``host_alive``, ``host_counts``: the host
  path (``Pipeline.ingest`` + ``process_batch``) on the four bundled
  scenes, one batch of 4;
* the 50-scene synthetic protocol (``synthetic_records``: seed 7, 640x640)
  with batches of 8, the last one padded with copies, as the root
  ``benchmark.py --synthetic`` runs it: per image ``syn_host_hp1``/
  ``syn_host_hp2`` of the host path and ``syn_dev_hp1``/``syn_dev_hp2`` of
  the on-device detector path (``ingest_image`` + ``process_images``), and
  each path's AUC@0.25 (``auc_host``, ``auc_dev``).

``chip_smoke.py`` holds the port against this file on the GPU, where JAX
is not installed. The whole run took 97 s on an 8-core CPU.

    python scripts/make_jax_reference_host.py [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_host.npz")
BUNDLED_KEYS = ("host_hp1", "host_hp2", "host_alive", "host_counts")
COUNT, BATCH, SIZE = 50, 8, 640


def _pipeline():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu.weights import load_params_and_mean

    params, mean = load_params_and_mean(warn=False)
    cfg = dataclasses.replace(PipelineConfig(), det_topk="exact")
    return Pipeline(params, mean, cfg)


def bundled_outputs(pipe=None) -> dict:
    """The host path on the four bundled scenes, as numpy arrays."""
    import numpy as np

    pipe = pipe or _pipeline()
    bundles = [pipe.ingest(os.path.join(ROOT, "assets", "examples",
                                        f"scene_{i}.png")) for i in range(4)]
    out = pipe.process_batch(bundles)
    return {f"host_{k}": np.asarray(out[k])
            for k in ("hp1", "hp2", "alive", "counts")}


def _batched(pipe, items, run):
    import numpy as np

    hp1, hp2 = [], []
    for i in range(0, len(items), BATCH):
        chunk = items[i:i + BATCH]
        n = len(chunk)
        out = run(chunk + [chunk[-1]] * (BATCH - n))
        hp1 += list(np.asarray(out["hp1"])[:n])
        hp2 += list(np.asarray(out["hp2"])[:n])
    return np.stack(hp1), np.stack(hp2)


def synthetic_outputs(pipe=None) -> dict:
    """Both paths on the 50-scene synthetic protocol."""
    import numpy as np

    from vanishing_points_2017_tpu.data.datasets import (
        normalized_horizon_error, synthetic_records)
    from vanishing_points_2017_tpu.metrics import calc_auc

    pipe = pipe or _pipeline()
    records, _ = synthetic_records(count=COUNT, size=SIZE)
    res = {}
    res["syn_host_hp1"], res["syn_host_hp2"] = _batched(
        pipe, [pipe.ingest(r.image) for r in records], pipe.process_batch)
    res["syn_dev_hp1"], res["syn_dev_hp2"] = _batched(
        pipe, [pipe.ingest_image(r.image)["gray"] for r in records],
        pipe.process_images)
    for path in ("host", "dev"):
        errs = [normalized_horizon_error(
            np.cross(h1.astype(np.float64), h2.astype(np.float64)),
            r.true_horizon, SIZE, SIZE) for r, h1, h2 in zip(
                records, res[f"syn_{path}_hp1"], res[f"syn_{path}_hp2"])]
        res[f"auc_{path}"] = np.asarray(calc_auc(np.array(errs), 0.25)[0])
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    pipe = _pipeline()
    ref = bundled_outputs(pipe) | synthetic_outputs(pipe)
    np.savez(args.out, **ref)
    print(f"wrote {args.out} in {time.time() - t0:.0f} s: AUC host "
          f"{float(ref['auc_host']):.4f}, device {float(ref['auc_dev']):.4f}")


if __name__ == "__main__":
    main()
