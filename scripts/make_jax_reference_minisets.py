"""Regenerate assets/examples/jax_reference_minisets.npz.

Writes the three miniature data sets (York Urban, Eurasian Cities, Horizon
Lines in the Wild; 8 evaluated images each, the golden-AUC test's sizes)
with the PyTorch port's writer, runs the JAX package's root
``benchmark.py`` on them on the CPU with the shipped weights (the host-LSD
path for all three, ``--device_detect`` for York Urban), and saves, per
run ``yud``, ``ecd``, ``hlw`` and ``yud_dev``:

* ``<run>_names``, ``<run>_hp1``, ``<run>_hp2``, ``<run>_err``: every
  evaluated image's name, horizon points and normalized horizon error;
* ``auc_<run>``: the run's AUC@0.25;

and per data set ``files_<set>`` and ``sha256_<set>``: every JPEG's path
in the data set and the digest of its bytes (the writer gives the same
bytes on every machine; the ``.mat`` files carry their creation time and
are left out).

``chip_smoke.py`` holds the port against this file on the GPU, where JAX
is not installed. The first 25 records of York Urban and Eurasian Cities
are the protocol's skipped split: they get placeholder results, so the
device stage runs on the evaluated images only. The whole run took 47 s
on an 8-core CPU.

    python scripts/make_jax_reference_minisets.py [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "assets", "examples",
                           "jax_reference_minisets.npz")
N_EVAL, BATCH = 8, 4
# run -> (data set, benchmark flag, the JAX package's data set name,
#         extra flags)
RUNS = {"yud": ("yud", "--yud", "york", []),
        "ecd": ("ecd", "--ecd", "eurasian", []),
        "hlw": ("hlw", "--hlw", "horizon", []),
        "yud_dev": ("yud", "--yud", "york", ["--device_detect"])}


def _setup():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")


def write_minis(root: str, sets=("yud", "ecd", "hlw")) -> dict:
    """The minis, written by the port's writer: {set: directory}."""
    _setup()
    from vanishing_points_2017_tpu_torch.data import minisets

    out = {}
    for name in sets:
        out[name] = os.path.join(root, name)
        getattr(minisets, f"make_mini_{name}")(out[name], n_eval=N_EVAL)
    return out


def jpeg_hashes(directory: str) -> tuple[list, list]:
    """(relative paths, sha256 digests) of a data set's JPEG files."""
    files = sorted(os.path.relpath(os.path.join(d, f), directory)
                   for d, _, names in os.walk(directory) for f in names
                   if f.endswith(".jpg"))
    digests = []
    for f in files:
        with open(os.path.join(directory, f), "rb") as fh:
            digests.append(hashlib.sha256(fh.read()).hexdigest())
    return files, digests


def run_outputs(run: str, directory: str, result_dir: str) -> dict:
    """One run of the JAX package's benchmark driver on a mini."""
    _setup()
    import numpy as np

    import benchmark  # the root driver of the JAX package
    from vanishing_points_2017_tpu import weights as wload
    from vanishing_points_2017_tpu.data import datasets as dsets
    from vanishing_points_2017_tpu.data.cache import StageCache
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    _, flag, jax_name, extra = RUNS[run]
    cfg = PipelineConfig()
    key = cfg.cache_key() + ("_devdet_" + cfg.det_key() if extra else "")
    stage = ("result_w" + wload.weights_identity() + "_m"
             + wload.mean_identity())
    cache = StageCache(os.path.join(result_dir, jax_name), key)
    records, start = dsets.DATASETS[jax_name][0](directory)
    for rec in records[:start]:  # the skipped split: placeholders
        cache.save(rec.name, stage, hp1=np.zeros(3), hp2=np.zeros(3))

    argv, sys.argv = sys.argv, [
        "benchmark.py", flag, "--dataset_dir", directory, "--result_dir",
        result_dir, "--run_cnn", "--batch", str(BATCH), "--no_weights_warn",
        *extra]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = benchmark.main()
    finally:
        sys.argv = argv
    text = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"benchmark.py {flag} failed:\n{text}")
    errs = [float(ln.split()[-1]) for ln in text.splitlines()
            if ln.startswith("max_error:")]
    auc = [float(ln.split()[-1]) for ln in text.splitlines()
           if ln.startswith("AUC:")][-1]
    res = [cache.load(r.name, stage) for r in records[start:]]
    assert len(errs) == len(res) == N_EVAL, text
    return {f"{run}_names": np.array([r.name for r in records[start:]]),
            f"{run}_hp1": np.stack([r["hp1"] for r in res]),
            f"{run}_hp2": np.stack([r["hp2"] for r in res]),
            f"{run}_err": np.array(errs), f"auc_{run}": np.asarray(auc)}


def reference(runs=tuple(RUNS)) -> dict:
    """The file's content for ``runs`` (all of them by default), with the
    digests of the data sets those runs read."""
    import numpy as np

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_minis(os.path.join(tmp, "minis"),
                           sorted({RUNS[r][0] for r in runs}))
        for name, directory in dirs.items():
            files, digests = jpeg_hashes(directory)
            out[f"files_{name}"] = np.array(files)
            out[f"sha256_{name}"] = np.array(digests)
        for run in runs:
            out |= run_outputs(run, dirs[RUNS[run][0]],
                               os.path.join(tmp, "results"))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    import time

    import numpy as np

    t0 = time.time()
    ref = reference()
    np.savez(args.out, **ref)
    aucs = ", ".join(f"{r} {float(ref[f'auc_{r}']):.4f}" for r in RUNS)
    print(f"wrote {args.out} in {time.time() - t0:.0f} s: AUC {aucs}")


if __name__ == "__main__":
    main()
