"""Benchmark driver of the PyTorch port (the root ``benchmark.py`` of the
JAX package, on a torch device).

    python -m vanishing_points_2017_tpu_torch.benchmark --synthetic --run_em
    python -m vanishing_points_2017_tpu_torch.benchmark --synthetic --run_em \\
        --device_detect
    python -m vanishing_points_2017_tpu_torch.benchmark --yud \\
        --dataset_dir <York Urban root> --run_em

Picks a dataset (``--yud``, ``--ecd``, ``--hlw`` with ``--dataset_dir``, or
``--synthetic``, which needs no files), computes the per-image stages that are not cached yet,
then prints each image's ``max_error`` and the horizon-error AUC at cutoff
0.25. Stage 1 runs on the host: load + LSD (``Pipeline.ingest``), or load
+ grayscale only with ``--device_detect``. Stage 2 (``--run_cnn`` or
``--run_em``, one fused stage) runs the rest on ``--device`` in batches of
``--batch``, the last batch padded with copies. Stage results live in
``.npz`` files under ``--result_dir`` (by default ``config.Paths``'s:
``$VP_TPU_RESULTS``, else ``build/results/`` of this checkout, so two
checkouts never serve each other's results), keyed
by the configuration, the path and the weights and mean fingerprints.

YUD is evaluated at its native size, ECD and HLW resized to fit 800 x 800;
the first 25 records of YUD and ECD are the train/val split and are not
evaluated. The images are JPEG, sequential or progressive
(``data/jpeg.py``), or PNG.
``--weights``/``--mean`` take ``.npz``/``.npy`` or Caffe's
``.caffemodel``/``.binaryproto``. The error CDF is plotted into
``--result_dir`` where matplotlib is installed, and skipped with a line
saying so where it is not. The JAX driver's ``--update_datalist`` (the real datasets' file
lists) and ``--no_weights_warn`` (the port always loads a weights
artifact) have nothing to act on here and are not accepted.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .config import Paths

RESULT_DIR = Paths().result_dir
# flag -> (data set's name in data.datasets.DATASETS, help)
DATASET_FLAGS = {"yud": ("york", "York Urban dataset"),
                 "ecd": ("eurasian", "Eurasian Cities dataset"),
                 "hlw": ("horizon", "Horizon Lines in the Wild"),
                 "synthetic": ("synthetic", "self-contained synthetic "
                               "benchmark (no downloads)")}


def cache_key(cfg, device_detect: bool) -> str:
    """Result identity: device-detector results also key on the detector
    configuration, host-LSD results do not depend on it."""
    return cfg.cache_key() + ("_devdet_" + cfg.det_key() if device_detect
                              else "")


def ingest_stage(pipe, records, cache, target, device_detect: bool,
                 update: bool = False) -> float:
    """Stage 1 for every record not cached yet; returns its host seconds."""
    seconds = 0.0
    for rec in records:
        stage = "gray" if device_detect else "lines"
        if cache.has(rec.name, stage) and not update:
            continue
        img = rec.image if rec.image is not None else rec.image_path
        t0 = time.perf_counter()
        if device_detect:
            host = pipe.ingest_image(img, target_size=target)
        else:
            host = pipe.ingest(img, target_size=target)
        seconds += time.perf_counter() - t0
        if device_detect:
            cache.save(rec.name, "gray", gray=host["gray"],
                       image_shape=np.asarray(host["image_shape"]))
            print(f"gray: {rec.name}  shape={host['image_shape']}")
        else:
            cache.save(rec.name, "lines", l=host["l"], lp=host["lp"],
                       lmask=host["lmask"], segments=host["segments"],
                       image_shape=np.asarray(host["image_shape"]))
            print(f"lines: {rec.name}  segments={host['segments'].shape[0]}")
    return seconds


def device_stage(pipe, records, cache, result_stage: str, batch: int,
                 device_detect: bool, update: bool = False):
    """Stage 2 for every record without a result; returns (images,
    seconds). Images are batched in record order (grouped by shape with
    ``device_detect``), the last batch of a group padded with copies of
    its last image, so the batch size is always ``batch``."""
    todo = [r for r in records
            if update or not cache.has(r.name, result_stage)]
    if device_detect:
        by_shape: dict[tuple, list] = {}
        for r in todo:
            g = cache.load(r.name, "gray")
            by_shape.setdefault(tuple(g["image_shape"]), []).append(
                (r, g["gray"]))
        groups = [chunk for _, recs in sorted(by_shape.items())
                  for chunk in (recs[i:i + batch]
                                for i in range(0, len(recs), batch))]
    else:
        groups = [[(r, None) for r in todo[i:i + batch]]
                  for i in range(0, len(todo), batch)]
    t0 = time.perf_counter()
    n_done = 0
    for gi, chunk in enumerate(groups):
        recs = [r for r, _ in chunk]
        if device_detect:
            items = [g for _, g in chunk]
        else:
            items = [cache.load(r.name, "lines") for r in recs]
        items += [items[-1]] * (batch - len(items))
        out = (pipe.process_images(items) if device_detect
               else pipe.process_batch(items))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for j, rec in enumerate(recs):
            cache.save(rec.name, result_stage,
                       **{k: v[j] for k, v in out.items()})
        n_done += len(recs)
        print(f"device batch {gi}: {len(recs)} imgs")
    return n_done, time.perf_counter() - t0


def horizon_errors(records, cache, result_stage: str, device_detect: bool,
                   start: int = 0):
    """The reference's eval loop: each evaluated image's normalized
    horizon error (printed as ``max_error``), skipping the first ``start``
    records; -> (errors, skipped)."""
    from .data.io import normalized_horizon_error

    errors, skipped = [], 0
    for count, rec in enumerate(records, 1):
        if count <= start:
            continue
        if rec.true_horizon is None or not cache.has(rec.name, result_stage):
            skipped += 1
            continue
        res = cache.load(rec.name, result_stage)
        shape = cache.load(rec.name, "gray" if device_detect
                           else "lines")["image_shape"]
        # crossed in float32, as the reference crosses them
        est = np.cross(res["hp1"].astype(np.float32),
                       res["hp2"].astype(np.float32))
        err = normalized_horizon_error(est, rec.true_horizon,
                                       width=int(shape[1]),
                                       height=int(shape[0]))
        print(f"max_error: {err}")
        errors.append(err)
    return np.array(errors), skipped


def plot_cdf(plot_points: np.ndarray, out_png: str) -> None:
    """The error CDF up to the cutoff, as the reference shows it; best
    effort: without matplotlib a line says that the plot was skipped."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(plot_points[:, 0], plot_points[:, 1], "-", lw=2, c="b")
        ax.set_xlabel("horizon error", fontsize=18)
        ax.set_ylabel("fraction of images", fontsize=18)
        ax.axis([0, 0.25, 0, 1])
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"CDF plot: {out_png}")
    except Exception as e:
        print(f"plot skipped: {e}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for flag, (_, text) in DATASET_FLAGS.items():
        ap.add_argument(f"--{flag}", action="store_true", help=text)
    ap.add_argument("--dataset_dir", default=None,
                    help="dataset root (YUD/ECD/HLW)")
    ap.add_argument("--result_dir", default=RESULT_DIR,
                    help="stage-cache directory (default: build/results/ "
                         "of this checkout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--update_datafiles", action="store_true",
                    help="recompute cached stages")
    ap.add_argument("--run_cnn", action="store_true",
                    help="run the fused CNN+EM device stage")
    ap.add_argument("--run_em", action="store_true",
                    help="alias of --run_cnn (stages are fused)")
    ap.add_argument("--weights", default=None,
                    help=".npz params / .caffemodel to load")
    ap.add_argument("--mean", default=None,
                    help="mean image (.npy or .binaryproto)")
    ap.add_argument("--batch", type=int, default=8,
                    help="device batch for the fused stage")
    ap.add_argument("--device_detect", action="store_true",
                    help="line detection on the device (no host LSD)")
    ap.add_argument("--num_synthetic", type=int, default=50)
    ap.add_argument("--consensus", type=int, default=0, metavar="K",
                    help="K-member dropout-ensemble horizon (medoid pick); "
                         "0 = single EM. Enters the result-cache identity")
    args = ap.parse_args(argv)

    name = next((n for flag, (n, _) in DATASET_FLAGS.items()
                 if getattr(args, flag)), None)
    if name is None:
        ap.error("pick a dataset: --yud / --ecd / --hlw / --synthetic")
    if name != "synthetic" and not args.dataset_dir:
        ap.error(f"--dataset_dir required for {name}")

    from . import weights as wload
    from .data import datasets as dsets
    from .data.cache import StageCache
    from .metrics import calc_auc
    from .pipeline import Pipeline, PipelineConfig, require_device

    dev = require_device(args.device)
    cfg = PipelineConfig(horizon_consensus=args.consensus)
    params, mean = wload.load_params_and_mean(args.weights, args.mean,
                                              device=dev)
    pipe = Pipeline(params, mean, cfg, device=dev)
    adapter, target = dsets.DATASETS[name]
    if name == "synthetic":
        records, start = adapter(count=args.num_synthetic)
    else:
        records, start = adapter(args.dataset_dir)

    cache = StageCache(os.path.join(args.result_dir, name),
                       cache_key(cfg, args.device_detect))
    wfp = wload.weights_identity(args.weights)
    mfp = wload.mean_identity(args.mean)
    result_stage = "result_w" + wfp + "_m" + mfp
    print(f"dataset: {name}  images: {len(records)}  skip: {start}  "
          f"weights: {wfp}  mean: {mfp}  device: {dev}")

    ingest_stage(pipe, records, cache, target, args.device_detect,
                 args.update_datafiles)
    if args.run_cnn or args.run_em:
        n_done, dt = device_stage(pipe, records, cache, result_stage,
                                  args.batch, args.device_detect,
                                  args.update_datafiles)
        if n_done:
            print(f"device stage: {n_done} imgs in {dt:.2f}s "
                  f"({n_done / dt:.2f} img/s)")

    start_time = time.time()
    errors, skipped = horizon_errors(records, cache, result_stage,
                                     args.device_detect, start)
    print("time elapsed: ", time.time() - start_time)
    print(f"evaluated: {len(errors)} / {len(records) - start} "
          f"(skipped: {skipped})")
    if not len(errors):
        print("no evaluated images (missing results or ground truth)")
        return 1
    auc, plot_points = calc_auc(errors, cutoff=0.25)
    print("AUC: ", auc)
    plot_cdf(plot_points, os.path.join(args.result_dir, f"auc_{name}.png"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
