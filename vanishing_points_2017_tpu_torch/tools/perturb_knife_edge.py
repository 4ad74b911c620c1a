"""EM knife-edge perturbation harness (``scripts/perturb_knife_edge.py``
of the JAX package).

Two competing triplets can score nearly alike in the horizon search, so a
float32-level change of the segments flips the winner and tilts the
horizon. For each reference photograph (when the 2017 reference's examples
are at hand, ``$VP_TPU_REFERENCE_EXAMPLES``) and the most knife-edge scenes
of the fixed 50-scene synthetic set, this runs K jittered copies of the
DEVICE-DETECTED segment population through the EM and the horizon search
(``pipeline.device_pipeline_batch``) and measures

  - flip rate: the share of jitters whose horizon error against the
    reference figure / exact ground truth exceeds 0.10;
  - rel margin: (s1 - s2) / s1 of the top two triplet scores
    (``em.horizon.triplet_score_margin``), per jitter;
  - disagreement: how far the horizon would move if the runner-up won.

Jitter: i.i.d. Gaussian endpoint noise (sigma 0.5 px at 640 by default)
and 2% random segment dropout, drawn with numpy exactly as the JAX script
draws them. Prints one row per probe and writes the JSON report.

    python -m vanishing_points_2017_tpu_torch.tools.perturb_knife_edge \\
        [--device cpu] [--jitters 16] [--sigma_px 0.5] [--drop 0.02] \\
        [--scenes 5] [--consensus K] [--json_out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from . import REFERENCE_HORIZONS, make_pipeline, reference_examples

FLIP_GATE = 0.10


def jitter_population(rng: np.random.Generator, lp: np.ndarray,
                      lmask: np.ndarray, sigma_norm: float, drop: float):
    """One jittered copy of a padded segment population (the JAX script's
    draws: endpoint noise, then the dropout), kept segments compacted to
    the front."""
    lp2 = lp.copy()
    n = int(lmask.sum())
    lp2[:n] += rng.normal(scale=sigma_norm, size=(n, 4)).astype(np.float32)
    keep = rng.random(n) >= drop
    mask2 = lmask.copy()
    mask2[:n] = keep
    idx = np.concatenate([np.flatnonzero(mask2), np.flatnonzero(~mask2)])
    return lp2[idx], mask2[idx]


def jittered_populations(rng: np.random.Generator, lp0: np.ndarray,
                         m0: np.ndarray, k: int, sigma_norm: float,
                         drop: float):
    """The unjittered population, then ``k`` jittered copies drawn in
    order -> (lps, masks) lists of k + 1."""
    lps, masks = [lp0], [m0]
    for _ in range(k):
        lp2, m2 = jitter_population(rng, lp0, m0, sigma_norm, drop)
        lps.append(lp2)
        masks.append(m2)
    return lps, masks


def run_populations(pipe, cfg, lps: list, masks: list) -> dict:
    """A batch of padded (lp, lmask) populations through
    ``device_pipeline_batch`` with ``cfg`` -> numpy ``hp1``, ``hp2``,
    ``em_valid``, ``s1``, ``s2``, ``rel_margin``, ``disagreement`` per
    item. The margins run in the pipeline's fixed chunks, as the horizon
    search does."""
    from ..batching import in_chunks
    from ..em.horizon import triplet_score_margin
    from ..ops.lines import segments_to_homogeneous
    from ..pipeline import device_pipeline_batch

    dev = pipe.device
    lp = torch.from_numpy(np.stack(lps)).to(dev)
    m = torch.from_numpy(np.stack(masks)).to(dev)
    with torch.inference_mode():
        l = torch.where(m[..., None], segments_to_homogeneous(lp), 0.0)
        out = device_pipeline_batch(l, lp, m, pipe.model, pipe.mean, cfg)
        s1, s2, rel, dis = in_chunks(
            lambda v, c, a: triplet_score_margin(
                v, c, a, maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
                pos_gate_ideal_tol=cfg.horizon_pos_gate_tol),
            [out["vp"], out["counts"], out["alive"]])
    return {k: v.cpu().numpy() for k, v in dict(
        hp1=out["hp1"], hp2=out["hp2"], em_valid=out["em_valid"],
        s1=s1, s2=s2, rel_margin=rel, disagreement=dis).items()}


def photo_errs(res: dict, image_shape, rl: float, rr: float) -> np.ndarray:
    """Each item's largest fractional-row error at the left and right
    edges against a reference figure's horizon."""
    h, w = image_shape
    s = max(h, w) / 2.0
    fl = (h / 2.0 - res["hp1"][:, 1] * s) / h
    fr = (h / 2.0 - res["hp2"][:, 1] * s) / h
    return np.maximum(np.abs(fl - rl), np.abs(fr - rr))


def detect_device(pipe, cfg, gray: np.ndarray):
    """One grayscale image through the device detector (K1 on a GPU) at
    ``cfg``'s gates -> (lp (S, 4), lmask (S,)) numpy."""
    from ..ops.lines_device import detect_segments_device

    with torch.inference_mode():
        lp, lmask = detect_segments_device(
            torch.from_numpy(np.asarray(gray)[None]).to(pipe.device),
            **cfg.det_kwargs())
    return lp[0].cpu().numpy(), lmask[0].cpu().numpy()


def probe_row(name: str, res: dict, errs: np.ndarray) -> dict:
    """The report row of one probe (the JAX script's keys): item 0 is the
    unjittered population."""
    base_err, jerrs = errs[0], errs[1:]
    return {"name": name, "base_err": float(base_err),
            "flip_rate": float((jerrs > FLIP_GATE).mean()),
            "err_median": float(np.median(jerrs)),
            "err_max": float(jerrs.max()),
            "rel_margin_base": float(res["rel_margin"][0]),
            "rel_margin_min": float(res["rel_margin"][1:].min()),
            "rel_margin_median": float(np.median(res["rel_margin"][1:])),
            "disagreement_max": float(res["disagreement"].max())}


def row_line(row: dict, jitters: int) -> str:
    return (f"{row['name']:<28s} base {row['base_err']:.3f}  "
            f"flips {round(row['flip_rate'] * jitters)}/{jitters}  "
            f"err med/max {row['err_median']:.3f}/{row['err_max']:.3f}  "
            f"margin base/min/med {row['rel_margin_base']:.3f}/"
            f"{row['rel_margin_min']:.3f}/{row['rel_margin_median']:.3f}  "
            f"disagree_max {row['disagreement_max']:.3f}")


def main(argv: list[str] | None = None) -> int:
    from ..config import Paths
    from ..device import require_device
    from ..pipeline import Pipeline, PipelineConfig
    from .eval_device_detector import build_scene_set, scene_horizon_errors

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--jitters", type=int, default=16)
    ap.add_argument("--sigma_px", type=float, default=0.5)
    ap.add_argument("--drop", type=float, default=0.02)
    ap.add_argument("--scenes", type=int, default=5,
                    help="how many lowest-margin synthetic scenes to probe")
    ap.add_argument("--scene_pool", type=int, default=50)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--consensus", type=int, default=0,
                    help="K > 1 turns on the consensus horizon "
                         "(PipelineConfig.horizon_consensus), measured "
                         "under the same jitter protocol")
    ap.add_argument("--consensus_mode", default="dropout",
                    choices=("bootstrap", "dropout"))
    ap.add_argument("--consensus_guard", type=float, default=0.0)
    ap.add_argument("--photos_only", action="store_true",
                    help="skip the synthetic-scene probes")
    ap.add_argument("--json_out", default=os.path.join(
        Paths().result_dir, "knife_edge.json"))
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = PipelineConfig()
    if args.consensus > 1:
        cfg = dataclasses.replace(cfg, horizon_consensus=args.consensus,
                                  consensus_mode=args.consensus_mode,
                                  consensus_guard=args.consensus_guard)
    pipe = make_pipeline(dev, cfg)
    sigma_norm = args.sigma_px * 2.0 / args.size
    rng = np.random.default_rng(args.seed)
    report = {"sigma_px": args.sigma_px, "drop": args.drop,
              "jitters": args.jitters, "consensus": args.consensus,
              "consensus_mode": args.consensus_mode,
              "consensus_guard": args.consensus_guard, "rows": []}

    def probe(name, lp0, m0, err_fn):
        lps, masks = jittered_populations(rng, lp0, m0, args.jitters,
                                          sigma_norm, args.drop)
        res = run_populations(pipe, cfg, lps, masks)
        row = probe_row(name, res, err_fn(res))
        report["rows"].append(row)
        print(row_line(row, args.jitters), flush=True)

    def write_report(note: str = ""):
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json_out}{note}")

    # ---- reference photographs (device-detected populations)
    examples = reference_examples()
    if os.path.isdir(examples):
        for name, rl, rr in REFERENCE_HORIZONS:
            host = Pipeline.ingest_image(os.path.join(examples, name),
                                         target_size=640)
            lp0, m0 = detect_device(pipe, cfg, host["gray"])
            probe(name, lp0, m0,
                  lambda res, shape=host["image_shape"], a=rl, b=rr:
                  photo_errs(res, shape, a, b))
    else:
        print("(reference photos unavailable — skipping)")

    if args.photos_only:
        write_report(" (photos only)")
        return 0

    # ---- knife-edge synthetic scenes: lowest unperturbed margin
    scenes, images = build_scene_set(args.scene_pool, size=args.size)
    pops = [detect_device(pipe, cfg, img) for img in images]
    base = run_populations(pipe, cfg, [p[0] for p in pops],
                           [p[1] for p in pops])
    margins = base["rel_margin"]
    order = np.argsort(margins)[:args.scenes]
    print(f"scene margins: min {margins.min():.4f}  "
          f"median {np.median(margins):.4f}  "
          f"knife-edge picks: {sorted(order.tolist())}")
    report["scene_margin_median"] = float(np.median(margins))
    report["scene_picks"] = sorted(int(i) for i in order)
    for i in order:
        probe(f"scene_{int(i):02d}", pops[i][0], pops[i][1],
              lambda res, scene=scenes[i]: scene_horizon_errors(
                  [scene] * res["hp1"].shape[0], res["hp1"], res["hp2"],
                  args.size))
    write_report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
