"""One-command detector re-validation gate
(``scripts/revalidate_detector.py`` of the JAX package).

Any change that can move the device detector's float32 output bits (its
scans, sorts, record budget, gate constants) re-rolls the EM's knife-edge
sensitivity. This runs, in one process on ``--device``:

  A. the real-photo gate: the device path on the 2017 reference's three
     example photographs (``$VP_TPU_REFERENCE_EXAMPLES``), horizon error
     against its published result figures <= 0.10 each; skipped, and said
     so, when they are not at hand;
  B. the synthetic AUC gap: the fixed-seed 50-scene protocol, host-LSD
     path against device-full path, AUC gap <= 0.005
     (``tools.eval_device_detector``'s functions);
  C. the golden pins: the port's miniset golden-AUC test
     (``tests/test_torch_datasets.py::test_golden_auc_minisets``) as a CPU
     pytest subprocess; ``--skip_pins`` skips it when only detector bits
     changed (the pins run the host-LSD path too).

and prints a PASS/FAIL block. Exit code 0 only when every stage that ran
passed.

    python -m vanishing_points_2017_tpu_torch.tools.revalidate_detector \\
        [--device cpu] [--count 50] [--batch 10] [--skip_pins] \\
        [--det_selection global|row] [--det_topk exact|approx] \\
        [--det_max_records R] [--horizon_tol T]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

from . import REFERENCE_HORIZONS, make_pipeline, reference_examples

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PHOTO_GATE = 0.10
AUC_GAP_GATE = 0.005
GOLDEN_PINS = "tests/test_torch_datasets.py::test_golden_auc_minisets"


def _fracs(hp1, hp2, image_shape):
    h, w = image_shape
    s = max(h, w) / 2.0
    return ((h / 2.0 - float(hp1[1]) * s) / h,
            (h / 2.0 - float(hp2[1]) * s) / h)


def stage_real_photos(pipe, examples: str):
    """-> (passed, [(name, err)]): each photograph alone through the
    device path."""
    rows = []
    for name, rl, rr in REFERENCE_HORIZONS:
        host = pipe.ingest_image(os.path.join(examples, name),
                                 target_size=640)
        out = pipe.process_images([host["gray"]])
        if not bool(out["em_valid"][0]):
            rows.append((name, float("inf")))
            continue
        fl, fr = _fracs(out["hp1"][0].cpu().numpy(),
                        out["hp2"][0].cpu().numpy(), host["image_shape"])
        rows.append((name, max(abs(fl - rl), abs(fr - rr))))
    return all(e <= PHOTO_GATE for _, e in rows), rows


def stage_synthetic_gap(pipe, count: int, batch: int, size: int):
    """-> (passed, host AUC, device AUC, gap)."""
    from .eval_device_detector import build_scene_set, run_path

    scenes, images = build_scene_set(count, size=size)
    host_auc = run_path("host", pipe, scenes, images, batch, size)["auc"]
    dev_auc = run_path("full", pipe, scenes, images, batch, size)["auc"]
    gap = host_auc - dev_auc
    return gap <= AUC_GAP_GATE, host_auc, dev_auc, gap


def stage_golden_pins():
    """The port's golden-AUC test on the CPU in a subprocess -> (passed,
    the last lines of its output)."""
    cmd = [sys.executable, "-m", "pytest", "-q", "--no-header", GOLDEN_PINS]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=1200)
    tail = "\n".join((r.stdout + r.stderr).splitlines()[-6:])
    return r.returncode == 0, tail


def main(argv: list[str] | None = None) -> int:
    from ..device import require_device
    from ..pipeline import PipelineConfig
    from ..weights import weights_identity
    from .eval_device_detector import add_detector_flags, detector_overrides

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--count", type=int, default=50,
                    help="synthetic scene count (stage B)")
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--skip_pins", action="store_true",
                    help="skip stage C (detector-only changes)")
    ap.add_argument("--skip_photos", action="store_true")
    ap.add_argument("--skip_synthetic", action="store_true")
    add_detector_flags(ap)
    ap.add_argument("--det_max_records", type=int, default=None)
    ap.add_argument("--horizon_tol", type=float, default=None)
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    overrides = detector_overrides(args)
    if args.det_max_records is not None:
        overrides["det_max_records"] = args.det_max_records
    if args.horizon_tol is not None:
        overrides["horizon_pos_gate_tol"] = args.horizon_tol
    cfg = dataclasses.replace(PipelineConfig(), **overrides)
    pipe = make_pipeline(dev, cfg)
    knobs = (" ".join(f"{k}={v}" for k, v in overrides.items())
             or "production defaults")
    print("=== detector re-validation gate ===")
    print(f"device: {dev}  weights: {weights_identity()}  cfg: {knobs}")
    print(f"det_key: {cfg.det_key()}")

    results = []  # (stage, "ok" | "FAIL" | "skipped")
    examples = reference_examples()
    if args.skip_photos or not os.path.isdir(examples):
        why = ("skipped by flag" if args.skip_photos
               else "reference photos unavailable")
        print(f"A real photos: SKIPPED ({why})")
        results.append(("A real photos", "skipped"))
    else:
        t0 = time.time()
        ok, rows = stage_real_photos(pipe, examples)
        print(f"A real photos (device path, gate {PHOTO_GATE}) "
              f"[{time.time() - t0:.0f}s]:")
        for name, err in rows:
            print(f"  {name:<28s} err {err:.3f}  "
                  f"{'PASS' if err <= PHOTO_GATE else 'FAIL'}")
        results.append(("A real photos", "ok" if ok else "FAIL"))

    if args.skip_synthetic:
        results.append(("B synthetic gap", "skipped"))
    else:
        t0 = time.time()
        ok, host_auc, dev_auc, gap = stage_synthetic_gap(
            pipe, args.count, args.batch, args.size)
        print(f"B synthetic AUC ({args.count} scenes) "
              f"[{time.time() - t0:.0f}s]: host {host_auc:.4f}  "
              f"device {dev_auc:.4f}  gap {gap:+.4f} "
              f"(gate {AUC_GAP_GATE})  {'PASS' if ok else 'FAIL'}")
        results.append(("B synthetic gap", "ok" if ok else "FAIL"))

    if args.skip_pins:
        print("C golden pins: SKIPPED (--skip_pins)")
        results.append(("C golden pins", "skipped"))
    else:
        t0 = time.time()
        ok, tail = stage_golden_pins()
        print(f"C golden pins [{time.time() - t0:.0f}s]: "
              f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            print(tail)
        results.append(("C golden pins", "ok" if ok else "FAIL"))

    ran = [r for _, r in results if r != "skipped"]
    all_ok = bool(ran) and all(r == "ok" for r in ran)
    print(f"=== GATE: {'PASS' if all_ok else 'FAIL'} "
          f"({', '.join(f'{s}={r}' for s, r in results)}) ===")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
