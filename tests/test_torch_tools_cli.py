"""Every ``python -m vanishing_points_2017_tpu_torch.tools.<name>`` command
on the CPU at a small size (``--device cpu``, 2-4 scenes, 1-2 jitters):
exit code 0 and the JAX script's lines; the detector flags take the JAX
scripts' values and refuse others; without ``--device cpu`` every command
raises when there is no GPU."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch.tools import (eval_device_detector,
                                                   eval_weights_artifacts,
                                                   perturb_knife_edge,
                                                   profile_detector,
                                                   profile_e2e,
                                                   revalidate_detector,
                                                   sweep_detector_gates)
from torch_cpu import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPACT = os.path.join(ROOT, "assets", "weights_compact.npz")
MODULES = {"eval_device_detector": eval_device_detector,
           "perturb_knife_edge": perturb_knife_edge,
           "revalidate_detector": revalidate_detector,
           "eval_weights_artifacts": eval_weights_artifacts,
           "sweep_detector_gates": sweep_detector_gates,
           "profile_detector": profile_detector,
           "profile_e2e": profile_e2e}


def _run(module, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(autouse=True)
def no_reference_photos(monkeypatch):
    monkeypatch.delenv("VP_TPU_REFERENCE_EXAMPLES", raising=False)


def test_eval_device_detector_three_paths():
    rc, out = _run(eval_device_detector, [
        "--device", "cpu", "--count", "3", "--batch", "2",
        "--paths", "host,full,ideal"])
    lines = out.splitlines()
    assert rc == 0
    assert [ln.split(":")[0] for ln in lines] == [
        "host-LSD path", "device-full path", "device segs + ideal prior",
        "gap (host - full)"], out
    assert "for 3 imgs" in lines[0] and "OK: within 0.02" in lines[3], out


def test_perturb_knife_edge_scenes(tmp_path):
    out_json = str(tmp_path / "ke.json")
    rc, out = _run(perturb_knife_edge, [
        "--device", "cpu", "--jitters", "2", "--scene_pool", "3",
        "--scenes", "1", "--json_out", out_json])
    lines = out.splitlines()
    assert rc == 0
    assert lines[0] == "(reference photos unavailable — skipping)", out
    assert lines[1].startswith("scene margins: min"), out
    assert lines[2].startswith("scene_0") and "flips " in lines[2], out
    assert lines[3] == f"wrote {out_json}", out
    with open(out_json) as f:
        report = json.load(f)
    assert report["jitters"] == 2 and len(report["scene_picks"]) == 1
    assert set(report["rows"][0]) == {
        "name", "base_err", "flip_rate", "err_median", "err_max",
        "rel_margin_base", "rel_margin_min", "rel_margin_median",
        "disagreement_max"}


def test_perturb_knife_edge_photo_probes(tmp_path, monkeypatch):
    """With the reference examples at hand (here three rendered scenes
    under the photographs' names, JPEG-coded), each photograph is probed;
    ``--photos_only`` stops there."""
    from vanishing_points_2017_tpu_torch.data.jpeg import encode_jpeg
    from vanishing_points_2017_tpu_torch.tools import REFERENCE_HORIZONS

    _, images = eval_device_detector.build_scene_set(3, size=320)
    for (name, _, _), img in zip(REFERENCE_HORIZONS, images):
        (tmp_path / name).write_bytes(encode_jpeg(img))
    monkeypatch.setenv("VP_TPU_REFERENCE_EXAMPLES", str(tmp_path))
    rc, out = _run(perturb_knife_edge, [
        "--device", "cpu", "--jitters", "1", "--photos_only",
        "--json_out", str(tmp_path / "ke.json")])
    lines = out.splitlines()
    assert rc == 0
    assert [ln.split()[0] for ln in lines[:3]] == [
        n for n, _, _ in REFERENCE_HORIZONS], out
    assert lines[3].endswith("(photos only)"), out


def test_revalidate_detector_gap_stage():
    rc, out = _run(revalidate_detector, [
        "--device", "cpu", "--count", "3", "--batch", "3", "--skip_pins"])
    assert rc == 0, out
    assert "A real photos: SKIPPED (reference photos unavailable)" in out
    assert "B synthetic AUC (3 scenes)" in out and "PASS" in out, out
    assert "C golden pins: SKIPPED (--skip_pins)" in out
    assert out.splitlines()[-1] == (
        "=== GATE: PASS (A real photos=skipped, B synthetic gap=ok, "
        "C golden pins=skipped) ===")


def test_revalidate_detector_pins_stage(monkeypatch):
    """Stage C runs its pytest node in a subprocess and passes on its exit
    code (here a quick node in place of the minutes-long golden pins)."""
    monkeypatch.setattr(revalidate_detector, "GOLDEN_PINS",
                        "tests/test_torch_misc.py::test_logger_singleton")
    rc, out = _run(revalidate_detector, [
        "--device", "cpu", "--skip_synthetic"])
    assert rc == 0, out
    assert out.splitlines()[-1] == (
        "=== GATE: PASS (A real photos=skipped, B synthetic gap=skipped, "
        "C golden pins=ok) ===")
    monkeypatch.setattr(revalidate_detector, "GOLDEN_PINS",
                        "tests/test_torch_misc.py::no_such_test")
    rc, out = _run(revalidate_detector, [
        "--device", "cpu", "--skip_synthetic"])
    assert rc == 1 and "C golden pins" in out and "FAIL" in out, out


def test_eval_weights_artifacts_table(tmp_path):
    missing = str(tmp_path / "none.npz")
    rc, out = _run(eval_weights_artifacts, [
        COMPACT, missing, "--device", "cpu", "--count", "2", "--batch",
        "2"])
    lines = out.splitlines()
    assert rc == 0
    assert lines[0] == "detecting (host C++ LSD, 2 scenes) ...", out
    assert lines[1].startswith(COMPACT) and "AUC" in lines[1], out
    assert lines[2] == f"{missing}: MISSING", out
    assert lines[4] == "| artifact | AUC@0.25 | size MB | vs best |", out
    assert lines[6].startswith("| weights_compact.npz [") and \
        lines[6].endswith("| +0.0000 |"), out


def test_sweep_detector_gates_rows():
    rc, out = _run(sweep_detector_gates, ["--device", "cpu", "--count", "2",
                                          "--size", "160"])
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 1 + len(sweep_detector_gates.VARIANTS)
    assert [v[0] for v in sweep_detector_gates.VARIANTS] == [
        "row"] * 4 + ["global"] * 2 + ["global!"]
    for line, (sel, budget, *_) in zip(lines[1:],
                                       sweep_detector_gates.VARIANTS):
        assert line.split()[:2] == [sel, str(budget)], out
        assert "(no photos)" in line, out


def test_profile_detector_rows():
    rc, out = _run(profile_detector, [
        "--device", "cpu", "--batch", "1", "--iters", "1", "--size", "96",
        "--budgets", "4096,2048"])
    assert rc == 0
    names = [ln.split(":")[0].strip() for ln in out.splitlines()[1:]]
    assert names == [
        "front (blur+grad)", "pack (edge bit-plane)", "ccl passes=8",
        "ccl passes=4", "ccl passes=2", "stats budget=4096",
        "stats runs_per_row=64", "stats runs_per_row=32",
        "whole detector budget=4096", "whole detector budget=4096 "
        "topk=approx", "whole detector budget=2048",
        "whole detector budget=2048 topk=approx",
        "whole detector selection=row", "whole detector ccl_passes=4",
        "whole detector ccl_passes=2",
        "sum of sub-stages (front, pack, ccl passes=8, stats)"], out
    assert out.splitlines()[0].startswith("device: cpu (no card")


def test_profile_e2e_record():
    rc, out = _run(profile_e2e, [
        "--device", "cpu", "--batches", "1", "--iters", "1", "--size", "96",
        "--em_variant_iters", "2"])
    rec = json.loads(out.splitlines()[-1])
    assert rc == 0
    assert rec["device"].startswith("cpu") and rec["rtt_ms"] > 0
    b1 = rec["batches"]["1"]
    assert {"det_ms", "post_ms", "em_host_syncs", "em_iterations"} <= set(b1)
    var = rec["em_variant"]
    assert var["num_iter"] == 2
    assert var["batch_max_iters_capped"] <= var["batch_max_iters_full"]
    assert np.isfinite(var["per_em_iter_ms_per_batch"])


@pytest.mark.parametrize("module", ["eval_device_detector",
                                    "revalidate_detector"])
@pytest.mark.parametrize("flag", [["--det_selection", "rows"],
                                  ["--det_topk", "fast"]])
def test_not_ported_flags_are_refused(module, flag, capsys):
    """The detector flags take what the JAX scripts pass (global / row,
    exact / approx) and refuse any other value before any work."""
    with pytest.raises(SystemExit) as exc:
        MODULES[module].main(["--device", "cpu", *flag])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag[0]}: invalid choice" in err


def test_detector_flags_reach_the_config(monkeypatch):
    """``--det_selection row --det_topk approx`` run the eval's full path
    and the gate under that configuration (the gate prints its det_key)."""
    from vanishing_points_2017_tpu_torch.tools import make_pipeline

    cfgs = []

    def spy(dev, cfg=None):
        cfgs.append(cfg)
        return make_pipeline(dev, cfg)

    flags = ["--det_selection", "row", "--det_topk", "approx"]
    monkeypatch.setattr(eval_device_detector, "make_pipeline", spy)
    monkeypatch.setattr(revalidate_detector, "make_pipeline", spy)
    rc, out = _run(eval_device_detector, [
        "--device", "cpu", "--count", "2", "--batch", "2", "--size", "160",
        "--paths", "full", *flags])
    assert rc == 0 and out.startswith("device-full path: AUC"), out
    monkeypatch.setattr(revalidate_detector, "stage_synthetic_gap",
                        lambda *a: (True, 1.0, 1.0, 0.0))
    rc, out = _run(revalidate_detector, ["--device", "cpu", "--skip_pins",
                                         *flags])
    assert rc == 0
    assert "det_key: detrow15-12-0.7-32768-approx-torch" in out, out
    assert [(c.det_selection, c.det_topk) for c in cfgs] == [
        ("row", "approx")] * 2


def test_bench_det_selection_flag_and_env(monkeypatch):
    """The bench's ``--det_selection`` defaults from
    ``BENCH_DET_SELECTION``, as the JAX bench reads it."""
    from vanishing_points_2017_tpu_torch import bench

    seen = []
    monkeypatch.setattr(bench, "measure",
                        lambda *a: (seen.append(a[-1]), ({}, {}))[1])
    monkeypatch.setenv("BENCH_DET_SELECTION", "row")
    for argv in ([], ["--det_selection", "global"]):
        with contextlib.redirect_stdout(io.StringIO()):
            assert bench.main(["--device", "cpu", *argv]) == 0
    assert seen == ["row", "global"]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_commands_raise_without_a_card(name):
    """The default ``--device cuda`` raises before any work when there is
    no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [COMPACT] if name == "eval_weights_artifacts" else []
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        MODULES[name].main(argv)
