"""CPU tests of the harness: its arithmetic on made-up numbers, that a
new configuration, traffic mix or per-layer metric is found by name from
files alone, that the run needs a card, and that the reference's raster
CCL is the port's. Tests marked ``gpu`` run a cell on the card; they
look for one inside the test."""

import json
import math
import os
import shutil
from types import SimpleNamespace

import pytest
import torch

from vpbench import counts, profile, run, scenes, weights
from vpbench.reference import detector as ref_det

ROOT = run.ROOT
FLOPS = 6_729_530_560  # per image, fc6 and fc7 dense


def test_percentile_is_over_all_batches():
    times = [0.1] * 95 + [0.5] * 5
    assert run.percentile(times, 95) == 0.1
    assert run.percentile(times + [0.9], 95) == 0.5
    assert run.percentile([3.0], 95) == 3.0
    assert run.percentile(list(range(1, 201)), 95) == 190


def test_window_rate_is_all_images_over_the_whole_window():
    # 3 fast batches and one slow one: the mean of per-batch rates would
    # read (3 * 32 / 0.1 + 32 / 1.0) / 4 = 248; the window's rate is not
    w = run.window_stats([0.1, 0.1, 0.1, 1.0], 32, 1.3)
    assert w["images_per_s"] == pytest.approx(4 * 32 / 1.3)
    assert w["images"] == 128 and w["batches"] == 4
    assert w["batch_ms_p95"] == pytest.approx(1000.0)
    assert w["batch_ms_median"] == pytest.approx(100.0)


def test_cnn_flops_from_the_configuration_shapes():
    from vanishing_points_2017_tpu_torch.models import cnn

    with open(os.path.join(ROOT, "vpbench", "configs", "vp_sd640.json")) as f:
        config = json.load(f)
    assert counts.cnn_flops_per_image(config["network"]) == FLOPS
    # the port's count on the weights both sides are given
    params, _ = weights.load(config, ROOT, "cpu")
    assert cnn.flops_per_image(params) == FLOPS


def test_weights_are_dense_at_the_published_widths():
    with open(os.path.join(ROOT, "vpbench", "configs", "vp_sd640.json")) as f:
        config = json.load(f)
    params, mean = weights.load(config, ROOT, "cpu")
    assert params["fc6"]["w"].shape == (57600, 4096)
    assert params["fc7"]["w"].shape == (4096, 4096)
    assert params["conv1"]["w"].shape == (96, 1, 11, 11)
    assert mean.shape == (500, 500)
    assert all("u" not in p for p in params.values())
    with pytest.raises(RuntimeError):
        weights.load(dict(config, weights_fingerprint="0" * 16), ROOT, "cpu")


def _trace(**kw):
    base = dict(window={}, stage_ms={}, em_syncs=[], profile={},
                config={}, on_card=False)
    base.update(kw)
    return SimpleNamespace(**base)


def test_step_mfu_and_idle_share_readers():
    with open(os.path.join(ROOT, "vpbench", "configs", "vp_sd640.json")) as f:
        config = json.load(f)
    mfu = run.reader("step_mfu")(_trace(window={"images_per_s": 200.0},
                                        config=config))
    assert mfu == pytest.approx(100 * FLOPS * 200.0 / 989e12)
    # over the untraced window's time of the same batches, not the
    # traced stretch's own span
    idle = run.reader("device_idle_share")(
        _trace(profile={"busy_s": 0.25, "window_s": 1.5, "paced_s": 1.0}))
    assert idle == pytest.approx(75.0)
    assert run.reader("device_idle_share")(_trace()) is None
    assert run.reader("step_mfu")(_trace(config=config)) is None


def test_stage_and_sync_readers_take_medians():
    serve = run.job("serve")
    tr = run.Trace({}, {}, torch.device("cpu"), {}, {}, None, 0, [],
                   serve.Traced({"em": [0.1, 0.3, 0.2], "render": [0.001]},
                                [80, 86, 83], [({"l": None}, None)],
                                torch.device("cpu")))
    assert run.reader("em_ms")(tr) == pytest.approx(200.0)
    assert run.reader("render_ms")(tr) == pytest.approx(1.0)
    assert run.reader("detector_ms")(tr) is None
    assert run.reader("em_host_syncs")(tr) == 83
    # device-time readers say nothing off the card
    assert run.reader("ccl_roofline")(tr) is None
    assert run.reader("render_roofline")(tr) is None


def test_roofline_shares_come_from_shapes():
    n_bytes, n_ops = counts.ccl_work(32, 639, 639)
    assert n_bytes == 2 * 32 * 639 * 639 * 4 and n_ops == 0
    share = counts.roofline_share(n_bytes, n_ops, 3.454e-3)
    assert share == pytest.approx(100 * n_bytes / 3.35e12 / 3.454e-3)
    # one horizontal line through the centre: curve beta = 0, one row
    # band per column
    l = torch.tensor([[[0.0, 1.0, 0.0]]])
    m = torch.tensor([[True]])
    b, o = counts.render_work(l, m, 100)
    assert b == 12 + 1 + 100 * 100
    covered = (o - 12 * 100 - 3 * 100 * 100) / 7
    assert covered == int(covered) and 100 <= covered <= 300
    b2, o2 = counts.render_work(l, torch.tensor([[False]]), 100)
    assert o2 == 3 * 100 * 100
    # the larger of the two times bounds the share
    assert counts.roofline_share(0, 67e9, 1.0) == pytest.approx(0.1)


class _Ev:
    def __init__(self, name, dev, start, end, kind="kernel"):
        self._n, self._d, self._s, self._e, self._k = name, dev, start, end, kind

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def activity_type(self):
        return self._k


def test_profile_summary_unions_device_intervals():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [_Ev(profile.WINDOW, cpu, 0, 1000, "user_annotation"),
          _Ev("k1", cuda, 100, 300), _Ev("k2", cuda, 200, 400),
          _Ev("k1", cuda, 700, 800),
          _Ev("copy", cuda, 950, 1100, "gpu_memcpy"),
          _Ev("annot", cuda, 0, 1000, "gpu_user_annotation"),
          _Ev("aten::item", cpu, 450, 650, "cpu_op"),
          _Ev("aten::_local_scalar_dense", cpu, 500, 600, "cpu_op")]
    s = profile.summarize(ev)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((300 + 100 + 50) * 1e-9)
    assert s["device_ops"][0] == ["k1", pytest.approx(300e-9)]
    gaps = dict((round(v * 1e9), k) for k, v in s["idle_gaps"])
    assert gaps[300] == "host aten::_local_scalar_dense"
    assert gaps[100] == "host python"
    # without the window's annotation: the busy union, uncut, and no gaps
    s = profile.summarize([e for e in ev if e.name() != profile.WINDOW])
    assert s["busy_s"] == pytest.approx((300 + 100 + 150) * 1e-9)
    assert "idle_gaps" not in s and "window_s" not in s
    assert profile.summarize([])["busy_s"] == 0


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "vpbench"), root / "vpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(root / "vpbench" / "configs" / "vp_sd640.json") as f:
        cfg = json.load(f)
    cfg["name"] = "vp_new"
    cfg["image"] = {"width": 1280, "height": 720}
    (root / "vpbench" / "configs" / "vp_new.json").write_text(json.dumps(cfg))
    (root / "vpbench" / "traffic" / "few_b4.json").write_text(json.dumps(
        {"inputs": "images", "batch": 4, "pool": 2, "judged": 1,
         "lines_per_vp": [10, 20],
         "outliers": [0, 5], "noise_sigma": 1.0, "n_pad": 512}))
    (root / "vpbench" / "limits" / "new_few_b4.json").write_text(
        (root / "vpbench" / "limits" / "sd640_scenes_b32.json").read_text())
    (root / "vpbench" / "metrics" / "window_batches.py").write_text(
        "def read(trace):\n    return trace.window.get('batches')\n")
    bench["configs"].append(dict(bench["configs"][0], name="vp_new",
                                 file="vpbench/configs/vp_new.json"))
    bench["workloads"].append({"name": "new_few_b4", "config": "vp_new",
                               "traffic": "few_b4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "window_batches", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "images_per_s",
                               "workloads": ["new_few_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b, wl, config, traffic = run.load_cell("new_few_b4", str(root))
    assert config["image"]["width"] == 1280 and traffic["batch"] == 4
    names = [m["name"] for m in run.cell_metrics(b, wl, True)]
    assert names == ["window_batches"]
    assert [m["name"] for m in run.cell_metrics(b, wl, False)] == [
        "images_per_s", "setup_s"]
    assert [m["name"] for m in run.cell_metrics(
        b, {"name": "sd640_scenes_b32"}, False)] == [
        "images_per_s", "batch_ms_p95", "setup_s"]
    read = run.reader("window_batches", str(root))
    assert read(SimpleNamespace(window={"batches": 7})) == 7
    pool = scenes.draw_pool(dict(traffic, pool=1, batch=1), 64, 36, 5)
    assert pool.images.shape == (1, 1, 36, 64)


def test_every_cell_reports_e2e_and_per_layer_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for wl in bench["workloads"]:
        _, _, config, traffic = run.load_cell(wl["name"])
        e2e = {m["name"] for m in run.cell_metrics(bench, wl, False)}
        assert {"setup_s", "images_per_s"} <= e2e
        per = run.cell_metrics(bench, wl, True)
        assert per
        for m in per:
            assert os.path.isfile(os.path.join(ROOT, "vpbench", "metrics",
                                               f"{m['name']}.py"))
        assert set(traffic["judge"]["limits"]) >= {
            "sphere_off", "grid_err", "em_hz_off", "hz_err"}


def test_run_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sd640_scenes_b32", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_run_does_not_fall_back_to_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would use it")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    bench, wl, config, traffic = run.load_cell("sd640_scenes_b32")
    with pytest.raises(RuntimeError):
        run.run(bench, wl, config, traffic, 1, 1.0, False, "cuda")


def test_reference_ccl_is_the_ports():
    from vanishing_points_2017_tpu_torch.ops import lines_device as ld

    tr = {"inputs": "images", "batch": 3, "pool": 1, "judged": 1,
          "lines_per_vp": [30, 60], "outliers": [10, 30],
          "noise_sigma": 3.0, "n_pad": 512}
    imgs = scenes.draw_pool(tr, 150, 110, 11).images[0]
    _, a, ux, uy = ld.gradient_front(imgs)
    packed = ld.pack_edge_masks(a, ux, uy, math.cos(math.radians(22.5)))
    for passes in (2, 8):
        assert torch.equal(ld.connected_components_ref(packed, passes),
                           ref_det.connected_components(packed, passes))
    lp, m = ld.detect_segments_device(imgs, max_segments=512,
                                      selection="global")
    det = {"max_segments": 512, "min_count": 15, "min_len_px": 12.0,
           "min_density": 0.7, "max_records": 32768}
    lp2, m2 = ref_det.detect_segments(imgs, det)
    assert torch.equal(m, m2) and int(m.sum()) > 20
    assert torch.equal(lp, lp2)


def _one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    _one_card()
    bench, wl, config, traffic = run.load_cell("sd640_scenes_b32")
    rec = run.run(bench, wl, config, traffic, 2 ** 31 + 3, 2.0, False)
    assert rec["correct"] and rec["device"]["platform"] == "gpu"
    assert rec["metrics"]["images_per_s"]["value"] > 0
    assert list(rec)[-1] == "checks"
