"""CPU tests of a cell's job (``vpbench/jobs/``): a job that exists only
as a new file in a checkout runs through the harness by name, an unknown
job raises with its name, the serving job builds today's
``PipelineConfig`` and passes the pipeline's other keys through, sends
the pool in the order drawn from the seed, and a tiny serving cell runs
to a record with every key of the result line."""

import copy
import hashlib
import json
import os
import shutil

import pytest
import torch

from vpbench import judge, run

ROOT = run.ROOT
CELL = "sd640_scenes_b32"

STUB_JOB = '''"""A stub job: step i gives i * i; its judge checks them."""

import time
from types import SimpleNamespace


class Squares:
    def __init__(self, traffic):
        self.items = traffic["items"]
        self.judged = [1, 3]
        self.fault = traffic["fault"]
        self.warmed = False

    def warm_up(self):
        self.warmed = True

    def step(self, i):
        time.sleep(0.002)
        return i * i + (self.fault and i == 3)

    def keep(self, i, out):
        return i, out

    def traced(self, kept, n):
        return SimpleNamespace(kept_n=len(kept))

    def free(self):
        self.freed = True

    def judge(self, kept):
        assert self.warmed and self.freed
        return {"wrong": float(sum(o != i * i for i, o in kept)),
                "kept": float(len(kept))}


def build(config, traffic, seed, dev, root, mark):
    mark("squares")
    return Squares(traffic)
'''


def _digests(base) -> dict:
    out = {}
    for d, _, fs in os.walk(base):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _stub_checkout(tmp_path, fault: bool):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "vpbench"), root / "vpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "vpbench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (root / "vpbench" / "jobs" / "squares.py").write_text(STUB_JOB)
    (root / "vpbench" / "configs" / "none.json").write_text("{}")
    (root / "vpbench" / "traffic" / "squares_b5.json").write_text(
        json.dumps({"job": "squares", "items": 5, "fault": fault}))
    (root / "vpbench" / "limits" / "squares_b5.json").write_text(
        json.dumps({"check": {}, "limits": {"wrong": 0, "kept": 2}}))
    for name, body in (("stub_steps", "len(trace.times)"),
                       ("stub_kept", "trace.kept_n")):
        (root / "vpbench" / "metrics" / f"{name}.py").write_text(
            f"def read(trace):\n    return {body}\n")
        bench["per_layer"].append({
            "name": name, "unit": "steps", "better": "higher",
            "source": "program_counter", "layer": "stub",
            "moves": "images_per_s", "workloads": ["squares_b5"]})
    bench["configs"].append({"name": "none", "source": "x",
                             "file": "vpbench/configs/none.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "squares_b5", "config": "none",
                               "traffic": "squares_b5", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


@pytest.mark.parametrize("fault,trace", [(False, False), (False, True),
                                         (True, False)])
def test_a_job_in_a_new_file_runs_through_the_harness(tmp_path, fault,
                                                      trace):
    root, before = _stub_checkout(tmp_path, fault)
    b, wl, config, traffic = run.load_cell("squares_b5", str(root))
    rec = run.run(b, wl, config, traffic, 2 ** 31 + 41, 0.05, trace,
                  device="cpu", root=str(root))
    after = _digests(root / "vpbench")
    assert {k: after[k] for k in before} == before
    assert list(rec) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert rec["correct"] == (not fault)
    assert rec["checks"] == {"wrong": {"value": float(fault), "limit": 0},
                             "kept": {"value": 2.0, "limit": 2}}
    assert rec["attempted"] % 5 == 0 and rec["attempted"] >= 4 * 5
    if trace:
        steps = rec["metrics"]["stub_steps"]["value"]
        assert rec["attempted"] == steps * 5
        assert rec["metrics"]["stub_kept"]["value"] == 2
    else:
        assert list(rec["metrics"]) == ["images_per_s", "setup_s"]
        assert rec["metrics"]["images_per_s"]["value"] > 0


def test_an_unknown_job_raises_with_its_name():
    bench, wl, config, traffic = run.load_cell(CELL)
    with pytest.raises(ValueError, match="no_such_job"):
        run.run(bench, wl, config, dict(traffic, job="no_such_job"), 1, 0.1,
                False, device="cpu")
    assert "job" not in traffic  # the cell's job is the default, serving


def _config():
    with open(os.path.join(ROOT, "vpbench", "configs", "vp_sd640.json")) as f:
        return json.load(f)


def test_serving_builds_todays_pipeline_config():
    from vanishing_points_2017_tpu_torch.em import EMConfig
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    config = _config()
    cfg = run.job("serve").pipeline_config(config)
    want = PipelineConfig(
        sphere_size=500, n_pad=512,
        em=EMConfig(**config["pipeline"]["em"]), maxbest=20,
        theta_vmin=0.3141592653589793, horizon_pos_gate_tol=8.0,
        cnn_dtype="bfloat16", det_min_count=15, det_min_len_px=12.0,
        det_min_density=0.7, det_selection="global", det_max_records=32768,
        det_topk="exact")
    assert cfg == want
    assert cfg.horizon_consensus == 0 and cfg.em.num_iter == 100


def test_serving_passes_other_pipeline_keys_through():
    serve = run.job("serve")
    config = _config()
    p = config["pipeline"]
    p.update(horizon_consensus=8, consensus_mode="bootstrap",
             consensus_seed=3, consensus_guard=0.5)
    cfg = serve.pipeline_config(config)
    assert (cfg.horizon_consensus, cfg.consensus_mode, cfg.consensus_seed,
            cfg.consensus_guard) == (8, "bootstrap", 3, 0.5)
    for bad in ({"no_such_field": 1}, {"maxbest": 5}):
        c = copy.deepcopy(config)
        c["pipeline"].update(bad)
        with pytest.raises(ValueError, match=next(iter(bad))):
            serve.pipeline_config(c)


def _small():
    bench, wl, config, traffic = run.load_cell(CELL)
    config = copy.deepcopy(config)
    config["image"] = {"width": 160, "height": 128}
    return bench, wl, config, dict(traffic, batch=2, pool=2, judged=1)


def test_serving_sends_the_pool_in_the_seeds_order():
    traffic = run.load_cell(CELL)[3]
    seed = 2 ** 31 + 5
    order, judged = run.window_order(traffic, seed)
    assert order[:8] == [238, 10, 132, 88, 136, 77, 93, 143]
    assert order[-3:] == [171, 4, 241] and judged == [14, 22, 28, 36]

    _, _, config, small = _small()
    marks = []
    work = run.job("serve").build(config, dict(small, pool=4, judged=2),
                                  seed, torch.device("cpu"), ROOT,
                                  marks.append)
    assert marks == ["import", "kernels", "weights", "pool"]
    assert (work.order, work.judged) == run.window_order(
        dict(small, pool=4, judged=2), seed)
    assert work.items == 2
    sent = []

    def record(host):
        sent.append(next(k for k in range(4) if torch.equal(
            host["images"], work.pool.images[k])))
        return {"hp1": torch.zeros(2, 2), "hp2": torch.zeros(2, 2)}

    work._step = record
    work.warm_up()
    assert sent == work.order[-3:]
    sent.clear()
    for i in range(6):
        out = work.step(i)
    assert sent == [work.order[i % 4] for i in range(6)]
    host, kept = work.keep(5, out)
    assert kept is out and torch.equal(host["images"],
                                       work.pool.images[work.order[1]])


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_serving_cell_gives_every_key(trace):
    bench, wl, config, traffic = _small()
    rec = run.run(bench, wl, config, traffic, 2 ** 31 + 7, 0.2, trace,
                  device="cpu")
    assert list(rec) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert rec["correct"] and rec["failed"] == 0
    assert rec["attempted"] % 2 == 0 and rec["attempted"] >= 2
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0, "power_limit": None}
    assert list(rec["checks"]) == list(judge.NUMBERS)
    for k, v in rec["checks"].items():
        assert v["limit"] == traffic["judge"]["limits"][k]
        assert v["value"] <= v["limit"]
    if not trace:
        assert list(rec["metrics"]) == ["images_per_s", "batch_ms_p95",
                                        "setup_s"]
    else:
        # off the card: the stage passes, the EM's syncs and the rate
        assert list(rec["metrics"]) == [
            "detector_ms", "render_ms", "cnn_ms", "step_mfu", "em_ms",
            "em_host_syncs", "horizon_ms"]
    assert all(v["value"] > 0 for v in rec["metrics"].values())
