"""Run one cell of the benchmark once.

    python3 -m vpbench.run --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration file (``configs``' ``file``) and its traffic file
(``vpbench/traffic/<traffic>.json``) say what to build and what to send.
Measures the PyTorch port (``vanishing_points_2017_tpu_torch``) on one
CUDA card, and raises without one.

Set-up (``setup_s``, from the start of this module): import the port,
load or build its kernels, read the configuration's weights and hand
them to the program (``vpbench/weights.py``), draw the cell's pool of
batches from ``--seed`` (``vpbench/scenes.py``), and warm up by sending
a few pool batches. Then the window: a closed loop with one batch in
flight, cycling through the pool in an order drawn from ``--seed``, each
batch a host-to-device copy from pinned memory, the entry call
(``pipeline.device_pipeline_full`` on images, ``device_pipeline_batch``
on padded lines) and the horizon's two points read back, until
``--seconds`` have passed and every judged batch has run.
``images_per_s`` is every image completed over the whole window;
``batch_ms_p95`` the 95th percentile of all batches' times, each from
its copy's dispatch to its horizon on the host.

``--trace 1`` runs the same window, then profiles the window's first
batches again in the same loop (``vpbench/profile.py``), times each
stage in passes of its own (``vpbench/stages.py``), and prints the
per-layer metrics that the readers of ``vpbench/metrics/`` take from
that record.

Once the window has closed and the device's peak memory is read, the
program's state is freed and the plain reference judges the outputs of
the pool batches drawn from the seed for judging (``vpbench/judge.py``),
on the weights the program was given. The numbers compared and their
limits are the last lines on stderr and the last key of the result, the
last line on stdout.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vanishing_points_2017_tpu")
WARM_BATCHES = 3   # pool batches sent in set-up
TRACE_BATCHES = 8  # the window's first batches, profiled and stage-timed
JUDGED_SPAN = 64   # judged batches are drawn among the window's first 64


def log(msg: str) -> None:
    sys.stderr.write(f"vpbench: {msg}\n")
    sys.stderr.flush()


def load_cell(name: str, root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """-> (BENCHMARK.json, the workload entry, its configuration, its
    traffic), each found by name; the cell's ``vpbench/limits`` file goes
    into the traffic under ``"judge"``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}")
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "vpbench", "traffic",
                           f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, "vpbench", "limits", f"{name}.json")) as f:
        traffic["judge"] = json.load(f)
    return bench, wl, config, traffic


def cell_metrics(bench: dict, wl: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics with
    ``trace`` 0, its per-layer ones with 1."""
    def has(m):
        return "workloads" not in m or wl["name"] in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if wl["name"] in m.get("workloads", [wl["name"]])
            and m["moves"] in names]


def reader(name: str, root: str = ROOT):
    """``vpbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "vpbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"vpbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pipeline_config(config: dict):
    """The configuration's ``pipeline`` section as the port's
    ``PipelineConfig``."""
    from vanishing_points_2017_tpu_torch.em import EMConfig
    from vanishing_points_2017_tpu_torch.pipeline import PipelineConfig

    p = config["pipeline"]
    d, hz = p["detector"], p["horizon"]
    cfg = PipelineConfig(
        sphere_size=p["sphere_size"], n_pad=p["n_pad"], em=EMConfig(**p["em"]),
        maxbest=hz["maxbest"], theta_vmin=hz["theta_vmin"],
        horizon_pos_gate_tol=hz["pos_gate_ideal_tol"],
        cnn_dtype=config["precision"]["cnn"], det_min_count=d["min_count"],
        det_min_len_px=d["min_len_px"], det_min_density=d["min_density"],
        det_selection=d["selection"], det_max_records=d["max_records"],
        det_topk=d["topk"])
    if cfg.det_kwargs()["max_segments"] != d["max_segments"]:
        raise ValueError("the detector's slots differ from n_pad")
    return cfg


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile of all values."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def window_stats(times: list, batch: int, window_s: float) -> dict:
    """The window's numbers from every batch's seconds: the rate is every
    image over the whole window, the p95 over all batches."""
    return {"images_per_s": len(times) * batch / window_s,
            "seconds": window_s, "batches": len(times),
            "images": len(times) * batch,
            "batch_ms_p95": percentile(times, 95) * 1e3,
            "batch_ms_median": statistics.median(times) * 1e3}


def card_info(dev) -> tuple[str, str | None]:
    """(the card's name, its power limit from nvidia-smi)."""
    import torch

    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return name, smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name, None


class Trace:
    """What a traced run recorded, for the metric readers."""

    def __init__(self, config, traffic, dev, window, stage_ms, em_syncs,
                 profile, judged):
        self.config, self.traffic, self.dev = config, traffic, dev
        self.window, self.stage_ms, self.em_syncs = window, stage_ms, em_syncs
        self.profile = profile
        self._judged = judged
        self.on_card = dev.type == "cuda"

    def stage_median_ms(self, stage: str):
        v = self.stage_ms.get(stage)
        return statistics.median(v) * 1e3 if v else None

    def device_images(self, k: int):
        """The images of the ``k``-th judged batch, on the device."""
        return self._judged[k][0].get("images")

    def device_lines(self, k: int):
        """The (l, lmask) the ``k``-th judged batch was rendered from in
        the window."""
        import torch

        batch, o = self._judged[k]
        if "images" in batch:
            from vanishing_points_2017_tpu_torch.ops import lines as lineops
            lm = o["segment_mask"]
            l = torch.where(lm[..., None],
                            lineops.segments_to_homogeneous(o["segments"]),
                            0.0)
            return l, lm
        return batch["l"], batch["lmask"]

    def cuda_ms(self, fn, iters: int = 20) -> float:
        """Mean milliseconds per call of ``fn`` between CUDA events, after
        one warm-up call."""
        import torch

        fn()
        torch.cuda.synchronize(self.dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(self.dev)
        return start.elapsed_time(end) / iters


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def make_step(model, mean, cfg, dev):
    """The timed path's call: one pool batch (host tensors: ``images``,
    or ``l``, ``lp``, ``lmask``) copied to ``dev`` without blocking and
    sent through the entry -> its outputs on the device."""
    from vanishing_points_2017_tpu_torch.pipeline import (
        device_pipeline_batch, device_pipeline_full)

    def step(host: dict) -> dict:
        x = {n: t.to(dev, non_blocking=True) for n, t in host.items()}
        if "images" in x:
            return device_pipeline_full(x["images"], model, mean, cfg)
        return device_pipeline_batch(x["l"], x["lp"], x["lmask"], model,
                                     mean, cfg)

    return step


def window_order(traffic: dict, seed: int) -> tuple[list, list]:
    """-> (the pool batches in the order the window sends them, the
    positions among the window's first :data:`JUDGED_SPAN` batches whose
    outputs are judged: distinct pool batches), both drawn from
    ``seed``."""
    n_pool = traffic["pool"]
    rng = np.random.default_rng([seed, 1])
    order = [int(k) for k in rng.permutation(n_pool)]
    span = min(n_pool, JUDGED_SPAN)
    judged = sorted(int(i) for i in rng.choice(
        span, min(traffic["judged"], span), replace=False))
    return order, judged


def _cpu_times() -> tuple[int, int]:
    """(steal, total) jiffies of the machine, from /proc/stat."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        return (v[7] if len(v) > 7 else 0), sum(v[:8])
    except OSError:
        return 0, 0


def host_state(t_wall: float, t_cpu: float, stat0: tuple) -> str:
    """One line on what the host did over a stretch that started at
    ``t_wall`` / ``t_cpu`` (``time.process_time``) / ``stat0``."""
    import torch

    wall = time.perf_counter() - t_wall
    steal, total = (b - a for a, b in zip(stat0, _cpu_times()))
    return (f"process CPU {100 * (time.process_time() - t_cpu) / wall:.1f}% "
            f"of the window, machine steal {100 * steal / max(total, 1):.2f}%"
            f", load {os.getloadavg()[0]:.2f}, {os.cpu_count()} CPUs, "
            f"{len(os.sched_getaffinity(0))} allowed, torch threads "
            f"{torch.get_num_threads()}")


def run(bench: dict, wl: dict, config: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, device: str = "cuda",
        root: str = ROOT) -> dict:
    """One run of the cell -> the result record (the line's object)."""
    import torch

    from vanishing_points_2017_tpu_torch import kernels
    from vanishing_points_2017_tpu_torch.pipeline import Pipeline

    from . import judge, scenes, weights

    marks = [("import", time.perf_counter())]
    dev = torch.device(device)
    gpu = dev.type == "cuda"
    if gpu:
        dev = torch.device("cuda", dev.index or 0)
        for k in kernels.all_kernels():
            k.build()
        torch.cuda.set_device(dev)
    marks.append(("kernels", time.perf_counter()))
    cfg = pipeline_config(config)
    params, mean = weights.load(config, root, dev)
    pipe = Pipeline(params, mean, cfg, device=dev)
    model = pipe.model
    marks.append(("weights", time.perf_counter()))

    width, height = config["image"]["width"], config["image"]["height"]
    pool = scenes.draw_pool(traffic, width, height, seed, dev)
    batch = traffic["batch"]
    if gpu:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("pool", time.perf_counter()))

    step = make_step(model, mean, cfg, dev)
    order, judged_pos = window_order(traffic, seed)
    for k in order[-WARM_BATCHES:]:
        out = step(pool.batch(k))
        out["hp1"].cpu(), out["hp2"].cpu()
    del out
    if gpu:
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{n} {t - p:.3f} s" for (n, t), p in
        zip(marks, [_T0] + [t for _, t in marks[:-1]])))

    judged: list = []
    times: list = []
    need = judged_pos[-1] + 1 if judged_pos else 1
    stat0, t_cpu = _cpu_times(), time.process_time()
    t_start = time.perf_counter()
    setup_s = t_start - _T0
    while True:
        k = order[len(times) % len(order)]
        t0 = time.perf_counter()
        out = step(pool.batch(k))
        out["hp1"].cpu(), out["hp2"].cpu()
        t1 = time.perf_counter()
        if len(times) in judged_pos:
            judged.append(out)
        times.append(t1 - t0)
        if t1 - t_start >= seconds and len(times) >= need:
            break
    del out
    window = window_stats(times, batch, t1 - t_start)
    window_s, images = window["seconds"], window["images"]
    host = host_state(t_start, t_cpu, stat0)
    peak = int(torch.cuda.max_memory_allocated(dev)) if gpu else 0
    name, power = card_info(dev) if gpu else ("cpu", None)
    log(f"{wl['name']} seed {seed}: setup {setup_s:.3f} s, "
        f"{len(times)} batches of {batch} in {window_s:.3f} s: "
        f"{window['images_per_s']:.3f} img/s, p95 "
        f"{window['batch_ms_p95']:.3f} ms, median "
        f"{window['batch_ms_median']:.3f} ms; peak {peak} B; {name}, "
        f"power limit {power}")
    log(f"host: {host}")

    result_metrics: dict = {}
    dev_info = {"platform": "gpu" if gpu else "cpu", "kind": name,
                "count": 1, "memory_peak_bytes": peak,
                "power_limit": power}
    breakdown = None
    judged = [({n: t.to(dev) for n, t in pool.batch(order[i]).items()}, o)
              for i, o in zip(judged_pos, judged)]
    wanted = cell_metrics(bench, wl, trace)
    if not trace:
        values = {"images_per_s": window["images_per_s"],
                  "batch_ms_p95": window["batch_ms_p95"],
                  "setup_s": setup_s}
        for m in wanted:
            result_metrics[m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        from . import profile, stages

        stretch = [pool.batch(order[i])
                   for i in range(min(TRACE_BATCHES, len(times)))]
        prof = {}
        if gpu:
            def pstep(i):
                o = step(stretch[i])
                o["hp1"].cpu(), o["hp2"].cpu()

            prof = profile.profile_stretch(pstep, len(stretch), dev)
            prof["paced_s"] = sum(times[:len(stretch)])
            dev_info["busy_s"] = prof["busy_s"]
            dev_info["window_s"] = prof["window_s"]
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
            log(f"profiled stretch: {len(stretch)} batches in "
                f"{prof['window_s']:.4f} s (device busy "
                f"{prof['busy_s']:.4f} s), the same batches in the "
                f"window {prof['paced_s']:.4f} s; with host ops traced "
                f"{prof['named_window_s']:.4f} s")
        stage_ms: dict = {}
        syncs = []
        for hb in stretch:
            t, n = stages.stage_pass(hb, model, mean, cfg)
            for s_, v in t.items():
                stage_ms.setdefault(s_, []).append(v)
            syncs.append(n)
        tr = Trace(config, traffic, dev, window, stage_ms, syncs, prof,
                   judged)
        for m in wanted:
            v = reader(m["name"], root)(tr)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        log("per layer: " + ", ".join(
            f"{k} {v['value']!r} {v['unit']}"
            for k, v in result_metrics.items()))

    # the program's state goes before the reference runs
    del model, pipe, step
    if gpu:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    from .reference.pipeline import Reference

    ref = Reference(config, params, mean)
    numbers, _ = judge.judge(ref, [b for b, _ in judged],
                             [o for _, o in judged],
                             traffic["judge"]["check"], width, height)
    limits = {k: traffic["judge"]["limits"][k] for k in numbers}
    correct = judge.verdict(numbers, limits)

    record = {"correct": correct, "attempted": images, "failed": 0,
              "metrics": result_metrics, "device": dev_info}
    if breakdown is not None:
        record["breakdown"] = breakdown
    record["checks"] = {
        k: {"value": v if math.isfinite(v) else str(v), "limit": limits[k]}
        for k, v in numbers.items()}
    for k in numbers:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    return record


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, wl, config, traffic = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 2
    record = run(bench, wl, config, traffic, args.seed, args.seconds,
                 bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}")
        return 3
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
