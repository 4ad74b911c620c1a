"""Run one cell of the benchmark once.

    python3 -m vpbench.run --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration file (``configs``' ``file``), its traffic file
(``vpbench/traffic/<traffic>.json``) and its limits file
(``vpbench/limits/<cell>.json``) say what to build, what to send and
what to hold the outputs to. The traffic file names the cell's job
(``"job"``, ``"serve"`` without it): ``vpbench/jobs/<job>.py``, which
builds the program and runs its steps (``vpbench/jobs/__init__.py``
sets out what a job supplies). Measures the PyTorch port
(``vanishing_points_2017_tpu_torch``) on one CUDA card, and raises
without one.

Set-up (``setup_s``, from the start of this module): the job's build
and its warm-up. Then the window: a closed loop with one step in flight,
the job's steps one after another, each timed on the host from its start
to the host read that ends it, until ``--seconds`` have passed and every
judged step has run. ``images_per_s`` is every item completed over the
whole window; ``batch_ms_p95`` the 95th percentile of all steps' times.

``--trace 1`` runs the same window, then profiles the window's first
steps again in the same loop (``vpbench/profile.py``), takes the job's
traced extras, and prints the per-layer metrics that the readers of
``vpbench/metrics/`` take from that record (``Trace``); the readers of
the port's spans run the same steps once more (``vpbench/spans.py``).

Once the window has closed and the device's peak memory is read, the
job frees the program's state and judges the kept outputs of the judged
steps by the plain reference. The numbers compared and their limits are
the last lines on stderr and the last key of the result, the last line
on stdout.
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
DEFAULT_JOB = "serve"  # the job of a cell whose traffic names none
TRACE_BATCHES = 8  # the window's first steps, profiled and traced again
JUDGED_SPAN = 64   # judged steps are drawn among the window's first 64


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


def _load(kind: str, name: str, root: str):
    """``vpbench/<kind>/<name>.py`` of the checkout at ``root``, loaded
    by path."""
    path = os.path.join(root, "vpbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no {kind[:-1]} {name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(
        f"vpbench_{kind[:-1]}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """``vpbench/metrics/<name>.py``'s ``read``."""
    return _load("metrics", name, root).read


def job(name: str, root: str = ROOT):
    """``vpbench/jobs/<name>.py``, the module that runs a cell's job."""
    return _load("jobs", name, root)


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile of all values."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def window_stats(times: list, items: int, window_s: float) -> dict:
    """The window's numbers from every step's seconds, each step
    completing ``items`` items: the rate is every item over the whole
    window, the p95 over all steps."""
    return {"images_per_s": len(times) * items / window_s,
            "seconds": window_s, "batches": len(times),
            "images": len(times) * items,
            "batch_ms_p95": percentile(times, 95) * 1e3,
            "batch_ms_median": statistics.median(times) * 1e3}


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is within its limit (a NaN exceeds every
    limit)."""
    return all(numbers[k] <= limits[k] for k in numbers)


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
    """What a traced run recorded, for the metric readers: the window's
    numbers, the profiled stretch, the stretch itself (``stretch_step(i)``
    for i < ``stretch_steps``: the window's first steps, as the window ran
    them, and ``times``, every window step's seconds), and the job's
    traced extras, whose attributes it answers to as its own."""

    def __init__(self, config, traffic, dev, window, profile, stretch_step,
                 stretch_steps, times, extras=None):
        self.config, self.traffic, self.dev = config, traffic, dev
        self.window, self.profile = window, profile
        self.stretch_step, self.stretch_steps = stretch_step, stretch_steps
        self.times, self._extras = times, extras
        self.on_card = dev.type == "cuda"

    def __getattr__(self, name: str):
        extras = self.__dict__.get("_extras")
        if extras is None:
            raise AttributeError(name)
        return getattr(extras, name)

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


def window_order(traffic: dict, seed: int) -> tuple[list, list]:
    """-> (the pool's entries in the order the window sends them, the
    positions among the window's first :data:`JUDGED_SPAN` steps whose
    outputs are judged: distinct pool entries), both drawn from ``seed``:
    a helper for jobs that cycle through a pool of ``traffic["pool"]``
    and judge ``traffic["judged"]`` of them."""
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

    module = job(traffic.get("job", DEFAULT_JOB), root)
    marks: list = []

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    dev = torch.device(device)
    gpu = dev.type == "cuda"
    if gpu:
        dev = torch.device("cuda", dev.index or 0)
    work = module.build(config, traffic, seed, dev, root, mark)
    if gpu:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    work.warm_up()
    if gpu:
        torch.cuda.synchronize(dev)
    mark("warm-up")
    log("set-up: " + ", ".join(
        f"{n} {t - p:.3f} s" for (n, t), p in
        zip(marks, [_T0] + [t for _, t in marks[:-1]])))

    judged_pos = work.judged
    kept: list = []
    times: list = []
    need = judged_pos[-1] + 1 if judged_pos else 1
    stat0, t_cpu = _cpu_times(), time.process_time()
    t_start = time.perf_counter()
    setup_s = t_start - _T0
    while True:
        t0 = time.perf_counter()
        out = work.step(len(times))
        t1 = time.perf_counter()
        if len(times) in judged_pos:
            kept.append(work.keep(len(times), out))
        times.append(t1 - t0)
        if t1 - t_start >= seconds and len(times) >= need:
            break
    del out
    window = window_stats(times, work.items, t1 - t_start)
    window_s, items = window["seconds"], window["images"]
    host = host_state(t_start, t_cpu, stat0)
    peak = int(torch.cuda.max_memory_allocated(dev)) if gpu else 0
    name, power = card_info(dev) if gpu else ("cpu", None)
    log(f"{wl['name']} seed {seed}: setup {setup_s:.3f} s, "
        f"{len(times)} steps of {work.items} in {window_s:.3f} s: "
        f"{window['images_per_s']:.3f} items/s, p95 "
        f"{window['batch_ms_p95']:.3f} ms, median "
        f"{window['batch_ms_median']:.3f} ms; peak {peak} B; {name}, "
        f"power limit {power}")
    log(f"host: {host}")

    result_metrics: dict = {}
    dev_info = {"platform": "gpu" if gpu else "cpu", "kind": name,
                "count": 1, "memory_peak_bytes": peak,
                "power_limit": power}
    breakdown = None
    wanted = cell_metrics(bench, wl, trace)
    if not trace:
        values = {"images_per_s": window["images_per_s"],
                  "batch_ms_p95": window["batch_ms_p95"],
                  "setup_s": setup_s}
        for m in wanted:
            result_metrics[m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        from . import profile

        n = min(TRACE_BATCHES, len(times))
        prof = {}
        if gpu:
            prof = profile.profile_stretch(work.step, n, dev)
            prof["paced_s"] = sum(times[:n])
            dev_info["busy_s"] = prof["busy_s"]
            dev_info["window_s"] = prof["window_s"]
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
            log(f"profiled stretch: {n} steps in {prof['window_s']:.4f} s "
                f"(device busy {prof['busy_s']:.4f} s), the same steps in "
                f"the window {prof['paced_s']:.4f} s; with host ops traced "
                f"{prof['named_window_s']:.4f} s")
        tr = Trace(config, traffic, dev, window, prof, work.step, n, times,
                   work.traced(kept, n))
        for m in wanted:
            v = reader(m["name"], root)(tr)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        log("per layer: " + ", ".join(
            f"{k} {v['value']!r} {v['unit']}"
            for k, v in result_metrics.items()))

    # the program's state goes before the reference runs
    work.free()
    if gpu:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    numbers = work.judge(kept)
    limits = {k: traffic["judge"]["limits"][k] for k in numbers}
    correct = verdict(numbers, limits)

    record = {"correct": correct, "attempted": items, "failed": 0,
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
