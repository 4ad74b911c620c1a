"""The device's busy time over a stretch of the timed loop, from
``torch.profiler`` (CUPTI): no stage synchronizes, the loop as timed.

The stretch runs twice. First with the device's activity recorded and
no host operation traced, which leaves the host's pace as in the window:
its busy time is the union of the device's kernel, copy and set
intervals, its window the host clock's span of the stretch, which ends
in a synchronize. Then with the host's operations traced too, inside a
``vpbench.window`` annotation, only to name the idle gaps: the longest
stretches between device intervals, each by the innermost host
operation running at its middle ("python" where none is). Tracing every
host operation slows a launch-bound loop about twofold, so its window
gives no idle share.
"""

from __future__ import annotations

import math
import time

import torch

WINDOW = "vpbench.window"
DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
TOP = 10
# the profiler's own work, named as such where it is what the host runs
PROFILER_OPS = {"Activity Buffer Request": "profiler buffer request"}


def _span(e) -> tuple[int, int]:
    s = e.start_ns()
    return s, s + e.duration_ns()


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    if e.device_type() != DeviceType.CUDA or e.name() == WINDOW:
        return False
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return False
    return not hasattr(e, "activity_type") or \
        e.activity_type() in DEVICE_ACTIVITIES


def _union(spans: list) -> list:
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """Kineto events of one profiled stretch -> ``busy_s`` and
    ``device_ops`` (the top device operations by total seconds); where a
    ``vpbench.window`` annotation bounds the stretch, the intervals are
    cut to it and ``window_s`` and ``idle_gaps`` (the longest gaps, each
    named by the host's operation) come too."""
    from torch.autograd import DeviceType

    win = [_span(e) for e in events if e.name() == WINDOW
           and e.device_type() == DeviceType.CPU]
    w0, w1 = win[0] if win else (-math.inf, math.inf)
    dev, host = [], []
    by_name: dict = {}
    for e in events:
        s, t = _span(e)
        if t <= w0 or s >= w1:
            continue
        if _is_device(e):
            s, t = max(s, w0), min(t, w1)
            dev.append((s, t))
            by_name[e.name()] = by_name.get(e.name(), 0) + (t - s)
        elif e.device_type() == DeviceType.CPU and e.name() != WINDOW:
            host.append((s, t, PROFILER_OPS.get(e.name(), e.name())))
    busy = _union(dev)
    if not win:
        return {"busy_s": sum(t - s for s, t in busy) / 1e9,
                "device_ops": _top(by_name)}
    busy_ns = sum(t - s for s, t in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, t in gaps[:TOP]:
        mid = (s + t) // 2
        inner = [h for h in host if h[0] <= mid < h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "python"
        named.append([f"host {name}"[:96], (t - s) / 1e9])
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": _top(by_name), "idle_gaps": named}


def _top(by_name: dict) -> list:
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k[:96], v / 1e9] for k, v in ops]


def profile_stretch(step, n: int, dev: torch.device) -> dict:
    """Run ``step(i)`` for i < n twice under the profiler, as set out
    above -> ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps``,
    and ``named_window_s``, the span of the stretch with host operations
    traced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    out = summarize(prof.profiler.kineto_results.events())
    out["window_s"] = t1 - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(n):
                step(i)
            torch.cuda.synchronize(dev)
    named = summarize(prof.profiler.kineto_results.events())
    out["idle_gaps"] = named.get("idle_gaps", [])
    out["named_window_s"] = named.get("window_s", 0.0)
    return out
