"""The port's own spans and counters over the window's first steps.

One more pass over the traced stretch (the window's first
``run.TRACE_BATCHES`` steps, through the job's own step as the timed
loop ran it: for serving, the copy, the entry call, ``hp1``/``hp2`` read
back) inside the port's ``utils.profiling.trace`` session, which records
the device's activity and only the program's ``record_function`` spans
on the host. No synchronize is added but the session's own at its end.

``vpbench/run.py`` hands the readers the ``Trace``, which carries the
stretch (``stretch_step``, ``stretch_steps``) and the window's step
times (``times``); the pass runs once per traced run, and keeps its
numbers on the ``Trace`` for the other readers. A program without the
port's tracing (``profiling.Record``), or a run off the card, gives
nothing to read: the readers then return None.

Each number is the median over the stretch's batches of the per-batch
value in the session's record (``profiling.Record.batches``).
"""

from __future__ import annotations

import statistics
import sys

LAYERS = {"detector": "vp.detector", "render": "vp.render", "cnn": "vp.cnn",
          "em": "vp.em", "horizon": "vp.horizon"}
OUTSIDE = "outside"


def log(msg: str) -> None:
    sys.stderr.write(f"vpbench: {msg}\n")
    sys.stderr.flush()


def per_batch(batch: dict) -> dict:
    """One batch of the record -> this module's numbers for it."""
    out = {}
    for short, name in LAYERS.items():
        out[f"{short}_span_ms"] = batch["span_ms"].get(name, 0.0)
        out[f"{short}_busy_ms"] = batch["busy_ms"].get(name, 0.0)
        out[f"{short}_idle_ms"] = batch["idle_ms"].get(name, 0.0)
    out["outside_busy_ms"] = batch["busy_ms"].get(OUTSIDE, 0.0)
    out["outside_idle_ms"] = batch["idle_ms"].get(OUTSIDE, 0.0)
    out["em_trips"] = batch["spans"].get("vp.em.iteration", 0)
    out["em_launches"] = batch["launches"].get("vp.em", 0)
    out["em_host_reads"] = batch["counters"].get("em.host_reads", 0)
    return out


def summarize(rec) -> dict | None:
    """A ``profiling.Record`` -> {number: median over its batches}, with
    ``idle_ms`` (the stretch's device idle), ``attributed_idle_ms`` (the
    five layers' and ``outside``'s summed over the batches),
    ``window_ms``, ``batches`` and ``unlaunched``; None without a
    batch."""
    rows = [per_batch(b) for b in rec.batches]
    if not rows:
        return None
    out = {k: float(statistics.median(r[k] for r in rows)) for k in rows[0]}
    out["attributed_idle_ms"] = sum(sum(b["idle_ms"].values())
                                    for b in rec.batches)
    out.update(idle_ms=rec.idle_ms, window_ms=rec.window_ms,
               batches=len(rows), unlaunched=rec.unlaunched)
    return out


def _pass(trace) -> dict | None:
    if not getattr(trace, "on_card", False):
        return None
    from vanishing_points_2017_tpu_torch.utils import profiling

    if not hasattr(profiling, "Record"):
        log("spans: the program records no spans")
        return None
    n = trace.stretch_steps
    with profiling.trace() as rec:
        for i in range(n):
            trace.stretch_step(i)
    out = summarize(rec)
    if out is None:
        return None
    out["paced_s"] = sum(trace.times[:n])
    log("spans: " + "; ".join(
        f"{k} span {out[f'{k}_span_ms']:.3f} busy {out[f'{k}_busy_ms']:.3f}"
        f" idle {out[f'{k}_idle_ms']:.3f} ms" for k in LAYERS)
        + f"; outside busy {out['outside_busy_ms']:.3f} idle "
        f"{out['outside_idle_ms']:.3f} ms (medians per batch); em trips "
        f"{out['em_trips']}, launches {out['em_launches']}, host reads "
        f"{out['em_host_reads']}")
    total = {k: sum(b["idle_ms"].get(name, 0.0) for b in rec.batches)
             for k, name in list(LAYERS.items()) + [(OUTSIDE, OUTSIDE)]}
    log("spans: device idle over the stretch by layer: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / max(out['idle_ms'], 1e-9):.1f}%)"
        for k, v in total.items()))
    log(f"spans: {out['batches']} batches in {out['window_ms']:.3f} ms "
        f"traced, the same batches in the window {out['paced_s'] * 1e3:.3f}"
        f" ms ({out['window_ms'] / 1e3 / out['paced_s']:.3f}x); device idle "
        f"{out['idle_ms']:.3f} ms, attributed to the layers and outside "
        f"{out['attributed_idle_ms']:.3f} ms; {out['unlaunched']} of "
        f"{rec.device_ops} device ops without a launch call")
    return out


def value(trace, name: str):
    """The number ``name`` of the spans pass, run once per ``trace``;
    None where the run has no spans to read."""
    if not hasattr(trace, "_spans_pass"):
        trace._spans_pass = _pass(trace)
    p = trace._spans_pass
    return None if p is None else p.get(name)
