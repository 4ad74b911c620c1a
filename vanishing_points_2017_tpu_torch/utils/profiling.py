"""Tracing, stage timing and logging (``utils/profiling.py`` of the JAX
package).

* :class:`StageTimer`: named wall-clock spans, summed into a report. A
  span around work queued on a GPU measures nothing unless it waits for
  the device, so ``span(..., block_on=tensors)`` synchronizes the devices
  of the CUDA tensors it is given before it stops the clock.
* :func:`trace`: a ``torch.profiler`` trace of the block, exported as a
  Chrome trace into the directory it is given; does nothing without one.
* :func:`get_logger`: stdlib logging in one format; the drivers keep their
  ``print`` lines, which follow the reference's, and use this for
  diagnostics.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch


def get_logger(name: str = "vp_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (a tensor, or nested
    dicts, lists and tuples of them)."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


class StageTimer:
    """Accumulating named wall-clock spans.

    >>> timer = StageTimer()
    >>> with timer.span("lsd"):
    ...     detect(...)
    >>> timer.report()
    {'lsd': {'total_s': ..., 'count': ..., 'mean_s': ...}}
    """

    def __init__(self, sync: bool = True):
        self._acc: dict[str, float] = defaultdict(float)
        self._cnt: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and self.sync:
                for dev in _cuda_devices(block_on, set()):
                    torch.cuda.synchronize(dev)
            self._acc[name] += time.perf_counter() - t0
            self._cnt[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self._acc[name] += seconds
        self._cnt[name] += 1

    def report(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self._cnt[k],
                    "mean_s": round(v / self._cnt[k], 4)}
                for k, v in sorted(self._acc.items())}

    def pretty(self) -> str:
        rows = [f"  {k:<24} {d['total_s']:>9.3f}s  x{d['count']:<5} "
                f"({d['mean_s'] * 1000:.1f} ms avg)"
                for k, d in self.report().items()]
        return "stage timings:\n" + "\n".join(rows) if rows else "no spans"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (the CPU, and the GPU
    where there is one) and write ``trace.json``, a Chrome trace, into
    ``log_dir``; a no-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
