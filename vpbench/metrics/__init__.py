"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``.

``vpbench/metrics/<name>.py`` defines ``read(trace)``, which takes the
metric from the traced run's record (``vpbench.run.Trace``: the stage
passes, the EM's host reads, the profiled stretch, the window's rate,
and the cell's inputs and outputs for a kernel's own timing) and returns
a number, or None where the cell has nothing to read: the harness then
leaves the metric out of the line.
"""
