"""device_idle_share: the share (%) of the timed loop in which no kernel,
copy or set ran on the device: 1 - the device's busy time over a
profiled stretch of the window's first batches, sent again in the same
loop, over those batches' own time in the untraced window. (The
profiler's CUDA activity tracing slows the launch-bound loop itself, so
the traced stretch's own span would overstate the idle share.)"""


def read(trace):
    p = trace.profile
    if not p or p.get("paced_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["paced_s"])
