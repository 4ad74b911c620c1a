"""detector_idle_ms: the device's idle milliseconds per batch while the
host is inside ``vp.detector`` (each idle interval split exactly by the
spans it overlaps); the median over the window's first batches, sent
again under the port's trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "detector_idle_ms")
