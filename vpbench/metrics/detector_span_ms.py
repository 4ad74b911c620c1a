"""detector_span_ms: the host's milliseconds per batch inside the port's
``vp.detector`` span (``ops.lines_device.detect_segments_device``); the
median over the window's first batches, sent again under the port's
trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "detector_span_ms")
