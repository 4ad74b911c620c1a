"""em_span_ms: the host's milliseconds per batch inside the port's
``vp.em`` spans (``em.em.expectation_maximisation``, its chunks summed);
the median over the window's first batches, sent again under the port's
trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "em_span_ms")
