"""horizon_span_ms: the host's milliseconds per batch inside the port's
``vp.horizon`` spans (``em.horizon.calculate_horizon_and_ortho_vp``, its
chunks summed); the median over the window's first batches, sent again
under the port's trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "horizon_span_ms")
