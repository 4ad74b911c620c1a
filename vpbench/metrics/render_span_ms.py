"""render_span_ms: the host's milliseconds per batch inside the port's
``vp.render`` span (``ops.sphere.sphere_image_uint8``); the median over
the window's first batches, sent again under the port's trace session
(``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "render_span_ms")
