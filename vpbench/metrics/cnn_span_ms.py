"""cnn_span_ms: the host's milliseconds per batch inside the port's
``vp.cnn`` span (``models.cnn.VPNet.forward``); the median over the
window's first batches, sent again under the port's trace session
(``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "cnn_span_ms")
