"""em_launches: the kernels, copies and sets launched per batch while
the host is inside ``vp.em``, each charged to the span open at its
launch; the median over the window's first batches, sent again under the
port's trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "em_launches")
