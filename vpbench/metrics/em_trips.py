"""em_trips: the EM's loop bodies per batch: the count of
``vp.em.iteration`` spans (one per ``em.em._iteration`` call); the
median over the window's first batches, sent again under the port's
trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "em_trips")
