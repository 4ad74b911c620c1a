"""em_host_reads: the EM's device-to-host reads per batch, as the
program counts them itself: the counter ``em.host_reads``
(``em.reads.host_bool``); the median over the window's first batches,
sent again under the port's trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "em_host_reads")
