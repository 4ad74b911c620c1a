"""outside_idle_ms: the device's idle milliseconds per batch while the
host is in none of the five layer spans: the copy in, the entry's glue,
the readback and the loop; the median over the window's first batches,
sent again under the port's trace session (``vpbench/spans.py``)."""

from vpbench import spans


def read(trace):
    return spans.value(trace, "outside_idle_ms")
