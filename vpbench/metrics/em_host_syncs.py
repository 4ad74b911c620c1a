"""em_host_syncs: the EM's device-to-host reads of loop conditions per
batch (``Tensor.__bool__`` on a device tensor), the median over the stage
passes; ``.item()`` and ``.cpu()`` reads are not counted."""

import statistics


def read(trace):
    if not trace.em_syncs:
        return None
    return float(statistics.median(trace.em_syncs))
