"""train_update_roofline: Caffe's update's share (%) of its roofline: 20
bytes per parameter (theta, gradient and momentum read once, theta and
momentum written once; ``vpbench/train_counts.py``) at the HBM rate,
over the device time of the kernels launched inside the port's
``vp.train.update`` span; the median over the window's first steps, run
again under the port's trace session by the training job
(``vpbench/jobs/train.py``)."""

from vpbench import counts, train_counts


def read(trace):
    if not trace.on_card:
        return None
    busy_ms = trace.train_span("update_busy_ms")
    if not busy_ms:
        return None
    n_bytes = train_counts.update_bytes(trace.config["network"])
    return counts.roofline_share(n_bytes, 0, busy_ms / 1e3)
