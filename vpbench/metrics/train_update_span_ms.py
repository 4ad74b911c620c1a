"""train_update_span_ms: the host's milliseconds per training step inside
the port's ``vp.train.update`` span: Caffe's update, ``sgd_update`` (``models/train.train_step``);
the median over the window's first steps, run again under the port's
trace session by the training job (``vpbench/jobs/train.py``)."""


def read(trace):
    if not trace.on_card:
        return None
    return trace.train_span("update_span_ms")
