"""train_input_span_ms: the host's milliseconds per training step inside
the port's ``vp.train.input`` span: the copy in, K2, floor and mean, and the dropout masks (``models/train.device_step``);
the median over the window's first steps, run again under the port's
trace session by the training job (``vpbench/jobs/train.py``)."""


def read(trace):
    if not trace.on_card:
        return None
    return trace.train_span("input_span_ms")
