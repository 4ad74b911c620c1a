"""train_idle_ms: the device's idle milliseconds per training step, over
the step's stretch of the port's trace session (from the end of the step
before to its own end: every training span and ``outside``, the loss
read and the loop included); the median over the window's first steps,
run again under the session by the training job
(``vpbench/jobs/train.py``)."""


def read(trace):
    if not trace.on_card:
        return None
    return trace.train_span("idle_ms")
