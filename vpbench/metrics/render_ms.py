"""render_ms: the median over the traced run's stage passes of the render
stage's milliseconds per batch (a synchronize after each stage)."""


def read(trace):
    return trace.stage_median_ms("render")
