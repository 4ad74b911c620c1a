"""step_mfu: the CNN's floating-point operations per image (from the
configuration's layer shapes) times the traced run's window rate in
images/s, as a percentage of the card's dense bfloat16 peak. Only the
CNN's operations are counted: the detector's, the renderer's and the
EM's arithmetic are left out."""

from vpbench import counts


def read(trace):
    rate = trace.window.get("images_per_s")
    if not rate:
        return None
    flops = counts.cnn_flops_per_image(trace.config["network"])
    return 100.0 * flops * rate / counts.BF16_FLOPS
