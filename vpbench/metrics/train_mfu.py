"""train_mfu: the training step's floating-point operations per image
(forward and backward from the configuration's layer shapes,
``vpbench/train_counts.py``: 19,837,114,752 at the published widths)
times the traced run's window rate in training images/s, as a
percentage of the card's dense bfloat16 peak."""

from vpbench import counts, train_counts


def read(trace):
    rate = trace.window.get("images_per_s")
    if not rate:
        return None
    flops = train_counts.train_flops_per_image(trace.config["network"])
    return 100.0 * flops * rate / counts.BF16_FLOPS
