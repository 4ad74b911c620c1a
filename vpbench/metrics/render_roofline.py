"""render_roofline: the uint8 sphere render's share (%) of its roofline on
the cell's own lines (the first pool batch's, as the window's entry had
them): the larger of the lines read once plus the uint8 image written
once at the HBM rate, and its float operations at the float32 peak, over
the CUDA-event time of ``ops.sphere.sphere_image_uint8``."""

from vpbench import counts


def read(trace):
    if not trace.on_card:
        return None
    from vanishing_points_2017_tpu_torch.ops import sphere

    l, lmask = trace.device_lines(0)
    size = trace.config["pipeline"]["sphere_size"]
    ms = trace.cuda_ms(lambda: sphere.sphere_image_uint8(l, lmask, size))
    n_bytes, n_ops = counts.render_work(l, lmask, size)
    return counts.roofline_share(n_bytes, n_ops, ms / 1e3)
