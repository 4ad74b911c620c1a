"""ccl_roofline: the raster CCL's share (%) of its roofline on the cell's
own packed edge grids (the first pool batch): the grid read once and the
int32 labels written once at the HBM rate, over the CUDA-event time of
``ops.lines_device.connected_components``."""

import math

from vpbench import counts


def read(trace):
    images = trace.device_images(0)
    if images is None or not trace.on_card:
        return None
    from vanishing_points_2017_tpu_torch.ops import lines_device as ld

    _, active, ux, uy = ld.gradient_front(images)
    packed = ld.pack_edge_masks(active, ux, uy,
                                math.cos(math.radians(ld.TOL_DEG)))
    ms = trace.cuda_ms(lambda: ld.connected_components(packed))
    n_bytes, n_ops = counts.ccl_work(*packed.shape)
    return counts.roofline_share(n_bytes, n_ops, ms / 1e3)
