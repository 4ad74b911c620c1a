"""The training step's arithmetic, from a configuration's ``network``
section, so that it reads the same work whatever implements the step:
the operations of forward and backward per image, the parameters, and
the bytes Caffe's update must move.
"""

from __future__ import annotations

from . import counts

# Caffe's update, per float32 parameter: theta, its gradient and its
# momentum read once, theta and the momentum written once
UPDATE_BYTES_PER_PARAM = 20


def _convs(net: dict) -> tuple:
    """-> (each conv's (in, out, kernel, groups, output side), the side
    left after the last pool)."""
    out, side, cin = [], net["input"], net["channels"]
    for name, cout, k, stride, pad, groups in net["convs"]:
        side = (side + 2 * pad - k) // stride + 1
        out.append((cin, cout, k, groups, side))
        if name in net["pool_after"]:
            side = counts._ceil_pool(side)
        cin = cout
    return out, side


def train_flops_per_image(net: dict) -> int:
    """Forward and backward operations per training image, 2 per
    multiply-add: each product's forward, its input gradient and its
    weight gradient (3 x the forward's, ``counts.cnn_flops_per_image``),
    less the first conv's input gradient, which nothing needs. Pooling,
    LRN, biases, activations, dropout and the loss are not counted."""
    cin, cout, k, groups, side = _convs(net)[0][0]
    first = 2 * k * k * (cin // groups) * cout * side * side
    return 3 * counts.cnn_flops_per_image(net) - first


def n_params(net: dict) -> int:
    """The network's parameters: every conv's and fc layer's weights
    (dense fc) and biases."""
    convs, side = _convs(net)
    total = sum(k * k * (cin // g) * cout + cout
                for cin, cout, k, g, _ in convs)
    din = convs[-1][1] * side * side
    for _name, dout in net["fc"]:
        total += din * dout + dout
        din = dout
    return total


def update_bytes(net: dict) -> int:
    """The least bytes Caffe's update moves per step."""
    return UPDATE_BYTES_PER_PARAM * n_params(net)
