"""Result figure (``viz.py`` of the JAX package, the reference's
``result_plotting.py``).

Three panels: the image with the best VPs' line segments coloured by VP
and the estimated horizon; the sphere image and the CNN's output grid,
both with VP markers sized by their share of the inliers. Drawn with
matplotlib's Agg backend and saved to a file. matplotlib is imported when
the figure is asked for, and asking without it raises an error that says
so: the rest of the port does not need it.
"""

from __future__ import annotations

import numpy as np


def angle_to_index(angles: np.ndarray, size: int) -> np.ndarray:
    """(alpha, beta) -> fractional (a, b) index on a size x size grid
    (``ops/coords.angle_to_index`` in numpy)."""
    return (np.asarray(angles) / np.pi + 0.5 - 0.5 / size) * size


def show_em_result(result: dict, image: np.ndarray, out_path: str,
                   maxbest: int = 4, horizon=None) -> None:
    """result: a ``Pipeline.process()`` dict; image: the (resized) input;
    horizon: two (x, y) pixel points, drawn when given."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("show_em_result needs matplotlib, which is not "
                           "installed here") from e
    matplotlib.use("Agg")
    import matplotlib.cm as cmx
    import matplotlib.colors as colors
    import matplotlib.pyplot as plt

    height, width = image.shape[0], image.shape[1]
    scale = max(width, height)

    sphere_image = result["sphere_image"]
    prediction = result["cnn_prediction"][::-1, :]
    alive = result["alive"].astype(bool)
    vps = result["vp"]
    counts = result["counts"]
    vp_assoc = result["vp_assoc"]
    segments = result["segments"]

    fig = plt.figure(figsize=(12, 6))
    ax1 = plt.subplot2grid((2, 3), (0, 0), rowspan=2, colspan=2)
    ax2 = plt.subplot2grid((2, 3), (0, 2))
    ax2.set_title("CNN input w/ VP detections")
    ax3 = plt.subplot2grid((2, 3), (1, 2))
    ax3.set_title("CNN output w/ VP detections")

    ax1.imshow(image, cmap="gray" if image.ndim == 2 else None)
    ax1.autoscale(enable=False)
    ax2.imshow(sphere_image, cmap="Greys_r")
    ax2.autoscale(enable=False)
    ax3.imshow(prediction, cmap="Greys_r", interpolation="none")
    ax3.autoscale(enable=False)

    # to pixel coordinates (centre origin, y down)
    lsc = segments.copy()
    lsc[:, 0] = lsc[:, 0] * scale / 2.0 + width / 2.0
    lsc[:, 2] = lsc[:, 2] * scale / 2.0 + width / 2.0
    lsc[:, 1] = -lsc[:, 1] * scale / 2.0 + height / 2.0
    lsc[:, 3] = -lsc[:, 3] * scale / 2.0 + height / 2.0

    order = np.argsort(-np.where(alive, counts, -1))
    best = order[:min(maxbest, int(alive.sum()))]

    cmap = cmx.ScalarMappable(
        norm=colors.Normalize(vmin=0, vmax=max(len(best) - 1, 1)),
        cmap=plt.get_cmap("jet"))

    for li in range(min(segments.shape[0], vp_assoc.shape[0])):
        a = vp_assoc[li]
        if a in best:
            color = cmap.to_rgba(int(np.where(best == a)[0][0]))
            ax1.plot([lsc[li, 0], lsc[li, 2]], [lsc[li, 1], lsc[li, 3]],
                     c=color, lw=2)

    pg = counts / max(counts.sum(), 1)
    beta = np.arcsin(np.clip(vps[:, 1], -1, 1))
    alpha = np.arcsin(np.clip(vps[:, 0] / np.cos(beta), -1, 1))
    angles = np.stack([alpha, beta], axis=-1)
    for panel, size in ((ax2, sphere_image.shape[0]),
                        (ax3, prediction.shape[0])):
        for j in np.flatnonzero(alive):
            pos = angle_to_index(angles[j], size)
            mark = "go" if j in best else "yo"
            ms = min(max(pg[j] * 100, 6), 20)
            panel.plot(pos[0], size - 1 - pos[1], mark, markersize=ms,
                       alpha=0.6)

    if horizon is not None:
        ax1.plot([horizon[0][0], horizon[1][0]],
                 [horizon[0][1], horizon[1][1]], c="c", lw=4)

    plt.subplots_adjust(left=0.05, right=0.95, top=0.95, bottom=0.05)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
