"""Horizon-error AUC (``metrics/auc.py`` of the JAX package).

Reproduces ``auc.py:5-37`` of fkluger/vanishing_points_2017, quirk
included: the fraction at the cutoff crossing is the value-weighted
average (e_prev * f_prev + e_next * f_next) / (e_next + e_prev), not a
linear interpolation. The empirical CDF points are (error_i, (i+1)/n)
over the sorted errors; a point at x = cutoff is appended (y = 1 if every
error is below the cutoff, else the midfraction), and the AUC is the
trapezoid integral over the points with x <= cutoff, divided by the
cutoff.
"""

from __future__ import annotations

import numpy as np


def calc_auc(error_array: np.ndarray, cutoff: float = 0.25):
    """-> (auc, plot_points): plot_points is the (n+1, 2) array of
    (error, fraction) CDF points with the cutoff point, sorted by error."""
    errors = np.sort(np.atleast_1d(np.asarray(error_array).squeeze()))
    n = errors.shape[0]
    if n == 0:
        return 0.0, np.array([[cutoff, 0.0]])

    fractions = np.arange(1, n + 1) / n
    plot_points = np.stack([errors, fractions], axis=1).astype(np.float64)
    midfraction = 1.0
    for i in range(1, n):
        last, value = errors[i - 1], errors[i]
        if last < cutoff < value:
            midfraction = ((last * plot_points[i - 1, 1]
                            + value * plot_points[i, 1]) / (value + last))

    tail = 1.0 if plot_points[-1, 0] < cutoff else midfraction
    plot_points = np.vstack([plot_points, [cutoff, tail]])
    plot_points = plot_points[np.argsort(plot_points[:, 0])]

    below = plot_points[:, 0] <= cutoff
    x, y = plot_points[below, 0], plot_points[below, 1]
    if x.shape[0] < 2:
        return 0.0, plot_points
    return float(np.trapezoid(y, x)) / cutoff, plot_points
