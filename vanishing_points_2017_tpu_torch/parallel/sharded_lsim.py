"""Line-axis sharding of the O(N^2) line-similarity matrix
(``parallel/sharded_lsim.py`` of the JAX package).

The reference's quadratic axis is N, the number of line segments
(``calc_lsim``, ``vp_localisation.py:34-108`` of
fkluger/vanishing_points_2017). Each dp rank computes the (N/dp, N) row
strip of the similarity matrix against all N segments (the segments are
small next to the matrix, so every rank holds them all), with the global
diagonal zeroed: ``ops/lines.calc_lsim`` restricted to the strip's rows,
one copy of the math for both. ``mesh.gather_outputs`` gathers the strips
into the dense matrix. On one card the dense function is the faster; this
is the pattern for line sets too large for one.
"""

from __future__ import annotations

import torch

from ..ops import lines as lineops
from .mesh import Mesh


def calc_lsim_sharded(lp: torch.Tensor, mask: torch.Tensor, mesh: Mesh,
                      sigma: float = 1.0) -> torch.Tensor:
    """This rank's (N/dp, N) strip of ``calc_lsim(lp, mask, sigma)``:
    lp (N, 4), mask (N,) bool, N divisible by dp (raises otherwise)."""
    n = lp.shape[0]
    if n % mesh.dp:
        raise ValueError(f"N={n} not divisible by dp={mesh.dp}")
    r0 = mesh.dp_index * (n // mesh.dp)
    return lineops.calc_lsim(lp, mask, sigma, rows=(r0, r0 + n // mesh.dp))
