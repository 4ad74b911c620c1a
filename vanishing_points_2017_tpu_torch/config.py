"""Global configuration: paths and the default pipeline and EM settings
(``config.py`` of the JAX package).

The 2017 reference's ``config.py`` is six hard-coded paths. Here the paths
come from a dataclass that reads the JAX package's ``VP_TPU_*``
environment variables, so a user's settings carry over; the algorithm's
configuration is the frozen ``PipelineConfig``/``EMConfig`` (which also
define the result cache's identity).
"""

from __future__ import annotations

import dataclasses
import os

from .em import EMConfig  # noqa: F401  (re-export)
from .pipeline import PipelineConfig  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(name: str, default: str):
    return dataclasses.field(
        default_factory=lambda: os.environ.get(name, default))


@dataclasses.dataclass
class Paths:
    """Where the data sets and artifacts lie (``VP_TPU_*`` override)."""

    yud: str = _env("VP_TPU_YUD", "/data/YUD")
    ecd: str = _env("VP_TPU_ECD", "/data/ECD")
    hlw: str = _env("VP_TPU_HLW", "/data/HLW")
    # this checkout's stage cache: the drivers' default result directory
    result_dir: str = _env("VP_TPU_RESULTS",
                           os.path.join(_ROOT, "build", "results"))
    weights: str = _env("VP_TPU_WEIGHTS",
                        os.path.join(_ROOT, "assets", "weights.npz"))
    mean: str = _env("VP_TPU_MEAN", os.path.join(_ROOT, "assets", "mean.npy"))
