"""The accuracy and robustness harnesses of the JAX package's ``scripts/``
on the port, one module per script under the script's own name:

* ``eval_device_detector``: the 50-scene AUC decomposition into the host
  LSD path, the device-detector path and device segments with the ideal
  prior;
* ``perturb_knife_edge``: the EM's triplet-flip rate under sub-pixel
  segment jitter;
* ``revalidate_detector``: the detector re-validation gate (photographs,
  the synthetic host-vs-device AUC gap, the golden pins);
* ``eval_weights_artifacts``: the host-LSD AUC per weights artifact;
* ``sweep_detector_gates``: the detector's noise gates and record budget;
* ``profile_detector``: the detector's sub-stage times;
* ``profile_e2e``: the round trip, the detector and the post-detector
  program on resident inputs, and the price of one EM iteration.

Each runs as ``python -m vanishing_points_2017_tpu_torch.tools.<name>``
with the script's flags; ``--device`` defaults to ``cuda`` and raises
without a GPU (``--device cpu`` runs the kernels' plain twins). Each has a
``main(argv)`` that can be called in-process.
"""

from __future__ import annotations

import os
import subprocess

import torch

# the 2017 reference's example photographs, with the horizons of its
# published result figures as fractional rows at the left and right edges
# (the JAX package's tests/test_real_photos.py); they lie in the reference
# checkout's assets/examples (reference_examples())
REFERENCE_HORIZONS = [
    ("ihme_zentrum.jpg", 0.7701, 0.7743),
    ("uni_hannover.jpg", 0.7458, 0.7336),
    ("uni_hannover_lichthof.jpg", 0.3889, 0.3877),
]


def reference_examples() -> str:
    """The 2017 reference checkout's ``assets/examples`` directory, from
    ``$VP_TPU_REFERENCE_EXAMPLES``; empty (not at hand) when unset."""
    return os.environ.get("VP_TPU_REFERENCE_EXAMPLES", "")


def card(dev: torch.device) -> str:
    """The device's name and power limit as ``nvidia-smi`` gives them, or
    a note that the times are the host's."""
    if dev.type != "cuda":
        return f"{dev.type} (no card: host-clock times)"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def make_pipeline(dev: torch.device, cfg=None):
    """The shipped weights in a ``Pipeline`` on ``dev``."""
    from ..pipeline import Pipeline, PipelineConfig
    from ..weights import load_params_and_mean

    params, mean = load_params_and_mean(device=dev)
    return Pipeline(params, mean, cfg or PipelineConfig(), device=dev)
