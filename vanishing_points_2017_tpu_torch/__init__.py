"""PyTorch + CUDA (Hopper) port of the vanishing-point pipeline.

The same system as ``vanishing_points_2017_tpu`` — image -> line segments
(host C++ LSD, or on-device detection) -> inverse-gnomonic sphere image ->
20x20 VP-prior CNN -> masked split/merge EM -> horizon triplet search ->
AUC — written in PyTorch, with the two stages that the JAX package
hand-wrote in Pallas (the raster connected-components pass of the
detector and the sphere renderer) as hand-written CUDA kernels for
``sm_90a`` under ``csrc/``. The drivers run with ``python -m
vanishing_points_2017_tpu_torch.benchmark`` and ``.example``.

Every function takes tensors with an explicit leading batch dimension
where the JAX package used ``vmap``. On a CPU tensor each kernel wrapper
runs its plain PyTorch twin; on a CUDA tensor it launches the kernel or
raises. This package imports neither ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"
