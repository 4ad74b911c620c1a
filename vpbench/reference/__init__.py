"""The benchmark's plain reference of the pipeline, in plain PyTorch.

Imports neither the port (``vanishing_points_2017_tpu_torch``) nor JAX:
the detector with its own raster CCL, the sphere renderer, the CNN read
from the weights file, the EM and the horizon search, each computed in
the precision a configuration states or, for the control, one step
below it (``vpbench/reference/pipeline.py``).
"""
