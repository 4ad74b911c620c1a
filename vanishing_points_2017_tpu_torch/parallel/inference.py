"""Mesh-sharded serving of the zero-host-round-trip pipeline
(``parallel/inference.py`` of the JAX package).

``pipeline.device_pipeline_full`` treats every image on its own, so the
batch splits over the mesh's dp ranks with no collective on the forward
path: each rank runs the detector (kernel K1), the render (K2), the CNN
and the EM on its slice, and :func:`gather_outputs` all-gathers the
results over dp where the caller wants them whole. With ``tp > 1`` the
CNN's fc6/fc7 run split over the tp group (``parallel/tp.py``), and every
rank of a tp group runs the same slice. The fixed chunks of 32 images
(``batching.py``) apply per rank, so at ``tp = 1`` an image's outputs are
bit-identical to the single-process run's on the same card. The JAX
package pins its XLA CCL here, because its Pallas kernel has no
partitioning rule; K1 runs per image and needs no such pin.
"""

from __future__ import annotations

import torch

from ..models import cnn
from ..pipeline import PipelineConfig, device_pipeline_full
from .mesh import Mesh, gather_outputs, shard_batch
from .tp import TPVPNet, shard_model

__all__ = ["sharded_pipeline_full", "gather_outputs"]


def sharded_pipeline_full(mesh: Mesh, images: torch.Tensor,
                          model: cnn.VPNet, mean: torch.Tensor,
                          cfg: PipelineConfig) -> dict:
    """This rank's outputs of ``device_pipeline_full`` on its dp slice of
    ``images`` (B, H, W), B divisible by dp (raises otherwise).

    ``model`` is the whole network, or with ``tp > 1`` its shards for this
    mesh (``tp.shard_model``, made once); a whole network is sharded here
    on every call."""
    if images.shape[0] % mesh.dp:
        raise ValueError(f"batch {images.shape[0]} not divisible by "
                         f"dp={mesh.dp}")
    if mesh.tp > 1 and not isinstance(model, TPVPNet):
        model = shard_model(model, mesh)
    return device_pipeline_full(shard_batch(images, mesh), model, mean, cfg)
