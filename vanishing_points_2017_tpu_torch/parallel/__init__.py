"""dp x tp parallelism over ``torch.distributed`` (``parallel/`` of the
JAX package): the mesh and the sharding rule (``mesh``), start-up
(``distributed``), the tp CNN (``tp``), sharded serving (``inference``)
and the sharded line-similarity matrix (``sharded_lsim``); the sharded
training step is ``models/train.train_step(..., mesh=)``."""

from .mesh import make_mesh, shard_params, shard_batch  # noqa: F401
from .inference import sharded_pipeline_full  # noqa: F401
