"""Data and model parallelism over processes, one card each:
counterpart of ``tim_tpu/parallel`` on ``torch.distributed``."""

from tim_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_batch, shard_train_state)
