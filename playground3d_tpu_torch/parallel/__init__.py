"""Device mesh and sharding (port of ``playground3d_tpu/parallel``)."""

from playground3d_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    batch_sharding,
    join_data_parallel,
    make_mesh,
    replicate,
    shard_batch,
)
