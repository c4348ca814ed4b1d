"""Device mesh and sharding (port of ``playground3d_tpu/parallel``)."""

from playground3d_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPACE_AXIS,
    Mesh,
    P,
    batch_sharding,
    camera_spatial_forward,
    join_data_parallel,
    make_mesh,
    make_mesh2,
    replicate,
    shard_batch,
    shard_spatial,
    spatial_constrainer,
    spatial_forward,
    spatial_sharding,
)
