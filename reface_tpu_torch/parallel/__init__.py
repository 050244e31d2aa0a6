from reface_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    create_mesh,
    init_distributed,
    replicated,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "create_mesh",
    "init_distributed",
    "replicated",
    "shard_batch",
    "shard_params",
]
