from viddet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    initialize_distributed,
    make_mesh,
    put_batch,
    replicate,
    shard_batch,
)

__all__ = ["DATA_AXIS", "initialize_distributed", "make_mesh", "put_batch", "replicate",
           "shard_batch"]
