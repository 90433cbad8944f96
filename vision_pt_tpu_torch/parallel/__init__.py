from .mesh import (
    MeshConfig,
    fsdp_partition_spec,
    make_mesh,
    shard_batch,
    shard_module,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "shard_batch",
    "shard_module",
    "fsdp_partition_spec",
]
