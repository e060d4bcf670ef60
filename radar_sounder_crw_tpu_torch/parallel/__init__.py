from .mesh import (
    Mesh,
    all_gather,
    all_reduce_grads,
    all_reduce_sum,
    default_mesh,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    shard_batch,
)

__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce_grads",
    "all_reduce_sum",
    "default_mesh",
    "init_distributed",
    "make_mesh",
    "pad_to_multiple",
    "shard_batch",
]
