"""Parallelism over a device mesh: the mesh, the transformer's layers,
and ring / Ulysses sequence parallelism.

Counterpart of `horovod_tpu.parallel`, for the names the port has:
`parallel.mesh` (a `DeviceMesh` over the world's ranks with the five
canonical axes; this slice shards ``data`` and ``seq``),
`parallel.tensor` (the layers on one device: no weight is sharded yet)
and `parallel.sequence` (blockwise, ring and Ulysses attention, SPMD
over the ambient mesh's ``seq`` axis). Tensor-parallel placement,
pipeline, FSDP and experts are later slices of the port.
"""

from horovod_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    MeshSpec,
    constrain,
    make_mesh,
    mesh_axis_names,
    replicate,
    shard_batch,
    sharding,
    use as use_mesh,
)
from horovod_tpu_torch.parallel.sequence import (
    blockwise_attention,
    ring_attention,
    ring_attention_gspmd,
    ulysses_attention,
    ulysses_attention_gspmd,
)
from horovod_tpu_torch.parallel.tensor import (
    ColumnParallelDense,
    ParallelMLP,
    ParallelSelfAttention,
    ParallelSwiGLU,
    RowParallelDense,
    apply_rope,
    dot_product_attention,
)

__all__ = [
    "MeshSpec", "make_mesh", "mesh_axis_names", "sharding", "shard_batch",
    "replicate", "constrain", "use_mesh",
    "AXIS_DATA", "AXIS_SEQ", "AXIS_MODEL", "AXIS_PIPE", "AXIS_EXPERT",
    "ColumnParallelDense", "RowParallelDense", "ParallelMLP",
    "ParallelSwiGLU", "ParallelSelfAttention", "apply_rope",
    "dot_product_attention",
    "ring_attention", "ring_attention_gspmd", "ulysses_attention",
    "ulysses_attention_gspmd", "blockwise_attention",
]
