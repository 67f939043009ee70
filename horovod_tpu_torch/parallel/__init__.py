"""Parallelism over a device mesh: the mesh, the transformer's layers,
and ring / Ulysses sequence parallelism.

Counterpart of `horovod_tpu.parallel`, for the names the port has:
`parallel.mesh` (a `DeviceMesh` over the world's ranks with the five
canonical axes; the port shards ``data``, ``seq`` and ``model``, and
the placement helpers cut a rank's block), `parallel.tensor` (the
transformer's layers, tensor parallel over ``model``: column/row
dense pairs, head-sharded attention, the collective matmuls, the
specs and the shard/gather of a state dict) and `parallel.sequence`
(blockwise, ring and Ulysses attention, SPMD over the ambient mesh's
``seq`` axis). Pipeline, FSDP and experts are later slices of the
port.
"""

from horovod_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    MeshSpec,
    Sharding,
    constrain,
    make_mesh,
    mesh_axis_names,
    place_with_specs,
    put_like,
    replicate,
    safe_spec,
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
    allgather_matmul,
    apply_rope,
    column_parallel_matmul,
    dot_product_attention,
    gather_params,
    matmul_reducescatter,
    param_specs,
    row_parallel_matmul,
    shard_params,
    unbox,
)

__all__ = [
    "MeshSpec", "make_mesh", "mesh_axis_names", "sharding", "shard_batch",
    "replicate", "constrain", "use_mesh", "Sharding", "safe_spec",
    "place_with_specs", "put_like",
    "AXIS_DATA", "AXIS_SEQ", "AXIS_MODEL", "AXIS_PIPE", "AXIS_EXPERT",
    "ColumnParallelDense", "RowParallelDense", "ParallelMLP",
    "ParallelSwiGLU", "ParallelSelfAttention", "apply_rope",
    "dot_product_attention", "column_parallel_matmul",
    "row_parallel_matmul", "allgather_matmul", "matmul_reducescatter",
    "param_specs", "shard_params", "gather_params", "unbox",
    "ring_attention", "ring_attention_gspmd", "ulysses_attention",
    "ulysses_attention_gspmd", "blockwise_attention",
]
