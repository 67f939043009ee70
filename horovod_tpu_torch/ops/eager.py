"""Eager collectives: `allreduce`, `allgather` and `broadcast` on this
rank's tensor, over the process group of `runtime.bootstrap.init`.

Counterpart of `horovod_tpu.ops.eager` in its multi-process form (a
rank is a process and passes its own tensor, as in Horovod): the JAX
package's single-controller ``per_rank`` inputs have no counterpart
here. Before the collective, the ranks exchange one small record of
(op, shape, dtype, root) and check it the way Horovod's coordinator
does (`horovod_tpu.ops.validation`): a disagreement raises
`CollectiveMismatchError` on every rank instead of hanging inside
`torch.distributed`. That exchange is also the size exchange of the
variable-length allgather. Each call synchronizes with the host, so
the training hot path uses `ops.fusion`, which does not negotiate.
`alltoall`, `reducescatter` and sparse ``IndexedSlices`` are later
slices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime import state as _state


class CollectiveMismatchError(ValueError):
    """Ranks disagree on a collective's metadata (op, dtype, shape or
    root rank): Horovod's precondition failure."""


def validate_requests(name: str, metas: Sequence[tuple],
                      allow_dim0_mismatch: bool = False) -> None:
    """Raise `CollectiveMismatchError` unless every rank's ``(op,
    shape, dtype, root)`` agrees with rank 0's (allgather: every dim
    but 0); messages as in Horovod's ``ConstructMPIResponse``."""
    op0, shape0, dtype0, root0 = metas[0]
    for r, (op, shape, dtype, root) in enumerate(metas):
        if op != op0:
            raise CollectiveMismatchError(
                f"Mismatched collective operations: One or more ranks "
                f"submitted tensor {name} as {op}, but rank 0 submitted "
                f"it as {op0}.")
        if dtype != dtype0:
            raise CollectiveMismatchError(
                f"Mismatched data types: One or more ranks submitted "
                f"tensor {name} with dtype {dtype}, but rank 0 submitted "
                f"dtype {dtype0}.")
        if root != root0:
            raise CollectiveMismatchError(
                f"Mismatched root ranks: One or more ranks submitted "
                f"tensor {name} with root rank {root}, but rank 0 "
                f"submitted root rank {root0}.")
        if len(shape) != len(shape0):
            raise CollectiveMismatchError(
                f"Mismatched tensor ranks: tensor {name} has rank "
                f"{len(shape)} on rank {r} but {len(shape0)} on rank 0.")
        start = 1 if allow_dim0_mismatch else 0
        if tuple(shape[start:]) != tuple(shape0[start:]):
            what = ("non-first dimensions" if allow_dim0_mismatch
                    else "shapes")
            raise CollectiveMismatchError(
                f"Mismatched {what}: tensor {name} has shape {shape} on "
                f"rank {r} but {shape0} on rank 0.")


def _negotiate(st, name, op, tensor, root=None, allow_dim0=False,
               extra=None) -> List[tuple]:
    """Exchange this rank's metadata with every rank and validate it;
    returns every rank's record (rank order)."""
    meta = (op if extra is None else f"{op} {extra}", tuple(tensor.shape),
            str(tensor.dtype), root)
    metas: list = [None] * st.size
    dist.all_gather_object(metas, meta)
    validate_requests(name or op, metas, allow_dim0)
    return metas


def _on_device(st, tensor: torch.Tensor) -> torch.Tensor:
    """A copy of ``tensor`` on this rank's collective device."""
    return tensor.detach().to(st.devices[0], copy=True)


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None) -> torch.Tensor:
    """Sum (or average) ``tensor`` over the ranks; returns a new tensor
    on the input's device and dtype. An integer average floor-divides
    and keeps its dtype, accumulating narrow integers in int32."""
    st = _state.check_initialized()
    if st.size > 1:
        _negotiate(st, name, "allreduce", tensor)
    x = _on_device(st, tensor)
    integer = not (x.is_floating_point() or x.is_complex())
    if integer and x.element_size() < 4:
        x = x.to(torch.int32)
    if st.size > 1:
        dist.all_reduce(x)
    if average:
        x = (torch.div(x, st.size, rounding_mode="floor") if integer
             else x / st.size)
    return x.to(tensor.device, tensor.dtype)


def allreduce_(tensor: torch.Tensor, average: bool = True,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place `allreduce`; returns ``tensor``."""
    with torch.no_grad():
        tensor.copy_(allreduce(tensor, average=average, name=name))
    return tensor


def allgather(tensor: torch.Tensor,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's ``tensor`` along dim 0; ranks may differ
    in dim 0 (MPI_Allgatherv): the negotiation carries the sizes, each
    rank's block is padded to the largest, gathered, and trimmed. A 0-d
    tensor gathers as [1]."""
    st = _state.check_initialized()
    x = tensor.reshape(1) if tensor.ndim == 0 else tensor
    if st.size == 1:
        return x.clone()
    metas = _negotiate(st, name, "allgather", x, allow_dim0=True)
    sizes = [m[1][0] for m in metas]
    n = max(sizes)
    block = x.new_zeros((n, *x.shape[1:]), device=st.devices[0])
    block[:x.shape[0]] = x
    parts = [torch.empty_like(block) for _ in range(st.size)]
    dist.all_gather(parts, block)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(
        tensor.device)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    """``tensor`` as rank ``root_rank`` holds it, on every rank (a new
    tensor on the input's device)."""
    st = _state.check_initialized()
    if not 0 <= root_rank < st.size:
        raise ValueError(f"broadcast root_rank {root_rank} out of range "
                         f"for size {st.size}")
    x = _on_device(st, tensor)
    if st.size > 1:
        _negotiate(st, name, "broadcast", tensor, root=root_rank)
        dist.broadcast(x, src=root_rank)
    return x.to(tensor.device)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place `broadcast`; returns ``tensor``."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank, name=name))
    return tensor
