"""Eager collectives: `allreduce`, `allgather`, `broadcast`,
`alltoall` and `reducescatter` on this rank's tensor, over the process
group of `runtime.bootstrap.init`.

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
``allreduce`` of an `ops.sparse.IndexedSlices` takes the sparse
allgather path.

Every op carries the hooks of the JAX package's `_run_collective` /
`_timeline` (`horovod_tpu/ops/eager.py:356-358`, `:416-464`): the
timeline records NEGOTIATING, then TOP_LEVEL with the op's activity,
then DONE; the `StallMonitor` of `init` brackets the op; and each
collective that reaches `torch.distributed` first passes the
``collective_slow`` chaos site and counts on
``collective_metrics()["dispatched"]``. Each op's host-side
enter -> exit time lands in the straggler tracker
(`obs.straggler.tracker().record`), as the JAX package's
`_run_collective` records it (`horovod_tpu/ops/eager.py:403-462`): a
slow peer's rendezvous, the ``collective_slow`` delay and host stalls
all fall inside the bracket.
"""

from __future__ import annotations

import re
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.resilience import chaos
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


def _auto_name(prefix: str, name: Optional[str], tensor,
               skip_dim0: bool = False) -> str:
    """The op's timeline and stall-monitor name: ``name`` with every
    character outside [a-zA-Z0-9_] replaced (Horovod's rule), else
    ``prefix`` with the shape and dtype, stable across steps so timeline
    pids and the stall table do not grow per call (allgather leaves dim
    0 out: ranks may differ there)."""
    if name is not None:
        return re.sub(r"[^a-zA-Z0-9_]", "_", name)
    shape = tuple(tensor.shape)
    if skip_dim0 and shape:
        shape = ("v",) + shape[1:]
    dims = "x".join(map(str, shape)) or "scalar"
    return f"{prefix}_{dims}_{str(tensor.dtype).replace('torch.', '')}"


_COLLECTIVES_COUNTER = None


def _dispatched():
    """The ``dispatched`` counter, resolved once (the eager hot path
    should not take the registry lock per call)."""
    global _COLLECTIVES_COUNTER
    if _COLLECTIVES_COUNTER is None:
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        _COLLECTIVES_COUNTER = _obs_catalog.collective_metrics()[
            "dispatched"]
    return _COLLECTIVES_COUNTER


class _Op:
    """The hooks around one eager op: timeline phases, the stall
    monitor's bracket and the straggler tracker's timing
    (`__enter__`/`__exit__`), and `dispatch` just before the collective
    reaches `torch.distributed`."""

    def __init__(self, st, opname: str, kind: str, activity: str):
        self.st, self.opname = st, opname
        self.kind, self.activity = kind, activity
        self.t_enter = 0.0

    def _timeline(self, phase, activity=None):
        if self.st.timeline is not None:
            self.st.timeline.record(self.opname, phase, activity)

    def __enter__(self):
        self.t_enter = time.time()
        if self.st.stall_monitor is not None:
            self.st.stall_monitor.begin(self.opname)
        self._timeline("NEGOTIATING")
        return self

    def top_level(self):
        """Negotiation is over; the collective itself starts."""
        self._timeline("TOP_LEVEL", self.activity)

    def dispatch(self):
        # The slow/hung-collective fault at the dispatch boundary: the
        # host blocks as it would on a dead peer, inside the stall
        # monitor's bracket.
        chaos.slow_site("collective_slow")
        _dispatched().inc(op=self.kind)

    def __exit__(self, exc_type, *exc):
        self._timeline("DONE")
        if self.st.stall_monitor is not None:
            self.st.stall_monitor.end(self.opname)
        if exc_type is None:
            from horovod_tpu_torch.obs import straggler
            straggler.tracker().record(self.kind,
                                       time.time() - self.t_enter)
        return False


def allreduce(tensor, average: bool = True,
              name: Optional[str] = None):
    """Sum (or average) ``tensor`` over the ranks; returns a new tensor
    on the input's device and dtype. An integer average floor-divides
    and keeps its dtype, accumulating narrow integers in int32. An
    `ops.sparse.IndexedSlices` takes the sparse path
    (`allreduce_indexed_slices`: two allgathers) and returns one."""
    from horovod_tpu_torch.ops.sparse import (IndexedSlices,
                                              allreduce_indexed_slices)
    if isinstance(tensor, IndexedSlices):
        return allreduce_indexed_slices(tensor, average=average, name=name)
    st = _state.check_initialized()
    with _Op(st, _auto_name("HorovodAllreduce", name, tensor),
             "allreduce", "ALLREDUCE") as op:
        if st.size > 1:
            _negotiate(st, name, "allreduce", tensor)
        op.top_level()
        x = _on_device(st, tensor)
        integer = not (x.is_floating_point() or x.is_complex())
        if integer and x.element_size() < 4:
            x = x.to(torch.int32)
        if st.size > 1:
            op.dispatch()
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
    with _Op(st, _auto_name("HorovodAllgather", name, x, skip_dim0=True),
             "allgather", "ALLGATHER") as op:
        if st.size == 1:
            op.top_level()
            return x.clone()
        metas = _negotiate(st, name, "allgather", x, allow_dim0=True)
        op.top_level()
        sizes = [m[1][0] for m in metas]
        n = max(sizes)
        block = x.new_zeros((n, *x.shape[1:]), device=st.devices[0])
        block[:x.shape[0]] = x
        parts = [torch.empty_like(block) for _ in range(st.size)]
        op.dispatch()
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
    with _Op(st, _auto_name("HorovodBroadcast", name, tensor),
             "broadcast", "BCAST") as op:
        if st.size > 1:
            _negotiate(st, name, "broadcast", tensor, root=root_rank)
        op.top_level()
        x = _on_device(st, tensor)
        if st.size > 1:
            op.dispatch()
            dist.broadcast(x, src=root_rank)
        return x.to(tensor.device)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place `broadcast`; returns ``tensor``."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank, name=name))
    return tensor


def _check_divisible(op: str, tensor: torch.Tensor, size: int) -> None:
    """Raise when dim 0 does not split evenly over the ranks; called
    after the negotiation, so every rank holds the same shape and
    raises alike."""
    rows = tensor.shape[0] if tensor.ndim else 1
    if tensor.ndim == 0 or rows % size:
        raise ValueError(f"{op} dim 0 ({rows}) must be divisible by "
                         f"world size {size}")


def alltoall(tensor: torch.Tensor,
             name: Optional[str] = None) -> torch.Tensor:
    """All-to-all along dim 0 (later Horovod's ``hvd.alltoall``;
    counterpart of `horovod_tpu/ops/eager.py:710` in its
    multi-controller form): rank r sends its q-th dim-0 slice to rank q
    and receives, in rank order, the r-th slice of every rank. Returns
    THIS rank's received tensor (same shape as its input) on the
    input's device."""
    st = _state.check_initialized()
    with _Op(st, _auto_name("HorovodAlltoall", name, tensor), "alltoall",
             "ALLTOALL") as op:
        if st.size > 1:
            _negotiate(st, name, "alltoall", tensor)
        _check_divisible("alltoall", tensor, st.size)
        op.top_level()
        x = _on_device(st, tensor).contiguous()
        if st.size == 1:
            return x.to(tensor.device)
        out = torch.empty_like(x)
        op.dispatch()
        dist.all_to_all_single(out, x)
        return out.to(tensor.device)


def reducescatter(tensor: torch.Tensor, average: bool = False,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter along dim 0 (later Horovod's
    ``hvd.reducescatter``; counterpart of `horovod_tpu/ops/eager.py:800`
    in its multi-controller form): the ranks' tensors are summed and
    rank r gets rows [r * n / size, (r + 1) * n / size) of the sum (of
    the mean when ``average``; an integer mean floor-divides and keeps
    its dtype, as `allreduce` does). Returns THIS rank's shard on the
    input's device."""
    st = _state.check_initialized()
    with _Op(st, _auto_name("HorovodReducescatter", name, tensor),
             "reducescatter", "REDUCESCATTER") as op:
        if st.size > 1:
            _negotiate(st, name, "reducescatter", tensor)
        _check_divisible("reducescatter", tensor, st.size)
        op.top_level()
        x = _on_device(st, tensor).contiguous()
        integer = not (x.is_floating_point() or x.is_complex())
        if integer and x.element_size() < 4:
            x = x.to(torch.int32)
        if st.size > 1:
            out = x.new_empty((x.shape[0] // st.size, *x.shape[1:]))
            op.dispatch()
            dist.reduce_scatter_tensor(out, x)
            x = out
        if average:
            x = (torch.div(x, st.size, rounding_mode="floor") if integer
                 else x / st.size)
        return x.to(tensor.device, tensor.dtype)
