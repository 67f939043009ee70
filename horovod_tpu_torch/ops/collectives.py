"""SPMD collectives over a named mesh axis: the port's
`horovod_tpu_torch.spmd`.

Counterpart of `horovod_tpu.ops.collectives`. The JAX package's
collectives run inside `shard_map` with the axis bound and lower to XLA
collectives; here every rank is a process, and each function runs over
the process group of axis ``axis_name`` of the ambient mesh
(`parallel.mesh.use`). An axis name the ambient mesh does not have
raises `NameError`, as an unbound axis does in JAX. Each call passes the
``collective_slow`` chaos site before it dispatches.

`ppermute` (the JAX package's `lax.ppermute`) and `alltoall` are
differentiable, because ring and Ulysses attention differentiate
through them: the backward of a permutation is the inverse permutation,
the backward of an all-to-all the all-to-all with its split and concat
axes swapped. Both take a tensor or a tuple of tensors and move every
tensor of the tuple in ONE autograd node, so every rank runs the
backward transfers of a call in the same order.

Transport: the axis group's own backend, NCCL on the card and gloo on
the CPU. Ranks sharing one card run over gloo (NCCL refuses two ranks
on one device). gloo takes CUDA tensors for its collectives (all-reduce,
broadcast, all-gather, all-to-all: it copies them through the host
itself) but has no CUDA path for point-to-point transfers: a
`batch_isend_irecv` of CUDA tensors over gloo kills the process
(``gloo::IoException ... writev: Bad address``, H100, torch 2.11). So
on a gloo group `ppermute` stages CUDA tensors through host memory,
explicitly, and counts the bytes it copies each way (`staged_bytes`).
Nothing is staged on an NCCL group, and nothing falls back after a
failure.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel import mesh as _mesh
from horovod_tpu_torch.resilience import chaos

Tensors = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

_staged_lock = threading.Lock()
_staged = {"bytes": 0, "model": 0}


def staged_bytes() -> int:
    """Bytes copied between the card and host memory by the staged
    point-to-point transfers of this process (both directions), since
    the last `reset_staged_bytes`."""
    return _staged["bytes"]


def reset_staged_bytes() -> None:
    with _staged_lock:
        _staged["bytes"] = 0


def model_bytes() -> int:
    """Bytes this process contributed to the ``model`` axis's
    collectives (f's and g's sums, the logits gathers, the max) since
    the last `reset_model_bytes`: each call's input once."""
    return _staged["model"]


def reset_model_bytes() -> None:
    with _staged_lock:
        _staged["model"] = 0


def _count_model(x: torch.Tensor) -> None:
    with _staged_lock:
        _staged["model"] += x.numel() * x.element_size()


def _count_staged(n: int) -> None:
    with _staged_lock:
        _staged["bytes"] += n


def _chaos_collective(op: str):
    """Chaos site ``collective_slow``: when armed, the calling thread
    sleeps before dispatching ``op`` (a hung peer)."""
    del op
    chaos.slow_site("collective_slow")


def _stages(group, x: torch.Tensor) -> bool:
    """True when a point-to-point transfer of ``x`` must go through host
    memory on ``group``: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    _count_staged(x.numel() * x.element_size())
    return x.detach().to("cpu", copy=True).contiguous()


def _to_device(h: torch.Tensor, device) -> torch.Tensor:
    _count_staged(h.numel() * h.element_size())
    return h.to(device)


# ---------------------------------------------------------------------------
# Reductions and gathers.
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, *, average: bool = True,
              axis_name: str = "data") -> torch.Tensor:
    """Sum (or average) ``x`` over the axis. An integer average
    floor-divides and keeps the dtype, accumulating narrow integers in
    int32 (as the JAX package does). Returns a new tensor."""
    group = _mesh.axis_group(axis_name)
    _chaos_collective("allreduce")
    integer = not (x.is_floating_point() or x.is_complex())
    acc = x.dtype if not integer or x.element_size() >= 4 else torch.int32
    out = x.detach().to(acc, copy=True)
    dist.all_reduce(out, group=group)
    if not average:
        return out.to(x.dtype)
    n = dist.get_world_size(group)
    if integer:
        return torch.div(out, n, rounding_mode="floor").to(x.dtype)
    return out / n


def _gather(x: torch.Tensor, group) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def allgather(x: torch.Tensor, *, axis_name: str = "data") -> torch.Tensor:
    """Concatenate ``x`` from every rank of the axis along dim 0 (the
    ranks' blocks are the same shape, as in an SPMD program)."""
    group = _mesh.axis_group(axis_name)
    _chaos_collective("allgather")
    return torch.cat(_gather(x.detach(), group))


def allgatherv(x: torch.Tensor, valid_len, *, max_len: int,
               axis_name: str = "data"):
    """Variable-dim-0 allgather: each rank holds ``x`` padded on dim 0
    to ``max_len`` with ``valid_len`` genuine rows. Returns
    ``(gathered [world, max_len, ...], sizes [world] int32)``; the
    caller compacts the valid rows."""
    del max_len
    group = _mesh.axis_group(axis_name)
    _chaos_collective("allgatherv")
    gathered = torch.stack(_gather(x.detach(), group))
    n = torch.as_tensor(valid_len, dtype=torch.int32,
                        device=x.device).reshape(1)
    sizes = torch.cat(_gather(n, group))
    return gathered, sizes


def broadcast(x: torch.Tensor, root_rank: int, *,
              axis_name: str = "data") -> torch.Tensor:
    """Every rank of the axis receives the value of axis coordinate
    ``root_rank`` (bool tensors included). Returns a new tensor."""
    group = _mesh.axis_group(axis_name)
    _chaos_collective("broadcast")
    n = dist.get_world_size(group)
    if not 0 <= root_rank < n:
        raise ValueError(f"broadcast root_rank {root_rank} out of range "
                         f"for axis {axis_name} of size {n}")
    out = x.detach().clone()
    wire = out.to(torch.int32) if out.dtype == torch.bool else out
    dist.broadcast(wire, src=dist.get_global_rank(group, root_rank),
                   group=group)
    return wire.to(torch.bool) if out.dtype == torch.bool else wire


def reducescatter(x: torch.Tensor, *, average: bool = False,
                  axis_name: str = "data") -> torch.Tensor:
    """Reduce-scatter along dim 0: the axis's tensors summed (averaged
    when ``average``), rank i keeping rows [i n/size, (i+1) n/size)."""
    group = _mesh.axis_group(axis_name)
    _chaos_collective("reducescatter")
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reducescatter dim 0 ({x.shape[0]}) must be "
                         f"divisible by axis {axis_name} of size {n}")
    summed = x.detach().clone()
    dist.all_reduce(summed, group=group)
    step = x.shape[0] // n
    out = summed[dist.get_rank(group) * step:][:step].clone()
    return out / n if average else out


def my_rank(axis_name: str = "data") -> int:
    """This rank's coordinate on the axis (the SPMD `hvd.rank()`)."""
    return _mesh.axis_index(axis_name)


def axis_size(axis_name: str = "data") -> int:
    """Size of the axis (the SPMD `hvd.size()`)."""
    return _mesh.axis_size(axis_name)


# ---------------------------------------------------------------------------
# Differentiable transfers: ppermute and all-to-all.
# ---------------------------------------------------------------------------

def _as_tuple(x: Tensors):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _permute_raw(xs, group, ranks, perm):
    """Send each tensor of ``xs`` to ``dst`` and receive from ``src`` for
    every (src, dst) pair of ``perm`` (axis coordinates) that names this
    rank; a rank no pair sends to receives zeros."""
    me = dist.get_rank(group)
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    outs = [torch.zeros_like(x) for x in xs]
    if sends == [me] and recvs == [me]:
        return [x.detach().clone() for x in xs]
    if len(sends) > 1 or len(recvs) > 1:
        raise ValueError(f"ppermute permutation {perm} is not one-to-one")
    staged = any(_stages(group, x) for x in xs)
    wire_in = [_to_host(x) if staged else x.detach().contiguous()
               for x in xs]
    wire_out = [torch.empty_like(w) for w in wire_in]
    ops = []
    for w in wire_in:
        if sends:
            ops.append(dist.P2POp(dist.isend, w, ranks[sends[0]], group))
    for w in wire_out:
        if recvs:
            ops.append(dist.P2POp(dist.irecv, w, ranks[recvs[0]], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recvs:
        outs = [_to_device(w, x.device) if staged else w
                for w, x in zip(wire_out, xs)]
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, ranks, perm, *xs):
        ctx.group, ctx.ranks = group, ranks
        ctx.inverse = [(d, s) for s, d in perm]
        return tuple(_permute_raw(xs, group, ranks, perm))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None,
                *_permute_raw(gs, ctx.group, ctx.ranks, ctx.inverse))


def ppermute(x: Tensors, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> Tensors:
    """`lax.ppermute`: each (src, dst) pair of ``perm`` (axis
    coordinates) sends src's ``x`` to dst; a rank no pair sends to gets
    zeros. ``x`` is a tensor or a tuple of tensors (moved in one
    autograd node); differentiable, its backward the inverse
    permutation."""
    group = _mesh.axis_group(axis_name)
    ranks = _mesh.axis_ranks(axis_name)
    _chaos_collective("ppermute")
    perm = [(int(s), int(d)) for s, d in perm]
    out = _PPermute.apply(group, ranks, perm, *_as_tuple(x))
    return out[0] if isinstance(x, torch.Tensor) else out


def _alltoall_raw(xs, group, split_axis, concat_axis):
    """Tiled all-to-all of each tensor of ``xs``: its ``split_axis``
    cut into one chunk a rank, chunk j to rank j, the received chunks
    concatenated along ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    outs = []
    for x in xs:
        if x.shape[split_axis] % n:
            raise ValueError(
                f"alltoall split axis {split_axis} of size "
                f"{x.shape[split_axis]} does not divide over {n} ranks")
        if n == 1:
            outs.append(x.detach().clone())
            continue
        chunks = x.detach().chunk(n, dim=split_axis)
        send = torch.stack(chunks).contiguous()       # [n, ...chunk]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        outs.append(torch.cat(recv.unbind(0), dim=concat_axis))
    return outs


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, *xs):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return tuple(_alltoall_raw(xs, group, split_axis, concat_axis))

    @staticmethod
    def backward(ctx, *gs):
        split_axis, concat_axis = ctx.axes
        return (None, None, None,
                *_alltoall_raw(gs, ctx.group, concat_axis, split_axis))


def alltoall(x: Tensors, *, axis_name: str = "data", split_axis: int = 0,
             concat_axis: int = 0) -> Tensors:
    """Tiled all-to-all over the axis (`lax.all_to_all(..., tiled=
    True)`): ``split_axis`` cut into one chunk a rank, chunk j sent to
    rank j, the received chunks concatenated along ``concat_axis`` in
    rank order. ``x`` is a tensor or a tuple of tensors (one autograd
    node); differentiable, its backward the all-to-all with the two
    axes swapped."""
    group = _mesh.axis_group(axis_name)
    _chaos_collective("alltoall")
    xs = _as_tuple(x)
    nd = xs[0].ndim
    out = _AllToAll.apply(group, split_axis % nd, concat_axis % nd, *xs)
    return out[0] if isinstance(x, torch.Tensor) else out


# ---------------------------------------------------------------------------
# Megatron's operators over the ``model`` axis (tensor parallelism).
# ---------------------------------------------------------------------------

def _sum(x: torch.Tensor, group) -> torch.Tensor:
    _count_model(x)
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _sum(g, ctx.group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        ctx.width = x.shape[-1]
        _count_model(x)
        return torch.cat(_gather(x.detach(), group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return None, g[..., r * ctx.width:(r + 1) * ctx.width].contiguous()


def _model_group(axis_name: str, mesh):
    group = _mesh.axis_group(axis_name, mesh)
    _chaos_collective(axis_name)
    return group


def copy_to_model(x: torch.Tensor, axis_name: str = "model",
                  mesh=None) -> torch.Tensor:
    """Megatron's f: the identity forward, the gradient summed over the
    axis backward. It opens a column-parallel region: every rank holds
    the whole input and its gradient is the sum of the ranks' parts.
    The axis group is the ambient mesh's (or ``mesh``'s); an unbound
    axis raises `NameError`."""
    return _CopyToModel.apply(_model_group(axis_name, mesh), x)


def reduce_from_model(x: torch.Tensor, axis_name: str = "model",
                      mesh=None) -> torch.Tensor:
    """Megatron's g: the sum over the axis forward, the identity
    backward. It closes a row-parallel region: the ranks' partial
    products become the whole product on every rank."""
    return _ReduceFromModel.apply(_model_group(axis_name, mesh), x)


def gather_from_model(x: torch.Tensor, axis_name: str = "model",
                      mesh=None) -> torch.Tensor:
    """The ranks' last-dim blocks concatenated in axis order forward
    (vocab-sharded logits into whole ones), this rank's block of the
    gradient backward."""
    return _GatherFromModel.apply(_model_group(axis_name, mesh), x)


def max_over(x: torch.Tensor, axis_name: str = "model",
             mesh=None) -> torch.Tensor:
    """Elementwise max over the axis (not differentiable: the
    vocab-parallel softmax's shift)."""
    _count_model(x)
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX,
                    group=_model_group(axis_name, mesh))
    return out
