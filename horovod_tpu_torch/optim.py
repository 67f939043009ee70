"""The framework adapter: Horovod's data-parallel training surface on
`torch.optim`.

Counterpart of `horovod_tpu.jax` (the JAX package's primary adapter),
in the shape of Horovod's torch API (`horovod.torch`): a
`DistributedOptimizer` that averages every gradient over the ranks,
fused into same-dtype buckets (`ops.fusion`), before the wrapped
optimizer's step; `broadcast_parameters` / `broadcast_optimizer_state`
for a consistent start; `broadcast_object`, `allgather_object` and
`grouped_allreduce`. The module is named for what it wraps, so it does
not shadow `torch`. PowerSGD compression and sparse ``IndexedSlices``
gradients are later slices.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import eager
from horovod_tpu_torch.ops.fusion import fused_allreduce_leaves
from horovod_tpu_torch.runtime import state as _state
from horovod_tpu_torch.runtime.config import config


def world_size() -> int:
    """Ranks of the initialized world; 1 before `init()`."""
    st = _state.global_state()
    return st.size if st.initialized else 1


def allreduce_gradients(grads: Sequence[torch.Tensor], *,
                        average: bool = True,
                        threshold: Optional[int] = None,
                        reduce_dtype: Optional[torch.dtype] = None
                        ) -> list:
    """Fused allreduce of gradient tensors, IN PLACE (buckets of
    ``threshold`` bytes, default ``HOROVOD_FUSION_THRESHOLD``; reduced
    in ``reduce_dtype``, default ``HOROVOD_ALLREDUCE_DTYPE``); returns
    them. The identity at world size 1 (or before `init()`), as in
    Horovod. The tensors must not alias one another."""
    grads = list(grads)
    if world_size() == 1 or not grads:
        return grads
    if reduce_dtype is None and config.allreduce_dtype:
        reduce_dtype = getattr(torch, config.allreduce_dtype)
    reduced = fused_allreduce_leaves(grads, average=average,
                                     threshold=threshold,
                                     reduce_dtype=reduce_dtype)
    with torch.no_grad():
        for g, r in zip(grads, reduced):
            g.copy_(r)
    return grads


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks (a device-side allreduce; the
    identity at world size 1)."""
    if world_size() == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / world_size()


def is_distributed(optimizer) -> bool:
    """True for an optimizer wrapped by `DistributedOptimizer` (its step
    averages the gradients over the ranks)."""
    return getattr(optimizer, "_hvd_distributed", False)


class _DistributedOptimizer:
    """Method bodies grafted by the `DistributedOptimizer` factory onto
    a dynamic subclass of the wrapped optimizer's class (as
    `horovod.torch` does): no __init__, the user's instance is
    rebranded with every attribute its constructor set."""

    def _allreduce_grads(self):
        """Average every ``.grad`` over the ranks (a no-op at world
        size 1)."""
        allreduce_gradients(
            [p.grad for group in self.param_groups
             for p in group["params"] if p.grad is not None],
            average=self._hvd_average, threshold=self._hvd_threshold,
            reduce_dtype=self._hvd_reduce_dtype)

    def _accumulate(self) -> bool:
        """Fold this backward pass's grads into the running sum; True
        when the k-th pass has arrived and ``.grad`` holds the mean."""
        k = self._hvd_passes
        if k == 1:
            return True
        acc = self._hvd_acc
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p in acc:
                    acc[p] += p.grad
                else:
                    acc[p] = p.grad.detach().clone()
        self._hvd_count += 1
        if self._hvd_count < k:
            return False
        for p, total in acc.items():
            p.grad = total / k
        self._hvd_acc, self._hvd_count = {}, 0
        return True

    def step(self, closure=None):
        if closure is None:
            if not self._accumulate():
                return None
            self._allreduce_grads()
            out = super(self.__class__, self).step()
            self._opt_called = True  # LR scheduler call-order tracking
            return out

        # Closure optimizers (LBFGS) re-evaluate the loss inside the
        # parent's step; average the grads after every re-evaluation.
        def distributed_closure():
            with torch.enable_grad():
                loss = closure()
            self._allreduce_grads()
            return loss

        out = super(self.__class__, self).step(distributed_closure)
        self._opt_called = True
        return out


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, *, average: bool = True,
                         fusion_threshold: Optional[int] = None,
                         reduce_dtype: Optional[torch.dtype] = None,
                         backward_passes_per_step: int = 1,
                         compression: Optional[str] = None):
    """Distributed step: every ``step()`` first allreduces each
    parameter's ``.grad`` over the ranks (averaged unless
    ``average=False``), bucketed by ``fusion_threshold`` bytes
    (default ``HOROVOD_FUSION_THRESHOLD``), optionally in
    ``reduce_dtype``; ``compression="fp16"`` is that with float16.
    ``backward_passes_per_step=k`` accumulates k passes locally and
    allreduces and steps once, on their mean. Returns the SAME
    optimizer instance rebranded to a subclass of its own class (LR
    schedulers, ``isinstance`` and checkpoints keep working).
    ``named_parameters`` is accepted for Horovod's signature."""
    if compression == "powersgd":
        raise NotImplementedError(
            "compression='powersgd' is a later slice of the PyTorch port")
    if compression not in (None, "fp16"):
        raise ValueError(f"compression must be None|'fp16'|'powersgd', "
                         f"got {compression!r}")
    if backward_passes_per_step < 1:
        raise ValueError(f"backward_passes_per_step must be >= 1, got "
                         f"{backward_passes_per_step}")
    if compression == "fp16" and reduce_dtype is None:
        reduce_dtype = torch.float16
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               {"step": _DistributedOptimizer.step,
                "_allreduce_grads": _DistributedOptimizer._allreduce_grads,
                "_accumulate": _DistributedOptimizer._accumulate})
    # The LR scheduler's "step() has been overridden" heuristic reads
    # this marker; the distributed step keeps the scheduler contract.
    cls.step._wrapped_by_lr_sched = True
    optimizer.__class__ = cls
    # A scheduler attached BEFORE wrapping patched `step` on the
    # instance; drop it so the distributed step is not shadowed.
    optimizer.__dict__.pop("step", None)
    optimizer._hvd_distributed = True
    optimizer._hvd_average = average
    optimizer._hvd_threshold = fusion_threshold
    optimizer._hvd_reduce_dtype = reduce_dtype
    optimizer._hvd_passes = backward_passes_per_step
    optimizer._hvd_acc, optimizer._hvd_count = {}, 0
    return optimizer


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a ``state_dict()`` (or ``named_parameters()``) in place
    from ``root_rank`` so every rank starts identically."""
    if world_size() == 1:
        return
    items = sorted(params.items() if hasattr(params, "items")
                   else params, key=lambda kv: kv[0])
    for name, p in items:
        if isinstance(p, torch.Tensor):
            eager.broadcast_(p.data, root_rank, name=f"bcast_{name}")


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast optimizer state (moments, step counts) from the root.

    The root first broadcasts the STRUCTURE of its state (which params
    have which keys, tensor shapes and dtypes, scalar values) and the
    other ranks materialize missing buffers before the tensor
    broadcasts, so ranks whose state is empty (a restore on the root
    only) run the same collective sequence instead of hanging."""
    if world_size() == 1:
        return
    spec = None
    if _state.check_initialized().rank == root_rank:
        spec = []
        for gi, group in enumerate(optimizer.param_groups):
            for pi, p in enumerate(group["params"]):
                entry = []
                state = optimizer.state.get(p, {})
                for key in sorted(state, key=str):
                    val = state[key]
                    if isinstance(val, torch.Tensor):
                        entry.append((key, "tensor", tuple(val.shape),
                                      str(val.dtype), str(val.device)))
                    else:
                        entry.append((key, "value", val))
                if entry:
                    spec.append(((gi, pi), entry))
    spec = broadcast_object(spec, root_rank)
    by_index = {(gi, pi): p
                for gi, group in enumerate(optimizer.param_groups)
                for pi, p in enumerate(group["params"])}
    for (gi, pi), entry in spec:
        p = by_index[(gi, pi)]
        state = optimizer.state[p]
        for item in entry:
            if item[1] != "tensor":
                state[item[0]] = item[2]
                continue
            key, _, shape, dtype_name, where = item
            dtype = getattr(torch, dtype_name.replace("torch.", ""))
            val = state.get(key)
            if (not isinstance(val, torch.Tensor)
                    or tuple(val.shape) != shape or val.dtype != dtype):
                # step counts live on the host, moments beside the param
                dev = "cpu" if where == "cpu" else p.device
                val = torch.zeros(shape, dtype=dtype, device=dev)
                state[key] = val
            eager.broadcast_(val, root_rank, name=f"opt_{gi}_{pi}_{key}")


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """A picklable object from ``root_rank``, on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def allgather_object(obj: Any) -> list:
    """One picklable object per rank, as a list in rank order."""
    if world_size() == 1:
        return [obj]
    out: list = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: bool = True,
                      name: Optional[str] = None) -> list:
    """Allreduce a list of tensors as one fused operation per dtype.
    The ranks first check that they agree on the whole group's
    composition (shapes, dtypes, order), which the flat payloads alone
    would not show."""
    st = _state.check_initialized()
    if st.size > 1:
        desc = repr([(tuple(t.shape), str(t.dtype)) for t in tensors])
        eager._negotiate(st, name, "grouped_allreduce",
                         torch.empty(len(tensors)), extra=desc)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: list = [None] * len(tensors)
    for idx in by_dtype.values():
        flat = eager.allreduce(
            torch.cat([tensors[i].reshape(-1) for i in idx]),
            average=average)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out
