"""The framework adapter: Horovod's data-parallel training surface on
`torch.optim`.

Counterpart of `horovod_tpu.jax` (the JAX package's primary adapter,
`horovod_tpu/jax/__init__.py`), in the shape of Horovod's torch API
(`horovod.torch`): a `DistributedOptimizer` that averages every
gradient over the ranks, fused into same-dtype buckets (`ops.fusion`),
before the wrapped optimizer's step — sparse gradients (PyTorch's COO
gradients of ``F.embedding(sparse=True)``, or `ops.sparse.IndexedSlices`)
by allgathering their rows instead, and optionally through PowerSGD
(`ops.compression`); `DistributedGradientTape` and `make_train_step`;
`broadcast_parameters` / `broadcast_optimizer_state` (and
`broadcast_global_variables`) for a consistent start;
`broadcast_object`, `allgather_object`, `grouped_allreduce` and
`make_global_batch`. The module is named for what it wraps, so it does
not shadow `torch`.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import eager
from horovod_tpu_torch.ops.fusion import fused_allreduce_leaves
from horovod_tpu_torch.ops.sparse import IndexedSlices
from horovod_tpu_torch.runtime import state as _state
from horovod_tpu_torch.runtime.config import config

# The keys under which DistributedOptimizer(compression="powersgd")
# keeps each compressed parameter's factor Q and error buffer in the
# wrapped optimizer's state.
POWERSGD_Q = "powersgd_q"
POWERSGD_ERR = "powersgd_err"
_POWERSGD_KEYS = (POWERSGD_Q, POWERSGD_ERR)


def world_size() -> int:
    """Ranks of the initialized world; 1 before `init()`."""
    st = _state.global_state()
    return st.size if st.initialized else 1


def _is_sparse(g) -> bool:
    return isinstance(g, IndexedSlices) or (
        isinstance(g, torch.Tensor) and g.layout == torch.sparse_coo)


def _allreduce_sparse(g, average: bool):
    """The allgather path of one sparse gradient: an `IndexedSlices`
    stays one; a COO tensor is coalesced, its rows and indices
    gathered, and it comes back as a coalesced COO tensor."""
    if isinstance(g, IndexedSlices):
        return eager.allreduce(g, average=average)
    red = eager.allreduce(IndexedSlices.from_sparse(g), average=average)
    return red.to_sparse().coalesce()


def allreduce_gradients(grads: Sequence[Any], *, average: bool = True,
                        threshold: Optional[int] = None,
                        reduce_dtype: Optional[torch.dtype] = None
                        ) -> list:
    """Allreduce a list of gradients; returns the list. Dense tensors
    are reduced IN PLACE, fused (buckets of ``threshold`` bytes, default
    ``HOROVOD_FUSION_THRESHOLD``; reduced in ``reduce_dtype``, default
    ``HOROVOD_ALLREDUCE_DTYPE``), and must not alias one another. Sparse
    ones (`IndexedSlices`, sparse COO tensors) never reach the fused
    buckets: they take the allgather path (`ops.sparse`), and their
    entries in the returned list are new objects. None entries pass
    through. The identity at world size 1 (or before `init()`), as in
    Horovod."""
    grads = list(grads)
    if world_size() == 1 or not grads:
        return grads
    if reduce_dtype is None and config.allreduce_dtype:
        reduce_dtype = getattr(torch, config.allreduce_dtype)
    dense = [i for i, g in enumerate(grads)
             if g is not None and not _is_sparse(g)]
    if dense:
        reduced = fused_allreduce_leaves([grads[i] for i in dense],
                                         average=average,
                                         threshold=threshold,
                                         reduce_dtype=reduce_dtype)
        with torch.no_grad():
            for i, r in zip(dense, reduced):
                grads[i].copy_(r)
    for i, g in enumerate(grads):
        if _is_sparse(g):
            grads[i] = _allreduce_sparse(g, average)
    return grads


def _allreduce_param_grads(params, **kw) -> None:
    """`allreduce_gradients` over the ``.grad`` of ``params``; a sparse
    gradient's reduced tensor replaces ``.grad``."""
    params = [p for p in params if p.grad is not None]
    out = allreduce_gradients([p.grad for p in params], **kw)
    for p, g in zip(params, out):
        if g is not p.grad:
            p.grad = g


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

    def _hvd_params(self) -> list:
        return [p for group in self.param_groups for p in group["params"]]

    def _allreduce_grads(self):
        """Average every ``.grad`` over the ranks (a no-op at world
        size 1, but PowerSGD's error feedback runs at every size)."""
        if self._hvd_powersgd is not None:
            self._hvd_powersgd_grads()
            return
        _allreduce_param_grads(
            self._hvd_params(), average=self._hvd_average,
            threshold=self._hvd_threshold,
            reduce_dtype=self._hvd_reduce_dtype)

    def _hvd_powersgd_slots(self):
        """Where the PowerSGD entries live now: the optimizer's state,
        or, while the wrapped step runs, the side table they wait in."""
        return self.state if self._hvd_held is None else self._hvd_held

    def _hvd_powersgd_grads(self):
        """Replace every ``.grad`` by its PowerSGD reduction and update
        each compressed parameter's Q and error in place in the state."""
        from horovod_tpu_torch.ops.compression import PowerSGDState
        params, slots = self._hvd_params(), self._hvd_powersgd_slots()
        entries = [slots.get(p, {}) for p in params]
        state = PowerSGDState(
            tuple(e.get(POWERSGD_Q) for e in entries),
            tuple(e.get(POWERSGD_ERR) for e in entries),
            self._hvd_powersgd.seed)
        reduced, new = self._hvd_powersgd.update(
            [p.grad for p in params], state)
        for p, g, q, err in zip(params, reduced, new.qs, new.errs):
            if g is not None and g is not p.grad:
                p.grad = g
            if q is not None:
                slots[p][POWERSGD_Q], slots[p][POWERSGD_ERR] = q, err

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
                if p.grad.is_sparse:
                    raise NotImplementedError(
                        "backward_passes_per_step > 1 does not support "
                        "sparse IndexedSlices gradients (densify them or "
                        "accumulate at k=1)")
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

    def _hvd_wrapped_step(self, closure=None):
        """The wrapped optimizer's step, with the PowerSGD entries held
        aside so it sees only its own state (Adam initializes a
        parameter's state when it finds it empty)."""
        if self._hvd_powersgd is None:
            return super(self.__class__, self).step(closure)
        held = {}
        for p in self._hvd_params():
            entry = self.state.get(p)
            if entry is not None and POWERSGD_Q in entry:
                held[p] = {k: entry.pop(k) for k in _POWERSGD_KEYS}
        self._hvd_held = held
        try:
            return super(self.__class__, self).step(closure)
        finally:
            self._hvd_held = None
            for p, entry in held.items():
                self.state[p].update(entry)

    def step(self, closure=None):
        if closure is None:
            if not self._accumulate():
                return None
            self._allreduce_grads()
            out = self._hvd_wrapped_step()
            self._opt_called = True  # LR scheduler call-order tracking
            return out

        # Closure optimizers (LBFGS) re-evaluate the loss inside the
        # parent's step; average the grads after every re-evaluation.
        def distributed_closure():
            with torch.enable_grad():
                loss = closure()
            self._allreduce_grads()
            return loss

        out = self._hvd_wrapped_step(distributed_closure)
        self._opt_called = True
        return out

    def load_state_dict(self, state_dict):
        """The wrapped optimizer's `load_state_dict`, except that the
        PowerSGD entries are placed by this wrapper, in float32 on the
        parameter's device (the base class would cast them to the
        parameter's dtype)."""
        base = super(self.__class__, self).load_state_dict
        if self._hvd_powersgd is None:
            return base(state_dict)
        own, extra = {}, {}
        for key, entry in state_dict["state"].items():
            rest = {k: v for k, v in entry.items()
                    if k not in _POWERSGD_KEYS}
            extra[key] = {k: entry[k] for k in _POWERSGD_KEYS
                          if k in entry}
            if rest:
                own[key] = rest
        base(dict(state_dict, state=own))
        saved = itertools.chain.from_iterable(
            g["params"] for g in state_dict["param_groups"])
        for key, p in zip(saved, self._hvd_params()):
            for k, v in extra.get(key, {}).items():
                self.state[p][k] = v.to(p.device, torch.float32)


_GRAFTED = ("_hvd_params", "_allreduce_grads", "_hvd_powersgd_slots",
            "_hvd_powersgd_grads", "_accumulate", "_hvd_wrapped_step", "step",
            "load_state_dict")


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, *, average: bool = True,
                         fusion_threshold: Optional[int] = None,
                         reduce_dtype: Optional[torch.dtype] = None,
                         backward_passes_per_step: int = 1,
                         compression: Optional[str] = None,
                         compression_rank: int = 4):
    """Distributed step: every ``step()`` first allreduces each
    parameter's ``.grad`` over the ranks (averaged unless
    ``average=False``), bucketed by ``fusion_threshold`` bytes
    (default ``HOROVOD_FUSION_THRESHOLD``), optionally in
    ``reduce_dtype``; ``compression="fp16"`` is that with float16. A
    sparse ``.grad`` (``F.embedding(sparse=True)``) is allgathered
    (its coalesced indices and rows) and replaced by the sparse mean,
    which `torch.optim.SGD` / `Adagrad` apply.

    ``compression="powersgd"``: each eligible matrix gradient is
    replaced by the rank-``compression_rank`` approximation of the mean
    gradient with error feedback (`ops.compression`); its Q and error
    live in this optimizer's ``state[p]`` (``"powersgd_q"``,
    ``"powersgd_err"``, float32), so ``state_dict()``, checkpoints and
    `broadcast_optimizer_state` carry them. Initial Qs come from
    `ops.compression.initial_q` (seed 17 and the parameter's index).

    ``backward_passes_per_step=k`` accumulates k passes locally and
    allreduces (or compresses) and steps once, on their mean. Returns
    the SAME optimizer instance rebranded to a subclass of its own class
    (LR schedulers, ``isinstance`` and checkpoints keep working).
    ``named_parameters`` is accepted for Horovod's signature."""
    if compression not in (None, "fp16", "powersgd"):
        raise ValueError(f"compression must be None|'fp16'|'powersgd', "
                         f"got {compression!r}")
    if backward_passes_per_step < 1:
        raise ValueError(f"backward_passes_per_step must be >= 1, got "
                         f"{backward_passes_per_step}")
    if compression == "fp16" and reduce_dtype is None:
        reduce_dtype = torch.float16
    compressor = None
    if compression == "powersgd":
        if not average:
            raise ValueError(
                "compression='powersgd' averages by construction "
                "(the factor allreduces are means); average=False is "
                "not supported")
        from horovod_tpu_torch.ops.compression import powersgd_allreduce
        compressor = powersgd_allreduce(compression_rank,
                                        threshold=fusion_threshold,
                                        reduce_dtype=reduce_dtype)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               {k: getattr(_DistributedOptimizer, k) for k in _GRAFTED})
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
    optimizer._hvd_powersgd, optimizer._hvd_held = compressor, None
    if compressor is not None:
        params = optimizer._hvd_params()
        init = compressor.init([p.detach() for p in params])
        for p, q, err in zip(params, init.qs, init.errs):
            if q is not None:
                optimizer.state[p][POWERSGD_Q] = q
                optimizer.state[p][POWERSGD_ERR] = err
    return optimizer


class DistributedGradientTape:
    """``tape(*args) -> (loss, grads)``: the loss of ``loss_fn(*args)``,
    its gradients with respect to ``params`` (None for a parameter the
    loss does not reach) and their allreduce over the ranks (averaged
    unless ``average=False``; sparse gradients by the allgather path).
    Later Horovod's ``hvd.DistributedGradientTape``; counterpart of
    `horovod_tpu/jax/__init__.py:189-204`. ``.grad`` is not touched."""

    def __init__(self, loss_fn: Callable, params, *, average: bool = True):
        self._loss_fn = loss_fn
        self._params = list(params)
        self._average = average

    def __call__(self, *args, **kwargs):
        loss = self._loss_fn(*args, **kwargs)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = allreduce_gradients(grads, average=self._average)
        return loss.detach(), grads


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    *, fusion_threshold: Optional[int] = None,
                    reduce_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """``step(*batch) -> loss``: zero the grads, ``loss_fn(*batch)``,
    backward, average the gradients over the ranks, ``optimizer.step()``;
    returns the loss averaged over the ranks as a 0-d device tensor (no
    host sync). A `DistributedOptimizer` owns the allreduce; for any
    other optimizer the step allreduces (with ``fusion_threshold`` /
    ``reduce_dtype``). Each call is a ``train_step`` span on the
    timeline (`utils.timeline.step_bracket`). Counterpart of
    `horovod_tpu/jax/__init__.py:345-395`."""
    from horovod_tpu_torch.utils.timeline import step_bracket
    owned = is_distributed(optimizer)
    if owned and (fusion_threshold is not None
                  or reduce_dtype is not None):
        raise ValueError(
            "optimizer is an hvd.DistributedOptimizer, which owns the "
            "gradient allreduce — pass fusion_threshold/reduce_dtype "
            "to DistributedOptimizer(...) instead of the step factory")
    params = [p for group in optimizer.param_groups
              for p in group["params"]]

    def step(*batch, **kwargs) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(*batch, **kwargs)
        loss.backward()
        if not owned:
            _allreduce_param_grads(params, threshold=fusion_threshold,
                                   reduce_dtype=reduce_dtype)
        optimizer.step()
        return mean_over_ranks(loss.detach())

    return step_bracket(step)


def make_global_batch(batch: Any) -> Any:
    """This rank's shard of the global batch (tensors or arrays, in
    dicts, lists and tuples), as tensors on this rank's device. In the
    JAX package's multi-process form
    (`horovod_tpu/jax/__init__.py:327-342`) the per-process shards are
    assembled into one array sharded over the mesh; a torch rank owns
    exactly its shard and the gradient allreduce joins the ranks, so
    placing the shard is all there is to do."""
    dev = _state.check_initialized().devices[0]

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return torch.as_tensor(x).to(dev)

    return place(batch)


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


def broadcast_global_variables(params, root_rank: int = 0) -> None:
    """Alias of `broadcast_parameters` (the name of Horovod's TF API and
    of `horovod_tpu.jax`)."""
    broadcast_parameters(params, root_rank)


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
