"""Process-group lifecycle: `init`, `shutdown` and the rank queries.

Counterpart of `horovod_tpu.runtime.bootstrap` over `torch.distributed`:
a rank is a process driving one device, as in Horovod itself. `init()`
builds the default process group — NCCL on a CUDA device, gloo for
``device="cpu"`` — with its membership from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, with
``MASTER_ADDR``/``MASTER_PORT`` for the rendezvous), from explicit
arguments (``rank``, ``size`` and an ``init_method`` such as
``file:///path``), or else as a world of one over an in-process store
(no port, no file). The launcher, elastic membership and the timeline
are later slices.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime import state as _state
from horovod_tpu_torch.runtime.config import config


def _membership(rank, size):
    """(rank, size, local_rank, local_size) from the arguments, else
    torchrun's environment, else a world of one."""
    env = os.environ
    if rank is None and size is None and "RANK" in env:
        rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
        lrank = int(env.get("LOCAL_RANK", rank))
        lsize = int(env.get("LOCAL_WORLD_SIZE", size))
        return rank, size, lrank, lsize
    if (rank is None) != (size is None):
        raise ValueError("pass both rank and size, or neither")
    if rank is None:
        return 0, 1, 0, 1
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    return rank, size, rank, size


def init(device=None, *, rank: Optional[int] = None,
         size: Optional[int] = None, init_method: Optional[str] = None,
         timeout_s: float = 300.0) -> int:
    """Join (or form) the data-parallel world; idempotent, like
    Horovod's ``init``. ``device``: this rank's device (CUDA unless
    ``"cpu"``; a CUDA rank uses card ``local_rank``) — it picks the
    backend, NCCL or gloo. ``rank``/``size``/``init_method`` give the
    membership explicitly (``init_method`` defaults to torchrun's
    ``env://`` when its variables are set). Returns 0."""
    st = _state.global_state()
    with st.lock:
        if st.initialized:
            return 0
        config.refresh()
        r, n, lr, ln = _membership(rank, size)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init(device='cuda') without a card; pass "
                    "device='cpu' for the gloo backend")
            dev = torch.device("cuda", lr if dev.index is None
                               else dev.index)
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = dict(backend=backend, rank=r, world_size=n,
                  timeout=datetime.timedelta(seconds=timeout_s))
        if init_method is not None:
            dist.init_process_group(init_method=init_method, **kw)
        elif n > 1 or "MASTER_ADDR" in os.environ:
            dist.init_process_group(init_method="env://", **kw)
        else:
            dist.init_process_group(store=dist.HashStore(), **kw)
        if dist.get_world_size() != n or dist.get_rank() != r:
            raise RuntimeError(
                f"process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, expected {r} of {n}")
        st.rank, st.size = r, n
        st.local_rank, st.local_size = lr, ln
        st.process_rank, st.num_processes = r, n
        st.devices = [dev]
        st.initialized = True
        st.shut_down = False
        atexit.register(shutdown)
        return 0


def shutdown() -> None:
    """Destroy the process group (an NCCL group left alive can hang the
    interpreter at exit) and forget the membership; `rank()` raises
    `NotInitializedError` until the next `init()`."""
    st = _state.global_state()
    with st.lock:
        if not st.initialized:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        st.reset()
        st.shut_down = True


def is_initialized() -> bool:
    return _state.global_state().initialized


def rank() -> int:
    return _state.check_initialized().rank


def size() -> int:
    return _state.check_initialized().size


def local_rank() -> int:
    return _state.check_initialized().local_rank


def local_size() -> int:
    return _state.check_initialized().local_size
