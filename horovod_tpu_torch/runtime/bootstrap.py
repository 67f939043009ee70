"""Process-group lifecycle: `init`, `shutdown` and the rank queries.

Counterpart of `horovod_tpu.runtime.bootstrap` over `torch.distributed`:
a rank is a process driving one device, as in Horovod itself. `init()`
builds the default process group — NCCL on a CUDA device, gloo on the
CPU. Its membership comes from, highest first: explicit ``rank=`` /
``size=`` (with an ``init_method`` such as ``file:///path``); the
``hvdrun`` launcher's ``HOROVOD_RANK`` / ``HOROVOD_SIZE`` /
``HOROVOD_LOCAL_RANK`` / ``HOROVOD_LOCAL_SIZE`` (`runner`); torchrun's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` with
``MASTER_ADDR`` / ``MASTER_PORT``; else a world of one over an
in-process store (no port, no file). Under the launcher the ranks meet
at its rendezvous store (``HOROVOD_KV=host:port``, a
`torch.distributed.TCPStore`), and ``HOROVOD_PLATFORM`` (``gpu`` or
``cpu``) picks the default device. As in the JAX package
(`bootstrap.py:169-175`), `init` opens the timeline when
``HOROVOD_TIMELINE`` names a file and starts a `StallMonitor` for the
eager collectives; `shutdown` closes both. Elastic membership is a
later slice.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime import state as _state
from horovod_tpu_torch.runtime.config import config, env_int, env_str


def _membership(rank, size):
    """(rank, size, local_rank, local_size) from the arguments, else the
    launcher's environment, else torchrun's, else a world of one."""
    env = os.environ
    if (rank is None) != (size is None):
        raise ValueError("pass both rank and size, or neither")
    if rank is None and env_str("HOROVOD_RANK"):
        rank, size = env_int("HOROVOD_RANK", 0), env_int("HOROVOD_SIZE", 0)
        lrank = env_int("HOROVOD_LOCAL_RANK", rank)
        lsize = env_int("HOROVOD_LOCAL_SIZE", size)
    elif rank is None and "RANK" in env:
        rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
        lrank = int(env.get("LOCAL_RANK", rank))
        lsize = int(env.get("LOCAL_WORLD_SIZE", size))
    elif rank is None:
        return 0, 1, 0, 1
    else:
        lrank, lsize = rank, size
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    return rank, size, lrank, lsize


def _default_device():
    """``HOROVOD_PLATFORM``'s device: gpu -> cuda, cpu -> cpu; unset ->
    cuda (entry points run on the card unless told otherwise)."""
    platform = config.platform or "gpu"
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"HOROVOD_PLATFORM must be 'gpu' or 'cpu', got "
                         f"{platform!r}")
    return "cuda" if platform == "gpu" else "cpu"


def _launcher_store(timeout):
    """A client of the launcher's rendezvous store, or None when no
    launcher set ``HOROVOD_KV``."""
    addr = env_str("HOROVOD_KV")
    if not addr:
        return None
    host, _, port = addr.rpartition(":")
    return dist.TCPStore(host, int(port), is_master=False,
                         timeout=timeout)


def init(device=None, *, rank: Optional[int] = None,
         size: Optional[int] = None, init_method: Optional[str] = None,
         timeout_s: float = 300.0) -> int:
    """Join (or form) the data-parallel world; idempotent, like
    Horovod's ``init``. ``device``: this rank's device (CUDA unless
    ``"cpu"``, default from ``HOROVOD_PLATFORM``; a CUDA rank uses card
    ``local_rank``) — it picks the backend, NCCL or gloo.
    ``rank``/``size``/``init_method`` give the membership explicitly
    (``init_method`` defaults to the launcher's store, else torchrun's
    ``env://`` when its variables are set). Returns 0."""
    st = _state.global_state()
    with st.lock:
        if st.initialized:
            return 0
        config.refresh()
        r, n, lr, ln = _membership(rank, size)
        dev = torch.device(_default_device() if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init(device='cuda') without a card; pass "
                    "device='cpu' (or HOROVOD_PLATFORM=cpu) for the gloo "
                    "backend")
            dev = torch.device("cuda", lr if dev.index is None
                               else dev.index)
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        timeout = datetime.timedelta(seconds=timeout_s)
        kw = dict(backend=backend, rank=r, world_size=n, timeout=timeout)
        store = None if init_method is not None else _launcher_store(
            timeout)
        if init_method is not None:
            dist.init_process_group(init_method=init_method, **kw)
        elif store is not None:
            dist.init_process_group(store=store, **kw)
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
        st.store = store
        if config.timeline_path:
            from horovod_tpu_torch.utils.timeline import Timeline
            st.timeline = Timeline(config.timeline_path)
        from horovod_tpu_torch.utils.stall import StallMonitor
        st.stall_monitor = StallMonitor(config.stall_warning_time)
        # Observability exporter: env-gated — with HVD_METRICS_PORT
        # unset this is a no-op, so the knob alone turns the HTTP
        # endpoint on for any init()'d process.
        from horovod_tpu_torch.obs.exporter import start_exporter
        start_exporter()
        st.initialized = True
        st.shut_down = False
        atexit.register(shutdown)
        return 0


def shutdown() -> None:
    """Close the timeline, stop the stall monitor, destroy the process
    group (an NCCL group left alive can hang the interpreter at exit)
    and forget the membership; `rank()` raises
    `NotInitializedError` until the next `init()`."""
    st = _state.global_state()
    with st.lock:
        if not st.initialized:
            return
        if st.timeline is not None:
            st.timeline.close()
        if st.stall_monitor is not None:
            st.stall_monitor.stop()
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
