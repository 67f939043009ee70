"""Global runtime state.

TPU-native replacement for the reference's `HorovodGlobalState` singleton
(`horovod/tensorflow/mpi_ops.cc:132-219`). The reference state holds a mutex,
tensor table, message queue, fusion buffers, CUDA streams and NCCL comms —
all machinery for ordering collectives across nondeterministically-scheduled
TF executor threads. Under JAX SPMD none of that is needed at runtime: the
collective schedule is fixed at trace time. What remains is membership
(rank/size/local_rank, `mpi_ops.cc:1536-1563` semantics), the device mesh,
and handles to the native control plane (timeline / stall detector /
validation).

Rank model (how Horovod's process-per-accelerator MPMD maps onto JAX):

* A *rank* is a device slot in the 1-D ``data`` mesh, exactly what gradient
  averaging divides by — Horovod's ``size()``.
* Under the ``hvdrun`` launcher each spawned process controls one device
  (CPU mode) or one host's devices (TPU pod), and ``rank()`` equals the
  global index of this process's first device — identical to Horovod's
  process rank in the one-device-per-process case the reference tests
  exercise (`mpi_ops_test.py:31-63`).
* In single-controller mode (one process, N local devices) the controller
  acts on behalf of all N ranks; ``rank()`` is 0 and per-rank identity is
  available inside ``shard_map`` via ``lax.axis_index``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class NotInitializedError(ValueError):
    """Raised by rank()/size()/local_rank() before init().

    Mirrors the reference's ValueError('Horovod has not been initialized;
    use horovod.tensorflow.init().') raised on the C API returning -1
    (`horovod/tensorflow/mpi_ops.py:86-124`).
    """


class GlobalState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.shut_down = False
        # Membership (-1 == uninitialized, mpi_ops.cc:1536-1563 contract).
        self.rank: int = -1
        self.size: int = -1
        self.local_rank: int = -1
        self.local_size: int = -1
        self.process_rank: int = -1
        self.num_processes: int = -1
        # Elastic membership (resilience/membership.py): monotonic
        # world generation — bumps on every committed resize; 0 is the
        # launch world. Survives init-state checks: a resize re-keys
        # the membership fields above in place rather than tearing
        # the runtime down.
        self.world_generation: int = 0
        # Device topology.
        self.mesh: Optional[Any] = None          # jax.sharding.Mesh
        self.axis_name: str = "data"
        self.devices: list = []
        # Native control plane handles (set lazily).
        self.native: Optional[Any] = None        # ctypes library wrapper
        self.timeline: Optional[Any] = None
        self.stall_monitor: Optional[Any] = None
        # The launcher's rendezvous store (a TCPStore client) the
        # process group was formed over, or None.
        self.store: Optional[Any] = None
        # Eager-path compile cache: name -> jitted collective.
        self.op_cache: dict = {}
        # (proc, local) mesh for payload-deduplicated mc collectives
        # (built lazily by ops.eager._mc_mesh2).
        self.mc_mesh2: Optional[Any] = None

    def reset(self) -> None:
        self.initialized = False
        self.shut_down = False
        self.rank = self.size = self.local_rank = self.local_size = -1
        self.process_rank = self.num_processes = -1
        self.world_generation = 0
        self.mesh = None
        self.devices = []
        self.op_cache = {}
        self.mc_mesh2 = None
        self.timeline = None
        self.stall_monitor = None
        self.store = None


_global_state = GlobalState()


def global_state() -> GlobalState:
    return _global_state


def check_initialized() -> GlobalState:
    """Parity with CheckInitialized (`mpi_ops.cc:1527-1533`)."""
    st = _global_state
    if not st.initialized:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized.")
    return st
