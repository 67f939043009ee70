"""horovod_tpu_torch — the PyTorch/CUDA port of `horovod_tpu`.

A package of its own beside the JAX one: it imports `torch`, never
`jax`, and nothing of `horovod_tpu`. Its layout mirrors the JAX
package's so each module's counterpart is easy to find. It serves the
flagship LM (`models.transformer.TransformerLM`) through
`serving.ServingEngine` and trains it data-parallel, with the
flash-forward, flash-backward and decode kernels hand-written in CUDA
for Hopper (`csrc/`).

Horovod's surface, over `torch.distributed` (NCCL on the card, gloo on
the CPU)::

    import horovod_tpu_torch as hvd
    hvd.init()                       # device="cpu" for gloo
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    total = hvd.allreduce(t, average=False)
    shard = hvd.reducescatter(t)     # also alltoall, IndexedSlices

launched one process per card by ``hvdrun-torch -np N python train.py``
(`runner`; ``--platform cpu`` for gloo), with sparse embedding
gradients, PowerSGD (``compression="powersgd"``), the callbacks and
the Horovod Timeline (``HOROVOD_TIMELINE`` / `start_timeline`).
``hvd.spmd`` holds the collectives over a named axis of a
`parallel.mesh` (`ops.collectives`: allreduce, allgather, broadcast,
alltoall, ppermute, ...), which ring and Ulysses attention run on.

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper uses its plain PyTorch version.
"""

from horovod_tpu_torch import callbacks
from horovod_tpu_torch.ops import collectives as spmd
from horovod_tpu_torch.ops.eager import (CollectiveMismatchError, allgather,
                                         allreduce, allreduce_, alltoall,
                                         broadcast, broadcast_,
                                         reducescatter)
from horovod_tpu_torch.ops.sparse import IndexedSlices
from horovod_tpu_torch.optim import (DistributedGradientTape,
                                     DistributedOptimizer, allgather_object,
                                     allreduce_gradients, broadcast_object,
                                     broadcast_global_variables,
                                     broadcast_optimizer_state,
                                     broadcast_parameters, grouped_allreduce,
                                     make_global_batch, make_train_step)
from horovod_tpu_torch.runtime.bootstrap import (init, is_initialized,
                                                 local_rank, local_size,
                                                 rank, shutdown, size)
from horovod_tpu_torch.runtime.config import config
from horovod_tpu_torch.runtime.state import NotInitializedError
from horovod_tpu_torch.utils.timeline import start_timeline, stop_timeline

__version__ = "0.1.0"
