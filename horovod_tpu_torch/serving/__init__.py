"""horovod_tpu_torch.serving — the continuous-batching serving engine.

* `engine.ServingEngine` — `submit()`/`shutdown()` over one background
  dispatch thread.
* `scheduler.ContinuousBatchingScheduler` — iteration-level batching
  with interleaved chunked prefill and the pipelined tick ring.
* `slots.SlotPool` — the slot-pool KV cache and the batched decode
  tick (flash-decode kernel on the card); with a ``spec_draft``, the
  speculative draft-verify round instead of the tick
  (`ServingEngine(spec_draft=..., spec_k=...)`).
* `paging.BlockPool` / `paging.PagedSlotPool` — the paged KV cache:
  refcounted fixed-size blocks (block tables, copy-on-write,
  LRU-cached shared prompt prefixes) and the batched paged tick
  (paged-decode kernel on the card); `ServingEngine(paged=True)`.
* `transfer` — digest-verified KV-block export/ingest (what swap
  preemption shelves and re-grafts).
* `admission`, `metrics`, `overload` — admission control, request
  metrics, preemption/brownout.

Routing and disaggregation are later slices of the port.
"""

from horovod_tpu_torch.serving.admission import (
    DeadlineExceededError, EngineClosedError, QueueFullError,
    SamplingParams, ServingError,
)
from horovod_tpu_torch.serving.engine import RequestHandle, ServingEngine
from horovod_tpu_torch.serving.metrics import EngineMetrics
from horovod_tpu_torch.serving.scheduler import (
    CompletedRequest, ContinuousBatchingScheduler,
)
from horovod_tpu_torch.serving.paging import BlockPool, PagedSlotPool
from horovod_tpu_torch.serving.slots import Admission, SlotPool
from horovod_tpu_torch.serving.transfer import (
    BlockTransfer, TransferCompatError, TransferError,
    TransferExportError, TransferVerifyError, export_blocks,
    ingest_blocks,
)

__all__ = [
    "ServingEngine", "RequestHandle", "SamplingParams", "CompletedRequest",
    "ContinuousBatchingScheduler", "SlotPool", "EngineMetrics",
    "QueueFullError", "DeadlineExceededError", "EngineClosedError",
    "ServingError", "Admission", "BlockPool", "PagedSlotPool",
    "BlockTransfer", "TransferError", "TransferExportError",
    "TransferCompatError", "TransferVerifyError", "export_blocks",
    "ingest_blocks",
]
