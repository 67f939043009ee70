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
* `router.ServingRouter` — fleet failover over N engine replicas:
  health-gated + load-aware routing, retry budgets, hedged
  slow-starters, and token-exact migration of in-flight streams off
  dead replicas (docs/serving.md "Fleet failover").
* `disagg.DisaggRouter` / `transfer` — disaggregated prefill/decode
  placement: a prefill pool runs prompts, the KV blocks migrate
  (digest-verified) into the decode pool's prefix cache, and the
  stream resumes mid-flight token-exact (``ServingRouter(disagg=...)``
  / ``HVD_DISAGG=1``); the same transfer is what swap preemption
  shelves and re-grafts.
* `admission`, `metrics`, `overload` — admission control, request
  metrics, preemption/brownout.
"""

from horovod_tpu_torch.serving.admission import (
    AdmissionQueue, DeadlineExceededError, EngineClosedError,
    QueueFullError, SamplingParams, ServingError,
)
from horovod_tpu_torch.serving.disagg import DisaggRouter
from horovod_tpu_torch.serving.engine import RequestHandle, ServingEngine
from horovod_tpu_torch.serving.metrics import EngineMetrics
from horovod_tpu_torch.serving.scheduler import (
    CompletedRequest, ContinuousBatchingScheduler,
)
from horovod_tpu_torch.serving.paging import BlockPool, PagedSlotPool
from horovod_tpu_torch.serving.router import (
    RetryBudget, RouterHandle, ServingRouter,
)
from horovod_tpu_torch.serving.slots import Admission, SlotPool
from horovod_tpu_torch.serving.transfer import (
    BlockTransfer, TransferCompatError, TransferError,
    TransferExportError, TransferVerifyError, export_blocks,
    ingest_blocks,
)

__all__ = [
    "ServingEngine", "RequestHandle", "CompletedRequest",
    "SamplingParams", "SlotPool", "ContinuousBatchingScheduler",
    "AdmissionQueue", "EngineMetrics", "ServingError",
    "QueueFullError", "DeadlineExceededError", "EngineClosedError",
    "Admission", "BlockPool", "PagedSlotPool",
    "ServingRouter", "RouterHandle", "RetryBudget",
    "DisaggRouter", "BlockTransfer", "TransferError",
    "TransferExportError", "TransferCompatError",
    "TransferVerifyError", "export_blocks", "ingest_blocks",
]
