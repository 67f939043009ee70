"""horovod_tpu_torch.serving — the continuous-batching serving engine.

* `engine.ServingEngine` — `submit()`/`shutdown()` over one background
  dispatch thread.
* `scheduler.ContinuousBatchingScheduler` — iteration-level batching
  with interleaved chunked prefill and the pipelined tick ring.
* `slots.SlotPool` — the slot-pool KV cache and the batched decode
  tick (flash-decode kernel on the card).
* `admission`, `metrics`, `overload` — admission control, request
  metrics, preemption/brownout.

The paged cache, routing, disaggregation and speculative decoding are
later slices of the port.
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
from horovod_tpu_torch.serving.slots import SlotPool

__all__ = [
    "ServingEngine", "RequestHandle", "SamplingParams", "CompletedRequest",
    "ContinuousBatchingScheduler", "SlotPool", "EngineMetrics",
    "QueueFullError", "DeadlineExceededError", "EngineClosedError",
    "ServingError",
]
