"""`horovod_tpu_torch.resilience` — fault injection, retry, failure
detection and preemption-safe training (counterpart of
`horovod_tpu.resilience`):

* `chaos` — a `ChaosMonkey` fault injector armed via ``HVD_CHAOS``;
  named sites instrument checkpoint I/O, the data pipeline, the train
  loop and the serving engine, with deterministic seeding so failures
  replay.
* `retry` — `RetryPolicy`: bounded exponential backoff with jitter
  and a deadline, shared by checkpoint I/O and data loading.
* `detector` — the failure detector the serving router's sweep shares.
* `elastic` — `PreemptionHandler` (SIGTERM/SIGINT/SIGUSR1 emergency
  checkpoint), `NaNGuard` (loss-spike / NaN rollback), and
  `ElasticTrainer` tying resume discovery, periodic + emergency
  checkpointing, rollback, and the exactly-once `TrainSnapshot`
  (model + optimizer + data cursor + host RNG + guard history) into
  one loop-side helper.
* `equivalence` — the crash-restart equivalence harness (``python -m
  horovod_tpu_torch.resilience.equivalence --workdir DIR``).

Membership, the multi-process drill and the resize half of the
equivalence harness are a later slice of the port.
"""

from horovod_tpu_torch.resilience.chaos import (
    ChaosError,
    ChaosMonkey,
    armed,
    fires,
)
from horovod_tpu_torch.resilience.detector import (
    FailureDetector,
    install_detector,
    shared_detector,
)
from horovod_tpu_torch.resilience.elastic import (
    ElasticTrainer,
    NaNGuard,
    PreemptionHandler,
    TrainSnapshot,
)
from horovod_tpu_torch.resilience.retry import (
    RetryError,
    RetryPolicy,
    default_io_policy,
)

__all__ = [
    "ChaosError", "ChaosMonkey", "armed", "fires",
    "FailureDetector", "install_detector", "shared_detector",
    "ElasticTrainer", "NaNGuard", "PreemptionHandler", "TrainSnapshot",
    "RetryError", "RetryPolicy", "default_io_policy",
]
