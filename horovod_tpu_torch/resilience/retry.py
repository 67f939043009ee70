"""Bounded exponential-backoff retry with jitter and a deadline.

One `RetryPolicy` is shared by checkpoint I/O (`utils/checkpoint.py`)
and data loading (`horovod_tpu_torch.data`, later slices of the port):
transient filesystem faults — an object store's 5xx, an injected
`ChaosError` in tests — are retried with exponential backoff;
programming errors are not (the default filter retries `OSError` and
`ChaosError` only). The policy is a frozen value object so one
instance can be shared across threads.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Type

from horovod_tpu_torch.resilience.chaos import ChaosError


class RetryError(RuntimeError):
    """All attempts failed (or the deadline passed). ``__cause__``
    carries the last underlying exception; `attempts` how many ran."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


@dataclass(frozen=True)
class RetryPolicy:
    """max_attempts total tries; sleep base * multiplier**k, capped at
    max_delay, +/- jitter fraction; give up early once deadline_s of
    wall clock has passed. `retry_on` filters which exceptions are
    transient — anything else propagates immediately."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (OSError, ChaosError)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1, got {self.multiplier}")

    def delays(self) -> Iterator[float]:
        """The backoff schedule (one entry per retry, i.e.
        max_attempts - 1 entries)."""
        d = self.base_delay_s
        for _ in range(self.max_attempts - 1):
            j = 1.0 + self.jitter * (2 * random.random() - 1)
            yield min(d, self.max_delay_s) * j
            d *= self.multiplier

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy.

        ``on_retry(exc, attempt, delay_s)`` fires before each backoff
        sleep (attempt is 1-based); the default logs to stderr — the
        CI chaos smoke greps for that line.
        """
        t0 = time.time()
        last: Optional[BaseException] = None
        delays = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203
                last = e
                if attempt >= self.max_attempts:
                    break
                delay = next(delays)
                if (self.deadline_s is not None
                        and time.time() - t0 + delay > self.deadline_s):
                    break
                if on_retry is not None:
                    on_retry(e, attempt, delay)
                else:
                    sys.stderr.write(
                        f"horovod_tpu_torch: transient failure ({e!r}); "
                        f"retry {attempt}/{self.max_attempts - 1} in "
                        f"{delay:.2f}s\n")
                time.sleep(delay)
        raise RetryError(
            f"gave up after {attempt} attempt(s): {last!r}",
            attempts=attempt) from last


def default_io_policy() -> RetryPolicy:
    """The shared checkpoint/data-loading policy. ``HVD_IO_RETRIES``
    overrides the attempt count (0 disables retries entirely)."""
    from horovod_tpu_torch.runtime.config import env_int
    return RetryPolicy(max_attempts=max(1, env_int("HVD_IO_RETRIES", 3)))
