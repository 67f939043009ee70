"""Profiling hooks: step brackets and the opt-in torch.profiler session.

Counterpart of `horovod_tpu.obs.profiling`, with the same two layers:

* `StepProfiler` / `profile_step` — host-side step bracketing into
  the metric registry: step cadence histogram, steps counter, and —
  when the caller declares the step's work — tokens/s and an MFU
  gauge (declared FLOPs per step over the device's peak, the
  `utils/profile_analysis.py` math).
* `profiler_session` — the device-side escape hatch: an opt-in
  `torch.profiler` trace session (CPU and, where there is a card, CUDA
  activity) gated on ``HVD_PROFILE_DIR``, whose Chrome trace feeds
  `profile_analysis.analyze_profile_dir` (measured α, op breakdown).
  Opt-in because a trace session costs memory and trace-file I/O; the
  metric registry is the always-on layer.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional

import torch

from horovod_tpu_torch.obs import catalog, events

__all__ = ["StepProfiler", "profile_step", "profiler_session"]


def _device_kind() -> Optional[str]:
    """The card's name (`torch.cuda.get_device_name`), None without a
    card: the key `profile_analysis.device_peak_flops` looks up."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


class StepProfiler:
    """Reusable step bracket feeding the training metric family.

    ``tokens_per_step`` drives the ``hvd_training_tokens_per_s``
    gauge (tokens OR examples — whatever unit the loop thinks in);
    ``flops_per_step`` plus a known device peak drives
    ``hvd_training_mfu``. Both optional: without them the bracket
    still records the step-cadence histogram and step counter.

    The measured time is host dispatch-to-return, as in the JAX
    package: PyTorch enqueues CUDA work asynchronously, so unless the
    step itself synchronizes (reads its loss, say) that is the step
    CADENCE, not device busy time (which belongs to
    `profiler_session`); on a saturated pipeline the two converge, and
    cadence is the number input stalls show up in.
    """

    def __init__(self, name: str = "train_step", *,
                 tokens_per_step: Optional[float] = None,
                 flops_per_step: Optional[float] = None,
                 device_kind: Optional[str] = None):
        self.name = name
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self._m = catalog.training_metrics()
        self._device_kind = (device_kind if device_kind is not None
                             else _device_kind())

    def observe(self, dt_s: float):
        """Fold one completed step of ``dt_s`` seconds in."""
        self._m["steps"].inc()
        self._m["step_time"].observe(dt_s)
        if dt_s <= 0:
            return
        if self.tokens_per_step:
            self._m["tokens_per_s"].set(self.tokens_per_step / dt_s)
        if self.flops_per_step:
            from horovod_tpu_torch.utils.profile_analysis import mfu
            m = mfu(self.flops_per_step / dt_s, self._device_kind)
            if m is not None:
                self._m["mfu"].set(m)

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.observe(time.perf_counter() - t0)


@contextlib.contextmanager
def profile_step(name: str = "train_step", *,
                 tokens: Optional[float] = None,
                 flops: Optional[float] = None,
                 device_kind: Optional[str] = None):
    """One-shot step bracket (`with obs.profile_step(...):`) — the ad
    hoc flavor of `StepProfiler` for loops that do not keep one."""
    prof = StepProfiler(name, tokens_per_step=tokens,
                        flops_per_step=flops,
                        device_kind=device_kind)
    with prof.step():
        yield prof


@contextlib.contextmanager
def profiler_session(profile_dir: Optional[str] = None):
    """Opt-in `torch.profiler` trace session. ``profile_dir=None``
    reads ``HVD_PROFILE_DIR``; unset = no-op (yields None) so call
    sites can bracket unconditionally. Records CPU activity and, where
    there is a card, CUDA activity (kernels, copies, memsets, via
    CUPTI); on exit the device work is synchronized and the Chrome
    trace written as ``<host>_<pid>.<ns>.pt.trace.json`` in the
    directory. Start/stop are recorded in the event log; analyze the
    capture with `utils.profile_analysis.analyze_profile_dir`."""
    if profile_dir is None:
        from horovod_tpu_torch.runtime.config import env_str
        profile_dir = env_str("HVD_PROFILE_DIR") or None
    if not profile_dir:
        yield None
        return
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    events.emit("profile.start", dir=profile_dir)
    try:
        yield profile_dir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(
            profile_dir, f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        events.emit("profile.stop", dir=profile_dir, trace=path)
