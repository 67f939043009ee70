"""Training-loop callbacks.

Counterpart of `horovod_tpu/callbacks.py:27-73` (Horovod's Keras
callbacks, `horovod/keras/callbacks.py`):

* `lr_warmup_schedule` — gradual LR warmup (Goyal et al. 2017):
  lr'(epoch) = lr * (epoch * (size - 1) / warmup + 1), so lr'(0) = lr
  and lr'(warmup) = size * lr; a ``step -> lr`` function for
  `torch.optim.lr_scheduler.LambdaLR`;
* `MetricAverager` — averages a metrics dict over the ranks at epoch
  end in one fused collective, in sorted key order;
* `broadcast_on_train_begin` — the BroadcastGlobalVariablesCallback
  contract;
* `ResilientCheckpointCallback` — periodic atomic checkpoints, the
  emergency save on a preemption signal and NaN/loss-spike rollback,
  over `resilience.ElasticTrainer`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from horovod_tpu_torch.runtime import state as _state


def lr_warmup_schedule(base_lr: float, warmup_epochs: int = 5,
                       steps_per_epoch: int = 1,
                       size: Optional[int] = None
                       ) -> Callable[[int], float]:
    """``step -> lr`` with the reference warmup: the LR rises linearly
    from ``base_lr`` at step 0 to ``size * base_lr`` at
    ``warmup_epochs`` epochs and stays there (compose any decay after).
    ``size`` defaults to the world size. Under `LambdaLR`, which
    multiplies the optimizer's own LR::

        sched = lr_warmup_schedule(0.1, warmup_epochs=5,
                                   steps_per_epoch=len(loader))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        lr_sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: sched(step) / 0.1)
    """
    n = size if size is not None else _state.check_initialized().size

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        scale = min(epoch, warmup_epochs) * (n - 1) / warmup_epochs + 1
        return base_lr * scale

    return schedule


class MetricAverager:
    """``averager(logs) -> logs`` with every metric replaced by its mean
    over the ranks: one `grouped_allreduce` in float64 over the sorted
    keys (the same collective order on every rank)."""

    def __init__(self):
        self._st = _state.check_initialized()

    def __call__(self, logs: Dict[str, float]) -> Dict[str, float]:
        from horovod_tpu_torch.optim import grouped_allreduce
        out = dict(logs)
        keys = sorted(logs)
        if not keys:
            return out
        vals = grouped_allreduce(
            [torch.tensor(float(logs[k]), dtype=torch.float64)
             for k in keys], average=True, name="metric_avg")
        for k, v in zip(keys, vals):
            out[k] = float(v)
        return out


def broadcast_on_train_begin(params, root_rank: int = 0) -> None:
    """Alias of `optim.broadcast_parameters` with the callback's name."""
    from horovod_tpu_torch.optim import broadcast_parameters
    broadcast_parameters(params, root_rank)


class ResilientCheckpointCallback:
    """Keras-style step/epoch-end callback over
    `resilience.ElasticTrainer`: periodic atomic checkpoints, an
    emergency save the moment SIGTERM/SIGINT lands, and NaN/loss-spike
    rollback to the last good checkpoint. ``state`` is the checkpoint
    tree (e.g. ``{"model": model.state_dict(), "opt":
    opt.state_dict()}``); after a rollback the call returns the
    restored tree, which the loop loads back into its modules.

    ::

        cb = ResilientCheckpointCallback("/ckpts", save_every=50)
        state, start = cb.resume(like=state)
        for i in range(start, steps):
            loss = step(batch())
            state = cb(i + 1, state, loss)
            if cb.should_stop:
                break
    """

    def __init__(self, directory: str, *, save_every: int = 50,
                 keep: int = 3, block: bool = False,
                 install_signals: bool = True):
        from horovod_tpu_torch.resilience import ElasticTrainer
        self._trainer = ElasticTrainer(
            directory, save_every=save_every, keep=keep, block=block,
            install_signals=install_signals)

    def resume(self, *, like=None, broadcast: bool = False):
        return self._trainer.resume(like=like, broadcast=broadcast)

    def __call__(self, step: int, state, loss):
        return self._trainer.after_step(step, state, loss)

    @property
    def should_stop(self) -> bool:
        return self._trainer.should_stop

    @property
    def rollbacks(self) -> int:
        return self._trainer.rollbacks

    def close(self):
        """Uninstall the signal handlers (see ElasticTrainer.close)."""
        self._trainer.close()
