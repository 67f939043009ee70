"""Preemption-safe training: emergency checkpoints, NaN rollback.

Counterpart of `horovod_tpu.resilience.elastic`, ported by copy with
its imports re-pointed; the state is the port's checkpoint tree (a
nested dict of tensors: ``model.state_dict()``,
``optimizer.state_dict()``), and the host-RNG leg also covers
`torch.Generator`. The elastic-resize path (``migrate_world=True``,
rebalancing a cursor from another world) waits for the membership
slice of the port.

Accelerator fleets are preempted on schedule (maintenance events, spot
reclaims): the runtime gets SIGTERM and a grace window. MLPerf-scale
runs (arXiv:1909.09756) treat checkpoint-resume as first-class —
a preempted run must cost at most `save_every` steps of progress, not
the job. Three pieces deliver that here:

* `PreemptionHandler` — installs SIGTERM/SIGINT handlers that only
  set a flag; the *training loop* (which owns the device and the
  up-to-date state) checks `triggered` between steps and writes the
  emergency checkpoint from a sane context, never from inside a
  signal frame mid-dispatch.
* `NaNGuard` — watches the loss stream for NaN/inf or a spike; the
  `ElasticTrainer` answers a trip by rolling back to the last good
  checkpoint instead of dying (the divergence-containment recipe).
* `ElasticTrainer` — resume discovery (latest-GOOD: partial/corrupt
  newest checkpoints are skipped, `utils/checkpoint.py`), periodic
  saves with `keep` retention, emergency save on preemption, and
  rollback.

Exact resume: a checkpoint that
captures model/optimizer state alone makes a resumed run *silently
lossy* — the interrupted epoch's remaining batches are replayed or
skipped depending on where the loop restarts. `TrainSnapshot` makes
the FULL training state one checkpointable unit: the tree plus the
data-pipeline cursor (`ShardedDataset.state()`), the host RNG, and
the NaN-guard history, saved atomically by every `save_step` /
emergency save (the cursor rides the `aux` sidecar) and restored by
`resume()`. A missing/corrupt/incompatible cursor degrades to the
epoch boundary — loudly: `hvd_resilience_cursor_fallbacks_total`
increments, a `training.cursor_fallback` event fires, and
`resume_gap_batches` reports how many batches the fallback replays.
`resilience/equivalence.py` proves the exactly-once contract
end-to-end under chaos-injected kills.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from horovod_tpu_torch.resilience.retry import RetryPolicy

# Version stamp of the TrainSnapshot aux schema; restore refuses a
# different version (the cursor would be meaningless) and falls back
# to the epoch boundary.
SNAPSHOT_SCHEMA = 1


#: Default signal set: SIGTERM/SIGINT are the kill path; SIGUSR1 is
#: the cloud *preemption notice* (GCE shutdown scripts, k8s preStop
#: hooks and maintenance notifiers can deliver it ahead of the
#: real SIGTERM) — catching it starts the emergency save BEFORE the
#: hard signal lands, with the whole HVD_PREEMPT_GRACE_S window still
#: in hand.
DEFAULT_PREEMPT_SIGNALS = (signal.SIGTERM, signal.SIGINT,
                           signal.SIGUSR1)


class PreemptionHandler:
    """Flag-setting SIGTERM/SIGINT/SIGUSR1 handler (context manager).

    The handler itself does no I/O: Python signal handlers run between
    bytecodes on the main thread, possibly inside a CUDA launch or a
    lock — checkpointing there can deadlock. It records the signal and
    the time; the training loop polls `triggered` at step boundaries
    (milliseconds apart) and saves from clean context.

    Escalation model: SIGUSR1 is an advance *notice* — it only ever
    sets the flag (clouds may deliver several; none should kill a
    loop that is busy saving). The FIRST hard signal (SIGTERM/SIGINT)
    after a notice is absorbed too — it is the expected second act of
    a preemption, arriving while the emergency checkpoint may still
    be in flight. Any further hard signal — and, without a notice,
    the SECOND hard signal of any kind — falls through to the
    previous disposition, so a wedged loop can still be killed with a
    second Ctrl-C (or SIGTERM then Ctrl-C).

    Grace window: ``HVD_PREEMPT_GRACE_S`` (default 30 s) is how long
    the platform promises the host survives past the first notice.
    `grace_remaining()` is the loop's save budget — e.g. skip an
    optional validation pass when it dips low.
    """

    def __init__(self, signals=DEFAULT_PREEMPT_SIGNALS, *,
                 callback: Optional[Callable[[int], None]] = None,
                 grace_s: Optional[float] = None):
        if grace_s is None:
            from horovod_tpu_torch.runtime.config import env_float
            grace_s = env_float("HVD_PREEMPT_GRACE_S", 30.0)
        self._signals = tuple(signals)
        self._callback = callback
        self._event = threading.Event()
        self._prev: dict = {}
        self._hard_seen: set = set()
        self._notice_seen = False
        self.grace_s = float(grace_s)
        self.signum: Optional[int] = None
        self.t_signal: Optional[float] = None

    def install(self) -> "PreemptionHandler":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        # No observability emission HERE: a Python signal handler runs
        # between bytecodes on the main thread, and the event log's
        # lock could already be held by the interrupted frame — the
        # loop-side consumers (`ElasticTrainer.after_step`) emit the
        # preemption event from clean context instead.
        hard = signum != signal.SIGUSR1
        # A SIGUSR1 notice buys exactly ONE hard-signal absorption:
        # the SIGTERM that follows a cloud preemption notice is the
        # preemption's expected second act (the emergency save may
        # still be writing). Without a notice, a second hard signal
        # of ANY kind escalates — the pre-existing wedged-loop escape
        # hatch (SIGTERM then Ctrl-C must still kill).
        absorb_hard = (self._notice_seen and not self._hard_seen)
        if self._event.is_set() and hard and not absorb_hard:
            # Escalating HARD signal: restore the previous disposition
            # and re-deliver so a wedged loop still dies (SIG_DFL
            # SIGTERM terminates via the re-raise below) or
            # KeyboardInterrupts (SIGINT). A SIGUSR1 notice — however
            # many times the cloud repeats it — never escalates.
            prev = self._prev.get(signum, signal.SIG_DFL)
            if prev is None:
                # signal.signal returns None for handlers installed by
                # non-Python code (C extensions); we cannot restore
                # those — fall back to the default disposition.
                prev = signal.SIG_DFL
            signal.signal(signum, prev)
            if callable(prev):
                prev(signum, frame)
            elif signum == signal.SIGINT:
                raise KeyboardInterrupt
            else:
                import os
                os.kill(os.getpid(), signum)  # restored disposition
            return
        if self._event.is_set():
            # Notice already active: record the stronger signal (the
            # grace clock keeps running from the FIRST notice — the
            # platform's promise is anchored there).
            self.signum = signum
            if hard:
                self._hard_seen.add(signum)
            else:
                self._notice_seen = True
            return
        self.signum = signum
        self.t_signal = time.time()
        if hard:
            self._hard_seen.add(signum)
        else:
            self._notice_seen = True
        self._event.set()
        if self._callback is not None:
            self._callback(signum)

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def grace_deadline(self) -> Optional[float]:
        """time.time() by which the host may be gone (first notice +
        HVD_PREEMPT_GRACE_S); None before any signal."""
        if self.t_signal is None:
            return None
        return self.t_signal + self.grace_s

    def grace_remaining(self) -> Optional[float]:
        """Seconds of the preemption grace window left (clamped at 0)
        — the emergency-save budget; None before any signal."""
        dl = self.grace_deadline
        if dl is None:
            return None
        return max(0.0, dl - time.time())

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, exc_type, exc, tb):
        self.uninstall()


class NaNGuard:
    """Detects a diverged step from its loss: NaN/inf always trips;
    a finite loss trips once it exceeds ``spike_factor`` x the median
    of the last ``window`` good losses (spikes only count once the
    window has ``min_history`` entries — early training is noisy)."""

    def __init__(self, *, spike_factor: float = 100.0,
                 window: int = 32, min_history: int = 8):
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor}")
        self.spike_factor = spike_factor
        self.window = window
        self.min_history = min_history
        self._good: list = []
        self.trips = 0

    def check(self, loss: float) -> bool:
        """True ⇒ this step is bad (do not keep its state)."""
        loss = float(loss)
        if not math.isfinite(loss):
            self.trips += 1
            return True
        if len(self._good) >= self.min_history:
            xs = sorted(self._good)
            median = xs[len(xs) // 2]
            if median > 0 and loss > self.spike_factor * median:
                self.trips += 1
                return True
        self._good.append(loss)
        if len(self._good) > self.window:
            self._good.pop(0)
        return False

    def state(self) -> Dict:
        """JSON-able snapshot (the TrainSnapshot guard leg): without
        it a resumed run restarts with an empty loss window, and the
        first `min_history` post-resume steps are spike-blind."""
        return {"good": [float(x) for x in self._good],
                "trips": int(self.trips)}

    def restore(self, state: Dict) -> "NaNGuard":
        self._good = [float(x) for x in state.get("good", [])]
        self.trips = int(state.get("trips", 0))
        return self


def _rng_state(rng) -> Dict:
    """JSON-able host-RNG snapshot: `np.random.Generator` (via its
    bit_generator state dict), legacy `np.random.RandomState` (MT19937
    key list) and `torch.Generator` (its state bytes, on any device) —
    the RNGs training loops draw batch/augmentation randomness (and,
    for torch, dropout) from."""
    import numpy as np
    import torch
    if isinstance(rng, torch.Generator):
        return {"kind": "torch_generator", "device": str(rng.device),
                "state": [int(b) for b in rng.get_state().tolist()]}
    if isinstance(rng, np.random.Generator):
        return {"kind": "generator", "state": rng.bit_generator.state}
    if isinstance(rng, np.random.RandomState):
        name, keys, pos, has_gauss, cached = rng.get_state()
        return {"kind": "random_state",
                "state": [name, [int(k) for k in keys], int(pos),
                          int(has_gauss), float(cached)]}
    raise TypeError(
        f"unsupported host RNG {type(rng).__name__}: pass a "
        f"numpy Generator or RandomState, or a torch.Generator")


def _rng_restore(rng, snap: Dict):
    import numpy as np
    import torch
    kind = snap.get("kind")
    if kind == "torch_generator":
        if not isinstance(rng, torch.Generator):
            raise TypeError("snapshot holds a torch.Generator state but "
                            f"the trainer's rng is {type(rng).__name__}")
        rng.set_state(torch.tensor(snap["state"], dtype=torch.uint8))
    elif kind == "generator":
        if not isinstance(rng, np.random.Generator):
            raise TypeError("snapshot holds a Generator state but the "
                            f"trainer's rng is {type(rng).__name__}")
        rng.bit_generator.state = snap["state"]
    elif kind == "random_state":
        if not isinstance(rng, np.random.RandomState):
            raise TypeError("snapshot holds a RandomState state but "
                            f"the trainer's rng is {type(rng).__name__}")
        name, keys, pos, has_gauss, cached = snap["state"]
        rng.set_state((name, np.asarray(keys, np.uint32), int(pos),
                       int(has_gauss), float(cached)))
    else:
        raise ValueError(f"unknown rng snapshot kind {kind!r}")


@dataclasses.dataclass
class TrainSnapshot:
    """The composite unit `resume()` reconstructs: model/optimizer
    tree + step + the host-side legs of exactly-once training. The
    tree lands in the step directory; everything else rides the
    atomic `aux` sidecar (`utils/checkpoint.py::save_step`).

    ``exact`` distinguishes a full restore from the degraded
    epoch-boundary fallback (cursor missing/corrupt/incompatible);
    ``gap_batches`` is how many batches the fallback replays — 0 on
    every exact resume."""

    state: Any
    step: int
    data_state: Optional[Dict] = None
    rng_state: Optional[Dict] = None
    guard_state: Optional[Dict] = None
    exact: bool = True
    gap_batches: int = 0
    schema: int = SNAPSHOT_SCHEMA


class ElasticTrainer:
    """Checkpoint-directory-centric resilience for a training loop::

        trainer = ElasticTrainer(ckpt_dir, save_every=50, keep=3)
        state = {"model": model.state_dict(), "opt": opt.state_dict()}
        state, start = trainer.resume(like=state)   # latest GOOD step
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        for i in range(start, steps):
            loss = step(batch())
            state = {"model": model.state_dict(),
                     "opt": opt.state_dict()}
            state = trainer.after_step(i + 1, state, loss)
            if trainer.should_stop:       # SIGTERM/SIGINT landed —
                break                     # emergency ckpt already cut

    (After a rollback `after_step` returns the restored tree: load it
    into the model and optimizer before the next step.)

    `after_step` is the one hook: it rolls back to the last good
    checkpoint when the `NaNGuard` trips (returning the restored
    state), saves every `save_every` steps, and cuts an emergency
    synchronous save the moment the preemption handler has triggered.
    Saves go through `utils.checkpoint.save_step` — rank-0-only,
    atomic (temp + rename), retried under the shared `RetryPolicy`.
    ``migrate_world=True`` (resuming a cursor saved under another world
    size, the elastic-resize path) raises `NotImplementedError`: it
    waits for the membership slice of the port.
    """

    def __init__(self, directory: str, *, save_every: int = 50,
                 keep: int = 3, block: bool = False,
                 guard: Optional[NaNGuard] = None,
                 handler: Optional[PreemptionHandler] = None,
                 retry: Optional[RetryPolicy] = None,
                 install_signals: bool = True,
                 dataset: Any = None, rng: Any = None,
                 migrate_world: bool = False):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self.block = block
        self.guard = guard if guard is not None else NaNGuard()
        self.retry = retry
        self.handler = handler
        if self.handler is None and install_signals:
            self.handler = PreemptionHandler().install()
        self._owns_handler = self.handler is not None and handler is None
        self._like: Any = None
        self._last_good_step: Optional[int] = None
        self._emergency_done = False
        self.rollbacks = 0
        # Exact-resume legs:
        # attach the ShardedDataset and the host RNG so every save_step
        # snapshots their state in the aux sidecar and resume()
        # restores them. Both optional — a loop without them keeps the
        # PR-2 model-state-only behavior.
        self.dataset = dataset
        self.rng = rng
        if rng is not None:
            _rng_state(rng)  # validate the type NOW, not at save time
        # Elastic resize: with migrate_world on, the reference migrates
        # a snapshot cursor from a DIFFERENT (rank, world) — the
        # dataset rebalances the interrupted epoch's untrained
        # remainder across the new world. That path needs the
        # membership slice; a cursor from another world degrades to
        # the loud epoch-boundary fallback meanwhile.
        if migrate_world:
            raise NotImplementedError(
                "ElasticTrainer(migrate_world=True), the elastic-resize "
                "path, is a later slice of the PyTorch port (membership "
                "and the drill, ROADMAP Queue A 4)")
        self.migrate_world = False
        self.resize_report: Optional[Dict] = None
        self.data_start: Tuple[int, int] = (0, 0)
        self.resume_gap_batches = 0
        self.cursor_fallbacks = 0
        self.snapshot: Optional[TrainSnapshot] = None

    def close(self):
        """Uninstall the signal handlers this trainer installed (a
        no-op for a caller-provided or disabled handler). Without
        this, Ctrl-C after the training loop would only set a stale
        flag instead of interrupting. Idempotent; `with` calls it.

        Note: installing handlers requires the main thread — construct
        with ``install_signals=False`` off the main thread and poll a
        caller-owned handler instead."""
        if self._owns_handler and self.handler is not None:
            self.handler.uninstall()
            self._owns_handler = False

    def __enter__(self) -> "ElasticTrainer":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    # -- resume -------------------------------------------------------

    def resume(self, *, like: Any = None, broadcast: bool = False):
        """(state, start_step) from the latest GOOD checkpoint —
        corrupt/partial newest steps are skipped with a warning. On a
        fresh directory returns ``(like, 0)``: the template passes
        through unchanged, so the documented
        ``state, start = trainer.resume(like=state)`` loop works on
        the very first run too. Keeps `like` as the rollback
        template.

        With a `dataset`/`rng`/guard attached, the step's aux sidecar
        is restored too: the data cursor lands in `data_start` (feed
        it to ``dataset.epoch(e, start_batch=b)``), the RNG and guard
        are re-seeded in place, and `resume_gap_batches` is 0 — the
        exactly-once contract. A missing/corrupt/incompatible sidecar
        degrades to the epoch boundary derived from the step count:
        the interrupted epoch replays from batch 0 (`resume_gap_
        batches` counts the replay), `cursor_fallbacks` increments,
        and a `training.cursor_fallback` event names the reason —
        degraded must never mean silent. `snapshot` keeps the full
        `TrainSnapshot` of what was actually reconstructed."""
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        from horovod_tpu_torch.obs import events as _events
        from horovod_tpu_torch.utils import checkpoint as ckpt
        t0 = time.time()
        self._like = like
        self.resume_gap_batches = 0
        self.data_start = (0, 0)
        out = ckpt.restore_latest(self.directory, like=like,
                                  broadcast=broadcast, with_step=True)
        if out is None:
            self.snapshot = None
            return like, 0
        restored, step = out
        step = int(step)
        self._last_good_step = step
        aux, aux_err = ckpt.load_step_aux(self.directory, step)
        needs_aux = self.dataset is not None or self.rng is not None
        if aux is None and not needs_aux:
            # Model-state-only mode (no dataset/rng attached) resuming
            # a checkpoint saved without a sidecar — e.g. a pre-exact-
            # resume directory or a plain save_step caller. There is
            # no cursor to lose: this is the documented PR-2 behavior,
            # not a degraded resume, so no fallback noise.
            aux_err = None
        exact = aux is not None or not needs_aux
        if exact and aux is not None \
                and aux.get("schema") != SNAPSHOT_SCHEMA:
            exact, aux_err = False, (
                f"snapshot schema {aux.get('schema')!r} != supported "
                f"{SNAPSHOT_SCHEMA}")
        if exact and aux is not None and aux.get("step") != step:
            # Sidecar from a different save than the step that
            # restored (e.g. the newest step was corrupt and discovery
            # fell back, or an orphan sidecar from a killed save) —
            # its cursor describes the wrong position.
            exact, aux_err = False, (
                f"snapshot step {aux.get('step')!r} != restored "
                f"step {step}")
        self.resize_report = None
        if exact and aux is not None:
            try:
                if self.dataset is not None:
                    data_state = aux.get("data")
                    if data_state is None:
                        raise ValueError(
                            "snapshot has no data cursor (saved "
                            "without an attached dataset?)")
                    self._restore_data(step, data_state)
                    self.data_start = tuple(self.dataset.cursor)
                if self.rng is not None:
                    if aux.get("rng") is None:
                        # Same contract as the dataset leg: an
                        # attached RNG with no snapshotted stream is
                        # NOT an exact resume — draws would restart
                        # from the fresh seed silently.
                        raise ValueError(
                            "snapshot has no host RNG state (saved "
                            "without an attached rng?)")
                    _rng_restore(self.rng, aux["rng"])
                if aux.get("guard") is not None:
                    self.guard.restore(aux["guard"])
            except (TypeError, ValueError, KeyError) as e:
                # DataStateError is a ValueError: incompatible cursors
                # land here too, with the mismatch named.
                exact, aux_err = False, repr(e)
        gap = 0
        if not exact:
            if self.dataset is not None:
                # Epoch-boundary fallback: derive the epoch from the
                # step count and replay it from batch 0. Degraded but
                # correct-on-epoch-boundaries — and loud.
                spe = max(1, int(self.dataset.steps_per_epoch()))
                epoch, gap = divmod(step, spe)
                self.data_start = (int(epoch), 0)
            self.cursor_fallbacks += 1
            _obs_catalog.resilience_metrics()["cursor_fallbacks"].inc()
            _events.emit("training.cursor_fallback", step=step,
                         reason=str(aux_err), gap_batches=int(gap))
            sys.stderr.write(
                f"horovod_tpu_torch: exact-resume cursor unavailable at step "
                f"{step} ({aux_err}); resuming from the epoch boundary "
                f"— {gap} batch(es) of the interrupted epoch will "
                f"replay\n")
        self.resume_gap_batches = int(gap)
        recovery_s = time.time() - t0
        met = _obs_catalog.resilience_metrics()
        met["resumes"].inc()
        met["resume_gap"].set(float(gap))
        met["train_recovery"].observe(recovery_s)
        _events.emit(
            "training.resume", step=step, exact=bool(exact),
            epoch=int(self.data_start[0]), batch=int(self.data_start[1]),
            gap_batches=int(gap),
            recovery_ms=round(recovery_s * 1e3, 3))
        self.snapshot = TrainSnapshot(
            state=restored, step=step,
            data_state=(aux or {}).get("data"),
            rng_state=(aux or {}).get("rng"),
            guard_state=(aux or {}).get("guard"),
            exact=bool(exact), gap_batches=int(gap))
        return restored, step

    def _restore_data(self, step: int, data_state: Dict) -> None:
        """The dataset leg of an exact resume: the cursor is restored
        as saved. A cursor from another (rank, world) raises
        `DataStateError` into the loud epoch-boundary fallback (the
        reference's ``migrate_world`` rebalance waits for the
        membership slice)."""
        self.dataset.restore(data_state)

    # -- the per-step hook --------------------------------------------

    def _snapshot_aux(self, step: int) -> Dict:
        """The aux sidecar for one save: everything exactly-once needs
        beyond the tree. Cheap (a handful of scalars + the guard
        window), so it's built fresh at every save."""
        aux: Dict[str, Any] = {"schema": SNAPSHOT_SCHEMA,
                               "step": int(step),
                               "guard": self.guard.state()}
        if self.dataset is not None:
            aux["data"] = self.dataset.state()
        if self.rng is not None:
            aux["rng"] = _rng_state(self.rng)
        return aux

    def after_step(self, step: int, state: Any, loss) -> Any:
        """Fold one finished step into the resilience machinery; see
        class docstring. Returns the state the loop should continue
        from (the rolled-back one after a NaN/spike trip)."""
        from horovod_tpu_torch.resilience import chaos
        if chaos.fires("train_crash"):
            # Simulated process death at the worst mid-epoch point:
            # the step's work is done but nothing is checkpointed yet
            # — the equivalence harness's kill-mid-epoch scenario.
            raise chaos.ChaosError(
                f"injected training-process kill after step {step} "
                f"(site train_crash)")
        if self.guard.check(loss):
            # No emergency save needed even if a preemption signal
            # landed this same step: the rolled-back state IS the last
            # good checkpoint, already durable on disk — the diverged
            # steps since it are precisely what must not be saved.
            return self._rollback(step, float(loss))
        if (self.handler is not None and self.handler.triggered
                and not self._emergency_done):
            self._emergency_save(step, state)
            return state
        # Deliberately NOT gated on the preemption flag: a loop that
        # chooses to keep training after the signal must keep its
        # periodic checkpoints.
        if self.save_every > 0 and step % self.save_every == 0:
            from horovod_tpu_torch.utils import checkpoint as ckpt
            ckpt.save_step(self.directory, step, state,
                           keep=self.keep, block=self.block,
                           retry=self.retry,
                           aux=self._snapshot_aux(step))
            self._last_good_step = step
        return state

    @property
    def should_stop(self) -> bool:
        return self.handler is not None and self.handler.triggered

    def _rollback(self, step: int, loss: float) -> Any:
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        from horovod_tpu_torch.obs import events as _events
        from horovod_tpu_torch.utils import checkpoint as ckpt
        self.rollbacks += 1
        out = ckpt.restore_latest(self.directory, like=self._like,
                                  with_step=True)
        if out is None:
            raise FloatingPointError(
                f"step {step}: non-finite/spiking loss ({loss}) with "
                f"no checkpoint to roll back to in {self.directory}")
        restored, good_step = out
        # The restore may have fallen back PAST what we last wrote
        # (that checkpoint could itself be the corrupt one).
        self._last_good_step = good_step
        _obs_catalog.resilience_metrics()["rollbacks"].inc()
        _events.emit("training.rollback", step=step, loss=loss,
                     restored_step=int(good_step))
        # Post-mortem capture (obs/flightrec.py, no-op unless
        # HVD_FLIGHT_DIR is set): a divergence rollback is exactly the
        # incident whose run-up (loss stream, chaos fires, step
        # cadence) the bundle preserves.
        from horovod_tpu_torch.obs import flightrec as _flightrec
        _flightrec.trigger("training.rollback", step=step,
                           loss=float(loss),
                           restored_step=int(good_step))
        sys.stderr.write(
            f"horovod_tpu_torch: step {step} diverged (loss={loss}); rolled "
            f"back to checkpoint step {good_step} "
            f"(rollback #{self.rollbacks})\n")
        return restored

    def _emergency_save(self, step: int, state: Any):
        """Synchronous (the process is about to die — an async write
        would race teardown), once."""
        if self._emergency_done:
            return
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        from horovod_tpu_torch.obs import events as _events
        from horovod_tpu_torch.utils import checkpoint as ckpt
        ckpt.wait_pending()
        ckpt.save_step(self.directory, step, state, keep=self.keep,
                       block=True, retry=self.retry,
                       aux=self._snapshot_aux(step))
        self._last_good_step = step
        self._emergency_done = True
        _obs_catalog.resilience_metrics()["emergency_saves"].inc()
        _events.emit(
            "training.emergency_save", step=step,
            signum=getattr(self.handler, "signum", None))
        sys.stderr.write(
            f"horovod_tpu_torch: preemption signal "
            f"{getattr(self.handler, 'signum', None)} — emergency "
            f"checkpoint at step {step} in {self.directory}\n")
