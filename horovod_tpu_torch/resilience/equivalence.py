"""Crash-restart equivalence: prove exactly-once resumable training.

Counterpart of `horovod_tpu.resilience.equivalence`, ported by copy. A
checkpointing story is only as good as its proof. This harness runs
the same small training workload twice over a sharded, shuffled
`ShardedDataset`:

* **control** — N epochs uninterrupted, recording a content hash of
  every consumed batch plus the final params/loss;
* **chaos** — the same workload under chaos-injected kills
  (``train_crash`` fires after a step completes but before anything is
  checkpointed — the worst mid-epoch point; ``ckpt_kill`` fires inside
  `save_step` after the staging write but before the atomic rename —
  death *during* a save), each kill followed by a process-like
  restart: a fresh dataset, a fresh `ElasticTrainer`, `resume()` from
  disk.

Equivalence then means: the chaos run's *effective* batch stream (the
batches whose effects survived into the final state — consumed batches
that were rolled past by a restart are trimmed back to the resumed
step) is **bitwise identical** to the control's, and the final params
match to tolerance. With the exact cursor restored,
``resume_gap_batches`` is 0 on every restart — nothing replayed,
nothing skipped.

The training step is deliberately a pure-numpy linear-regression SGD:
bitwise deterministic, no device in the loop, so the harness isolates
exactly what this subsystem owns — data-cursor and snapshot semantics
(the checkpoints are the port's `torch.save` trees).

Smoke entry::

    HVD_CHAOS=train_crash:2,ckpt_kill:1 \\
        python -m horovod_tpu_torch.resilience.equivalence --workdir DIR

With ``--resize`` it runs the elastic twin instead: a simulated world
(`resilience.membership.SimulatedWorld`) of ``--world`` members under
``rank_death`` must shrink, roll back, rebalance and finish with the
per-record union stream bitwise-equal (as a multiset) to an
uninterrupted run's::

    python -m horovod_tpu_torch.resilience.equivalence --resize \\
        --workdir DIR
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience.elastic import ElasticTrainer, NaNGuard

DEFAULT_KILL_SPEC = "train_crash:2,ckpt_kill:1"


@dataclasses.dataclass
class EquivalenceReport:
    """What one crash-restart equivalence run proved (or didn't)."""

    batches_match: bool
    params_match: bool
    kills: int
    resume_gap_batches: int      # max over restarts; 0 = exactly-once
    cursor_fallbacks: int
    recovery_ms: List[float]     # per restart: kill -> resumed
    control_batches: int
    resumed_batches: int
    max_param_delta: float
    control_loss: float
    final_loss: float
    loader: str                  # "native" | "python"
    steps: int

    @property
    def ok(self) -> bool:
        return self.batches_match and self.params_match

    def summary(self) -> Dict:
        """JSON-able digest (the bench artifact / CI log line)."""
        ms = sorted(self.recovery_ms)
        return {
            "ok": self.ok,
            "batches_match": self.batches_match,
            "params_match": self.params_match,
            "kills": self.kills,
            "resume_gap_batches": self.resume_gap_batches,
            "cursor_fallbacks": self.cursor_fallbacks,
            "recovery_ms": {
                "p50": round(ms[len(ms) // 2], 3) if ms else None,
                "max": round(ms[-1], 3) if ms else None,
            },
            "batches": self.resumed_batches,
            "steps": self.steps,
            "max_param_delta": float(self.max_param_delta),
            "loader": self.loader,
        }


def _batch_key(batch: Dict[str, np.ndarray]) -> str:
    """Content hash of one batch — field names, dtypes, shapes, and
    raw bytes all participate, so "bitwise identical" means exactly
    that."""
    h = hashlib.sha256()
    for name in sorted(batch):
        a = np.ascontiguousarray(batch[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _default_step(state: Dict[str, np.ndarray],
                  batch: Dict[str, np.ndarray],
                  lr: float = 0.05
                  ) -> Tuple[Dict[str, np.ndarray], float]:
    """Pure-numpy linear-regression SGD step — bitwise deterministic
    given (state, batch)."""
    x = batch["x"].astype(np.float64)
    y = batch["y"].astype(np.float64)
    pred = x @ state["w"] + state["b"]
    err = pred - y
    gw = x.T @ err / len(y)
    gb = err.mean()
    new = {"w": state["w"] - lr * gw,
           "b": state["b"] - lr * gb}
    return new, float((err ** 2).mean())


def _write_dataset(workdir: str, *, records: int, dim: int,
                   num_shards: int, seed: int):
    from horovod_tpu_torch import data as hd
    spec = [("x", "float32", (dim,)), ("y", "float32", ())]
    rs = np.random.RandomState(seed)
    w_true = rs.randn(dim).astype(np.float32)
    x = rs.randn(records, dim).astype(np.float32)
    y = (x @ w_true + 0.01 * rs.randn(records)).astype(np.float32)
    paths = hd.write_shards(os.path.join(workdir, "shards"), "eq",
                            spec, {"x": x, "y": y}, num_shards)
    return paths, spec


def run_crash_restart_equivalence(
        workdir: str, *,
        epochs: int = 3,
        records: int = 48,
        batch_size: int = 4,
        dim: int = 3,
        num_shards: int = 3,
        save_every: int = 2,
        seed: int = 11,
        kill_spec: str = DEFAULT_KILL_SPEC,
        use_native: Optional[bool] = None,
        tol: float = 1e-9,
        max_restarts: int = 64,
        step_fn: Callable = _default_step,
        log: Optional[Callable[[str], None]] = None,
) -> EquivalenceReport:
    """Train-twice, kill-once(-or-more), assert-equivalent.

    ``use_native``: pin the loader implementation (None = whatever
    `ShardedDataset` resolves; tests run both). ``kill_spec`` arms the
    kill sites for the chaos leg — unless a monkey is ALREADY
    installed (e.g. the CI smoke's ``HVD_CHAOS`` env arming), which
    then takes precedence so the harness composes with external chaos
    drills. The control leg always runs disarmed.

    Raises `RuntimeError` if the chaos leg cannot finish within
    ``max_restarts`` restarts (an armed unbounded kill site would
    otherwise loop forever).
    """
    from horovod_tpu_torch import data as hd
    from horovod_tpu_torch.runtime.config import config

    def say(msg):
        if log is not None:
            log(msg)

    os.makedirs(workdir, exist_ok=True)
    paths, spec = _write_dataset(workdir, records=records, dim=dim,
                                 num_shards=num_shards, seed=seed)
    state0 = {"w": np.zeros(dim, np.float64), "b": np.float64(0.0)}

    prev_native = config.use_native
    if use_native is not None:
        config.use_native = use_native

    def make_ds():
        return hd.ShardedDataset(paths, spec, batch_size, shuffle=True,
                                 seed=seed, rank=0, world=1)

    cursor_fallbacks = [0]   # mutated by run_leg across restarts
    gaps_seen: List[int] = []
    recovery_ms: List[float] = []
    used_native = [False]    # observed from the live legs' datasets

    def run_leg(ckpt_dir: str, stream: List[str],
                kill_t: Optional[float] = None
                ) -> Tuple[Dict, float, int]:
        """One process lifetime: resume (fresh everything), trim the
        stream to the resumed step, train to the end. Returns
        (final_state, final_loss, steps)."""
        with make_ds() as ds:
            used_native[0] = bool(ds.native)
            trainer = ElasticTrainer(
                ckpt_dir, save_every=save_every, keep=0, block=True,
                install_signals=False, dataset=ds, guard=NaNGuard())
            state, step = trainer.resume(like=state0)
            if kill_t is not None:
                # The operator-felt number: simulated process death to
                # full TrainSnapshot reconstruction.
                recovery_ms.append((time.time() - kill_t) * 1e3)
            gaps_seen.append(int(trainer.resume_gap_batches))
            cursor_fallbacks[0] += trainer.cursor_fallbacks
            # Batches consumed after the last snapshot died with the
            # process; their effects are NOT in `state`. Trim so the
            # stream records exactly the batches that built the final
            # params.
            del stream[step:]
            e0, b0 = trainer.data_start
            loss = float("nan")
            for epoch in range(e0, epochs):
                sb = b0 if epoch == e0 else 0
                for batch in ds.epoch(epoch, start_batch=sb):
                    state, loss = step_fn(state, batch)
                    step += 1
                    stream.append(_batch_key(batch))
                    state = trainer.after_step(step, state, loss)
            return state, loss, step

    try:
        # -- control: uninterrupted, chaos disarmed ---------------------
        prev_monkey = chaos.active()   # NOT install(None)'s return —
        chaos.install(None)            # install returns the NEW value
        try:
            control_stream: List[str] = []
            control_state, control_loss, control_steps = run_leg(
                os.path.join(workdir, "ckpt_control"), control_stream)
        finally:
            chaos.install(prev_monkey)
        say(f"control: {control_steps} steps, "
            f"{len(control_stream)} batches, loss {control_loss:.6f}")

        # -- chaos leg: kills + restarts --------------------------------
        monkey = (prev_monkey if prev_monkey is not None
                  else chaos.ChaosMonkey(kill_spec, seed=seed))
        chaos.install(monkey)
        cursor_fallbacks[0] = 0
        gaps_seen.clear()
        stream: List[str] = []
        kills = 0
        kill_t: Optional[float] = None
        try:
            while True:
                try:
                    final_state, final_loss, steps = run_leg(
                        os.path.join(workdir, "ckpt_chaos"), stream,
                        kill_t)
                    break
                except chaos.ChaosError as e:
                    kills += 1
                    kill_t = time.time()
                    say(f"kill #{kills}: {e}")
                    if kills > max_restarts:
                        raise RuntimeError(
                            f"chaos leg did not converge within "
                            f"{max_restarts} restarts — is an "
                            f"unbounded kill site armed?") from e
        finally:
            chaos.install(prev_monkey)
        gap_max = max(gaps_seen) if gaps_seen else 0
        say(f"chaos: {kills} kill(s), {steps} steps, "
            f"{len(stream)} effective batches, loss {final_loss:.6f}")

        batches_match = stream == control_stream
        deltas = [np.max(np.abs(np.asarray(final_state[k])
                                - np.asarray(control_state[k])))
                  for k in control_state]
        max_delta = float(max(deltas)) if deltas else 0.0
        params_match = max_delta <= tol
        return EquivalenceReport(
            batches_match=batches_match,
            params_match=params_match,
            kills=kills,
            resume_gap_batches=gap_max,
            cursor_fallbacks=cursor_fallbacks[0],
            recovery_ms=recovery_ms,
            control_batches=len(control_stream),
            resumed_batches=len(stream),
            max_param_delta=max_delta,
            control_loss=control_loss,
            final_loss=final_loss,
            loader="native" if used_native[0] else "python",
            steps=steps,
        )
    finally:
        config.use_native = prev_native


# ---------------------------------------------------------------------------
# Resize equivalence (elastic membership).
# ---------------------------------------------------------------------------

DEFAULT_RESIZE_KILL_SPEC = "rank_death:1"


@dataclasses.dataclass
class ResizeEquivalenceReport:
    """What one elastic shrink(/grow) equivalence run proved."""

    union_match: bool
    completed: bool              # both legs finished every epoch
    deaths: int
    joins: int
    resizes: int
    final_world: int
    final_generation: int
    control_records: int
    resized_records: int         # effective union size, chaos leg
    records_reassigned: int
    detect_s: Dict               # p50/max: member death -> resumed
    time_to_resume_s: Dict       # p50/max: detection -> resumed
    loader: str
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return (self.union_match and self.completed
                and self.resizes >= 1 and self.deaths >= 1)

    def summary(self) -> Dict:
        return {
            "ok": self.ok,
            "union_match": self.union_match,
            "completed": self.completed,
            "deaths": self.deaths,
            "joins": self.joins,
            "resizes": self.resizes,
            "final_world": self.final_world,
            "final_generation": self.final_generation,
            "records": self.resized_records,
            "records_reassigned": self.records_reassigned,
            "detect_s": self.detect_s,
            "time_to_resume_s": self.time_to_resume_s,
            "loader": self.loader,
            "error": self.error,
        }


def _elastic_grad(state: Dict[str, np.ndarray],
                  batch: Dict[str, np.ndarray]):
    """Gradient leg of the pure-numpy SGD step (`_default_step`'s
    math split so the simulated world can average across members)."""
    x = batch["x"].astype(np.float64)
    y = batch["y"].astype(np.float64)
    err = x @ state["w"] + state["b"] - y
    return ({"w": x.T @ err / len(y), "b": np.float64(err.mean())},
            float((err ** 2).mean()))


def _elastic_apply(state: Dict[str, np.ndarray], grads: Dict,
                   lr: float = 0.05) -> Dict[str, np.ndarray]:
    return {"w": state["w"] - lr * grads["w"],
            "b": state["b"] - lr * np.float64(grads["b"])}


def run_resize_equivalence(
        workdir: str, *,
        world: int = 4,
        epochs: int = 2,
        records: int = 64,
        batch_size: int = 4,
        dim: int = 3,
        num_shards: int = 4,
        save_every: int = 2,
        seed: int = 11,
        kill_spec: str = DEFAULT_RESIZE_KILL_SPEC,
        lease_s: float = 0.35,
        use_native: Optional[bool] = None,
        timeout_s: float = 180.0,
        log: Optional[Callable[[str], None]] = None,
) -> ResizeEquivalenceReport:
    """Train the elastic world twice — uninterrupted control vs a
    chaos leg under ``kill_spec`` (an ALREADY-installed monkey, e.g.
    the CI smoke's ``HVD_CHAOS`` env arming, takes precedence; the
    control leg always runs disarmed) — and assert the effective
    per-record union streams are bitwise identical multisets."""
    from horovod_tpu_torch import data as hd
    from horovod_tpu_torch.resilience.membership import SimulatedWorld
    from horovod_tpu_torch.runtime.config import config

    def say(msg):
        if log is not None:
            log(msg)

    os.makedirs(workdir, exist_ok=True)
    paths, spec = _write_dataset(workdir, records=records, dim=dim,
                                 num_shards=num_shards, seed=seed)
    state0 = {"w": np.zeros(dim, np.float64), "b": np.float64(0.0)}
    used_native = [False]

    prev_native = config.use_native
    if use_native is not None:
        config.use_native = use_native

    def make_ds(rank, w):
        ds = hd.ShardedDataset(paths, spec, batch_size, shuffle=True,
                               seed=seed, rank=rank, world=w)
        used_native[0] = bool(ds.native)
        return ds

    def run_leg(ckpt_sub):
        return SimulatedWorld(
            world=world, make_dataset=make_ds, state0=state0,
            grad_fn=_elastic_grad, apply_fn=_elastic_apply,
            ckpt_dir=os.path.join(workdir, ckpt_sub), epochs=epochs,
            save_every=save_every, lease_s=lease_s,
        ).run(timeout_s=timeout_s)

    try:
        prev_monkey = chaos.active()   # NOT install(None)'s return —
        chaos.install(None)            # install returns the NEW value
        try:
            control = run_leg("ckpt_control")
        finally:
            chaos.install(prev_monkey)
        say(f"control: {control.summary()}")

        monkey = (prev_monkey if prev_monkey is not None
                  else chaos.ChaosMonkey(kill_spec, seed=seed))
        chaos.install(monkey)
        try:
            resized = run_leg("ckpt_chaos")
        finally:
            chaos.install(prev_monkey)
        say(f"chaos: {resized.summary()}")

        control_union = control.union_keys()
        resized_union = resized.union_keys()
        errors = [e for e in (control.error, resized.error) if e]
        return ResizeEquivalenceReport(
            union_match=(control_union == resized_union),
            completed=(control.completed and resized.completed),
            deaths=len(resized.deaths),
            joins=len(resized.joins),
            resizes=len(resized.resizes),
            final_world=resized.final_world,
            final_generation=resized.final_generation,
            control_records=len(control_union),
            resized_records=len(resized_union),
            records_reassigned=sum(
                r.get("records_reassigned", 0)
                for r in resized.resizes),
            detect_s=resized.summary()["detect_s"],
            time_to_resume_s=resized.summary()["time_to_resume_s"],
            loader="native" if used_native[0] else "python",
            error="; ".join(errors) if errors else None,
        )
    finally:
        config.use_native = prev_native


def main(argv=None) -> int:
    """CI smoke entry: run the harness once, print the report, exit
    nonzero unless the run proved equivalence with a zero resume gap
    AND at least one kill actually fired (a smoke whose chaos never
    triggered proves nothing)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="chaos-driven crash-restart equivalence check")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--resize", action="store_true",
                    help="run the ELASTIC resize equivalence instead: "
                         "a 4-member simulated world under rank_death "
                         "must shrink, rebalance, and finish with the "
                         "untrained-remainder union bitwise-equal to "
                         "an uninterrupted run's")
    ap.add_argument("--world", type=int, default=4,
                    help="--resize: launch world size")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--records", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--lease-s", type=float, default=0.35,
                    help="--resize: heartbeat lease for the simulated "
                         "world")
    ap.add_argument("--kill-spec", default=None,
                    help="chaos sites for the kill leg (an installed "
                         "HVD_CHAOS monkey takes precedence; default "
                         f"'{DEFAULT_KILL_SPEC}', or "
                         f"'{DEFAULT_RESIZE_KILL_SPEC}' with --resize)")
    ap.add_argument("--loader", default="auto",
                    choices=["auto", "native", "python"],
                    help="pin the ShardedDataset implementation")
    args = ap.parse_args(argv)

    use_native = {"auto": None, "native": True,
                  "python": False}[args.loader]
    if args.resize:
        rreport = run_resize_equivalence(
            args.workdir, world=args.world,
            epochs=max(2, args.epochs - 1), records=args.records + 16,
            batch_size=args.batch_size, save_every=args.save_every,
            seed=args.seed,
            kill_spec=args.kill_spec or DEFAULT_RESIZE_KILL_SPEC,
            lease_s=args.lease_s, use_native=use_native, log=print)
        print(json.dumps(rreport.summary()))
        if rreport.ok:
            print(f"resize equivalence OK: {rreport.deaths} death(s),"
                  f" {rreport.joins} join(s), {rreport.resizes} "
                  f"resize(s) to world {rreport.final_world} "
                  f"(generation {rreport.final_generation}), "
                  f"{rreport.resized_records} records union-bitwise-"
                  f"identical, {rreport.records_reassigned} "
                  f"reassigned")
            return 0
        print(f"resize equivalence FAILED: {rreport.summary()}")
        return 1
    report = run_crash_restart_equivalence(
        args.workdir, epochs=args.epochs, records=args.records,
        batch_size=args.batch_size, save_every=args.save_every,
        seed=args.seed, kill_spec=args.kill_spec or DEFAULT_KILL_SPEC,
        use_native=use_native, log=print)
    print(json.dumps(report.summary()))
    if report.ok and report.resume_gap_batches == 0 and report.kills:
        print(f"equivalence OK: {report.kills} kill(s), "
              f"{report.resumed_batches} batches bitwise-identical, "
              f"max param delta {report.max_param_delta:.2e}, "
              f"resume gap 0")
        return 0
    print(f"equivalence FAILED: {report.summary()}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
