"""The multi-process elastic drill — real processes, real SIGKILL.

Counterpart of `horovod_tpu.resilience.drill`, ported by copy with its
imports re-pointed; the transport is the launcher's
`torch.distributed.TCPStore` where the JAX package has its native
rendezvous server.

`SimulatedWorld` (membership.py) proves the elastic-membership
machinery inside ONE process: fake ranks as threads, `InProcessKV` as
the transport, `die()` as death. This module graduates every one of
those stand-ins:

* **real worker processes** launched by ``hvdrun-torch --elastic`` (a
  worker's death by a signal does not kill the job);
* **the launcher's rendezvous store** as the transport —
  `bootstrap.connect_kv()` attaches each worker to it WITHOUT
  `init()` (no process group, no CUDA, no init barrier), and
  ``membership.install_kv(BootstrapKV(...))`` makes it the membership
  transport, retry-hardened with typed errors. The launcher serves the
  store, so a killed worker does not take it down;
* **a real ``SIGKILL``** of one worker mid-epoch — no atexit, no
  goodbye beat, the process is simply gone;
* survivors detect the lapsed lease through the shared
  `FailureDetector`, run the propose/ack/commit resize,
  `bootstrap.apply_resize` re-keys the runtime, `ElasticTrainer`
  rolls back to the committed `TrainSnapshot` and rebalances shards —
  **exact resume**, proven by the same union contract as the
  simulated harness: the multiset union of all members' effective
  per-record streams equals every dataset record exactly once per
  epoch.

Workers coordinate lockstep training THROUGH THE KV ONLY — each
member publishes its gradient contribution under
``c/<generation>/<epoch>/<step>/<member>`` and folds the full set
deterministically (rank-order float64 average) — no process group and
no device, so the drill runs on any host.

Entry::

    python -m horovod_tpu_torch.resilience.drill --workdir /tmp/mc \\
        --world 3 --kill-rank 2
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

DEFAULT_WORLD = 3
DEFAULT_EPOCHS = 2
DEFAULT_RECORDS = 48
DEFAULT_BATCH = 4
DEFAULT_SAVE_EVERY = 2
# Default SIGKILL point: after the first committed snapshot (step 2
# at save_every=2) but strictly MID-epoch (a 3-rank 48-record world
# runs 4 lockstep steps per epoch), so the rollback leaves a nonempty
# untrained remainder to rebalance.
DEFAULT_KILL_STEP = 3
# Roomy on purpose: the drill shares its host with whatever else runs
# (a loaded machine staggers worker starts and steals whole GIL
# quanta); detection latency ~= the lease, and 2 s is still a crisp
# headline number for a real SIGKILL.
DEFAULT_LEASE_S = 2.0

_POLL_S = 0.01


def _say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Shared workload (the equivalence harness's pure-numpy SGD).
# ---------------------------------------------------------------------------

def _grad(state, batch):
    x = batch["x"].astype(np.float64)
    y = batch["y"].astype(np.float64)
    err = x @ state["w"] + state["b"] - y
    return ({"w": (x.T @ err / len(y)).tolist(),
             "b": float(err.mean())},
            float((err ** 2).mean()))


def _apply(state, grads, lr: float = 0.05):
    return {"w": state["w"] - lr * np.asarray(grads["w"], np.float64),
            "b": state["b"] - lr * np.float64(grads["b"])}


def _state0(dim: int) -> Dict:
    return {"w": np.zeros(dim, np.float64), "b": np.float64(0.0)}


def _digest(state) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state):
        a = np.ascontiguousarray(np.asarray(state[k], np.float64))
        h.update(k.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _manifest_path(workdir: str) -> str:
    return os.path.join(workdir, "manifest.json")


def _load_manifest(workdir: str) -> Dict:
    with open(_manifest_path(workdir)) as f:
        return json.load(f)


def _make_ds(manifest: Dict, rank: int, world: int):
    from horovod_tpu_torch import data as hd
    spec = [tuple([n, d, tuple(s)]) for n, d, s in manifest["spec"]]
    return hd.ShardedDataset(
        manifest["paths"], spec, manifest["batch"], shuffle=True,
        seed=manifest["seed"], rank=rank, world=world)


# ---------------------------------------------------------------------------
# The worker (one per hvdrun-torch-launched process).
# ---------------------------------------------------------------------------

def _append_jsonl(path: str, obj) -> None:
    # O_APPEND single-write lines + flush: a SIGKILL loses at most the
    # user-space buffer of the CURRENT line, never a committed one.
    with open(path, "a") as f:
        f.write(json.dumps(obj) + "\n")
        f.flush()


def _read_jsonl(path: str) -> List:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue   # torn tail line (SIGKILL mid-write)
    except OSError:
        pass
    return out


def _truncate_log(path: str, step: int) -> None:
    """Drop a member's record-log entries past ``step`` — those
    batches' effects died with the rollback (the SimulatedWorld trim,
    durable across processes)."""
    entries = [e for e in _read_jsonl(path) if e["step"] <= step]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    os.replace(tmp, path)


class _Worker:
    """One member's lifetime inside the drill world."""

    def __init__(self, args):
        from horovod_tpu_torch.runtime import config as _config
        self.a = args
        self.rank0 = int(_config.env_raw("HOROVOD_RANK") or 0)
        self.world0 = int(_config.env_raw("HOROVOD_SIZE") or 1)
        self.member = f"rank{self.rank0}"
        self.workdir = args.workdir
        self.manifest = _load_manifest(self.workdir)
        self.log_path = os.path.join(self.workdir, "logs",
                                     f"{self.member}.jsonl")
        self.ds = None
        self.trainer = None

    # -- world plumbing -----------------------------------------------

    def _build(self, rank: int, world: int):
        from horovod_tpu_torch.resilience.elastic import ElasticTrainer
        if self.ds is not None:
            self.ds.close()
        self.ds = _make_ds(self.manifest, rank, world)
        self.trainer = ElasticTrainer(
            os.path.join(self.workdir, "ckpt"),
            save_every=self.a.save_every if rank == 0 else 0,
            keep=0, block=True, install_signals=False,
            dataset=self.ds, migrate_world=True)
        state, step = self.trainer.resume(
            like=_state0(self.manifest["dim"]))
        _truncate_log(self.log_path, step)
        return state, step

    def _committed_step(self) -> int:
        """Newest COMMITTED step in the shared checkpoint dir (the
        leader writes it; the victim only reads the directory — its
        own trainer never saves)."""
        ckpt_dir = os.path.join(self.workdir, "ckpt")
        best = 0
        try:
            names = os.listdir(ckpt_dir)
        except OSError:
            return 0
        for n in names:
            if (n.startswith("step_") and n[5:].isdigit()
                    and os.path.isfile(os.path.join(
                        ckpt_dir, n, "_CHECKPOINT_METADATA"))):
                best = max(best, int(n[5:]))
        return best

    def _maybe_die(self, step: int) -> None:
        """The drill's fault: a REAL SIGKILL of this process at the
        scheduled step, once a snapshot is committed (so there is
        something exact to resume from). No cleanup, no last beat —
        the lease must find out the hard way."""
        if self.a.kill_rank is None or self.rank0 != self.a.kill_rank:
            return
        committed = self._committed_step()
        if step >= self.a.kill_step and committed >= self.a.save_every:
            _append_jsonl(
                os.path.join(self.workdir, "deaths.jsonl"),
                {"member": self.member, "step": step,
                 "t": time.time()})
            _say(f"drill worker {self.member}: SIGKILL at step "
                 f"{step} (committed {committed})")
            os.kill(os.getpid(), signal.SIGKILL)

    def _wait_for_world(self, kv, monitor,
                        timeout_s: float = 120.0) -> bool:
        """Hold at the start line until every launch member has
        beaten at least once (worker starts stagger — imports,
        scheduler jitter): nobody consults liveness before the world
        actually assembled. Past the timeout the lease semantics
        take over (a member that never came up IS dead)."""
        from horovod_tpu_torch.resilience.membership import KVTransportError
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                missing = [m for m in monitor.members()
                           if kv.get(f"hb/{m}") is None]
            except KVTransportError:
                missing = ["<kv unreachable>"]
            if not missing:
                return True
            time.sleep(0.05)
        _say(f"drill worker {self.member}: world incomplete after "
             f"{timeout_s}s ({missing}); proceeding on lease "
             f"semantics")
        return False

    def _gather(self, kv, monitor, gen: int, epoch: int, step: int
                ) -> Optional[Dict]:
        """Wait for every member's contribution at (gen, epoch, step)
        — the KV-coordinated step barrier. Returns None when the
        membership changed underneath (caller resizes)."""
        from horovod_tpu_torch.resilience.membership import KVTransportError
        while True:
            members = monitor.members()
            vals = {}
            complete = True
            for m in members:
                try:
                    v = kv.get(f"c/{gen}/{epoch}/{step}/{m}")
                except KVTransportError:
                    v = None
                if v is None:
                    complete = False
                    break
                vals[m] = v
            if complete:
                return vals
            try:
                if monitor.pending_change() is not None:
                    return None
            except KVTransportError:
                pass
            time.sleep(_POLL_S)

    def _resize(self, monitor, gen_before: int, t_detect: float):
        """Survivor side: agree, roll back, rebalance. Returns the
        resumed (state, step, gen) or None on a spurious wake."""
        dec = monitor.resize(
            timeout_s=max(20.0, self.a.lease_s * 40))
        if dec.generation == gen_before:
            return None
        t_commit = time.time()   # agreed — BEFORE rollback/rebalance
        state, step = self._build(dec.rank, dec.world)
        t_done = time.time()
        if dec.rank == 0:
            _append_jsonl(
                os.path.join(self.workdir, "resizes.jsonl"),
                {"generation": dec.generation, "world": dec.world,
                 "kind": dec.kind, "died": dec.died,
                 "joined": dec.joined, "committed_step": step,
                 "t_detect": t_detect, "t_commit": t_commit,
                 "resume_s": round(t_done - t_detect, 3),
                 "records_reassigned": int(
                     (self.ds.last_rebalance or {}).get(
                         "records_reassigned", 0))})
        _say(f"drill worker {self.member}: adopted generation "
             f"{dec.generation} world={dec.world} rank={dec.rank} "
             f"(rolled back to step {step})")
        return state, step, dec.generation

    # -- the lockstep loop --------------------------------------------

    def run(self) -> int:
        from horovod_tpu_torch.resilience.membership import (
            BootstrapKV, KVTransportError, MembershipError,
            WorldMonitor, install_kv, record_keys)
        from horovod_tpu_torch.runtime import bootstrap

        kv = BootstrapKV(bootstrap.connect_kv())
        install_kv(kv)
        monitor = WorldMonitor(
            self.member, rank=self.rank0, world=self.world0, kv=kv,
            lease_s=self.a.lease_s,
            heartbeat_s=self.a.lease_s / 4.0)
        monitor.start()
        _say(f"drill worker {self.member}: joined world "
             f"{self.world0} via rendezvous KV")
        self._wait_for_world(kv, monitor)
        try:
            state, step = self._build(monitor.rank, monitor.world)
            epoch, b0 = self.trainer.data_start
            it = iter(self.ds.epoch(epoch, start_batch=b0))
            gen = monitor.generation
            pending = None
            while True:
                try:
                    pend = monitor.pending_change()
                except KVTransportError:
                    pend = None
                if pend is not None:
                    out = self._resize(monitor, gen, time.time())
                    if out is not None:
                        state, step, gen = out
                        epoch, b0 = self.trainer.data_start
                        it = iter(self.ds.epoch(epoch,
                                                start_batch=b0))
                        pending = None
                    continue
                self._maybe_die(step)
                if pending is None:
                    batch = next(it, None)
                    if batch is None:
                        pending = {"grads": None, "loss": None,
                                   "keys": []}
                    else:
                        grads, loss = _grad(state, batch)
                        pending = {"grads": grads, "loss": loss,
                                   "keys": record_keys(batch)}
                try:
                    kv.put(f"c/{gen}/{epoch}/{step}/{self.member}",
                           {"grads": pending["grads"],
                            "loss": pending["loss"]})
                except KVTransportError:
                    time.sleep(_POLL_S)
                    continue   # retry the publish next round
                contribs = self._gather(kv, monitor, gen, epoch, step)
                if contribs is None:
                    continue   # membership changed: resize at loop top
                members = monitor.members()
                order = [m for m in members
                         if contribs[m]["grads"] is not None]
                if not order:
                    # Every live member exhausted the epoch.
                    epoch += 1
                    pending = None
                    if epoch >= self.manifest["epochs"]:
                        break
                    it = iter(self.ds.epoch(epoch))
                    continue
                avg = {k: sum(np.asarray(contribs[m]["grads"][k],
                                         np.float64)
                              for m in order) / len(order)
                       for k in contribs[order[0]]["grads"]}
                loss_mean = float(
                    sum(float(contribs[m]["loss"]) for m in order)
                    / len(order))
                state = _apply(state, avg)
                step += 1
                if pending["keys"]:
                    _append_jsonl(self.log_path,
                                  {"step": step,
                                   "keys": pending["keys"]})
                pending = None
                if monitor.rank == 0 and len(order) == len(members):
                    state = self.trainer.after_step(step, state,
                                                    loss_mean)
            final = {"member": self.member, "step": step,
                     "generation": monitor.generation,
                     "world": monitor.world,
                     "digest": _digest(state)}
            with open(os.path.join(self.workdir, "final",
                                   f"{self.member}.json"), "w") as f:
                json.dump(final, f)
            _say(f"drill worker {self.member}: DONE {final}")
            return 0
        except MembershipError as e:
            # Declared dead / partitioned out: the only safe exit.
            # Nonzero ON PURPOSE — in this drill only the SIGKILL'd
            # worker may leave the world, so a survivor landing here
            # fails the job (hvdrun-torch --elastic tolerates signal
            # deaths, not status failures).
            _say(f"drill worker {self.member}: excluded from the "
                 f"world ({e}); exiting")
            return 3
        finally:
            monitor.stop()
            if self.ds is not None:
                self.ds.close()


# ---------------------------------------------------------------------------
# Launching the drill world.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DrillReport:
    """What one hvdrun-torch-launched drill proved (the assertion
    surface of the tests and of the card smoke)."""

    ok: bool
    union_match: bool
    finals_agree: bool
    launcher_rc: int
    world0: int
    final_world: int
    final_generation: int
    deaths: int
    resizes: int
    records: int
    records_reassigned: int
    detect_s: Optional[float]        # SIGKILL -> commit adopted
    time_to_resume_s: Optional[float]  # detection -> resumed
    error: Optional[str] = None

    def summary(self) -> Dict:
        return dataclasses.asdict(self)


def _write_workdir(workdir: str, *, world: int, epochs: int,
                   records: int, batch: int, dim: int, seed: int,
                   save_every: int) -> Dict:
    from horovod_tpu_torch.resilience.equivalence import _write_dataset
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    os.makedirs(os.path.join(workdir, "final"), exist_ok=True)
    paths, spec = _write_dataset(workdir, records=records, dim=dim,
                                 num_shards=world, seed=seed)
    manifest = {
        "paths": list(paths),
        "spec": [[n, d, list(s)] for n, d, s in spec],
        "batch": batch, "seed": seed, "dim": dim, "epochs": epochs,
        "records": records, "world": world, "save_every": save_every,
    }
    with open(_manifest_path(workdir), "w") as f:
        json.dump(manifest, f)
    return manifest


def _expected_union(manifest: Dict) -> List[str]:
    """The control: every dataset record exactly once per epoch —
    computed directly (record hashing ignores batch grouping, and a
    resize regroups records, never alters them)."""
    from horovod_tpu_torch.resilience.membership import record_keys
    ds = _make_ds(manifest, 0, 1)
    keys: List[str] = []
    try:
        for batch in ds.epoch(0):
            keys.extend(record_keys(batch))
    finally:
        ds.close()
    return sorted(keys * manifest["epochs"])


def run_drill(workdir: str, *,
              world: int = DEFAULT_WORLD,
              epochs: int = DEFAULT_EPOCHS,
              records: int = DEFAULT_RECORDS,
              batch: int = DEFAULT_BATCH,
              dim: int = 3,
              seed: int = 11,
              save_every: int = DEFAULT_SAVE_EVERY,
              kill_rank: Optional[int] = None,
              kill_step: int = DEFAULT_KILL_STEP,
              lease_s: float = DEFAULT_LEASE_S,
              timeout_s: Optional[float] = None,
              log=None) -> DrillReport:
    """Launch the drill world under ``hvdrun-torch --elastic``, SIGKILL
    the scheduled worker, and verify the survivors' exact resume: finals
    agree, >= 1 committed shrink, and the effective per-record union
    is bitwise the full dataset x epochs.

    ``kill_rank``: ``None`` picks the default victim (the highest
    rank); a NEGATIVE value disables the kill entirely (a fault-free
    baseline run — no death/resize expected, only the union check)."""
    from horovod_tpu_torch.runtime.config import env_float
    if timeout_s is None:
        timeout_s = env_float("HVD_ELASTIC_DRILL_TIMEOUT_S", 300.0)
    if kill_rank is None:
        kill_rank = world - 1
    if kill_rank < 0:
        kill_rank = None   # fault disabled
    os.makedirs(workdir, exist_ok=True)
    manifest = _write_workdir(
        workdir, world=world, epochs=epochs, records=records,
        batch=batch, dim=dim, seed=seed, save_every=save_every)
    expected = _expected_union(manifest)

    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(world), "--platform", "cpu", "--elastic", "--",
           sys.executable, "-m", "horovod_tpu_torch.resilience.drill",
           "--worker", "--workdir", workdir,
           "--save-every", str(save_every),
           "--lease-s", str(lease_s),
           "--kill-rank", str(kill_rank if kill_rank is not None
                              else -1),
           "--kill-step", str(kill_step)]
    env = dict(os.environ)
    # The launcher/workers must resolve horovod_tpu_torch however THIS
    # process did (repo checkout on sys.path, not installed).
    import horovod_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(horovod_tpu_torch.__file__)))
    env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else pkg_root)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=timeout_s)
        rc, out = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = -1
        out = ((e.stdout or b"").decode(errors="replace")
               if isinstance(e.stdout, bytes) else (e.stdout or ""))
        out += "\n<the drill timed out>"
    if log is not None:
        log(out)

    deaths = _read_jsonl(os.path.join(workdir, "deaths.jsonl"))
    resizes = _read_jsonl(os.path.join(workdir, "resizes.jsonl"))
    logs: Dict[str, List] = {}
    logdir = os.path.join(workdir, "logs")
    for name in sorted(os.listdir(logdir)):
        if not name.endswith(".jsonl"):
            continue   # a .tmp staging file a crash left behind
        member = name[:-len(".jsonl")]
        logs[member] = _read_jsonl(os.path.join(logdir, name))
    # The dead member's post-commit batches died with it: trim to the
    # step the survivors rolled back to (survivors self-trim on
    # resize; the corpse cannot).
    for rz in resizes:
        for dm in rz.get("died", ()):
            logs[dm] = [e for e in logs.get(dm, ())
                        if e["step"] <= rz["committed_step"]]
    union = sorted(k for entries in logs.values()
                   for e in entries for k in e["keys"])
    finals = []
    fdir = os.path.join(workdir, "final")
    for name in sorted(os.listdir(fdir)):
        with open(os.path.join(fdir, name)) as f:
            finals.append(json.load(f))
    finals_agree = (
        len(finals) > 0
        and len({f["digest"] for f in finals}) == 1
        and len({f["step"] for f in finals}) == 1
        and len({(f["generation"], f["world"]) for f in finals}) == 1)
    union_match = union == expected
    detect_s = None
    resume_s = None
    if deaths and resizes:
        # detect_s = SIGKILL -> the recorder flagged the pending
        # change (pure lease-detection latency); the rollback +
        # rebalance that follows is time_to_resume_s, not detection.
        first = resizes[0]
        detect_s = round(first["t_detect"] - deaths[0]["t"], 3)
        resume_s = first.get("resume_s")
    errors = []
    if rc != 0:
        errors.append(f"launcher exited {rc}")
    if kill_rank is not None and not deaths:
        errors.append("the scheduled SIGKILL never happened")
    if kill_rank is not None and not resizes:
        errors.append("no resize committed")
    if not finals_agree:
        errors.append(f"finals disagree/missing: {finals}")
    if not union_match:
        errors.append(
            f"union mismatch: {len(union)} effective records vs "
            f"{len(expected)} expected")
    report = DrillReport(
        ok=not errors,
        union_match=union_match,
        finals_agree=finals_agree,
        launcher_rc=rc,
        world0=world,
        final_world=finals[0]["world"] if finals else 0,
        final_generation=finals[0]["generation"] if finals else 0,
        deaths=len(deaths),
        resizes=len(resizes),
        records=len(union),
        records_reassigned=sum(r.get("records_reassigned", 0)
                               for r in resizes),
        detect_s=detect_s,
        time_to_resume_s=resume_s,
        error="; ".join(errors) if errors else None)
    if log is not None:
        log(f"drill wall time {time.time() - t0:.1f}s")
    return report


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.resilience.drill",
        description="multi-process elastic drill: hvdrun-torch workers "
                    "over the launcher's rendezvous store, real SIGKILL, "
                    "detect -> resize -> exact resume")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--worker", action="store_true",
                    help="run as ONE drill worker (internal; spawned "
                         "by run_drill under hvdrun-torch)")
    ap.add_argument("--world", type=int, default=DEFAULT_WORLD)
    ap.add_argument("--epochs", type=int, default=DEFAULT_EPOCHS)
    ap.add_argument("--records", type=int, default=DEFAULT_RECORDS)
    ap.add_argument("--batch-size", type=int, default=DEFAULT_BATCH)
    ap.add_argument("--save-every", type=int,
                    default=DEFAULT_SAVE_EVERY)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--kill-rank", type=int, default=None,
                    help="worker (launch rank) to SIGKILL mid-epoch "
                         "(default: the highest rank; negative "
                         "disables the kill)")
    ap.add_argument("--kill-step", type=int, default=DEFAULT_KILL_STEP)
    ap.add_argument("--lease-s", type=float, default=DEFAULT_LEASE_S)
    ap.add_argument("--timeout-s", type=float, default=None)
    args = ap.parse_args(argv)

    if args.worker:
        return _Worker(args).run()

    report = run_drill(
        args.workdir, world=args.world, epochs=args.epochs,
        records=args.records, batch=args.batch_size, seed=args.seed,
        save_every=args.save_every, kill_rank=args.kill_rank,
        kill_step=args.kill_step, lease_s=args.lease_s,
        timeout_s=args.timeout_s, log=_say)
    print(json.dumps(report.summary()))
    if report.ok:
        print(f"resize equivalence OK (multi-process): "
              f"{report.deaths} SIGKILL(s), {report.resizes} "
              f"resize(s) to world {report.final_world} (generation "
              f"{report.final_generation}), {report.records} records "
              f"union-bitwise-identical, detect_s={report.detect_s}, "
              f"time_to_resume_s={report.time_to_resume_s}")
        return 0
    print(f"multi-process drill FAILED: {report.summary()}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
