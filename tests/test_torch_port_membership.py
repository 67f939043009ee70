"""PyTorch port: elastic membership (`resilience/membership.py`), the
migrating resume of `ElasticTrainer`, the resize half of the
equivalence harness and `bootstrap.apply_resize`, against the JAX
package.

* Every case of the JAX package's ``tests/test_membership.py`` runs on
  the port: the module is loaded by path (not re-collected) with its
  module-level names re-pointed to the port's modules. Six of its 29
  cases reach the JAX package by imports inside the test or by the
  native rendezvous client; each has a twin here (the table in
  `TWINS`).
* The same inputs through both packages: `record_keys` of the same
  batches; scripted resizes under an injected clock (a heartbeat drop,
  a death, a join) give the same sequence of `ResizeDecision`s;
  `SimulatedWorld` of 4 members over the same shard files under
  ``rank_death:1`` and ``rank_death:1,rank_join:1`` gives the same
  union stream, resizes and world; `run_resize_equivalence` the same
  report; a world-4 cursor resumed at world 3 the same `resize_report`
  and the same rebalanced streams.
* The port's own parts: the float64 average of torch tensors equals
  the numpy path's bitwise; `BootstrapKV` over a real `TCPStore`
  (missing keys, a dead store, reconnects, no scan, and the asymmetric
  partition that must never split the world's brain).

Tolerance: none; everything here is compared bitwise or exactly.
"""

import datetime
import importlib.util
import inspect
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu import data as j_data
from horovod_tpu.obs import straggler as j_straggler
from horovod_tpu.resilience import chaos as j_chaos
from horovod_tpu.resilience import elastic as j_elastic
from horovod_tpu.resilience import equivalence as j_eq
from horovod_tpu.resilience import membership as j_mem
from horovod_tpu.runtime import bootstrap as j_bootstrap
from horovod_tpu.runtime import config as j_config_mod
from horovod_tpu.runtime import state as j_state
from horovod_tpu_torch import data as t_data
from horovod_tpu_torch.obs import catalog as t_catalog
from horovod_tpu_torch.obs import events as t_events
from horovod_tpu_torch.obs import straggler as t_straggler
from horovod_tpu_torch.resilience import chaos as t_chaos
from horovod_tpu_torch.resilience import drill as t_drill
from horovod_tpu_torch.resilience import elastic as t_elastic
from horovod_tpu_torch.resilience import equivalence as t_eq
from horovod_tpu_torch.resilience import membership as t_mem
from horovod_tpu_torch.runtime import bootstrap as t_bootstrap
from horovod_tpu_torch.runtime import config as t_config_mod
from horovod_tpu_torch.runtime import state as t_state
from horovod_tpu_torch.resilience.detector import install_detector

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _stop_port_detector():
    """Stop the port's shared failure detector after the module: its
    sweep thread carries the JAX package's thread name, and a later
    module of this worker process (`tests/test_detector.py`) counts the
    live threads of that name."""
    yield
    old = install_detector(None)
    if old is not None:
        old.stop()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("test_membership")
PORT_NAMES = dict(
    hd=t_data, events=t_events, EventLog=t_events.EventLog, chaos=t_chaos,
    ElasticTrainer=t_elastic.ElasticTrainer,
    PreemptionHandler=t_elastic.PreemptionHandler,
    equivalence_main=t_eq.main,
    run_resize_equivalence=t_eq.run_resize_equivalence,
    BootstrapKV=t_mem.BootstrapKV, ChaosKV=t_mem.ChaosKV,
    ElasticBarrier=t_mem.ElasticBarrier, InProcessKV=t_mem.InProcessKV,
    KVTransportError=t_mem.KVTransportError,
    MembershipError=t_mem.MembershipError,
    SimulatedWorld=t_mem.SimulatedWorld, WorldMonitor=t_mem.WorldMonitor,
    record_keys=t_mem.record_keys, bootstrap=t_bootstrap,
    runtime_state=t_state)
# The reference's cases that reach the JAX package past its module
# names, and the port test here that takes each one's place.
TWINS = {
    "TestSimulatedWorldE2E::test_elastic_generation_metric_tracks_"
    "transitions": "test_generation_metric_tracks_transitions",
    "TestKVTransportHardening::test_bootstrap_put_retries_and_reconnects":
        "test_bootstrap_put_retries_and_reconnects",
    "TestKVTransportHardening::test_bootstrap_exhaustion_is_typed":
        "test_bootstrap_exhaustion_is_typed",
    "TestKVTransportHardening::test_bootstrap_get_distinguishes_missing_"
    "from_down": "test_bootstrap_get_distinguishes_missing_from_down",
    "TestMergeWindowsMissingRank::test_missing_rank_degrades_and_is_"
    "flagged": "test_merge_windows_missing_rank_equals_reference",
    "TestMergeWindowsMissingRank::test_all_windows_dead_returns_none":
        "test_merge_windows_missing_rank_equals_reference",
}
REF_CASES = [
    (cls, name) for cls in sorted(
        n for n, v in vars(REF).items()
        if n.startswith("Test") and isinstance(v, type))
    for name in sorted(vars(getattr(REF, cls))) if name.startswith("test_")
    and f"{cls}::{name}" not in TWINS] + [
    (None, name) for name in sorted(vars(REF))
    if name.startswith("test_") and callable(getattr(REF, name))]
SPEC = REF.SPEC
# The leases of the worlds and monitors this file builds itself (the
# reference's cases keep their own 0.3 s). A loaded host can stall a
# member's heartbeat thread past 0.3 s, and a false death changes the
# world's history: the port's worlds take 1 s; a world of the JAX
# package, whose Orbax saves share its process, takes HVD_LEASE_S's
# default of 2 s; a leg without chaos, where nothing should die, a lease
# no stall reaches.
LEASE_S = 1.0
REF_LEASE_S = 2.0
CALM_LEASE_S = 60.0


def test_every_reference_case_is_mapped():
    names = {f"{c}::{n}" if c else n for c, n in REF_CASES}
    assert len(names) + len(TWINS) == 29
    assert all(t in globals() for t in TWINS.values())


@pytest.fixture(autouse=True)
def _python_loader(monkeypatch):
    """Both packages read the shards with their Python readers (the
    loaders are pinned against each other in test_torch_port_data.py)."""
    monkeypatch.setattr(t_config_mod.config, "use_native", False)
    monkeypatch.setattr(j_config_mod.config, "use_native", False)


@pytest.fixture(autouse=True)
def _fresh_generation():
    """`apply_resize` is monotonic per process: reset both packages'
    generation and membership fields around each test."""
    sts = (t_state.global_state(), j_state.global_state())
    prev = [(st.rank, st.size) for st in sts]
    for st in sts:
        st.world_generation = 0
    yield
    for st, (r, n) in zip(sts, prev):
        st.world_generation = 0
        st.rank, st.size = r, n


def _shards(hd, tmp_path):
    """The reference's ``shards`` fixture, written by ``hd``."""
    rs = np.random.RandomState(5)
    n, dim = 64, 3
    x = rs.randn(n, dim).astype(np.float32)
    y = (x @ rs.randn(dim).astype(np.float32)).astype(np.float32)
    return hd.write_shards(str(tmp_path / "shards"), "m", SPEC,
                           {"x": x, "y": y}, 4)


@pytest.mark.parametrize("case", REF_CASES,
                         ids=[f"{c}::{n}" if c else n for c, n in REF_CASES])
def test_reference_case_on_port(case, tmp_path, monkeypatch):
    cls, name = case
    for k, v in PORT_NAMES.items():
        monkeypatch.setattr(REF, k, v)
    fn = getattr(getattr(REF, cls)(), name) if cls else getattr(REF, name)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    if "shards" in inspect.signature(fn).parameters:
        args["shards"] = _shards(t_data, tmp_path)
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


# -- the twins ----------------------------------------------------------------

def test_generation_metric_tracks_transitions(tmp_path):
    paths = _shards(t_data, tmp_path)
    with t_chaos.armed("rank_death:1"):
        run = t_mem.SimulatedWorld(
            world=4, make_dataset=_make_ds(t_data, paths),
            state0=REF._STATE0, grad_fn=REF._grad, apply_fn=REF._apply,
            ckpt_dir=str(tmp_path / "ck"), epochs=2, save_every=2,
            lease_s=LEASE_S).run(timeout_s=90)
    assert run.completed, run.error
    gen = t_catalog.registry().to_json()["hvd_elastic_generation"]
    assert any(s.get("value") == 1.0 for s in gen["samples"])


class _FlakyStore:
    """The `TCPStore` surface `BootstrapKV` consumes, scripted: the
    first ``fail_sets`` sets raise as a dead server does, and
    ``server_up=False`` makes every call raise."""

    def __init__(self, fail_sets=0, server_up=True):
        self.fail_sets = fail_sets
        self.server_up = server_up
        self.data = {}

    def _up(self):
        if not self.server_up:
            raise dist.DistNetworkError("Connection reset by peer")

    def set(self, key, value):
        self._up()
        if self.fail_sets > 0:
            self.fail_sets -= 1
            raise dist.DistNetworkError("Broken pipe")
        self.data[key] = bytes(value)

    def check(self, keys):
        self._up()
        return all(k in self.data for k in keys)

    def get(self, key):
        self._up()
        return self.data[key]


def test_bootstrap_put_retries_and_reconnects(monkeypatch):
    monkeypatch.setenv("HOROVOD_KV", "127.0.0.1:1")
    store = _FlakyStore(fail_sets=2)
    connects = []
    kv = t_mem.BootstrapKV(
        store, connect=lambda addr: connects.append(addr) or store)
    kv.put("a", {"x": 1})          # two faults absorbed
    assert kv.get("a") == {"x": 1}
    assert kv.reconnects == 2      # reconnect tried per fault
    assert connects == ["127.0.0.1:1"] * 2


def test_bootstrap_exhaustion_is_typed(monkeypatch):
    monkeypatch.setenv("HOROVOD_KV", "127.0.0.1:1")
    store = _FlakyStore(fail_sets=10 ** 6)
    kv = t_mem.BootstrapKV(store, connect=lambda addr: store)
    with pytest.raises(t_mem.KVTransportError):
        kv.put("a", 1)


def test_bootstrap_get_distinguishes_missing_from_down(monkeypatch):
    monkeypatch.delenv("HOROVOD_KV", raising=False)
    up = t_mem.BootstrapKV(_FlakyStore(server_up=True))
    assert up.get("nope") is None            # absent, the server said so
    down = t_mem.BootstrapKV(_FlakyStore(server_up=False))
    with pytest.raises(t_mem.KVTransportError):   # unreachable, typed
        down.get("nope")


def test_merge_windows_missing_rank_equals_reference():
    w0 = {"rank": 0, "n": 4, "total_s": 0.4, "max_s": 0.2}
    w2 = {"rank": 2, "n": 4, "total_s": 0.04, "max_s": 0.02}
    cases = [([w0, None, w2, {"rank": 1, "n": "???"}], 4), ([w0, w2], None),
             ([None, {}, {"rank": 1}], 2)]
    for windows, expected in cases:
        kw = {} if expected is None else {"expected_ranks": expected}
        got = t_straggler.merge_windows(windows, **kw)
        assert got == j_straggler.merge_windows(windows, **kw)
    rep = t_straggler.merge_windows(cases[0][0], expected_ranks=4)
    assert rep["missing_ranks"] == [1, 3] and rep["slowest_rank"] == 0
    assert t_straggler.merge_windows(cases[2][0], expected_ranks=2) is None


# -- the same inputs through both packages ------------------------------------

def _make_ds(hd, paths, seed=3, batch=4):
    def make(rank, world):
        return hd.ShardedDataset(paths, SPEC, batch, shuffle=True,
                                 seed=seed, rank=rank, world=world)
    return make


def test_record_keys_equal_reference(tmp_path):
    paths = _shards(t_data, tmp_path)
    batches = list(_make_ds(t_data, paths)(0, 1).epoch(0))
    rows = t_data.pack_tokens([np.arange(1, 40), np.arange(7, 30)], 16,
                              eos_id=1)
    batches.append({"tokens": rows})
    for b in batches:
        assert t_mem.record_keys(b) == j_mem.record_keys(b)
    assert len(set(t_mem.record_keys(batches[0]))) == 4


def _boot(m):
    """`WorldMonitor.start` without its watcher thread: the genesis
    commit, a first beat, the detector's peers."""
    m.kv.put_if_absent("commit/0", {"generation": 0,
                                    "members": m.members(),
                                    "died": [], "joined": []})
    m.heartbeat()
    m._sync_detector_peers()


def _agree(calls, timeout=20.0):
    """Run each (name, fn) in its own thread; name -> result or the
    exception's type name."""
    out = {}

    def run(name, fn):
        try:
            out[name] = fn()
        except Exception as e:   # noqa: BLE001 — recorded, compared
            out[name] = type(e).__name__

    ts = [threading.Thread(target=run, args=c, daemon=True) for c in calls]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert len(out) == len(calls), f"agreement did not finish: {out}"
    return out


def _dec(d):
    if isinstance(d, str):
        return d
    return (d.generation, list(d.members), d.rank, d.world, list(d.died),
            list(d.joined), d.kind)


def _scripted(mem, chaos_mod):
    """A world of 3 under a manual clock: a lost heartbeat the lease
    absorbs, rank2's death and the survivors' shrink, a joiner's
    announcement and the grow. Returns what every member saw."""
    t = [100.0]
    kv = mem.InProcessKV()
    mk = dict(kv=kv, lease_s=1.0, heartbeat_s=0.25, clock=lambda: t[0],
              apply_runtime=False)
    mons = {f"rank{i}": mem.WorldMonitor(f"rank{i}", rank=i, world=3, **mk)
            for i in range(3)}
    seq = []
    try:
        for m in mons.values():
            _boot(m)
        t[0] += 0.3
        with chaos_mod.armed("heartbeat_drop:1"):
            beats = [m.heartbeat() for m in mons.values()]
        seq.append(("drop", beats,
                    [m.pending_change() for m in mons.values()],
                    [m.suspect_members() for m in mons.values()]))
        t[0] += 1.2                        # rank2 stops beating
        for name in ("rank0", "rank1"):
            mons[name].heartbeat()
        seq.append(("death", mons["rank0"].pending_change(),
                    mons["rank1"].dead_members()))
        got = _agree([(n, lambda n=n: mons[n].resize(timeout_s=30.0))
                      for n in ("rank0", "rank1")])
        seq.append(("shrink", {n: _dec(d) for n, d in sorted(got.items())}))
        got = _agree([("rank2", lambda: mons["rank2"].resize(timeout_s=5))])
        seq.append(("corpse", got))
        joiner = mem.WorldMonitor("joiner0", joining=True, **mk)
        mons["joiner0"] = joiner
        joiner.announce_join()
        t[0] += 0.1
        for name in ("rank0", "rank1"):
            mons[name].heartbeat()
        seq.append(("announce", mons["rank0"].pending_change(),
                    mons["rank1"].joiners()))
        got = _agree([(n, lambda n=n: mons[n].resize(timeout_s=30.0))
                      for n in ("rank0", "rank1")]
                     + [("joiner0", lambda: joiner.wait_for_membership(
                         timeout_s=30.0))])
        seq.append(("grow", {n: _dec(d) for n, d in sorted(got.items())}))
        seq.append(("log", [kv.get(f"commit/{g}") for g in range(4)],
                    kv.get("gen"), kv.get("join_queue")))
    finally:
        for m in mons.values():
            m.stop()
    return seq


def test_scripted_resizes_equal_reference():
    ours = _scripted(t_mem, t_chaos)
    ref = _scripted(j_mem, j_chaos)
    assert ours == ref
    by = {step[0]: step[1:] for step in ours}
    shrink, grow = by["shrink"][0], by["grow"][0]
    assert shrink["rank1"] == (1, ["rank0", "rank1"], 1, 2, ["rank2"], [],
                               "shrink")
    assert grow["joiner0"][:4] == (2, ["rank0", "rank1", "joiner0"], 2, 3)
    assert by["corpse"][0] == {"rank2": "MembershipError"}
    assert by["drop"][0] == [False, True, True]
    assert t_bootstrap.world_generation() == 2


# Epochs of each leg. The grow leg runs longer: the JAX package admits
# a joiner at the first watcher tick that sees it (every HEARTBEAT_S),
# and its world must not finish before that tick.
WORLD_SPECS = {"rank_death:1": 2, "rank_death:1,rank_join:1": 6}
# The heartbeat (and watcher tick) of these worlds: many beats a lease,
# so a stalled beat is not a death, and a prompt sight of the joiner.
HEARTBEAT_S = 0.05


def _sim(mem, chaos_mod, paths, ckpt_dir, spec, epochs):
    for state in (t_state, j_state):     # each run starts at generation 0
        state.global_state().world_generation = 0
    world = mem.SimulatedWorld(
        world=4, make_dataset=_make_ds(
            t_data if mem is t_mem else j_data, paths),
        state0=REF._STATE0, grad_fn=REF._grad, apply_fn=REF._apply,
        ckpt_dir=ckpt_dir, epochs=epochs, save_every=2,
        lease_s=REF_LEASE_S if spec else CALM_LEASE_S,
        heartbeat_s=HEARTBEAT_S if spec else None)
    if spec:
        with chaos_mod.armed(spec):
            return world.run(timeout_s=90)
    return world.run(timeout_s=90)


def _facts(run):
    """What the committed history decides whatever the timing: the
    resizes, who died and joined, the final world and generation, and
    the shrink's rollback step and records reassigned (the death is
    offered once step 2 is committed, and the world waits for it)."""
    s = run.summary()
    shrink = run.resizes[0] if run.resizes else {}
    return dict(completed=s["completed"], final_world=s["final_world"],
                final_generation=s["final_generation"],
                deaths=s["deaths"], joins=s["joins"],
                resizes=[(r["generation"], r["world"], r["kind"],
                          r["died"], r["joined"]) for r in run.resizes],
                shrink_committed=shrink.get("committed_step"),
                shrink_reassigned=shrink.get("records_reassigned"))


def _timed(run):
    """What also depends, in the JAX package, on the step at which a
    watcher tick saw the joiner: the grow's rollback step, and with it
    the steps taken and the records reassigned (ROADMAP Queue C)."""
    s = run.summary()
    return dict(committed=[r["committed_step"] for r in run.resizes],
                records_reassigned=s["records_reassigned"],
                steps=s["steps"])


def _bits(state):
    return {k: np.asarray(v, np.float64).tobytes() for k, v in state.items()}


@pytest.mark.parametrize("spec", sorted(WORLD_SPECS))
def test_simulated_world_equals_reference(spec, tmp_path):
    """Both packages' worlds of 4 over the same shard files, the JAX
    package's as it stands: the union stream equals the other package's
    and an uninterrupted world's; the resizes, the shrink's rollback step
    and records reassigned, the final world and generation are the same.

    The shrink-only leg has no timing in it: its steps, records
    reassigned and final state equal both JAX runs', the state bitwise.
    In the grow leg the JAX package admits the joiner at a watcher tick,
    so its rollback step varies from run to run; the port admits it at
    the step boundary that spawned it (`SimulatedWorld._await_joiner`,
    the port's own behaviour), so its grow always rolls back to the
    shrink's snapshot, held here against that fixed step only. A JAX
    run that happened to roll back to the same steps must then agree
    bitwise as well."""
    paths = _shards(j_data, tmp_path)
    epochs = WORLD_SPECS[spec]
    control = _sim(t_mem, t_chaos, paths, str(tmp_path / "c"), "", epochs)
    assert control.completed and not control.resizes, control.error
    refs = [_sim(j_mem, j_chaos, paths, str(tmp_path / f"j{i}"), spec,
                 epochs) for i in range(2)]
    run = _sim(t_mem, t_chaos, paths, str(tmp_path / "t"), spec, epochs)
    assert run.completed, run.error
    assert run.union_keys() == refs[0].union_keys() == control.union_keys()
    assert refs[1].union_keys() == control.union_keys()
    ours, theirs = _facts(run), [_facts(r) for r in refs]
    assert ours == theirs[0] == theirs[1], (ours, theirs)
    joined = "rank_join" in spec
    assert ours["final_world"] == (4 if joined else 3)
    assert ours["final_generation"] == (2 if joined else 1)
    assert ours["shrink_committed"] == 2
    assert _timed(run)["committed"] == [2] * ours["final_generation"]
    same = [r for r in refs if _timed(r) == _timed(run)]
    if not joined:
        assert len(same) == 2, (_timed(run), [_timed(r) for r in refs])
    for r in same:
        assert _bits(run.final_state) == _bits(r.final_state)


class _UnmigratedWorld(t_mem.SimulatedWorld):
    """Members resume without the trainer's world migration (the card
    smoke's planted fault)."""

    def _build_trainer(self, dec_rank, dec_world):
        ds = self.make_dataset(dec_rank, dec_world)
        trainer = t_elastic.ElasticTrainer(
            self.ckpt_dir, save_every=self.save_every if dec_rank == 0
            else 0, keep=0, block=True, install_signals=False, dataset=ds,
            migrate_world=False)
        state, step = trainer.resume(like=self.state0)
        return ds, trainer, state, step


def test_union_check_sees_the_migration_turned_off(tmp_path):
    """Without the migration a shrink cannot resume its cursor (the
    loud epoch-boundary fallback), so records are trained twice or not
    at all: the union is no longer every record once per epoch, and the
    union check catches it."""
    paths = _shards(t_data, tmp_path)
    with t_chaos.armed("rank_death:1"):
        run = _UnmigratedWorld(
            world=4, make_dataset=_make_ds(t_data, paths),
            state0=REF._STATE0, grad_fn=REF._grad, apply_fn=REF._apply,
            ckpt_dir=str(tmp_path / "ck"), epochs=2, save_every=2,
            lease_s=LEASE_S).run(timeout_s=90)
    assert run.completed and len(run.deaths) == 1, run.error
    keys = [k for b in _make_ds(t_data, paths)(0, 1).epoch(0)
            for k in t_mem.record_keys(b)]
    union = run.union_keys()
    assert set(union) <= set(keys) and union != sorted(keys * 2)


def test_resize_equivalence_report_equals_reference(tmp_path, capsys):
    """``equivalence --resize`` in both packages on the same arguments:
    the same exit code and, but for the timings, the same report."""
    argv = ["--resize", "--records", "32", "--loader", "python",
            "--lease-s", str(REF_LEASE_S)]
    reports = []
    for tag, main in (("t", t_eq.main), ("j", j_eq.main)):
        for state in (t_state, j_state):
            state.global_state().world_generation = 0
        assert main(argv + ["--workdir", str(tmp_path / tag)]) == 0
        out = capsys.readouterr().out
        assert "resize equivalence OK: 1 death(s)" in out
        reports.append(json.loads(next(
            ln for ln in out.splitlines() if ln.startswith("{"))))
    for rep in reports:
        del rep["detect_s"], rep["time_to_resume_s"]
    assert reports[0] == reports[1]
    assert reports[0]["ok"] and reports[0]["loader"] == "python"


def test_average_of_torch_tensors_is_bitwise_numpy():
    """The lockstep average: CPU float32 tensors average to the numpy
    path's float64 result bit for bit (the JAX package's expression,
    ``sum(np.asarray(g, float64) ...) / n``, in the same rank order),
    signed zeros included; numpy leaves stay bitwise the reference's."""
    rs = np.random.RandomState(0)
    grads = [{"w": rs.randn(7, 3).astype(np.float32),
              "b": np.float32(rs.randn()),
              "z": np.array([-0.0, 0.0, 1e-30], np.float32) * (i - 1)}
             for i in range(3)]
    ref = {k: sum(np.asarray(g[k], dtype=np.float64) for g in grads)
           / len(grads) for k in grads[0]}
    tgrads = [{k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}
              for g in grads]
    got = t_mem.average(tgrads)
    for k in ref:
        assert got[k].dtype == torch.float64 and got[k].device.type == "cpu"
        assert got[k].numpy().tobytes() == np.asarray(ref[k]).tobytes(), k
    got_np = t_mem.average(grads)
    for k in ref:
        assert np.asarray(got_np[k]).tobytes() == np.asarray(
            ref[k]).tobytes(), k


def _snapshot_world4(hd, elastic, paths, ckpt):
    """Rank 0 of a world of 4 trains two steps and checkpoints them."""
    ds = _make_ds(hd, paths)(0, 4)
    trainer = elastic.ElasticTrainer(ckpt, save_every=2, keep=0,
                                     block=True, install_signals=False,
                                     dataset=ds)
    state, step = trainer.resume(like=REF._STATE0)
    it = ds.epoch(0)
    for _ in range(2):
        g, loss = REF._grad(state, next(it))
        state = REF._apply(state, g)
        step += 1
        state = trainer.after_step(step, state, loss)
    del it
    ds.close()


def _resume_world3(hd, elastic, mem, paths, ckpt, rank, migrate):
    ds = _make_ds(hd, paths)(rank, 3)
    trainer = elastic.ElasticTrainer(ckpt, save_every=0, keep=0,
                                     block=True, install_signals=False,
                                     dataset=ds, migrate_world=migrate)
    state, step = trainer.resume(like=REF._STATE0)
    e0, b0 = trainer.data_start
    stream = [mem.record_keys(b) for e in range(e0, 2)
              for b in ds.epoch(e, start_batch=b0 if e == e0 else 0)]
    report = dict(trainer.resize_report or {})
    report.pop("rebalance_s", None)
    out = dict(step=step, data_start=(e0, b0), report=report,
               gap=trainer.resume_gap_batches,
               fallbacks=trainer.cursor_fallbacks,
               exact=trainer.snapshot.exact, stream=stream,
               state=_bits(state))
    ds.close()
    return out


@pytest.mark.parametrize("migrate", [True, False])
def test_migrating_resume_equals_reference(migrate, tmp_path):
    """A world-4 snapshot resumed at each rank of world 3: with
    ``migrate_world`` the resize report, the exact cursor and the
    rebalanced streams equal the JAX package's; without it both fall
    back loudly to the epoch boundary."""
    paths = _shards(j_data, tmp_path)
    got = {}
    for tag, hd, elastic, mem in (("t", t_data, t_elastic, t_mem),
                                  ("j", j_data, j_elastic, j_mem)):
        ckpt = str(tmp_path / f"ck_{tag}")
        _snapshot_world4(hd, elastic, paths, ckpt)
        got[tag] = [_resume_world3(hd, elastic, mem, paths, ckpt, r, migrate)
                    for r in range(3)]
    assert got["t"] == got["j"]
    if migrate:
        rep = got["t"][0]["report"]
        assert (rep["old_world"], rep["new_world"]) == (4, 3)
        assert rep["records_reassigned"] > 0
        assert all(r["gap"] == 0 and r["exact"] and not r["fallbacks"]
                   for r in got["t"])
    else:
        assert all(r["fallbacks"] == 1 and not r["exact"] and not r["report"]
                   for r in got["t"])


# -- BootstrapKV over a real TCPStore -----------------------------------------

def _master():
    return dist.TCPStore("127.0.0.1", 0, None, True,
                         datetime.timedelta(seconds=30),
                         wait_for_workers=False)


def _client(master):
    return t_bootstrap.connect_kv(f"127.0.0.1:{master.port}", timeout_s=10)


def test_bootstrap_kv_over_tcpstore(monkeypatch):
    """Round trips, the ``null`` tombstone, no scan; a dead store's miss
    is a typed error after the retries, never None; a reconnect to the
    store ``HOROVOD_KV`` names lands the write."""
    a = _master()
    kv = t_mem.BootstrapKV(_client(a))
    kv.put("k", {"v": [1, 2]})
    assert kv.get("k") == {"v": [1, 2]}
    assert kv.get("missing") is None
    assert kv.put_if_absent("k", {"v": 0}) == {"v": [1, 2]}
    assert kv.put_if_absent("p", 3) == 3
    kv.delete("k")
    assert kv.get("k") is None
    with pytest.raises(NotImplementedError):
        kv.scan("")
    del a                                   # the server goes away
    monkeypatch.delenv("HOROVOD_KV", raising=False)
    with pytest.raises(t_mem.KVTransportError):
        kv.get("missing")
    with pytest.raises(t_mem.KVTransportError):
        kv.put("k", 1)
    b = _master()                           # a new server, named by env
    monkeypatch.setenv("HOROVOD_KV", f"127.0.0.1:{b.port}")
    kv.put("k", 2)
    assert kv.reconnects >= 1 and kv.get("k") == 2
    assert _client(b).get("k") == b"2"
    with pytest.raises(RuntimeError, match="rendezvous"):
        t_bootstrap.connect_kv("")


class _StoreKV(t_mem.InProcessKV):
    """The survivors' handle on the store: `BootstrapKV`'s JSON over
    `TCPStore` calls, without the hardening (whose chaos sites are
    process-wide: arming ``kv_partition`` for the victim's
    `BootstrapKV` in this one process would partition every member's)."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def put(self, key, value):
        self.store.set(key, json.dumps(value).encode())

    def get(self, key):
        if not self.store.check([key]):
            return None
        return json.loads(bytes(self.store.get(key)).decode())

    def put_if_absent(self, key, value):
        with self._lock:
            cur = self.get(key)
            if cur is None:
                self.put(key, value)
                cur = value
            return cur

    def scan(self, prefix):
        raise NotImplementedError


def test_bootstrap_kv_shared_by_threads():
    """One `BootstrapKV` client shared by more threads than cores (a
    member's main loop, its watcher and the detector's sweep share one
    in the drill), under a short switch interval: every thread reads
    back exactly what it wrote."""
    import os
    import sys
    master = _master()
    kv = t_mem.BootstrapKV(_client(master))
    n = (os.cpu_count() or 4) + 2
    bad, interval = [], sys.getswitchinterval()

    def worker(i):
        for j in range(40):
            kv.put(f"t{i}/{j % 4}", [i, j])
            if kv.get(f"t{i}/{j % 4}") != [i, j]:
                bad.append((i, j))

    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert bad == []


def test_launch_counts_are_atomic_across_threads():
    """The kernel wrappers' launch counts: members of an elastic world
    launch from threads of their own, and no launch may be lost."""
    import os
    import sys
    from horovod_tpu_torch.ops import flash_attention as tfa
    n, per = (os.cpu_count() or 4) + 2, 2000
    saved, interval = tfa.flash_fwd_cuda.launches, sys.getswitchinterval()
    tfa.flash_fwd_cuda.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            tfa.count_launch(tfa.flash_fwd_cuda) for _ in range(per)])
            for _ in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        assert tfa.flash_fwd_cuda.launches == n * per
    finally:
        sys.setswitchinterval(interval)
        tfa.flash_fwd_cuda.launches = saved


def test_kv_partition_never_two_generations_over_tcpstore():
    """The reference's split-brain case over the launcher's store: the
    victim's `BootstrapKV` writes stop landing (``kv_partition``), the
    survivors commit generation 1 without it, and the victim adopts
    that commit as MembershipError — never a world of its own."""
    master = _master()
    lease = LEASE_S
    survivors = [t_mem.WorldMonitor(
        f"rank{i}", rank=i, world=3, kv=_StoreKV(_client(master)),
        lease_s=lease, heartbeat_s=0.05, apply_runtime=False)
        for i in range(2)]
    victim = t_mem.WorldMonitor(
        "rank2", rank=2, world=3, kv=t_mem.BootstrapKV(_client(master)),
        lease_s=lease, heartbeat_s=0.05, apply_runtime=False)
    for m in survivors + [victim]:
        m.start()
    try:
        time.sleep(0.15)
        with t_chaos.armed("kv_partition:-1") as monkey:
            deadline = time.monotonic() + lease * 10
            while (survivors[0].pending_change() is None
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert survivors[0].pending_change()["dead"] == ["rank2"]
            got = _agree([(i, lambda i=i: survivors[i].resize(
                timeout_s=15.0)) for i in range(2)])
            assert [_dec(got[i]) for i in range(2)] == [
                (1, ["rank0", "rank1"], i, 2, ["rank2"], [], "shrink")
                for i in range(2)]
            assert monkey.fired("kv_partition") > 0
            deadline = time.monotonic() + 5.0
            flagged = None
            while time.monotonic() < deadline:
                flagged = victim.pending_change()
                if flagged and flagged.get("commit"):
                    break
                time.sleep(0.02)
            assert flagged and flagged["commit"] == 1
            with pytest.raises(t_mem.MembershipError):
                victim.resize(timeout_s=5.0)
        shared = t_mem.BootstrapKV(_client(master))
        assert shared.get("commit/1")["members"] == ["rank0", "rank1"]
        assert shared.get("commit/2") is None
        assert victim.generation == 0 and victim.beats_missed > 0
    finally:
        for m in survivors + [victim]:
            m.stop()


# -- bootstrap and knobs ------------------------------------------------------

def test_apply_resize_rekeys_an_initialized_runtime():
    """With the runtime initialized, `apply_resize` moves rank and size
    and drops the op cache (``rekey_runtime=False`` moves only the
    generation), as the JAX package's does on its state."""
    for boot, state in ((t_bootstrap, t_state), (j_bootstrap, j_state)):
        st = state.global_state()
        saved = (st.initialized, st.rank, st.size, st.op_cache)
        st.initialized, st.rank, st.size = True, 3, 4
        st.op_cache = {"x": 1}
        try:
            boot.apply_resize(1, 3, 1, rekey_runtime=False)
            assert (st.rank, st.size, st.op_cache) == (3, 4, {"x": 1})
            boot.apply_resize(1, 3, 2)
            assert (st.rank, st.size, st.op_cache) == (1, 3, {})
            assert boot.world_generation() == 2
        finally:
            st.initialized, st.rank, st.size, st.op_cache = saved
    gauge = t_catalog.registry().to_json()["hvd_elastic_generation"]
    assert gauge["samples"][0]["value"] == 2.0


ELASTIC_KNOBS = ["HVD_LEASE_S", "HVD_HEARTBEAT_S",
                 "HVD_ELASTIC_DRILL_TIMEOUT_S"]


@pytest.mark.parametrize("name", ELASTIC_KNOBS)
def test_elastic_knob_declared_and_read(name, monkeypatch, tmp_path):
    ours, ref = t_config_mod.KNOBS[name], j_config_mod.KNOBS[name]
    assert (ours.kind, ours.default, ours.consumer) == (
        ref.kind, ref.default, ref.consumer)
    monkeypatch.setenv(name, "7.5")
    if name == "HVD_ELASTIC_DRILL_TIMEOUT_S":
        seen = []

        def fake_run(cmd, **kw):
            seen.append(kw["timeout"])
            raise t_drill.subprocess.TimeoutExpired(cmd, kw["timeout"])
        monkeypatch.setattr(t_drill.subprocess, "run", fake_run)
        report = t_drill.run_drill(str(tmp_path / "d"), records=12)
        assert seen == [7.5] and not report.ok
        return
    m = t_mem.WorldMonitor("rank0", rank=0, world=1,
                           kv=t_mem.InProcessKV(), apply_runtime=False)
    assert (m.lease_s if name == "HVD_LEASE_S" else m.heartbeat_s) == 7.5
