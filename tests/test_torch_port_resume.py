"""PyTorch port: checkpoints (`utils/checkpoint.py`), preemption-safe
training (`resilience/elastic.py`), the crash-restart equivalence
harness (`resilience/equivalence.py`) and `ResilientCheckpointCallback`
against the JAX package.

* The JAX package's own cases of ``tests/test_resume.py`` and
  ``tests/test_resilience.py`` that cover these modules (the aux
  sidecar, retention, kill sites, host RNG legs, exact resume and its
  loud fallbacks, checkpoint errors and write chaos, data chaos, the
  NaN guard and the preemption handler) run on the port: each module
  is loaded by path (not re-collected) with its module-level names
  re-pointed to the port's data, checkpoint, elastic, chaos, obs and
  equivalence modules.
* The same sequence of saves, corrupt steps, ``ckpt_kill`` and
  ``HVD_CKPT_KEEP`` leaves the same discoverable steps, the same
  ``latest_step`` and the same aux JSON in both packages, and each
  package reads the other's aux sidecar.
* The equivalence harness under ``train_crash:2,ckpt_kill:1`` gives the
  reference's report, with the same batch hashes in the same order and
  bitwise equal final parameters (it is pure numpy).
* Rank-0 rules on two gloo CPU ranks (``python -c`` processes that
  import only the port): only rank 0 writes, and ``broadcast=True``
  hands every rank rank 0's tree.

Tolerance: none; everything here is compared bitwise.
"""

import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.resilience import chaos as j_chaos
from horovod_tpu.resilience import equivalence as j_eq
from horovod_tpu.utils import checkpoint as j_ckpt
from horovod_tpu_torch import data as t_data
from horovod_tpu_torch.obs import catalog as t_catalog
from horovod_tpu_torch.obs import events as t_events
from horovod_tpu_torch.resilience import chaos as t_chaos
from horovod_tpu_torch.resilience import elastic as t_elastic
from horovod_tpu_torch.resilience import equivalence as t_eq
from horovod_tpu_torch.resilience import retry as t_retry
from horovod_tpu_torch.utils import checkpoint as t_ckpt

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_RESUME = _load("test_resume")
REF_RESIL = _load("test_resilience")
PORT_NAMES = dict(
    hd=t_data, catalog=t_catalog, events=t_events, chaos=t_chaos,
    ckpt=t_ckpt, ElasticTrainer=t_elastic.ElasticTrainer,
    NaNGuard=t_elastic.NaNGuard,
    PreemptionHandler=t_elastic.PreemptionHandler,
    _rng_state=t_elastic._rng_state, _rng_restore=t_elastic._rng_restore,
    run_crash_restart_equivalence=t_eq.run_crash_restart_equivalence,
    RetryPolicy=t_retry.RetryPolicy, RetryError=t_retry.RetryError,
    ChaosError=t_chaos.ChaosError, ChaosMonkey=t_chaos.ChaosMonkey,
    CheckpointCorruptError=t_ckpt.CheckpointCorruptError,
    CheckpointNotFoundError=t_ckpt.CheckpointNotFoundError)
# The JAX package's cases of these modules (both files' other classes
# are chaos, serving, collectives or JAX train steps: not this slice).
REF_CASES = [
    (REF_RESUME, cls, name)
    for cls in ("TestAuxSidecar", "TestRetentionGC", "TestKillSites",
                "TestHostRngSnapshot", "TestExactResume",
                "TestCrashRestartEquivalence")
    for name in sorted(vars(getattr(REF_RESUME, cls)))
    if name.startswith("test_")] + [
    (REF_RESIL, cls, name)
    for cls in ("TestCheckpointErrors", "TestCheckpointWriteChaos",
                "TestDataChaos", "TestNaNGuard",
                "TestPreemptionSafeTraining")
    for name in sorted(vars(getattr(REF_RESIL, cls)))
    if name.startswith("test_")
    # Its trajectory is an optax train step; `test_trainer_resume_
    # trajectory` below is the port's counterpart.
    and name != "test_kill_restart_resumes_latest_good_trajectory"]


def _case_id(case):
    mod, cls, name = case
    return f"{mod.__name__[5:]}::{cls}::{name}"


def _expand(cases):
    """(case, native) pairs: the loader-parametrized case runs twice."""
    out = []
    for case in cases:
        if case[2] == "test_equivalence_under_kills":
            out += [pytest.param(case, n, id=f"{_case_id(case)}[{i}]")
                    for n, i in ((True, "native"), (False, "python"))]
        else:
            out.append(pytest.param(case, None, id=_case_id(case)))
    return out


@pytest.mark.parametrize("case,native", _expand(REF_CASES))
def test_reference_case_on_port(case, native, tmp_path, monkeypatch):
    """One JAX-package test of these modules, its names re-pointed to
    the port. The reference's ``state`` fixture is its numpy tree."""
    mod, cls, name = case
    for k, v in PORT_NAMES.items():
        if hasattr(mod, k):
            monkeypatch.setattr(mod, k, v)
    # the cases' own ``from horovod_tpu import data``
    import horovod_tpu
    monkeypatch.setattr(horovod_tpu, "data", t_data)
    if hasattr(mod, "FAST"):
        monkeypatch.setattr(mod, "FAST", t_retry.RetryPolicy(
            max_attempts=3, base_delay_s=0.001, max_delay_s=0.01))
    fn = getattr(getattr(mod, cls)(), name)
    import inspect
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch, "hvd": None,
            "native": native,
            "state": {"params": {"w": np.arange(6, dtype=np.float32)
                                 .reshape(2, 3)},
                      "step": np.asarray(3)}}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


# -- the same discovery in both packages -----------------------------------

def _layout(d):
    """Discoverable steps, latest step, and every aux sidecar's JSON."""
    names = sorted(os.listdir(d))
    auxes = {n: json.load(open(os.path.join(d, n))) for n in names
             if n.endswith(".aux.json")}
    return ([s for s, _ in j_ckpt._step_entries(d)],
            j_ckpt.latest_step(d), auxes)


def _script(ckpt, chaos_mod, d, state):
    """Saves, a gutted newest step, a ckpt_kill, retention by
    HVD_CKPT_KEEP; returns what restore_latest found."""
    aux = lambda s: {"schema": 1, "step": s, "data": {"epoch": s // 3,
                                                      "next_batch": s % 3}}
    for s in (1, 2, 3):
        ckpt.save_step(d, s, state, aux=aux(s))
    with chaos_mod.armed("ckpt_kill:1"):
        with pytest.raises(chaos_mod.ChaosError):
            ckpt.save_step(d, 4, state, aux=aux(4))
    ckpt.save_step(d, 5, state, aux=aux(5))
    bad = os.path.join(d, "step_00000006")
    os.makedirs(bad)
    open(os.path.join(bad, "junk"), "w").write("partial write")
    os.environ["HVD_CKPT_KEEP"] = "3"
    try:
        ckpt.save_step(d, 7, state, aux=aux(7))
    finally:
        del os.environ["HVD_CKPT_KEEP"]
    _, step = ckpt.restore_latest(d, with_step=True)
    return step


def test_discovery_and_retention_equal_reference(tmp_path):
    state = {"w": np.arange(4.0), "b": np.float64(2.0)}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    j_step = _script(j_ckpt, j_chaos, jd, state)
    t_step = _script(t_ckpt, t_chaos, td, state)
    assert j_step == t_step == 7
    assert _layout(jd) == _layout(td)
    assert _layout(td)[0] == [5, 6, 7]
    # each package reads the other's sidecar
    assert t_ckpt.load_step_aux(jd, 7) == j_ckpt.load_step_aux(jd, 7)
    assert j_ckpt.load_step_aux(td, 5) == t_ckpt.load_step_aux(td, 5)
    got = t_ckpt.restore(os.path.join(td, "step_00000007"),
                         like={"w": np.zeros(4), "b": np.float64(0)})
    np.testing.assert_array_equal(got["w"], state["w"])
    assert type(got["b"]) is np.float64 and got["b"] == 2.0


def test_torch_tree_round_trip_and_template(tmp_path):
    """A model and AdamW state dict round-trips bitwise (sync and async
    saves); a template places leaves by its dtypes; a template that
    does not fit is a corrupt checkpoint; ``distributed=True`` names
    the later slice."""
    m = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(m.parameters(), lr=0.1)
    m(torch.randn(5, 4)).sum().backward()
    opt.step()
    state = {"model": m.state_dict(), "opt": opt.state_dict(), "step": 3}
    w0 = m.weight.detach().clone()
    t_ckpt.save(str(tmp_path / "a"), state)
    t_ckpt.save(str(tmp_path / "b"), state, block=False)
    m.weight.data.add_(1.0)          # after the async save's host copy
    t_ckpt.wait_pending()
    for d in ("a", "b"):
        got = t_ckpt.restore(str(tmp_path / d))
        assert torch.equal(got["model"]["weight"], w0)
        assert got["opt"]["state"][0]["exp_avg"].dtype == torch.float32
        assert got["step"] == 3
    like = {"model": {k: v.double() for k, v in m.state_dict().items()},
            "opt": torch.optim.AdamW(m.parameters()).state_dict(),
            "step": 0}
    got = t_ckpt.restore(str(tmp_path / "a"), like=like)
    assert got["model"]["bias"].dtype == torch.float64
    with pytest.raises(t_ckpt.CheckpointCorruptError, match="template"):
        t_ckpt.restore(str(tmp_path / "a"), like={"model": {}})
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        t_ckpt.save(str(tmp_path / "c"), state, distributed=True)


def test_torch_generator_rides_the_snapshot():
    g = torch.Generator().manual_seed(5)
    torch.rand(3, generator=g)
    snap = t_elastic._rng_state(g)
    json.dumps(snap)
    expect = torch.rand(4, generator=g)
    g2 = torch.Generator().manual_seed(0)
    t_elastic._rng_restore(g2, snap)
    assert torch.equal(torch.rand(4, generator=g2), expect)
    with pytest.raises(TypeError, match="torch.Generator"):
        t_elastic._rng_restore(np.random.default_rng(0), snap)


def test_resize_paths_work(tmp_path, capsys):
    """The elastic-resize paths exist: `ElasticTrainer(migrate_world=
    True)` is built with the migration on, and the harness's ``--resize``
    runs a simulated world through a death and prints its OK line."""
    trainer = t_elastic.ElasticTrainer(str(tmp_path / "ck"),
                                       migrate_world=True,
                                       install_signals=False)
    assert trainer.migrate_world and trainer.resize_report is None
    assert t_eq.main(["--workdir", str(tmp_path / "eq"), "--resize"]) == 0
    assert "resize equivalence OK: 1 death(s)" in capsys.readouterr().out


def test_preemption_notice_absorbs_one_hard_signal():
    h = t_elastic.PreemptionHandler(grace_s=20).install()
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert h.triggered and 0 < h.grace_remaining() <= 20
        signal.raise_signal(signal.SIGTERM)      # absorbed
        assert h.signum == signal.SIGTERM
    finally:
        h.uninstall()


def test_trainer_resume_trajectory(tmp_path):
    """The port's counterpart of the reference's kill-restart case: a
    torch model and AdamW checkpointed every 2 steps, killed after step
    8 with step 8 gutted; the restart resumes from step 6 and reaches
    the uninterrupted run's parameters bitwise."""
    def fresh():
        torch.manual_seed(0)
        m = torch.nn.Linear(3, 1, bias=False)
        return m, torch.optim.AdamW(m.parameters(), lr=0.05)

    def batch(i):
        rs = np.random.RandomState(1000 + i)
        x = torch.from_numpy(rs.randn(16, 3).astype(np.float32))
        return x, x @ torch.tensor([[1.0], [-2.0], [0.5]])

    def run(m, opt, steps, trainer=None, start=0):
        for i in range(start, steps):
            x, y = batch(i)
            opt.zero_grad()
            loss = ((m(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            if trainer is not None:
                trainer.after_step(i + 1, {"m": m.state_dict(),
                                           "o": opt.state_dict()},
                                   float(loss.detach()))

    ref, ref_opt = fresh()
    run(ref, ref_opt, 12)
    d = str(tmp_path)
    m, opt = fresh()
    tr = t_elastic.ElasticTrainer(d, save_every=2, keep=3, block=True,
                                  install_signals=False)
    run(m, opt, 8, tr)
    import shutil
    shutil.rmtree(os.path.join(d, "step_00000008"))
    os.makedirs(os.path.join(d, "step_00000008"))
    m2, opt2 = fresh()
    tr2 = t_elastic.ElasticTrainer(d, save_every=2, keep=3, block=True,
                                   install_signals=False)
    st, start = tr2.resume(like={"m": m2.state_dict(),
                                 "o": opt2.state_dict()})
    assert start == 6
    m2.load_state_dict(st["m"])
    opt2.load_state_dict(st["o"])
    run(m2, opt2, 12, tr2, start)
    assert torch.equal(m2.weight, ref.weight)


def test_callback_resumes_and_rolls_back(tmp_path):
    from horovod_tpu_torch.callbacks import ResilientCheckpointCallback
    cb = ResilientCheckpointCallback(str(tmp_path), save_every=2,
                                     block=True, install_signals=False)
    try:
        st, start = cb.resume(like={"w": torch.zeros(2)})
        assert start == 0
        for i in range(4):
            st = cb(i + 1, {"w": torch.full((2,), float(i + 1))}, 1.0)
        rolled = cb(5, {"w": torch.full((2,), float("nan"))},
                    float("nan"))
        assert cb.rollbacks == 1 and torch.equal(rolled["w"],
                                                 torch.full((2,), 4.0))
        assert not cb.should_stop
    finally:
        cb.close()
    cb2 = ResilientCheckpointCallback(str(tmp_path), install_signals=False)
    assert cb2.resume(like={"w": torch.zeros(2)})[1] == 4
    cb2.close()


# -- the equivalence harness -----------------------------------------------

def _recorded_step(log, default_step):
    def step(state, batch):
        log.append(j_eq._batch_key(batch))
        new, loss = default_step(state, batch)
        log.append({k: np.asarray(v).copy() for k, v in new.items()})
        return new, loss
    return step


def test_equivalence_report_equals_reference(tmp_path):
    """Under ``train_crash:2,ckpt_kill:1`` (the ``HVD_CHAOS`` smoke's
    spec): the same kills, batch hashes (every leg's, in order), report
    and final parameters."""
    reports, logs = [], []
    for chaos_mod, eq in ((j_chaos, j_eq), (t_chaos, t_eq)):
        log = []
        # the harness takes an installed monkey, as HVD_CHAOS arms one
        with chaos_mod.armed("train_crash:2,ckpt_kill:1"):
            reports.append(eq.run_crash_restart_equivalence(
                str(tmp_path / eq.__name__), epochs=2, use_native=False,
                step_fn=_recorded_step(log, eq._default_step)))
        assert chaos_mod.active() is None
        logs.append(log)
    j, t = (r.summary() for r in reports)
    for s in (j, t):
        s.pop("recovery_ms")
        s.pop("loader")
    assert j == t and t["ok"] and t["kills"] == 3
    assert len(logs[0]) == len(logs[1])
    for a, b in zip(*logs):
        if isinstance(a, str):
            assert a == b
        else:
            for k in a:
                assert a[k].tobytes() == b[k].tobytes()


def test_equivalence_cli(tmp_path, capsys):
    with t_chaos.armed("train_crash:1"):
        assert t_eq.main(["--workdir", str(tmp_path), "--epochs", "2",
                          "--loader", "python"]) == 0
    assert t_chaos.active() is None
    assert "equivalence OK: 1 kill(s)" in capsys.readouterr().out


# -- rank-0 rules on two gloo ranks ----------------------------------------

WORKER = r'''
import sys, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils import checkpoint as ckpt
rank, store, out = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=2, init_method="file://" + store)
state = {"w": torch.full((3,), float(r + 1)), "step": r}
wrote = ckpt.save_step(out + "/shared", 1, state)
hvd.allreduce(torch.zeros(1))        # rank 0's write is done
# each rank's own directory: rank 1's holds a different tree
ckpt.save(out + f"/own{r}", {"w": torch.full((3,), 10.0 + r)}) \
    if r == 0 else ckpt._write_tree(out + "/own1",
                                    {"w": torch.full((3,), 11.0)}, True)
mine = ckpt.restore(out + f"/own{r}")
bcast = ckpt.restore(out + f"/own{r}", broadcast=True,
                     like={"w": torch.zeros(3)})
latest, step = ckpt.restore_latest(out + "/shared", broadcast=True,
                                   with_step=True)
torch.save({"wrote": wrote, "mine": mine, "bcast": bcast,
            "latest": latest, "step": step}, f"{out}/rank{r}.pt")
hvd.shutdown()
'''


def test_rank0_only_save_and_broadcast_restore(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert [x["wrote"] for x in res] == [True, False]
    assert sorted(os.listdir(tmp_path / "shared")) == ["step_00000001"]
    assert torch.equal(res[1]["mine"]["w"], torch.full((3,), 11.0))
    for x in res:
        assert torch.equal(x["bcast"]["w"], torch.full((3,), 10.0))
        assert torch.equal(x["latest"]["w"], torch.full((3,), 1.0))
        assert x["step"] == 1 and x["latest"]["step"] == 0
