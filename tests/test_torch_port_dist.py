"""PyTorch port: Horovod's data-parallel core over `torch.distributed`
(gloo on the CPU) against the JAX package.

Two real ranks: one module fixture starts two processes that import
only the port (``python -c``; the JAX package must stay out of them)
and join one gloo group through a ``file://`` store under the test's
tmp_path (no fixed port, so parallel test workers cannot collide).
They run the eager collectives, the mismatch errors and a
data-parallel LM step, and write what they saw to disk. The JAX
references run here: the JAX test mesh has 8 ranks, so each collective
gets the two ranks' inputs repeated four times, which leaves averages,
broadcasts and the first two gathered blocks unchanged and multiplies
sums by 4.

Tolerances: collectives of float32 data within 1e-6 (one sum order);
integer results exact; the data-parallel SGD step against the
single-process full-batch step and against the JAX step within 1e-5
(float32, summation order: the two half-batch gradients are averaged
where the full batch sums once).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import horovod_tpu_torch as hvd_port
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.fusion import plan_buckets as jax_plan_buckets
from horovod_tpu.parallel.mesh import make_mesh
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops.fusion import plan_buckets
from horovod_tpu_torch.runtime import config as tconfig

REPO = pathlib.Path(__file__).resolve().parent.parent
VOCAB, LAYERS, HEADS, HEAD_DIM, MAX_LEN, LR = 64, 2, 4, 8, 32, 0.1


def _x(rank):
    return np.random.RandomState(100 + rank).randn(3, 4).astype(np.float32)


def _xi(rank):
    return np.random.RandomState(300 + rank).randint(
        -50, 50, (5,)).astype(np.int32)


def _y(rank):
    return np.random.RandomState(200 + rank).randn(2 + 3 * rank,
                                                   3).astype(np.float32)


def _batch():
    return np.random.RandomState(7).randint(0, VOCAB, (4, 16))


# Each rank's program: only the port is imported. argv: rank, store
# file, output dir, initial state_dict path, token batch path.
WORKER = r'''
import sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
rank, store, out, sd_path, tok_path = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=2, init_method="file://" + store)
res = {}
x = np.random.RandomState(100 + r).randn(3, 4).astype(np.float32)
xi = np.random.RandomState(300 + r).randint(-50, 50, (5,)).astype(np.int32)
y = np.random.RandomState(200 + r).randn(2 + 3 * r, 3).astype(np.float32)
t = torch.from_numpy(x)
res["sum"] = hvd.allreduce(t, average=False)
res["avg"] = hvd.allreduce(t)
res["int_avg"] = hvd.allreduce(torch.from_numpy(xi))
res["int_sum"] = hvd.allreduce(torch.from_numpy(xi), average=False)
res["gather"] = hvd.allgather(torch.from_numpy(y))
for root in (0, 1):
    res[f"bcast{root}"] = hvd.broadcast(t, root)
res["inplace"] = hvd.allreduce_(t.clone(), average=False)
res["grouped"] = torch.cat([g.reshape(-1) for g in hvd.grouped_allreduce(
    [t, torch.from_numpy(xi), 2 * t], average=False)]).double()
res["fused"] = torch.cat([g.reshape(-1) for g in hvd.allreduce_gradients(
    [t.clone(), 2 * t, t[:1].clone()], threshold=40)])
errors = []
for name, fn in [
        ("shape", lambda: hvd.allreduce(t if r == 0 else t.T)),
        ("dtype", lambda: hvd.allreduce(t if r == 0 else t.double())),
        ("gather_dims", lambda: hvd.allgather(
            torch.zeros(2, 3) if r == 0 else torch.zeros(2, 4))),
        ("root", lambda: hvd.broadcast(t, r)),
        ("range", lambda: hvd.broadcast(t, 2))]:
    try:
        fn()
        errors.append(f"{name}: no error")
    except hvd.CollectiveMismatchError as e:
        errors.append(f"{name}: CollectiveMismatchError {e}")
    except ValueError as e:
        errors.append(f"{name}: ValueError {e}")
res["after_errors"] = hvd.allreduce(t)
objs = hvd.allgather_object({"rank": r})
root_obj = hvd.broadcast_object({"from": r}, root_rank=1)
m = tt.TransformerLM(64, 2, 4, 8, max_len=32, dtype=torch.float32,
                     attn_impl="flash", device="cpu")
m.load_state_dict(torch.load(sd_path))
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))
toks = torch.from_numpy(np.load(tok_path))
half = toks.shape[0] // 2
loss = tt.make_lm_train_step(m, opt)(toks[r * half:(r + 1) * half])
res["dp_loss"] = loss.reshape(1)
# Optimizer state only on the root (a restore there): the broadcast
# materializes it on rank 1.
lin = torch.nn.Linear(3, 2)
aw = torch.optim.AdamW(lin.parameters(), lr=0.1)
if r == 0:
    lin(torch.ones(4, 3)).sum().backward()
    aw.step()
hvd.broadcast_optimizer_state(aw, root_rank=0)
res["adam_state"] = torch.cat([
    torch.cat([st["step"].reshape(1), st["exp_avg"].reshape(-1),
               st["exp_avg_sq"].reshape(-1)])
    for st in (aw.state[p] for p in lin.parameters())])
try:
    tt.make_lm_train_step(m, torch.optim.SGD(m.parameters(), lr=0.1))(toks)
    errors.append("plain optimizer: no error")
except ValueError as e:
    errors.append(f"plain optimizer: ValueError {e}")
torch.save({"res": res, "errors": errors, "objs": objs,
            "root_obj": root_obj, "state": m.state_dict(),
            "rank": hvd.rank(), "size": hvd.size(),
            "local": (hvd.local_rank(), hvd.local_size())},
           f"{out}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def jax_params():
    m = jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                         num_heads=HEADS, head_dim=HEAD_DIM,
                         max_len=MAX_LEN, dtype=jnp.float32,
                         attn_impl="flash")
    return m, unbox(m.init(jax.random.PRNGKey(9),
                           jnp.zeros((1, 16), jnp.int32))["params"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params):
    """Run the two-rank gloo world once; {rank: what it saved}."""
    d = tmp_path_factory.mktemp("gloo")
    sd = params_from_jax(jax.tree.map(np.asarray, jax_params[1]))
    torch.save(sd, d / "sd.pt")
    np.save(d / "toks.npy", _batch())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(d / "store"), str(d),
         str(d / "sd.pt"), str(d / "toks.npy")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {r: torch.load(d / f"rank{r}.pt") for r in range(2)}


def test_membership(ranks):
    for r in range(2):
        assert ranks[r]["rank"] == r and ranks[r]["size"] == 2
        assert ranks[r]["local"] == (r, 2)


def test_allreduce_matches_jax(ranks, hvd):
    xs = [_x(r) for r in range(2)] * 4
    jsum = np.asarray(hvd.allreduce(hvd.per_rank(xs), average=False)) / 4
    javg = np.asarray(hvd.allreduce(hvd.per_rank(xs)))
    ints = [_xi(r) for r in range(2)] * 4
    jint = np.asarray(hvd.allreduce(hvd.per_rank(ints)))
    for r in range(2):
        res = ranks[r]["res"]
        np.testing.assert_allclose(res["sum"].numpy(), jsum, atol=1e-6)
        np.testing.assert_allclose(res["inplace"].numpy(), jsum, atol=1e-6)
        np.testing.assert_allclose(res["avg"].numpy(), javg, atol=1e-6)
        np.testing.assert_allclose(res["after_errors"].numpy(), javg,
                                   atol=1e-6)
        assert res["int_avg"].dtype == torch.int32
        np.testing.assert_array_equal(res["int_avg"].numpy(), jint)
        np.testing.assert_array_equal(res["int_sum"].numpy(),
                                      _xi(0) + _xi(1))


def test_variable_allgather_matches_jax(ranks, hvd):
    ys = [_y(r) for r in range(2)] * 4
    ref = np.asarray(hvd.allgather(hvd.per_rank(ys)))[:2 + 5]
    for r in range(2):
        got = ranks[r]["res"]["gather"].numpy()
        assert got.shape == (7, 3)
        np.testing.assert_array_equal(got, ref)


def test_broadcast_from_every_root_matches_jax(ranks, hvd):
    xs = [_x(r) for r in range(2)] * 4
    for root in (0, 1):
        ref = np.asarray(hvd.broadcast(hvd.per_rank(xs), root))
        for r in range(2):
            np.testing.assert_array_equal(
                ranks[r]["res"][f"bcast{root}"].numpy(), ref)


def test_grouped_and_fused_allreduce(ranks):
    x = _x(0) + _x(1)
    xi = (_xi(0) + _xi(1)).astype(np.float64)
    grouped = np.concatenate([x.ravel(), xi, 2 * x.ravel()])
    # fused: average over 2 ranks of [t, 2t, t[:1]] in buckets of <= 40 B
    fused = np.concatenate([x.ravel(), 2 * x.ravel(), x[:1].ravel()]) / 2
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["res"]["grouped"].numpy(),
                                   grouped, atol=1e-5)
        np.testing.assert_allclose(ranks[r]["res"]["fused"].numpy(),
                                   fused, atol=1e-6)


def test_mismatches_raise_on_every_rank(ranks, hvd):
    want = {"shape": "CollectiveMismatchError Mismatched shapes",
            "dtype": "CollectiveMismatchError Mismatched data types",
            "gather_dims": "CollectiveMismatchError Mismatched "
                           "non-first dimensions",
            "root": "CollectiveMismatchError Mismatched root ranks",
            "range": "ValueError broadcast root_rank 2 out of range",
            "plain optimizer": "ValueError make_lm_train_step at world "
                               "size > 1 needs a DistributedOptimizer"}
    for r in range(2):
        errs = dict(e.split(": ", 1) for e in ranks[r]["errors"])
        for name, prefix in want.items():
            assert errs[name].startswith(prefix), (r, name, errs[name])
    # the JAX package refuses the same per-rank disagreements
    x = _x(0)
    with pytest.raises(ValueError, match="Mismatched"):
        hvd.allreduce(hvd.per_rank([x, x.T] * 4))
    with pytest.raises(ValueError, match="Mismatched"):
        hvd.allreduce(hvd.per_rank([x, x.astype(np.float64)] * 4))


def test_objects_and_optimizer_state(ranks):
    for r in range(2):
        assert ranks[r]["objs"] == [{"rank": 0}, {"rank": 1}]
        assert ranks[r]["root_obj"] == {"from": 1}
    root = ranks[0]["res"]["adam_state"]
    assert root[0] == 1.0 and bool(root.abs().sum() > 1)
    torch.testing.assert_close(ranks[1]["res"]["adam_state"], root,
                               rtol=0, atol=0)


def test_data_parallel_step_matches_full_batch_and_jax(ranks, jax_params):
    """Each rank steps on half the batch through DistributedOptimizer;
    both ranks end with the parameters of one full-batch step, in the
    port (one process) and in the JAX package."""
    jm, params = jax_params
    toks = _batch()
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    step = jt.make_lm_train_step(jm, optax.sgd(LR), mesh, donate=False)
    jp, _, jloss = step(params, optax.sgd(LR).init(params),
                        jnp.asarray(toks))
    ref = params_from_jax(jax.tree.map(np.asarray, jp))
    m = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                         dtype=torch.float32, attn_impl="flash",
                         device="cpu")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    loss = tt.make_lm_train_step(m, torch.optim.SGD(m.parameters(),
                                                    lr=LR))(
        torch.from_numpy(toks))
    full = m.state_dict()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    dp_loss = np.mean([float(ranks[r]["res"]["dp_loss"][0])
                       for r in range(2)])
    for r in range(2):
        # the step reports the loss averaged over the ranks
        np.testing.assert_allclose(float(ranks[r]["res"]["dp_loss"][0]),
                                   dp_loss, rtol=1e-6)
        np.testing.assert_allclose(dp_loss, float(jloss), rtol=1e-5)
        for name, t in ranks[r]["state"].items():
            torch.testing.assert_close(t, full[name], atol=1e-5, rtol=0,
                                       msg=name)
            torch.testing.assert_close(t, ref[name], atol=1e-5, rtol=0,
                                       msg=name)


# -- world of one, in this process ------------------------------------------

@pytest.fixture
def hvd_world1():
    hvd_port.init(device="cpu")
    yield hvd_port
    hvd_port.shutdown()


def test_rank_before_init_and_after_shutdown_raises():
    with pytest.raises(hvd_port.NotInitializedError):
        hvd_port.rank()
    hvd_port.init(device="cpu")
    try:
        assert (hvd_port.rank(), hvd_port.size()) == (0, 1)
        assert hvd_port.init(device="cpu") == 0       # idempotent
    finally:
        hvd_port.shutdown()
    assert not hvd_port.is_initialized()
    with pytest.raises(hvd_port.NotInitializedError):
        hvd_port.size()


def test_plan_buckets_is_the_jax_plan():
    rs = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (), (7, 2), (1,), (10, 10), (2,)]
    dtypes = [np.float32, np.float32, np.float32, np.float16, np.float16,
              np.float32, np.int32]
    leaves = [np.asarray(rs.randn(*s)).astype(d)
              for s, d in zip(shapes, dtypes)]
    for threshold in (None, 0, 1, 20, 48, 100, 1000):
        assert plan_buckets([torch.from_numpy(np.asarray(a))
                             for a in leaves], threshold) == \
            jax_plan_buckets(leaves, threshold)


def test_fusion_knobs(monkeypatch):
    """HOROVOD_FUSION_THRESHOLD (bytes) wins over HVD_FUSION_MB."""
    cfg = tconfig.config
    try:
        monkeypatch.setenv("HVD_FUSION_MB", "0.5")
        assert cfg.refresh().fusion_threshold == 1 << 19
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1000")
        assert cfg.refresh().fusion_threshold == 1000
        monkeypatch.setenv("HOROVOD_ALLREDUCE_DTYPE", "bfloat16")
        assert cfg.refresh().allreduce_dtype == "bfloat16"
    finally:
        monkeypatch.undo()
        cfg.refresh()
    assert cfg.fusion_threshold == tconfig.DEFAULT_FUSION_THRESHOLD


def test_distributed_optimizer_options(hvd_world1):
    hvd = hvd_world1
    lin = torch.nn.Linear(3, 1)
    psgd = hvd.DistributedOptimizer(
        torch.optim.SGD(torch.nn.Linear(32, 48).parameters(), lr=0.1),
        compression="powersgd")
    assert sum("powersgd_q" in st for st in psgd.state.values()) == 1
    with pytest.raises(ValueError, match="average=False"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                 compression="powersgd", average=False)
    with pytest.raises(ValueError, match="compression"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                 compression="zip")
    # backward_passes_per_step=2: one update, on the mean of two passes
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 3)
                         .astype(np.float32))
    a, b = torch.nn.Linear(3, 1), torch.nn.Linear(3, 1)
    b.load_state_dict(a.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(a.parameters(), lr=0.1),
                                   backward_passes_per_step=2,
                                   compression="fp16")
    w0 = a.weight.detach().clone()
    for half in (x[:4], x[4:]):
        opt.zero_grad()
        (a(half) ** 2).mean().backward()
        opt.step()
        if half is x[:4]:
            assert torch.equal(a.weight, w0)   # no update after pass 1
    ref = torch.optim.SGD(b.parameters(), lr=0.1)
    (b(x) ** 2).mean().backward()
    ref.step()
    torch.testing.assert_close(a.weight, b.weight, atol=1e-6, rtol=0)


# -- the DistributedOptimizer contract of tests/test_torch_compat.py --------

def _load_compat_cases():
    """tests/test_torch_compat.py as a private module (not collected
    again from here); its TestCollectives / TestTraining cases take the
    framework module as ``hvd_torch`` and run against the port."""
    spec = importlib.util.spec_from_file_location(
        "_jax_torch_compat_cases", REPO / "tests" / "test_torch_compat.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_COMPAT = _load_compat_cases()
_COMPAT_CASES = [
    (cls, name, kw)
    for cls in ("TestCollectives", "TestTraining")
    for name in sorted(vars(getattr(_COMPAT, cls)))
    if name.startswith("test_")
    for kw in ([dict(dtype=d) for d in (torch.float32, torch.float64,
                                        torch.int32, torch.int64)]
               if name == "test_allreduce" else [{}])]


@pytest.mark.parametrize(
    "cls,name,kw", _COMPAT_CASES,
    ids=[f"{c}.{n}{'-' + str(k['dtype']) if k else ''}"
         for c, n, k in _COMPAT_CASES])
def test_torch_compat_contract_on_port(cls, name, kw, hvd_world1):
    getattr(getattr(_COMPAT, cls)(), name)(hvd_world1, **kw)
