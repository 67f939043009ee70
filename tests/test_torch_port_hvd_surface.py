"""PyTorch port: the rest of Horovod's data-parallel surface against the
JAX package — alltoall, reducescatter, the sparse `IndexedSlices` path
and word2vec, PowerSGD, the callbacks, the timeline (with the serving
scheduler's request spans) and `init`'s membership.

Two real ranks: one module fixture starts two processes that import
only the port (``python -c``) and join one gloo group through a
``file://`` store under the test's tmp_path, as
`tests/test_torch_port_dist.py` does. They run the collectives, the
error paths, a sparse word2vec step, PowerSGD's cross-rank mean, the
metric averager and a gradient tape, each under its own timeline, and
write what they saw to disk. The JAX references run here: the
collectives as `horovod_tpu.ops.collectives` under ``jax.shard_map``
over a 2-device mesh, everything else single-process.

Tolerances: float32 collectives within 1e-6 (one sum order), integers
exact; word2vec loss and gradients against the JAX model within 1e-5;
the two-rank word2vec and gradient-tape steps against the
single-process full batch within 1e-6 (two half-batch means averaged
where the full batch sums once); PowerSGD against the JAX compressor
within 1e-5 relative to each tensor's largest entry (float32 products
and a QR from another LAPACK), its Q up to each column's sign (QR
implementations may flip it); the warmup schedule within 1e-12.
"""

import json
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
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd_port
from horovod_tpu import callbacks as jax_callbacks
from horovod_tpu.models import transformer as jt
from horovod_tpu.models import word2vec as jw
from horovod_tpu.ops import collectives as C
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops.sparse import IndexedSlices as JaxSlices
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu.utils import timeline as jax_timeline
from horovod_tpu_torch.compat.from_jax import (params_from_jax,
                                               powersgd_state_from_jax,
                                               word2vec_params_from_jax)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models import word2vec as tw
from horovod_tpu_torch.ops import compression as tcomp
from horovod_tpu_torch.runtime import bootstrap
from horovod_tpu_torch.serving import ServingEngine
from horovod_tpu_torch.utils import timeline as port_timeline

REPO = pathlib.Path(__file__).resolve().parent.parent
V, D, B, K = 40, 8, 16, 3     # word2vec toy: vocab, dim, batch, negatives
W2V_LR = 0.5


def _a(r):
    return np.random.RandomState(10 + r).randn(4, 3).astype(np.float32)


def _ai(r):
    return np.random.RandomState(20 + r).randint(-50, 50, (6, 2)).astype(
        np.int32)


def _slices(r):
    """Rank r's sparse gradient; index 3 repeats within and across
    ranks."""
    vals = np.random.RandomState(30 + r).randn(3 - r, 4).astype(np.float32)
    return vals, np.asarray([[1, 3, 3], [3, 0]][r], np.int64)


def _w2v_batch():
    rs = np.random.RandomState(5)
    return (rs.randint(0, V, B), rs.randint(0, V, B),
            rs.randint(0, V, (B, K)))


def _low_rank_per_rank():
    """Two ranks' gradients with distinct coefficients on one rank-2
    basis (rank(mean) <= r, so PowerSGD's mean is exact)."""
    rs = np.random.RandomState(3)
    U, Vb = rs.randn(64, 2), rs.randn(2, 32)
    return np.stack([U @ np.diag(rs.randn(2)) @ Vb
                     for _ in range(2)]).astype(np.float32)


def _lin_x(r):
    return np.random.RandomState(60 + r).randn(5, 3).astype(np.float32)


# Each rank's program: only the port is imported. argv: rank, store
# file, output dir, word2vec state_dict path.
WORKER = r'''
import sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.word2vec import Word2Vec
from horovod_tpu_torch.obs import catalog
from horovod_tpu_torch.ops.compression import powersgd_allreduce
rank, store, out, w2v_path = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=2, init_method="file://" + store)
hvd.start_timeline(f"{out}/tl{r}.json")
res, errors = {}, []
a = torch.from_numpy(np.random.RandomState(10 + r).randn(4, 3).astype(np.float32))
ai = torch.from_numpy(np.random.RandomState(20 + r).randint(-50, 50, (6, 2)).astype(np.int32))
res["a2a_float32"] = hvd.alltoall(a)
res["a2a_int32"] = hvd.alltoall(ai)
res["rs_float32_sum"] = hvd.reducescatter(a)
res["rs_float32_avg"] = hvd.reducescatter(a, average=True)
res["rs_int32_sum"] = hvd.reducescatter(ai)
res["rs_int32_avg"] = hvd.reducescatter(ai, average=True)
vals = torch.from_numpy(np.random.RandomState(30 + r).randn(3 - r, 4).astype(np.float32))
idx = torch.tensor([[1, 3, 3], [3, 0]][r])
for avg in (True, False):
    s = hvd.allreduce(hvd.IndexedSlices(vals, idx, (5, 4)), average=avg)
    res[f"sparse_{avg}"] = s.to_dense()
for name, fn in [
        ("alltoall", lambda: hvd.alltoall(torch.zeros(3, 2))),
        ("reducescatter", lambda: hvd.reducescatter(torch.zeros(5, 2))),
        ("shape", lambda: hvd.alltoall(torch.zeros(4, 2 + r))),
        ("dtype", lambda: hvd.reducescatter(
            torch.zeros(4, 2, dtype=torch.float32 if r == 0 else torch.float64)))]:
    try:
        fn()
        errors.append(f"{name}: no error")
    except hvd.CollectiveMismatchError as e:
        errors.append(f"{name}: CollectiveMismatchError {e}")
    except ValueError as e:
        errors.append(f"{name}: ValueError {e}")
res["after_errors"] = hvd.alltoall(a)
# word2vec: half the batch per rank, sparse embedding gradient
m = Word2Vec(40, 8, device="cpu")
m.load_state_dict(torch.load(w2v_path))
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.5))
rs = np.random.RandomState(5)
c, ctx, neg = (torch.from_numpy(x) for x in (
    rs.randint(0, 40, 16), rs.randint(0, 40, 16), rs.randint(0, 40, (16, 3))))
h = slice(8 * r, 8 * (r + 1))
res["w2v_loss"] = hvd.make_train_step(m, opt)(c[h], ctx[h], neg[h]).reshape(1)
res["w2v_sparse_grad"] = torch.tensor([m.embeddings.grad.is_sparse])
w2v_state = m.state_dict()
# PowerSGD: each rank its own gradient on a shared rank-2 basis
rs = np.random.RandomState(3)
U, Vb = rs.randn(64, 2), rs.randn(2, 32)
per = np.stack([U @ np.diag(rs.randn(2)) @ Vb for _ in range(2)]).astype(np.float32)
tx = powersgd_allreduce(rank=4)
st = tx.init([torch.zeros(64, 32)])
res["psgd_mean"] = tx.update([torch.from_numpy(per[r])], st)[0][0]
metrics = hvd.callbacks.MetricAverager()({"loss": 1.0 + r, "acc": 0.25 * r})
# a gradient tape and a plain optimizer through make_train_step
torch.manual_seed(0)
lin = torch.nn.Linear(3, 2)
x = torch.from_numpy(np.random.RandomState(60 + r).randn(5, 3).astype(np.float32))
loss, grads = hvd.DistributedGradientTape(
    lambda xb: (lin(xb) ** 2).mean(), lin.parameters())(x)
res["tape"] = torch.cat([g.reshape(-1) for g in grads])
hvd.make_train_step(lambda xb: (lin(xb) ** 2).mean(),
                    torch.optim.SGD(lin.parameters(), lr=0.1))(x)
res["plain_step"] = torch.cat([p.detach().reshape(-1) for p in lin.parameters()])
dispatched = {op: catalog.collective_metrics()["dispatched"].value(op=op)
              for op in ("alltoall", "reducescatter", "allgather", "allreduce")}
hvd.stop_timeline()
torch.save({"res": res, "errors": errors, "w2v_state": w2v_state,
            "metrics": metrics, "dispatched": dispatched},
           f"{out}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def jax_w2v():
    model = jw.Word2Vec(vocab_size=V, embed_dim=D)
    c, ctx, neg = (jnp.asarray(x) for x in _w2v_batch())
    params = model.init(jax.random.PRNGKey(3), c, ctx, neg)["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_w2v):
    """Run the two-rank gloo world once; {rank: what it saved}."""
    d = tmp_path_factory.mktemp("gloo_surface")
    torch.save(word2vec_params_from_jax(jax_w2v[1]), d / "w2v.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(d / "store"), str(d),
         str(d / "w2v.pt")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = {r: torch.load(d / f"rank{r}.pt") for r in range(2)}
    for r in range(2):
        out[r]["timeline"] = json.loads((d / f"tl{r}.json").read_text())
    return out


def _two_rank_jax(fn, xs):
    """``fn`` (a per-rank JAX collective) under shard_map over a
    2-device mesh; row r of the result is rank r's output."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    f = jax.jit(jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                              in_specs=P("data"), out_specs=P("data"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(np.stack(xs))))


# -- alltoall and reducescatter ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_alltoall_matches_jax(ranks, dtype):
    xs = [(_a if dtype == "float32" else _ai)(r) for r in range(2)]
    ref = _two_rank_jax(C.alltoall, xs)
    for r in range(2):
        got = ranks[r]["res"][f"a2a_{dtype}"]
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.numpy(), ref[r])
        np.testing.assert_array_equal(
            ranks[r]["res"]["after_errors"].numpy(),
            _two_rank_jax(C.alltoall, [_a(q) for q in range(2)])[r])


@pytest.mark.parametrize("dtype,mode", [
    ("float32", "sum"), ("float32", "avg"), ("int32", "sum"),
    ("int32", "avg")])
def test_reducescatter_matches_jax(ranks, dtype, mode):
    """Sums and float means as the JAX collective computes them; an
    integer mean floor-divides the JAX sum and keeps int32, as the JAX
    package's multi-process reducescatter does."""
    xs = [(_a if dtype == "float32" else _ai)(r) for r in range(2)]
    if dtype == "int32" and mode == "avg":
        ref = _two_rank_jax(C.reducescatter, xs) // 2
    else:
        ref = _two_rank_jax(
            lambda x: C.reducescatter(x, average=mode == "avg"), xs)
    for r in range(2):
        got = ranks[r]["res"][f"rs_{dtype}_{mode}"]
        assert got.dtype == getattr(torch, dtype)
        if dtype == "int32":
            np.testing.assert_array_equal(got.numpy(), ref[r])
        else:
            np.testing.assert_allclose(got.numpy(), ref[r], atol=1e-6)


@pytest.mark.parametrize("op", ["alltoall", "reducescatter"])
def test_not_divisible_raises_jax_message(ranks, hvd, op):
    rows = 3 if op == "alltoall" else 5
    with pytest.raises(ValueError) as jerr:
        getattr(hvd, op)(hvd.per_rank([np.zeros((rows, 2))] * hvd.size()))
    want = str(jerr.value).replace(f"world size {hvd.size()}",
                                   "world size 2")
    for r in range(2):
        errs = dict(e.split(": ", 1) for e in ranks[r]["errors"])
        assert errs[op] == f"ValueError {want}", (r, errs[op])


def test_mismatches_raise_on_every_rank(ranks, hvd):
    for r in range(2):
        errs = dict(e.split(": ", 1) for e in ranks[r]["errors"])
        assert errs["shape"].startswith(
            "CollectiveMismatchError Mismatched shapes"), errs["shape"]
        assert errs["dtype"].startswith(
            "CollectiveMismatchError Mismatched data types"), errs["dtype"]
    z = np.zeros((8, 2))
    with pytest.raises(ValueError, match="Mismatched"):
        hvd.alltoall(hvd.per_rank([z, np.zeros((8, 3))] * 4))
    with pytest.raises(ValueError, match="Mismatched"):
        hvd.reducescatter(hvd.per_rank([z, z.astype(np.float32)] * 4))


def test_eager_ops_hooks(ranks):
    """Each collective that reached torch.distributed counted once per
    call; every op's timeline process holds NEGOTIATE, the op and its
    activity, balanced."""
    for r in range(2):
        d = ranks[r]["dispatched"]
        assert d["alltoall"] == 3 and d["reducescatter"] == 4, d
        assert d["allgather"] >= 4 and d["allreduce"] >= 1, d
        ev = ranks[r]["timeline"]
        names = {e["args"]["name"]: e["pid"] for e in ev
                 if e.get("ph") == "M"}
        pid = names["HorovodAlltoall_4x3_float32"]
        seq = [(e["ph"], e["name"]) for e in ev if e.get("pid") == pid
               and e.get("ph") in "BE"]
        assert seq[:5] == [("B", "NEGOTIATE"), ("E", "NEGOTIATE"),
                           ("B", "HorovodAlltoall_4x3_float32"),
                           ("B", "ALLTOALL"), ("E", "")], seq
        assert "HorovodReducescatter_6x2_int32" in names
        assert "train_step" in names
        _assert_balanced(ev)


# -- the sparse path and word2vec -------------------------------------------

@pytest.mark.parametrize("average", [True, False])
def test_sparse_allreduce_matches_jax(ranks, hvd, average):
    """Indices repeat within and across ranks; the dense result of the
    two allgathers against JAX's `to_dense` of the gathered slices."""
    parts = [_slices(r) for r in range(2)]
    vals = np.asarray(hvd.allgather(hvd.per_rank(
        [p[0] for p in parts] * 4)))[:5]
    idx = np.asarray(hvd.allgather(hvd.per_rank(
        [p[1] for p in parts] * 4)))[:5]
    if average:
        vals = vals / 2
    ref = np.asarray(JaxSlices(jnp.asarray(vals), jnp.asarray(idx),
                               (5, 4)).to_dense())
    for r in range(2):
        np.testing.assert_allclose(
            ranks[r]["res"][f"sparse_{average}"].numpy(), ref, atol=1e-6)


def test_indexed_slices_to_dense_and_coo_round_trip():
    vals, idx = _slices(0)
    ts = hvd_port.IndexedSlices(torch.from_numpy(vals),
                                torch.from_numpy(idx), (5, 4))
    ref = np.asarray(JaxSlices(jnp.asarray(vals), jnp.asarray(idx),
                               (5, 4)).to_dense())
    np.testing.assert_allclose(ts.to_dense().numpy(), ref, atol=1e-7)
    back = hvd_port.IndexedSlices.from_sparse(ts.to_sparse())
    assert back.indices.tolist() == [1, 3]      # coalesced: 3 summed
    np.testing.assert_allclose(back.to_dense().numpy(), ref, atol=1e-7)
    with pytest.raises(ValueError, match="dense_shape"):
        hvd_port.IndexedSlices(ts.values, ts.indices).to_dense()


def test_embedding_grad_as_slices_matches_jax():
    rs = np.random.RandomState(4)
    grad = rs.randn(V, D).astype(np.float32)
    touched = rs.randint(0, V, (6, 3))
    ref = jw.embedding_grad_as_slices(jnp.asarray(grad),
                                      jnp.asarray(touched))
    got = tw.embedding_grad_as_slices(torch.from_numpy(grad),
                                      torch.from_numpy(touched))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(ref.values))
    assert got.dense_shape == ref.dense_shape


def _port_w2v(params, sparse=True):
    m = tw.Word2Vec(V, D, device="cpu", sparse=sparse)
    m.load_state_dict(word2vec_params_from_jax(params))
    return m


def test_word2vec_loss_and_grads_match_jax(jax_w2v):
    model, params = jax_w2v
    batch = _w2v_batch()
    loss, grads = jax.value_and_grad(
        lambda p: model.apply({"params": p},
                              *(jnp.asarray(x) for x in batch)))(params)
    m = _port_w2v(params)
    tl = m(*(torch.from_numpy(x) for x in batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(loss), rtol=1e-5)
    assert m.embeddings.grad.is_sparse
    np.testing.assert_allclose(m.embeddings.grad.to_dense().numpy(),
                               np.asarray(grads["embeddings"]), atol=1e-5)
    np.testing.assert_allclose(m.nce_weights.grad.numpy(),
                               np.asarray(grads["nce_weights"]), atol=1e-5)
    with pytest.raises(KeyError, match="Word2Vec"):
        word2vec_params_from_jax({"embeddings": params["embeddings"]})


def test_word2vec_two_rank_sparse_step_matches_full_batch(ranks, jax_w2v):
    """Each rank steps SGD on half the batch with a sparse embedding
    gradient; both end with the parameters of one full-batch step, in
    the port (one process, dense gradients) and in the JAX package."""
    model, params = jax_w2v
    batch = _w2v_batch()
    m = _port_w2v(params, sparse=False)
    opt = torch.optim.SGD(m.parameters(), lr=W2V_LR)
    loss = m(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    opt.step()
    jgrads = jax.grad(lambda p: model.apply(
        {"params": p}, *(jnp.asarray(x) for x in batch)))(params)
    jnew = jax.tree.map(lambda p, g: np.asarray(p - W2V_LR * g), params,
                        jgrads)
    for r in range(2):
        assert bool(ranks[r]["res"]["w2v_sparse_grad"][0])
        np.testing.assert_allclose(
            float(ranks[r]["res"]["w2v_loss"][0]), float(loss.detach()),
            rtol=1e-6)
        for name, t in ranks[r]["w2v_state"].items():
            np.testing.assert_allclose(t.numpy(),
                                       getattr(m, name).detach().numpy(),
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(t.numpy(), jnew[name], atol=1e-5,
                                       err_msg=name)


def test_gradient_tape_and_plain_optimizer_step_two_ranks(ranks):
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    x = torch.from_numpy(np.concatenate([_lin_x(0), _lin_x(1)]))
    grads = torch.autograd.grad((lin(x) ** 2).mean(),
                                list(lin.parameters()))
    with torch.no_grad():
        stepped = torch.cat([(p - 0.1 * g).reshape(-1)
                             for p, g in zip(lin.parameters(), grads)])
    want = torch.cat([g.reshape(-1) for g in grads])
    for r in range(2):
        torch.testing.assert_close(ranks[r]["res"]["tape"], want,
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(ranks[r]["res"]["plain_step"], stepped,
                                   atol=1e-6, rtol=0)


def test_sparse_gradient_cannot_accumulate():
    m = tw.Word2Vec(V, D, device="cpu").init_weights(0)
    opt = hvd_port.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1), backward_passes_per_step=2)
    m(*(torch.from_numpy(x) for x in _w2v_batch())).backward()
    with pytest.raises(NotImplementedError,
                       match="does not support sparse IndexedSlices"):
        opt.step()


# -- PowerSGD ---------------------------------------------------------------

PSGD_SHAPES = {"w": (48, 32), "b": (32,), "t": (2, 8, 12), "tiny": (3, 2)}
PSGD_ORDER = sorted(PSGD_SHAPES)      # the JAX flatten order


def _psgd_grads(step):
    rs = np.random.RandomState(40 + step)
    return {k: rs.randn(*PSGD_SHAPES[k]).astype(np.float32)
            for k in PSGD_ORDER}


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _close_up_to_column_sign(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    signs = np.sign(np.sum(got * ref, axis=0))
    _close(got * signs, ref)


def _port_state(jstate):
    conv = [None if q is None else torch.from_numpy(np.array(q))
            for q in jstate.qs]
    errs = [None if e is None else torch.from_numpy(np.array(e))
            for e in jstate.errs]
    return tcomp.PowerSGDState(tuple(conv), tuple(errs), 17)


def test_powersgd_matches_jax_three_steps():
    jtx = jcomp.powersgd_allreduce(rank=2)
    jstate = jtx.init({k: jnp.zeros(s) for k, s in PSGD_SHAPES.items()})
    assert [q is not None for q in jstate.qs] == [False, True, False, True]
    ptx = tcomp.powersgd_allreduce(rank=2)
    pstate = _port_state(jstate)
    for step in range(3):
        g = _psgd_grads(step)
        jout, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate)
        pout, pstate = ptx.update([torch.from_numpy(g[k])
                                   for k in PSGD_ORDER], pstate)
        for i, k in enumerate(PSGD_ORDER):
            _close(pout[i].numpy(), jout[k])
            if jstate.qs[i] is not None:
                _close(pstate.errs[i].numpy(), jstate.errs[i])
                _close_up_to_column_sign(pstate.qs[i].numpy(),
                                         jstate.qs[i])


class _Params(torch.nn.Module):
    """The PowerSGD toy as a module, registered in another order than
    the JAX flatten order (`powersgd_state_from_jax` must sort)."""

    def __init__(self, values):
        super().__init__()
        for k in ("w", "tiny", "b", "t"):
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(
                np.array(values[k]))))


def test_distributed_optimizer_powersgd_matches_jax(hvd):
    """Three SGD steps through `DistributedOptimizer(compression=
    "powersgd")` in both packages from the same parameters and the JAX
    compressor's state carried across: parameters and error buffers
    agree, the Qs up to column sign."""
    rs = np.random.RandomState(2)
    params = {k: rs.randn(*s).astype(np.float32)
              for k, s in PSGD_SHAPES.items()}
    jtx = hvd.DistributedOptimizer(optax.sgd(0.1), compression="powersgd",
                                   compression_rank=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    mod = _Params(params)
    opt = hvd_port.DistributedOptimizer(torch.optim.SGD(mod.parameters(),
                                                        lr=0.1),
                                        compression="powersgd",
                                        compression_rank=2)
    carried = powersgd_state_from_jax(
        jax.tree.map(np.asarray, jstate[0]), mod)
    assert sorted(n for n, p in mod.named_parameters()
                  if p in carried) == ["t", "w"]
    for p, entry in carried.items():
        opt.state[p].update(entry)
    for step in range(3):
        g = _psgd_grads(step)
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in mod.named_parameters():
            p.grad = torch.from_numpy(g[name])
        opt.step()
    for i, name in enumerate(PSGD_ORDER):
        p = getattr(mod, name)
        _close(p.detach().numpy(), jp[name])
        if jstate[0].qs[i] is not None:
            _close(opt.state[p]["powersgd_err"].numpy(), jstate[0].errs[i])
            _close_up_to_column_sign(opt.state[p]["powersgd_q"].numpy(),
                                     jstate[0].qs[i])


COMPRESSIBLE_CASES = [
    ((48, 32), "float32", 4), ((32,), "float32", 4), ((3, 2), "float32", 4),
    ((8, 8), "int32", 1), ((2, 8, 12), "float32", 2),
    ((2, 8, 12), "float32", 4), ((64, 8), "float32", 3),
    ((8, 8), "float16", 1)]


@pytest.mark.parametrize("shape,dtype,rank", COMPRESSIBLE_CASES,
                         ids=[f"{s}-{d}-r{r}" for s, d, r in
                              COMPRESSIBLE_CASES])
def test_compressible_rule_matches_jax(shape, dtype, rank):
    want = jcomp._compressible(jnp.zeros(shape, dtype), rank)
    assert tcomp._compressible(torch.zeros(shape,
                                           dtype=getattr(torch, dtype)),
                               rank) == want
    if len(shape) >= 2:
        assert not tcomp._compressible(
            torch.zeros(shape, dtype=getattr(torch, dtype)).to_sparse(),
            rank)


def test_low_rank_gradient_reconstructs_exactly():
    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(48, 2) @ rs.randn(2, 32)).astype(
        np.float32))
    b = torch.from_numpy(rs.randn(32).astype(np.float32))
    tx = tcomp.powersgd_allreduce(rank=4)
    out, state = tx.update([w, b], tx.init([w, b]))
    torch.testing.assert_close(out[0], w, rtol=1e-3, atol=1e-3)
    assert torch.equal(out[1], b)
    assert float(state.errs[0].abs().max()) < 1e-2 and state.errs[1] is None


def test_error_feedback_telescopes():
    """The sum of applied updates over k identical-gradient steps
    approaches k x the gradient; the relative error decays like 1/k."""
    rs = np.random.RandomState(1)
    low = torch.from_numpy((rs.randn(48, 2) @ rs.randn(2, 32)
                            + 0.01 * rs.randn(48, 32)).astype(np.float32))
    dense = torch.from_numpy(rs.randn(48, 32).astype(np.float32))
    tx = tcomp.powersgd_allreduce(rank=4)

    def rel_after(k, g):
        state, applied = tx.init([g]), torch.zeros_like(g)
        for _ in range(k):
            out, state = tx.update([g], state)
            applied += out[0]
        return float((applied - k * g).norm() / (k * g).norm())

    assert rel_after(20, low) < 0.02
    r15, r60 = rel_after(15, dense), rel_after(60, dense)
    assert r60 < r15 / 2, (r15, r60)


def test_sparse_gradient_at_compressible_slot_goes_exact():
    tx = tcomp.powersgd_allreduce(rank=4)
    state = tx.init([torch.zeros(64, 32)])
    assert state.qs[0] is not None
    coo = torch.zeros(64, 32)
    coo[3] = 1.0
    for g in (coo.to_sparse(),
              hvd_port.IndexedSlices(torch.ones(2, 32), torch.tensor([1, 3]),
                                     (64, 32))):
        out, state2 = tx.update([g], state)
        assert out[0] is g                 # exact path, world size 1
        assert state2.qs[0] is state.qs[0]  # frozen, not dropped


def test_powersgd_error_texts_match_jax(hvd):
    jtx = jcomp.powersgd_allreduce(rank=2)
    jstate = jtx.init({"a": jnp.zeros((48, 32)), "b": jnp.zeros(3)})
    with pytest.raises(ValueError) as jerr:
        jtx.update({"a": jnp.zeros((48, 32))}, jstate)
    tx = tcomp.powersgd_allreduce(rank=2)
    with pytest.raises(ValueError) as terr:
        tx.update([torch.zeros(48, 32)],
                  tx.init([torch.zeros(48, 32), torch.zeros(3)]))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        hvd.DistributedOptimizer(optax.sgd(0.1), compression="powersgd",
                                 average=False)
    with pytest.raises(ValueError) as terr:
        hvd_port.DistributedOptimizer(
            torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), lr=0.1),
            compression="powersgd", average=False)
    assert str(terr.value) == str(jerr.value)


def test_powersgd_cross_replica_mean_two_ranks(ranks):
    """Two ranks with different gradients on one rank-2 basis: both get
    the exact mean (a sign or averaging fault in either factor
    allreduce would show)."""
    mean = _low_rank_per_rank().mean(0)
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["res"]["psgd_mean"].numpy(),
                                   mean, atol=1e-3)


def test_powersgd_state_lives_in_the_optimizer_state():
    """AdamW (which initializes a parameter's state when it finds it
    empty) steps with the PowerSGD entries beside its own; the state
    dict carries them and loading it keeps them float32 for a bf16
    parameter; the LM train step runs on it."""
    lin = torch.nn.Linear(32, 48).to(torch.bfloat16)
    opt = hvd_port.DistributedOptimizer(
        torch.optim.AdamW(lin.parameters(), lr=1e-3),
        compression="powersgd", compression_rank=2)
    w = lin.weight
    assert set(opt.state[w]) == {"powersgd_q", "powersgd_err"}
    assert lin.bias not in opt.state
    q0 = opt.state[w]["powersgd_q"].clone()
    torch.testing.assert_close(q0, tcomp.initial_q(32, 2, 17, 0))
    x = torch.randn(4, 32, dtype=torch.bfloat16)
    for _ in range(2):
        opt.zero_grad()
        lin(x).float().pow(2).mean().backward()
        opt.step()
    assert set(opt.state[w]) == {"step", "exp_avg", "exp_avg_sq",
                                 "powersgd_q", "powersgd_err"}
    assert not torch.equal(opt.state[w]["powersgd_q"], q0)
    sd = opt.state_dict()
    opt2 = hvd_port.DistributedOptimizer(
        torch.optim.AdamW(lin.parameters(), lr=1e-3),
        compression="powersgd", compression_rank=2)
    opt2.load_state_dict(sd)
    for k in ("powersgd_q", "powersgd_err"):
        assert opt2.state[w][k].dtype == torch.float32
        torch.testing.assert_close(opt2.state[w][k], opt.state[w][k],
                                   rtol=0, atol=0)
    assert opt2.state[w]["exp_avg"].dtype == torch.bfloat16
    opt2.zero_grad()
    lin(x).float().pow(2).mean().backward()
    opt2.step()


# -- callbacks --------------------------------------------------------------

@pytest.mark.parametrize("warmup,spe,size", [(5, 1, 8), (3, 10, 4),
                                             (2, 7, 1)])
def test_warmup_schedule_matches_jax(hvd, warmup, spe, size):
    jsched = jax_callbacks.lr_warmup_schedule(0.1, warmup, spe, size=size)
    tsched = hvd_port.callbacks.lr_warmup_schedule(0.1, warmup, spe,
                                                   size=size)
    for step in range(0, warmup * spe + 5):
        assert abs(tsched(step) - float(jsched(step))) < 1e-12, step
    assert abs(tsched(warmup * spe) - 0.1 * size) < 1e-12


def test_metric_averager_two_ranks(ranks):
    for r in range(2):
        assert ranks[r]["metrics"] == {"loss": 1.5, "acc": 0.125}


def test_callback_aliases_and_later_slices():
    hvd_port.init(device="cpu")
    try:
        lin = torch.nn.Linear(2, 2)
        hvd_port.callbacks.broadcast_on_train_begin(lin.state_dict())
        hvd_port.broadcast_global_variables(lin.state_dict())
        assert hvd_port.callbacks.MetricAverager()({"a": 2.0}) == {"a": 2.0}
        # Ported since: the callback over the port's ElasticTrainer
        # (its behaviour is held in tests/test_torch_port_resume.py).
        cb = hvd_port.callbacks.ResilientCheckpointCallback(
            "/nonexistent", install_signals=False)
        assert cb.resume(like={"w": torch.zeros(1)})[1] == 0
        assert not cb.should_stop and cb.rollbacks == 0
        cb.close()
        batch = hvd_port.make_global_batch(
            {"x": np.ones((2, 3), np.float32), "y": [np.arange(2)]})
        assert isinstance(batch["x"], torch.Tensor)
        assert batch["y"][0].tolist() == [0, 1]
    finally:
        hvd_port.shutdown()


# -- the timeline -----------------------------------------------------------

def _assert_balanced(events):
    """Every B has its E on the same pid, in stack order."""
    stacks = {}
    for e in events:
        if e.get("ph") == "B":
            stacks.setdefault(e["pid"], []).append(e["name"])
        elif e.get("ph") == "E":
            assert stacks.get(e["pid"]), e
            opened = stacks[e["pid"]].pop()
            assert e["name"] in (opened, ""), (opened, e)
    assert not any(stacks.values()), stacks


def _drive(tl):
    tl.record("grad_w", "NEGOTIATING")
    tl.record("grad_w", "TOP_LEVEL", "ALLREDUCE")
    tl.record("grad_b", "TOP_LEVEL")
    tl.mark("grad_w", "CHECK")
    tl.record("grad_w", "DONE")
    tl.record("grad_b", "DONE")
    tl.begin_span("request:7", "QUEUE", args={"trace_id": "abc"})
    tl.end_span("request:7", "QUEUE")
    tl.record("grad_w", "NEGOTIATING")
    tl.record("grad_w", "DONE")
    tl.close()


def test_timeline_writer_matches_jax(tmp_path):
    jax_tl = jax_timeline.Timeline(str(tmp_path / "jax.json"))
    port_tl = port_timeline.Timeline(str(tmp_path / "port.json"))
    _drive(jax_tl)
    _drive(port_tl)

    def events(name):
        ev = json.loads((tmp_path / name).read_text())
        return [{k: v for k, v in e.items() if k != "ts"} for e in ev]

    got = events("port.json")
    assert got == events("jax.json")
    assert got[0] == {"name": "process_name", "ph": "M", "pid": 0,
                      "args": {"name": "grad_w"}}
    _assert_balanced(got)


def test_timeline_unwritable_path_warns_and_disables(tmp_path, capsys):
    bad = str(tmp_path / "missing_dir" / "tl.json")
    tl = port_timeline.Timeline(bad)
    jax_timeline.Timeline(bad)
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "Timeline" in ln]
    assert len(lines) == 2 and lines[0] == lines[1], err
    tl.record("x", "NEGOTIATING")
    tl.close()
    assert not os.path.exists(bad)


def test_timeline_env_opens_at_init_and_eager_ops_record(tmp_path,
                                                         monkeypatch):
    """``HOROVOD_TIMELINE`` opens the file at init and shutdown closes
    it; at world size 1 each eager op still records its phases, and the
    stall monitor's bracket is left empty."""
    path = tmp_path / "tl.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd_port.init(device="cpu")
    try:
        from horovod_tpu_torch.runtime import state as tstate
        st = tstate.global_state()
        assert st.timeline is not None and st.stall_monitor is not None
        x = torch.ones(2, 3)
        hvd_port.allreduce(x, name="g.w")
        hvd_port.alltoall(x)
        hvd_port.reducescatter(x)
        hvd_port.allgather(x)
        hvd_port.broadcast(x, 0)
        assert st.stall_monitor._pending == {}
        monitor = st.stall_monitor
    finally:
        hvd_port.shutdown()
    assert monitor._stopped
    ev = json.loads(path.read_text())
    names = {e["args"]["name"] for e in ev if e.get("ph") == "M"}
    assert names == {"g_w", "HorovodAlltoall_2x3_float32",
                     "HorovodReducescatter_2x3_float32",
                     "HorovodAllgather_vx3_float32",
                     "HorovodBroadcast_2x3_float32"}
    assert {e["name"] for e in ev if e.get("ph") == "B"} >= {
        "NEGOTIATE", "ALLREDUCE", "ALLTOALL", "REDUCESCATTER",
        "ALLGATHER", "BCAST"}
    _assert_balanced(ev)


@pytest.fixture(scope="module")
def tiny_lm():
    jm = jt.TransformerLM(vocab_size=64, num_layers=2, num_heads=4,
                          head_dim=8, max_len=32, dtype=jnp.float32)
    params = unbox(jm.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))["params"])
    m = tt.TransformerLM(64, 2, 4, 8, max_len=32, dtype=torch.float32,
                         device="cpu")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return m


def test_scheduler_request_spans(tiny_lm, tmp_path):
    """Two requests through the engine under `start_timeline`: each is
    a ``request:<id>`` process with QUEUE, PREFILL and DECODE spans in
    that order, balanced, its trace_id in each begin's args, and its
    outcome marked."""
    hvd_port.init(device="cpu")
    try:
        hvd_port.start_timeline(str(tmp_path / "tl.json"))
        eng = ServingEngine(tiny_lm, num_slots=2)
        try:
            hs = [eng.submit(np.arange(1, 6 + i), 4) for i in range(2)]
            outs = [h.result(timeout=120) for h in hs]
        finally:
            eng.shutdown()
        hvd_port.stop_timeline()
    finally:
        hvd_port.shutdown()
    ev = json.loads((tmp_path / "tl.json").read_text())
    _assert_balanced(ev)
    procs = {e["args"]["name"]: e["pid"] for e in ev if e.get("ph") == "M"}
    for out in outs:
        pid = procs[f"request:{out.request_id}"]
        mine = [e for e in ev if e.get("pid") == pid]
        begins = [e for e in mine if e["ph"] == "B"]
        assert [e["name"] for e in begins] == ["QUEUE", "PREFILL",
                                               "DECODE"]
        assert all(e["args"] == {"trace_id": out.trace_id}
                   for e in begins)
        assert [e["name"] for e in mine if e["ph"] == "X"] == [
            out.finish_reason.upper()]


# -- membership and platform ------------------------------------------------

@pytest.mark.parametrize("case", ["explicit", "launcher", "torchrun",
                                  "alone"])
def test_membership_precedence(monkeypatch, case):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if case in ("explicit", "launcher"):
        monkeypatch.setenv("HOROVOD_RANK", "3")
        monkeypatch.setenv("HOROVOD_SIZE", "4")
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
        monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "2")
    if case != "alone":
        monkeypatch.setenv("RANK", "5")
        monkeypatch.setenv("WORLD_SIZE", "6")
        monkeypatch.setenv("LOCAL_RANK", "0")
    want = {"explicit": (1, 2, 1, 2), "launcher": (3, 4, 1, 2),
            "torchrun": (5, 6, 0, 6), "alone": (0, 1, 0, 1)}[case]
    args = (1, 2) if case == "explicit" else (None, None)
    assert bootstrap._membership(*args) == want


def test_platform_picks_the_default_device(monkeypatch):
    monkeypatch.setenv("HOROVOD_PLATFORM", "cpu")
    hvd_port.init()
    try:
        from horovod_tpu_torch.runtime import state as tstate
        assert tstate.global_state().devices == [torch.device("cpu")]
        assert torch.distributed.get_backend() == "gloo"
    finally:
        hvd_port.shutdown()
    monkeypatch.setenv("HOROVOD_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="HOROVOD_PLATFORM"):
        hvd_port.init()
    monkeypatch.delenv("HOROVOD_PLATFORM")
    if not torch.cuda.is_available():
        # Entry points default to the card and never fall back.
        with pytest.raises(RuntimeError, match="without a card"):
            hvd_port.init()
    assert not hvd_port.is_initialized()
