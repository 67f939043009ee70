"""PyTorch port: the mesh, the SPMD collectives, ring and Ulysses
sequence parallelism and the LM train step over a (data, seq) mesh,
against the JAX package.

One module fixture starts ONE world of four gloo ranks that import only
the port (``python -c``; the JAX package must stay out of them). They
join through a ``file://`` store under the test's tmp_path, build a
(data=2, seq=2) mesh (and a seq=4 one for the fully masked rotation),
run every case on their own blocks and write what they saw to disk.
The JAX references run here, on the first four devices of the test
process's 8-device CPU mesh laid out the same way, their Pallas kernels
in interpret mode (as `tests/test_parallel.py` runs them). Rank r of the
port's (data=2, seq=2) mesh holds data block r // 2 and seq block r % 2,
as device r of the JAX mesh does.

Tolerances (float32 on both sides, the same algorithms; differences are
summation order): attention outputs and gradients, the sharded LM
forward and the SGD step within 1e-5; collectives exact for integers
and 1e-6 for float sums. The bf16 flagship is held to a finite, falling
loss, as the JAX package's own test holds it.
"""

import functools
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
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops.flash_attention import flash_attention as j_flash
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import sequence as jseq
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sequence as tseq

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
B, S, H, HKV, D, WINDOW = 2, 16, 4, 2, 8, 8
VOCAB, LAYERS, MAX_LEN, LR = 64, 2, 32, 0.1

# name -> (impl, causal, window); "ring" (the plain online softmax) takes
# K/V at the query head count, as the model repeats them for it.
MASKS = {"full": (False, None), "window": (True, WINDOW)}
ATTN_CASES = {f"{impl}-{m}": (impl, c, w)
              for impl in ("ring", "ring_flash", "ulysses", "ulysses_flash")
              for m, (c, w) in MASKS.items()}
# The sharded LM forward: (attn_impl, pos_emb, kv heads).
LM_CASES = {"ring-learned": ("ring", "learned", None),
            "ulysses-learned": ("ulysses", "learned", None),
            "ring_flash-rope-gqa": ("ring_flash", "rope", HKV),
            "ulysses_flash-rope-gqa": ("ulysses_flash", "rope", HKV)}
# The seq=4 ring: S_l = 4 and window 4, so rank 3's rotation 2 (the
# block of rank 1) is masked whole.
MASKED = dict(S=16, window=4)


def _qkv(seed, b=B, s=S, h=H, hkv=HKV):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, h, D).astype(np.float32),
            rs.randn(b, s, hkv, D).astype(np.float32),
            rs.randn(b, s, hkv, D).astype(np.float32),
            rs.randn(b, s, h, D).astype(np.float32))    # cotangent


def _x(r):
    return np.random.RandomState(100 + r).randn(4, 3).astype(np.float32)


def _xi(r):
    return np.random.RandomState(300 + r).randint(
        -100, 100, (4,)).astype(np.int8)


def _xv(r):
    """allgatherv input: [3, 2] padded, valid rows r % 2 + 1."""
    return np.random.RandomState(400 + r).randn(3, 2).astype(np.float32)


def _tokens(b=B, s=S, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s))


# Each rank's program: only the port is imported. argv: rank, store,
# work directory (inputs in, rank<r>.pt out).
WORKER = r'''
import sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import mesh as M, sequence as sq
rank, store, work = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=4, init_method="file://" + store)
inp = dict(np.load(f"{work}/inputs.npz"))
spec = torch.load(f"{work}/spec.pt")
res, errors = {}, []
mesh = M.make_mesh(data=2, seq=2, device_type="cpu")
res["coords"] = (M.axis_index("data", mesh), M.axis_index("seq", mesh))
res["shape"] = M.mesh_shape(mesh)
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))

def attention(name, impl, causal, window, q, k, v, cot, axis="seq"):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    if impl == "ring":
        g = q.shape[2] // k.shape[2]
        kk, vv = (t.repeat_interleave(g, dim=2) for t in (k, v))
        o = sq.ring_attention(q, kk, vv, causal=causal, window=window)
    elif impl == "ring_flash":
        o = sq.ring_attention(q, k, v, causal=causal, window=window,
                              block_impl="flash")
    elif impl == "ulysses":
        o = sq.ulysses_attention(q, k, v, causal=causal, window=window)
    else:
        o = sq.ulysses_attention(q, k, v, causal=causal, window=window,
                                 attn_impl=flash_attention)
    (o * cot).sum().backward()
    res[name] = [o.detach(), q.grad, k.grad, v.grad]

with M.use(mesh):
    blk = lambda a: M.shard_batch(mesh, T(a))
    res["perms"] = M.ring_perms("seq")
    for name, (impl, causal, window) in spec["attn"].items():
        q, k, v, cot = (blk(inp[f"{name}/{t}"]) for t in "qkvc")
        attention(name, impl, causal, window, q, k, v, cot)
    x = T(inp[f"x{r}"])
    res["allreduce_sum"] = C.allreduce(x, average=False, axis_name="seq")
    res["allreduce_avg"] = C.allreduce(x, axis_name="data")
    res["allreduce_int_avg"] = C.allreduce(T(inp[f"xi{r}"]),
                                           axis_name="seq")
    res["allgather"] = C.allgather(x, axis_name="seq")
    res["allgatherv"] = C.allgatherv(T(inp[f"xv{r}"]), r % 2 + 1,
                                     max_len=3, axis_name="data")
    res["broadcast"] = C.broadcast(x, 1, axis_name="seq")
    res["broadcast_bool"] = C.broadcast(x > 0, 1, axis_name="data")
    res["alltoall"] = C.alltoall(x, axis_name="seq", split_axis=0,
                                 concat_axis=0)
    res["reducescatter"] = C.reducescatter(x, axis_name="seq")
    res["ppermute"] = C.ppermute(x, "seq", M.ring_perms("seq")[0])
    res["my_rank"] = (C.my_rank("data"), C.my_rank("seq"))
    res["axis_size"] = C.axis_size("seq")
    res["batch_block"] = M.shard_batch(mesh, {"t": T(inp["tokens"])})["t"]
    try:
        C.allreduce(x, axis_name="model_x")
        errors.append("unbound: no error")
    except NameError as e:
        errors.append(f"unbound: NameError {e}")

# The sharded LM forward, from the JAX package's weights.
for name, (impl, pos_emb, kv) in spec["lm"].items():
    m = tt.TransformerLM(64, 2, 4, 8, max_len=32, dtype=torch.float32,
                         attn_impl=impl, pos_emb=pos_emb, num_kv_heads=kv,
                         device="cpu")
    m.load_state_dict(torch.load(f"{work}/lm-{name}.pt"))
    with torch.no_grad(), M.use(mesh):
        res[f"lm/{name}"] = m(M.shard_batch(mesh, T(inp["tokens"])))

# One SGD step and the eval step over the mesh.
m = tt.TransformerLM(64, 2, 4, 8, max_len=32, dtype=torch.float32,
                     attn_impl="ring_flash", device="cpu")
m.load_state_dict(torch.load(f"{work}/lm-step.pt"))
opt = torch.optim.SGD(m.parameters(), lr=0.1)
toks = M.shard_batch(mesh, T(inp["tokens"]))
res["eval"] = tt.make_lm_eval_step(m, mesh)(toks)
res["step_loss"] = tt.make_lm_train_step(m, opt, mesh)(toks)
res["step_state"] = m.state_dict()
try:
    tt.make_lm_train_step(m, hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1)), mesh)(toks)
    errors.append("distributed optimizer: no error")
except ValueError as e:
    errors.append(f"distributed optimizer: ValueError {e}")
try:
    with M.use(mesh):
        tt.TransformerLM(64, 1, 4, 8, max_len=32, attn_impl="flash",
                         device="cpu")(toks)
    errors.append("local impl: no error")
except ValueError as e:
    errors.append(f"local impl: ValueError {e}")

# The bf16 flagship: rope, window 8, GQA 4:2, ring_flash, AdamW.
m = tt.TransformerLM(64, 2, 4, 8, num_kv_heads=2, pos_emb="rope",
                     window=8, max_len=32, dtype=torch.bfloat16,
                     attn_impl="ring_flash", device="cpu")
opt = torch.optim.AdamW(m.parameters(), lr=1e-2)
tt.init_lm_state(m, opt, seed=0)
step = tt.make_lm_train_step(m, opt, mesh)
toks = M.shard_batch(mesh, T(inp["flagship_tokens"]))
res["flagship"] = [float(step(toks)) for _ in range(4)]

# seq=4: a ring with a rotation masked whole.
mesh4 = M.make_mesh(seq=4, device_type="cpu")
with M.use(mesh4):
    q, k, v, cot = (M.shard_batch(mesh4, T(inp[f"masked/{t}"]))
                    for t in "qkvc")
    attention("masked", "ring_flash", True, spec["masked_window"], q, k, v,
              cot)
torch.save({"res": res, "errors": errors}, f"{work}/rank{r}.pt")
hvd.shutdown()
'''


def _jax_mesh(**axes):
    return jmesh.make_mesh(devices=jax.devices()[:4], **axes)


def _jax_lm(impl, pos_emb="learned", kv=None, dtype=jnp.float32):
    return jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                            num_heads=H, head_dim=D, max_len=MAX_LEN,
                            dtype=dtype, attn_impl=impl, pos_emb=pos_emb,
                            num_kv_heads=kv)


def _jax_params(model, seed):
    """Seeded numpy weights in the model's param layout (traced by
    `jax.eval_shape`, nothing compiled): norm scales near 1, every other
    leaf N(0, 0.05)."""
    shapes = unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, S), jnp.int32))["params"])
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        x = 0.05 * rs.randn(*leaf.shape)
        if getattr(path[-1], "key", None) == "scale":
            x = 1.0 + x
        return jnp.asarray(x, leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the four-rank gloo world once: ({rank: what it saved}, the
    inputs, the JAX params it was given)."""
    d = tmp_path_factory.mktemp("sp_world")
    inp = {"tokens": _tokens(), "flagship_tokens": _tokens(4, 16, 40)}
    for i, name in enumerate(ATTN_CASES):
        for t, a in zip("qkvc", _qkv(i)):
            inp[f"{name}/{t}"] = a
    for t, a in zip("qkvc", _qkv(50, b=1, s=MASKED["S"])):
        inp[f"masked/{t}"] = a
    for r in range(4):
        inp[f"x{r}"], inp[f"xi{r}"], inp[f"xv{r}"] = _x(r), _xi(r), _xv(r)
    np.savez(d / "inputs.npz", **inp)
    # One init a parameter layout (the attention impl holds no weights).
    layouts = {}
    for name, (impl, pos_emb, kv) in LM_CASES.items():
        layouts.setdefault((pos_emb, kv), []).append(name)
    params = {}
    for (pos_emb, kv), names in layouts.items():
        p = _jax_params(_jax_lm("blockwise", pos_emb, kv), 3)
        sd = params_from_jax(jax.tree.map(np.asarray, p))
        for name in names:
            params[name] = p
            torch.save(sd, d / f"lm-{name}.pt")
    params["step"] = params["ring-learned"]
    torch.save(params_from_jax(jax.tree.map(np.asarray, params["step"])),
               d / "lm-step.pt")
    torch.save({"attn": ATTN_CASES, "lm": LM_CASES,
                "masked_window": MASKED["window"]}, d / "spec.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(d / "store"), str(d)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = {r: torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(4)}
    return ranks, inp, params


def _assemble(blocks, dp=2, sp=2):
    """The global [B, S, ...] array from the ranks' blocks (rank r at
    data block r // sp, seq block r % sp)."""
    rows = [np.concatenate([np.asarray(blocks[d * sp + s])
                            for s in range(sp)], axis=1)
            for d in range(dp)]
    return np.concatenate(rows, axis=0)


def _j_attention(mesh, impl, causal, window, q, k, v, cot):
    """(out, dq, dk, dv) of the JAX package's SPMD attention under
    shard_map over ``mesh``."""
    spec = P("data", "seq", None, None)
    g = q.shape[2] // k.shape[2]
    if impl == "ring":
        fn = functools.partial(jseq.ring_attention, causal=causal,
                               window=window)
    elif impl == "ring_flash":
        fn = functools.partial(jseq.ring_attention, causal=causal,
                               window=window, block_impl="flash")
    elif impl == "ulysses":
        fn = functools.partial(jseq.ulysses_attention, causal=causal,
                               window=window)
    else:
        fn = functools.partial(jseq.ulysses_attention, causal=causal,
                               window=window, attn_impl=j_flash)
    shard = jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                          out_specs=spec)

    def sm(q, k, v):
        if impl == "ring":      # the model's repeat, inside the gradient
            k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        return shard(q, k, v)
    q, k, v, cot = map(jnp.asarray, (q, k, v, cot))

    @jax.jit
    def run(q, k, v):
        out, vjp = jax.vjp(sm, q, k, v)
        return (out,) + vjp(cot)
    return [np.asarray(t) for t in run(q, k, v)]


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_sequence_attention_matches_jax(world, name):
    """Outputs and dq/dk/dv of ring, ring_flash, ulysses and
    ulysses_flash (full, causal, causal window 8; GQA 4:2) on the port's
    four ranks against the JAX package's shard_map on four devices."""
    ranks, inp, _ = world
    impl, causal, window = ATTN_CASES[name]
    q, k, v, cot = (inp[f"{name}/{t}"] for t in "qkvc")
    ref = _j_attention(_jax_mesh(data=2, seq=2), impl, causal, window,
                       q, k, v, cot)
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        got = _assemble([ranks[r]["res"][name][i].numpy()
                         for r in range(4)])
        assert np.isfinite(got).all(), (name, what)
        np.testing.assert_allclose(got, ref[i], atol=TOL, rtol=0,
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("mask", list(MASKS))
def test_blockwise_matches_jax(mask):
    causal, window = MASKS[mask]
    q, k, v, cot = _qkv(20, h=H, hkv=H)
    ref = jseq.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                   block_size=5, causal=causal,
                                   window=window)
    got = tseq.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                   block_size=5, causal=causal,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_masked_rotation_ring_matches_jax(world):
    """The seq=4 ring_flash at window 4: rank 3's rotation 2 is masked
    whole; outputs and gradients finite and equal to the JAX package's
    ring over the same seq=4 layout (its online-softmax form, which
    `test_sequence_attention_matches_jax` holds to its flash form)."""
    ranks, inp, _ = world
    q, k, v, cot = (inp[f"masked/{t}"] for t in "qkvc")
    ref = _j_attention(_jax_mesh(data=1, seq=4), "ring", True,
                       MASKED["window"], q, k, v, cot)
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        got = _assemble([ranks[r]["res"]["masked"][i].numpy()
                         for r in range(4)], dp=1, sp=4)
        assert np.isfinite(got).all(), what
        np.testing.assert_allclose(got, ref[i], atol=TOL, rtol=0,
                                   err_msg=what)


def test_fully_masked_rotation_gives_zero_finite_gradients():
    """One rotation of the ring masked whole (q_offset = 2 S_l, window
    4, S_l 4): the flash forward gives out 0 and lse -inf, and its
    backward, under cotangents on both out and lse, zero and finite
    gradients; merged with the running partial, the rows keep the
    running partial's values and gradients stay finite."""
    q, k, v, _ = _qkv(60, b=1, s=4)
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o, lse = tfa.flash_attention_lse(q, k, v, causal=True, window=4,
                                     q_offset=8)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()
    rs = np.random.RandomState(61)
    go = torch.from_numpy(rs.randn(*o.shape).astype(np.float32))
    gl = torch.from_numpy(rs.randn(*lse.shape).astype(np.float32))
    torch.autograd.backward([o, lse], [go, gl])
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
        assert torch.equal(t.grad, torch.zeros_like(t.grad))
    # The merge: an empty partial on either side, and on both.
    o1 = torch.randn(1, 4, 4, 8, requires_grad=True)
    l1 = torch.randn(1, 4, 4, requires_grad=True)
    empty_o = torch.zeros(1, 4, 4, 8, requires_grad=True)
    empty_l = torch.full((1, 4, 4), float("-inf"), requires_grad=True)
    om, lm = tseq._merge_partials(o1, l1, empty_o, empty_l)
    torch.testing.assert_close(om, o1, rtol=0, atol=1e-6)
    torch.testing.assert_close(lm, l1, rtol=0, atol=1e-6)
    oe, le = tseq._merge_partials(empty_o, empty_l, empty_o, empty_l)
    assert torch.equal(oe, torch.zeros_like(oe)) and torch.isneginf(le).all()
    (om.sum() + lm.sum() + oe.sum()).backward()
    for t in (o1, l1, empty_o, empty_l):
        assert torch.isfinite(t.grad).all()
    assert torch.equal(empty_l.grad, torch.zeros_like(empty_l.grad))


def _j_spmd(fn, xs, out_rank_dims=1):
    """Run ``fn`` on each of the 4 devices' input (the stacked ``xs``)
    under shard_map over (data=2, seq=2); returns per-device outputs."""
    mesh = _jax_mesh(data=2, seq=2)
    stacked = jnp.concatenate([jnp.asarray(x)[None] for x in xs])
    spec = P(("data", "seq"))
    out = jax.jit(jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                                in_specs=(spec,), out_specs=spec))(stacked)
    return [np.asarray(o) for o in out]


SPMD_CASES = {
    "allreduce_sum": (lambda x: jcoll.allreduce(x, average=False,
                                                axis_name="seq"), _x),
    "allreduce_avg": (lambda x: jcoll.allreduce(x, axis_name="data"), _x),
    "allreduce_int_avg": (lambda x: jcoll.allreduce(x, axis_name="seq"),
                          _xi),
    "allgather": (lambda x: jcoll.allgather(x, axis_name="seq"), _x),
    "broadcast": (lambda x: jcoll.broadcast(x, 1, axis_name="seq"), _x),
    "broadcast_bool": (lambda x: jcoll.broadcast(x > 0, 1,
                                                 axis_name="data"), _x),
    "alltoall": (lambda x: jcoll.alltoall(x, axis_name="seq"), _x),
    "reducescatter": (lambda x: jcoll.reducescatter(x, axis_name="seq"),
                      _x),
    "ppermute": (lambda x: lax.ppermute(
        x, "seq", jmesh.ring_perms("seq")[0]), _x),
}


@pytest.mark.parametrize("name", list(SPMD_CASES))
def test_spmd_op_matches_jax(world, name):
    ranks, _, _ = world
    fn, make = SPMD_CASES[name]
    ref = _j_spmd(fn, [make(r) for r in range(4)])
    for r in range(4):
        got = ranks[r]["res"][name].numpy()
        assert got.dtype == ref[r].dtype, (name, got.dtype, ref[r].dtype)
        if np.issubdtype(got.dtype, np.floating):
            np.testing.assert_allclose(got, ref[r], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got, ref[r])


def test_allgatherv_rank_and_size_match_jax(world):
    ranks, _, _ = world
    mesh = _jax_mesh(data=2, seq=2)
    spec = P(("data", "seq"))
    xs = jnp.stack([jnp.asarray(_xv(r)) for r in range(4)])
    lens = jnp.asarray([r % 2 + 1 for r in range(4)], jnp.int32)

    def fn(x, n):
        g, s = jcoll.allgatherv(x[0], n[0], max_len=3, axis_name="data")
        mine = jnp.stack([jcoll.my_rank("data"), jcoll.my_rank("seq")])
        return g[None], s[None], mine[None]
    g, s, mine = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec, spec, spec)))(xs, lens)
    for r in range(4):
        got_g, got_s = ranks[r]["res"]["allgatherv"]
        np.testing.assert_array_equal(got_g.numpy(), np.asarray(g[r]))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(s[r]))
        assert ranks[r]["res"]["my_rank"] == tuple(np.asarray(mine[r]))
        assert ranks[r]["res"]["axis_size"] == 2


def test_mesh_layout_ring_perms_and_shard_batch(world):
    """The port's rank r sits where JAX's device r does; ring_perms
    match; shard_batch hands rank r rows of its data block and columns
    of its seq block; an unbound axis raises NameError."""
    ranks, inp, _ = world
    jm = _jax_mesh(data=2, seq=2)
    grid = np.vectorize(lambda d: d.id)(jm.devices)   # [1, 2, 2, 1, 1]
    perms = []

    def capture(x):
        perms.append(jmesh.ring_perms("seq"))
        return x
    jax.shard_map(capture, mesh=jm, in_specs=P("seq"),
                  out_specs=P("seq"))(jnp.zeros(2))
    for r in range(4):
        res = ranks[r]["res"]
        d, s = res["coords"]
        assert grid[0, d, s, 0, 0] == jax.devices()[r].id
        assert res["shape"] == {"pipe": 1, "data": 2, "seq": 2,
                                "expert": 1, "model": 1}
        assert [list(p) for p in res["perms"]] == [list(map(tuple, p))
                                                   for p in perms[0]]
        want = inp["tokens"][d * B // 2:(d + 1) * B // 2,
                             s * S // 2:(s + 1) * S // 2]
        np.testing.assert_array_equal(res["batch_block"].numpy(), want)
        errs = dict(e.split(": ", 1) for e in ranks[r]["errors"])
        assert errs["unbound"].startswith("NameError unbound axis name")


def test_mesh_spec_resolve_matches_jax():
    for kw, n in [(dict(data=3, model=2), 8), (dict(data=-1, seq=-1), 8),
                  (dict(seq=3), 8), (dict(seq=2), 8), (dict(), 4)]:
        try:
            want = ("ok", jmesh.MeshSpec(**kw).resolve(n).__dict__)
        except ValueError as e:
            want = ("ValueError", str(e))
        try:
            got = ("ok", tmesh.MeshSpec(**kw).resolve(n).__dict__)
        except ValueError as e:
            got = ("ValueError", str(e))
        assert got == want, kw


def test_tensor_parallel_axes_raise_naming_their_slice():
    """The model axis is ported (`tests/test_torch_port_tensor.py`): a
    model mesh only wants a world, and `constrain` is the identity. The
    pipe and expert axes still raise, naming their slices."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(model=2, device_type="cpu")
    with pytest.raises(NotImplementedError, match="pipeline"):
        tmesh.make_mesh(pipe=2, device_type="cpu")
    with pytest.raises(NotImplementedError, match="expert"):
        tmesh.make_mesh(expert=2, device_type="cpu")
    x = torch.zeros(2)
    assert tmesh.constrain(x, "data") is x


@pytest.mark.parametrize("name", list(LM_CASES))
def test_sharded_lm_forward_matches_jax(world, name):
    """The LM forward under (data=2, seq=2): each rank's logits block
    against the JAX package's sharded forward (global positions: the
    learned table's slice and RoPE's offsets)."""
    ranks, inp, params = world
    impl, pos_emb, kv = LM_CASES[name]
    mesh = _jax_mesh(data=2, seq=2)
    model = _jax_lm(impl, pos_emb, kv)
    with jmesh.use(mesh):
        toks = jax.device_put(jnp.asarray(inp["tokens"]),
                              NamedSharding(mesh, P("data", "seq")))
        ref = jax.jit(lambda p, t: model.apply({"params": p}, t))(
            params[name], toks)
    got = _assemble([ranks[r]["res"][f"lm/{name}"].numpy()
                     for r in range(4)])
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=0)


def test_train_step_over_mesh_matches_jax(world):
    """One SGD step of the ring_flash LM over (data=2, seq=2): the loss
    (and the eval step's) and every updated parameter against the JAX
    package's make_lm_train_step on its mesh, from the same weights and
    global batch; a DistributedOptimizer (the step averages over the
    data and seq ranks itself) and a local-only attention under seq > 1
    are refused."""
    ranks, inp, params = world
    # The JAX package's own layout for this step (tests/test_transformer.py
    # shards the step over data=2, seq=2, model=2; on four devices its
    # SPMD partitioner stops at a CHECK). Its plain ring computes the
    # same function as the port's ring_flash.
    mesh = jmesh.make_mesh(data=2, seq=2, model=2)
    model = _jax_lm("ring")
    tx = optax.sgd(LR)
    step = jt.make_lm_train_step(model, tx, mesh, donate=False)
    toks = jax.device_put(jnp.asarray(inp["tokens"]),
                          NamedSharding(mesh, P("data", "seq")))
    new, _, loss = step(params["step"], tx.init(params["step"]), toks)
    ref = params_from_jax(jax.tree.map(np.asarray, new))
    for r in range(4):
        res = ranks[r]["res"]
        assert abs(float(res["step_loss"]) - float(loss)) <= TOL
        assert abs(float(res["eval"]) - float(loss)) <= TOL
        for n, want in ref.items():
            np.testing.assert_allclose(res["step_state"][n].numpy(),
                                       want.numpy(), atol=TOL, rtol=0,
                                       err_msg=f"rank {r} {n}")
        errs = dict(e.split(": ", 1) for e in ranks[r]["errors"])
        assert errs["distributed optimizer"].startswith(
            "ValueError make_lm_train_step over a mesh averages the "
            "gradients")
        assert errs["local impl"].startswith("ValueError attn_impl='flash'")


def test_bf16_flagship_loss_falls(world):
    """The JAX package's bf16 flagship (rope, window 8, GQA 4:2,
    ring_flash, AdamW 1e-2, B 4 x S 16) on the port's (data=2, seq=2)
    mesh: 4 steps, finite, falling, the same on every rank."""
    ranks, _, _ = world
    losses = ranks[0]["res"]["flagship"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for r in range(1, 4):
        assert ranks[r]["res"]["flagship"] == losses


def test_ring_impls_fall_back_to_blockwise_off_mesh():
    """Off-mesh the sequence-parallel impls are the blockwise attention
    on the whole sequence (init and one-device evaluation)."""
    q, k, v, _ = _qkv(70)
    q, k, v = map(torch.from_numpy, (q, k, v))
    g = H // HKV
    want = tseq.blockwise_attention(q, k.repeat_interleave(g, 2),
                                    v.repeat_interleave(g, 2), causal=True,
                                    window=WINDOW)
    for impl in tt.SEQ_PARALLEL_IMPLS:
        fn = tt.make_attn_fn(impl, window=WINDOW)
        kk, vv = (k, v) if fn.native_gqa else (k.repeat_interleave(g, 2),
                                               v.repeat_interleave(g, 2))
        torch.testing.assert_close(fn(q, kk, vv, None), want, rtol=0,
                                   atol=0)
    with pytest.raises(ValueError, match="flash_block_q"):
        tt.make_attn_fn("ring", flash_block_q=64)
