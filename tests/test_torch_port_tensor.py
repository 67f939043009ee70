"""PyTorch port: tensor parallelism over the ``model`` axis — the
column/row layers, head-sharded attention, the collective matmuls, the
LM forward and train step over (data, model) and (seq, model) meshes,
the shard / gather of a state dict, and sharded serving through the
lockstep engine on both pools — against the JAX package.

One module fixture starts TWO gloo worlds that import only the port
(``python -c``; the JAX package must stay out of them), both at once:
world A of four ranks runs the layers, the collective matmuls, the LM
and the state-dict cases on (data=2, model=2), (seq=2, model=2) and
model=4 meshes; world B of two ranks serves at ``mesh=2`` (model rank 0
leads, rank 1 runs ``follow()``). Each rank writes what it saw to disk.
The JAX references run here, on the test process's 8-device CPU mesh:
the sharded layers and the collective matmuls under GSPMD / shard_map,
the LM forward on one device (the JAX package's own sharded-forward
test holds its mesh to that), its int8 forward on the quantized tree,
its train step on a (data=4, model=2) and a (data=2, seq=2, model=2)
mesh, and the serving streams through its UNSHARDED engine (the
reference's sharded-serving contract: a mesh changes where the tick
runs, never what it produces).

Tolerances (float32 on both sides, the same algorithms; differences are
summation order): layer and LM outputs and gradients, and the SGD step,
within 1e-5; shard -> gather and quantize-then-shard bitwise; token
streams identical.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from horovod_tpu import parallel as jpar
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu.serving import ServingEngine as JEngine
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import tensor as ttensor

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
VOCAB, LAYERS, H, D, MAX_LEN, LR = 64, 2, 4, 8, 32, 0.1
BS, STEPS = 8, 6

# Layer cases at tp 2: name -> (kind, kv heads, bias).
LAYER_CASES = {"mlp": ("mlp", None, True), "swiglu": ("swiglu", None, False),
               "attn-mha": ("attn", None, False),
               "attn-gqa": ("attn", 2, True), "attn-mqa": ("attn", 1, False)}
# The LM forward: name -> (mesh, attn_impl, pos_emb, kv heads, vocab).
LM_CASES = {"dm-blockwise": ("dm", "blockwise", "learned", None, VOCAB),
            "dm-flash-gqa": ("dm", "flash", "rope", 2, VOCAB),
            "dm-mqa-untied": ("dm", "blockwise", "rope", 1, VOCAB),
            "dm-vocab63": ("dm", "blockwise", "learned", None, 63),
            "sm-ring": ("sm", "ring", "learned", None, VOCAB),
            "sm-ring_flash-gqa": ("sm", "ring_flash", "rope", 2, VOCAB)}
# One SGD step: name -> (mesh, attn_impl, pos_emb, kv heads, vocab).
STEP_CASES = {"step": ("dm", "blockwise", "learned", None, VOCAB),
              "step63": ("dm", "blockwise", "learned", None, 63),
              "step-sm": ("sm", "ring_flash", "rope", 2, VOCAB)}
# Sharded serving: (pool, weights); every run mixes greedy and seeded.
SERVE_CASES = [(p, q) for p in ("fixed", "paged") for q in ("fp32", "int8")]

# World A: four ranks, (data=2, model=2), (seq=2, model=2) and model=4.
WORKER_A = r'''
import sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.compat.from_jax import (gather_state_dict,
                                               shard_state_dict)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops.quantization import quantize_lm
from horovod_tpu_torch.parallel import mesh as M, tensor as PT
rank, store, work = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=4, init_method="file://" + store)
inp = dict(np.load(f"{work}/inputs.npz"))
spec = torch.load(f"{work}/spec.pt")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
res, errors = {}, []
dm = M.make_mesh(data=2, model=2, device_type="cpu")
sm = M.make_mesh(seq=2, model=2, device_type="cpu")
m4 = M.make_mesh(model=4, device_type="cpu")
mr = M.axis_index("model", dm)

def layer(kind, kv, bias, tp, tpr):
    kw = dict(dtype=torch.float32, device="cpu", tp=tp)
    if kind == "mlp":
        return PT.ParallelMLP(32, 64, 16, **kw)
    if kind == "swiglu":
        return PT.ParallelSwiGLU(32, 64, 16, **kw)
    return PT.ParallelSelfAttention(4, 8, num_kv_heads=kv, use_bias=bias,
                                    tp_rank=tpr, **kw)

# The layers at tp 2: outputs, the input's gradient, and every
# parameter's gradient gathered back to the whole layer.
for name, (kind, kv, bias) in spec["layers"].items():
    sd = torch.load(f"{work}/layer-{name}.pt")
    full = layer(kind, kv, bias, 1, 0)
    full.load_state_dict(sd)
    m = layer(kind, kv, bias, 2, mr)
    m.load_state_dict(PT.shard_params(dm, full, sd))
    x = T(inp[f"{name}/x"]).requires_grad_()
    with M.use(dm):
        out = m(x)
        (out * T(inp[f"{name}/c"])).sum().backward()
        grads = PT.gather_params(dm, m, {k: p.grad for k, p in
                                         m.named_parameters()})
    res[name] = [out.detach(), x.grad, grads]

# The column/row pair, functional: rows of x over data, w1 columns and
# w2 rows over model; the weights' gradients.
with M.use(dm):
    x = M.shard_batch(dm, T(inp["pair/x"]))
    w1 = M.place_with_specs(dm, T(inp["pair/w1"]), (None, "model"))
    w2 = M.place_with_specs(dm, T(inp["pair/w2"]), ("model", None))
    w1.requires_grad_(); w2.requires_grad_()
    out = PT.row_parallel_matmul(PT.column_parallel_matmul(x, w1), w2)
    (out * M.shard_batch(dm, T(inp["pair/c"]))).sum().backward()
    res["pair"] = [out.detach(), w1.grad, w2.grad]

# The collective matmuls at tp 2 and 4, and the gradients of the
# overlapped pair (all-gather matmul up, matmul reduce-scatter down).
for tp, mesh in ((2, dm), (4, m4)):
    with M.use(mesh):
        place = lambda a, s: M.place_with_specs(mesh, T(a), s)
        res[f"ag{tp}"] = PT.allgather_matmul(
            place(inp["ag/x"], ("model", None)),
            place(inp["ag/w"], (None, "model")))
        res[f"rs{tp}"] = PT.matmul_reducescatter(
            place(inp["rs/x"], (None, "model")),
            place(inp["rs/w"], ("model", None)))
        xs = [place(inp[f"cm{tp}/{n}"], s).requires_grad_() for n, s in
              (("x", ("model", None)), ("w1", (None, "model")),
               ("w2", ("model", None)))]
        out = PT.matmul_reducescatter(PT.allgather_matmul(xs[0], xs[1]),
                                      xs[2])
        (out * out).sum().backward()
        res[f"cm{tp}"] = [t.grad for t in xs]
    try:
        with M.use(mesh):
            PT.matmul_reducescatter(torch.ones(4 * tp + 1, 8 // tp),
                                    torch.ones(8 // tp, 6))
        errors.append(f"indivisible{tp}: no error")
    except ValueError as e:
        errors.append(f"indivisible{tp}: ValueError {e}")

def lm(vocab, impl, pos_emb, kv, mesh=None, **kw):
    return tt.TransformerLM(vocab, 2, 4, 8, max_len=32, dtype=torch.float32,
                            attn_impl=impl, pos_emb=pos_emb,
                            num_kv_heads=kv, tied_head=kv != 1, mesh=mesh,
                            device="cpu", **kw)

# The LM forward on both meshes, the shard -> gather round trip, and
# int8: quantizing the tensor-parallel model == sharding the quantized
# whole model.
meshes = {"dm": dm, "sm": sm}
for name, (mk, impl, pos_emb, kv, vocab) in spec["lm"].items():
    mesh = meshes[mk]
    sd = torch.load(f"{work}/lm-{name}.pt")
    m = lm(vocab, impl, pos_emb, kv, mesh)
    m.load_state_dict(shard_state_dict(m, sd, mesh))
    with torch.no_grad(), M.use(mesh):
        res[f"lm/{name}"] = m(M.shard_batch(mesh, T(inp["tokens"])))
    back = gather_state_dict(m, m.state_dict(), mesh)
    res[f"roundtrip/{name}"] = sorted(k for k, v in sd.items()
                                      if not torch.equal(back[k], v))
    if mk == "dm":
        full = lm(vocab, impl, pos_emb, kv)
        full.load_state_dict(sd)
        q, qfull = quantize_lm(m), quantize_lm(full)
        want = shard_state_dict(q, qfull.state_dict(), mesh)
        res[f"int8/{name}"] = sorted(k for k, v in q.state_dict().items()
                                     if not torch.equal(want[k], v))
        # The quantized shard runs: its logits and its eval loss.
        toks = M.shard_batch(mesh, T(inp["tokens"]) % vocab)
        with torch.no_grad(), M.use(mesh):
            res[f"int8lm/{name}"] = q(toks)
        res[f"int8loss/{name}"] = tt.make_lm_eval_step(q, mesh)(toks)
        res[f"local_kv/{name}"] = m.local_kv

# The serving caches of a whole model cut to this rank's kv heads:
# GQA 4:2 (one head a rank), and MQA 4:1 with and without the query
# heads (the one kv head, or the JAX package's replicated degrade).
for kv in (2, 1):
    full = lm(64, "blockwise", "rope", kv)
    cache = tt.init_slot_cache(full, 2)
    for t in cache.tensors():
        t.normal_()
    spec_p = tt.paged_cache_spec(full, 8)
    pools = tt.init_paged_pools(full, spec_p, 5)
    for layer in pools:
        for t in layer:
            t.normal_()
    for heads in (4, None):
        sc = tt.shard_slot_cache(cache, dm, num_heads=heads)
        sp = tt.shard_paged_pools(pools, dm, num_heads=heads)
        res[f"cache/{kv}/{heads}"] = [
            [tuple(t.shape) for t in sc.tensors()[:2]],
            [tuple(t.shape) for t in sp[0]],
            torch.equal(sc.k[1], cache.k[1][:, :, [mr if kv == 2 else 0]])
            if heads or kv == 2 else torch.equal(sc.k[1], cache.k[1]),
            torch.equal(sp[1][1], pools[1][1][:, :, [mr if kv == 2 else 0]])
            if heads or kv == 2 else torch.equal(sp[1][1], pools[1][1])]

# One SGD step over (data=2, model=2) and (seq=2, model=2) (and the
# eval step), then the whole updated model; the vocab-63 model takes
# the replicated path.
for name, (mk, impl, pos_emb, kv, vocab) in spec["step"].items():
    mesh = meshes[mk]
    m = lm(vocab, impl, pos_emb, kv, mesh)
    m.load_state_dict(shard_state_dict(
        m, torch.load(f"{work}/lm-{name}.pt"), mesh))
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    toks = M.shard_batch(mesh, T(inp["step_tokens"]) % vocab)
    res[f"{name}/eval"] = tt.make_lm_eval_step(m, mesh)(toks)
    res[f"{name}/loss"] = tt.make_lm_train_step(m, opt, mesh)(toks)
    res[f"{name}/state"] = gather_state_dict(m, m.state_dict(), mesh)
    res[f"{name}/vocab_parallel"] = m.vocab_parallel
for what, make in (
        ("unsharded model", lambda: tt.make_lm_train_step(
            lm(64, "blockwise", "learned", None),
            torch.optim.SGD([torch.zeros(1)], lr=0.1), dm)),
        ("distributed optimizer", lambda: tt.make_lm_train_step(
            m, hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                        lr=0.1)),
            mesh)(toks))):
    try:
        make()
        errors.append(f"{what}: no error")
    except ValueError as e:
        errors.append(f"{what}: ValueError {e}")
for what, make in (("heads", lambda: tt.TransformerLM(
        64, 1, 6, 8, num_kv_heads=3, mesh=dm, device="cpu")),
                   ("expert", lambda: M.make_mesh(expert=2, data=2,
                                                  device_type="cpu")),
                   ("pipe", lambda: M.make_mesh(pipe=2, data=2,
                                                device_type="cpu"))):
    try:
        make()
        errors.append(f"{what}: no error")
    except (ValueError, NotImplementedError) as e:
        errors.append(f"{what}: {type(e).__name__} {e}")
torch.save({"res": res, "errors": errors}, f"{work}/rank{r}.pt")
hvd.shutdown()
'''

# World B: two ranks serving at mesh=2; model rank 1 follows.
WORKER_B = r'''
import os, sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.obs.catalog import serving_metrics
from horovod_tpu_torch.runtime.config import config
from horovod_tpu_torch.serving import ServingEngine, ShardDivergence
rank, store, work = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=2, init_method="file://" + store)
inp = dict(np.load(f"{work}/inputs.npz"))
spec = torch.load(f"{work}/spec.pt")
res, errors = {}, []

def model():
    m = tt.TransformerLM(64, 2, 4, 8, max_len=32, dtype=torch.float32,
                         decode_prefix_impl="pallas", device="cpu")
    m.load_state_dict(torch.load(f"{work}/lm-serve.pt"))
    return m

def engine(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("mesh", 2)
    if kw.get("paged"):
        kw.setdefault("kv_block_size", 8)
    return ServingEngine(model(), **kw)

def run(eng, reqs, **sub):
    """The leader's streams for [(prompt, temperature, seed)]; a
    follower follows. None on the follower."""
    if eng.is_follower:
        eng.follow()
        eng.shutdown()
        return None
    hs = [eng.submit(p, spec["steps"], temperature=t, top_p=tp, seed=s,
                     **sub) for p, t, tp, s in reqs]
    out = [list(map(int, h.result(timeout=120).tokens)) for h in hs]
    return out

reqs = [(inp[f"serve/p{i}"], *spec["sampling"][i]) for i in range(4)]
for pool, quant in spec["serve"]:
    eng = engine(paged=pool == "paged",
                 weight_quant=None if quant == "fp32" else "int8",
                 prefill_chunk_budget=4)
    got = run(eng, reqs)
    if got is not None:
        res[f"serve/{pool}-{quant}"] = got
        res[f"weights/{pool}-{quant}"] = eng.model.weight_quant
        eng.shutdown()

# Prefix hits: three prompts sharing two full blocks.
eng = engine(paged=True, prefix_cache=True)
shared = [(inp[f"prefix/p{i}"], 0.0, None, 0) for i in range(3)]
if eng.is_follower:
    run(eng, shared)
else:
    first = eng.submit(shared[0][0], spec["steps"]).result(timeout=120)
    rest = [eng.submit(p, spec["steps"]).result(timeout=120)
            for p, *_ in shared[1:]]
    res["prefix"] = [list(map(int, c.tokens)) for c in [first] + rest]
    res["prefix_cached"] = [c.prefix_tokens_cached for c in [first] + rest]
    eng.shutdown()

# Forced-prefix migration between a sharded and an unsharded engine,
# both ways (the unsharded engine lives on the leader alone).
p, k = inp["migrate/p"], spec["migrate_k"]
for src, dst in ((None, 2), (2, None)):
    legs = []
    for mesh, kw in ((src, dict(max_new=k)),
                     (dst, dict(max_new=spec["steps"], forced=True))):
        if mesh is None and r != 0:
            continue
        eng = engine(num_slots=1, mesh=mesh)
        if eng.is_follower:
            run(eng, [])
            continue
        sub = dict(forced_prefix=legs[0]) if kw.get("forced") else {}
        legs.append(list(map(int, eng.submit(p, kw["max_new"], **sub)
                             .result(timeout=120).tokens)))
        eng.shutdown()
    if r == 0:
        res[f"migrate/{src}->{dst}"] = legs

# A bf16 serving model sharded at the door keeps its dtypes and the
# head's vocab-shard mark.
m = model()
tt.serving_params(m)
eng = ServingEngine(m, num_slots=1, mesh=2)
if eng.is_follower:
    run(eng, [])
else:
    sm = eng.model
    res["door"] = [str(sm.blocks[0].attn.qkv.kernel.dtype),
                   str(sm.embed.dtype),
                   isinstance(sm.logits_head(), tt.VocabShard),
                   tuple(sm.blocks[0].attn.qkv.kernel.shape)]
    eng.shutdown()

# The mesh forms, HVD_SERVE_MESH and the stamp; per-shard KV gauges.
cat = serving_metrics()
for form in ("model=2", 2, "env"):
    if form == "env":
        os.environ["HVD_SERVE_MESH"] = "2"
        config.refresh()
        eng = engine(mesh=None, paged=True)
    else:
        eng = engine(mesh=form, paged=True)
    if eng.is_follower:
        run(eng, [])
    else:
        res[f"form/{form}"] = [eng.mesh_devices, eng._health()["mesh"]]
        if form == "env":
            h = eng.submit(inp["serve/p0"], 4)
            h.result(timeout=120)
            label = str(eng._engine_id)
            res["gauges"] = [cat[n].value(engine=label, shard=s)
                             for n in ("kv_blocks_free_shard",
                                       "kv_blocks_used_shard")
                             for s in ("0", "1")]
            res["gauge_mesh"] = cat["mesh_devices"].value(engine=label)
            snap = eng.metrics_snapshot()
            res["snap_mesh"] = [snap["mesh_devices"], snap["mesh"]]
        eng.shutdown()
        if form == "env":
            res["gauges_after"] = [
                lbl for n in ("kv_blocks_free_shard", "mesh_devices")
                for lbl, _ in cat[n].samples()
                if lbl.get("engine") == label]
    if form == "env":
        del os.environ["HVD_SERVE_MESH"]
        config.refresh()
try:
    engine(auto_restart=True)
    errors.append("auto_restart: no error")
except NotImplementedError as e:
    errors.append(f"auto_restart: NotImplementedError {e}")
for bad in (99, "seq=2", "model=2,data=1,seq=1"):
    try:
        eng = engine(mesh=bad)
        errors.append(f"mesh={bad}: no error")
        eng.follow() if eng.is_follower else eng.shutdown()
    except (ValueError, NotImplementedError) as e:
        errors.append(f"mesh={bad}: {type(e).__name__} {e}")
os.environ["HVD_SERVE_MESH_AXIS"] = "data"
config.refresh()
try:
    engine()
    errors.append("axis: no error")
except NotImplementedError as e:
    errors.append(f"axis: NotImplementedError {e}")
del os.environ["HVD_SERVE_MESH_AXIS"]
config.refresh()
if r == 1:
    eng = engine()
    try:
        eng.submit(inp["serve/p0"], 2)
    except RuntimeError as e:
        errors.append(f"follower submit: RuntimeError {e}")
    eng.follow()
else:
    eng = engine()
    eng.shutdown()
torch.save({"res": res, "errors": errors}, f"{work}/rank{r}.pt")

# Last: a follower that drops one free descriptor must raise
# ShardDivergence (the leader's next tick carries its digest).
eng = engine(paged=True)
try:
    if eng.is_follower:
        eng.follow(drop="free")
        out = "no error"
    else:
        for p in (inp["serve/p0"], inp["serve/p1"]):
            eng.submit(p, 4).result(timeout=30)
        out = "no error"
except ShardDivergence as e:
    out = f"ShardDivergence {e}"
except Exception as e:
    out = f"{type(e).__name__} {e}"
torch.save(out, f"{work}/divergence{r}.pt")
os._exit(0)
'''


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = torch.from_numpy(np.array(v))
    return out


def _jax_layer(kind, kv, bias):
    if kind == "mlp":
        return jpar.ParallelMLP(hidden=64, out=16)
    if kind == "swiglu":
        return jpar.ParallelSwiGLU(hidden=64, out=16)
    return jpar.ParallelSelfAttention(num_heads=H, head_dim=D,
                                      num_kv_heads=kv, use_bias=bias)


def _layer_x(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    shape = (2, 6, 32)
    out = 16 if name in ("mlp", "swiglu") else 32
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape[:-1], out).astype(np.float32))


def _jax_lm(impl, pos_emb="learned", kv=None, vocab=VOCAB):
    return jt.TransformerLM(vocab_size=vocab, num_layers=LAYERS,
                            num_heads=H, head_dim=D, max_len=MAX_LEN,
                            dtype=jnp.float32, attn_impl=impl,
                            pos_emb=pos_emb, num_kv_heads=kv,
                            tied_head=kv != 1)


def _lm_params(model, seed):
    """Seeded numpy weights in the model's param layout (shapes traced
    by `jax.eval_shape`): norm scales near 1, every other leaf
    N(0, 0.05)."""
    shapes = unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16), jnp.int32))["params"])
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        x = 0.05 * rs.randn(*leaf.shape)
        if getattr(path[-1], "key", None) == "scale":
            x = 1.0 + x
        return jnp.asarray(x, leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _run_world(worker, n, d, tag):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("HVD_SERVE_MESH", None)
    return [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), str(d / f"store-{tag}"),
         str(d)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run both worlds once: ({"A": {rank: saved}, "B": ...}, inputs,
    JAX params by case)."""
    da = tmp_path_factory.mktemp("tp_world_a")
    db = tmp_path_factory.mktemp("tp_world_b")
    rs = np.random.RandomState(5)
    inp = {"tokens": rs.randint(0, VOCAB, (4, 16)),
           "step_tokens": rs.randint(0, VOCAB, (4, 16)),
           "pair/x": rs.randn(8, 16).astype(np.float32),
           "pair/w1": rs.randn(16, 32).astype(np.float32),
           "pair/w2": rs.randn(32, 16).astype(np.float32),
           "pair/c": rs.randn(8, 16).astype(np.float32),
           "ag/x": rs.randn(16, 12).astype(np.float32),
           "ag/w": rs.randn(12, 16).astype(np.float32),
           "rs/x": rs.randn(16, 16).astype(np.float32),
           "rs/w": rs.randn(16, 10).astype(np.float32)}
    for tp in (2, 4):
        inp[f"cm{tp}/x"] = rs.randn(4 * tp, 12).astype(np.float32)
        inp[f"cm{tp}/w1"] = rs.randn(12, 4 * tp).astype(np.float32)
        inp[f"cm{tp}/w2"] = rs.randn(4 * tp, 12).astype(np.float32)
    params = {}
    for name, (kind, kv, bias) in LAYER_CASES.items():
        x, c = _layer_x(name)
        inp[f"{name}/x"], inp[f"{name}/c"] = x, c
        v = _jax_layer(kind, kv, bias).init(jax.random.PRNGKey(3), x)
        params[name] = unbox(v)["params"]
        torch.save(_flat(jax.tree.map(np.asarray, params[name])),
                   da / f"layer-{name}.pt")
    for name, (_, impl, pos_emb, kv, vocab) in LM_CASES.items():
        params[name] = _lm_params(_jax_lm(impl, pos_emb, kv, vocab), 3)
        torch.save(params_from_jax(jax.tree.map(np.asarray, params[name])),
                   da / f"lm-{name}.pt")
    for name, (_, impl, pos_emb, kv, vocab) in STEP_CASES.items():
        params[name] = _lm_params(_jax_lm(impl, pos_emb, kv, vocab), 4)
        torch.save(params_from_jax(jax.tree.map(np.asarray, params[name])),
                   da / f"lm-{name}.pt")
    params["serve"] = unbox(_jax_lm("dot").init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32))["params"])
    torch.save(params_from_jax(jax.tree.map(np.asarray, params["serve"])),
               db / "lm-serve.pt")
    srs = np.random.RandomState(11)
    for i in range(4):
        inp[f"serve/p{i}"] = srs.randint(0, VOCAB, (int(srs.randint(3, 10)),))
    head = srs.randint(0, VOCAB, (2 * BS,))
    for i in range(3):
        inp[f"prefix/p{i}"] = np.concatenate(
            [head, srs.randint(0, VOCAB, (3 + i,))])
    inp["migrate/p"] = srs.randint(0, VOCAB, (6,))
    spec = {"layers": LAYER_CASES, "lm": LM_CASES, "step": STEP_CASES,
            "serve": SERVE_CASES,
            "steps": STEPS, "migrate_k": 3,
            "sampling": [(0.0, None, 0), (0.9, 0.9, 7), (0.0, None, 0),
                         (0.7, None, 3)]}
    for d in (da, db):
        np.savez(d / "inputs.npz", **inp)
        torch.save(spec, d / "spec.pt")
    procs = _run_world(WORKER_A, 4, da, "a") + _run_world(WORKER_B, 2, db,
                                                          "b")
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = {"A": {r: torch.load(da / f"rank{r}.pt", weights_only=False)
                 for r in range(4)},
           "B": {r: torch.load(db / f"rank{r}.pt", weights_only=False)
                 for r in range(2)},
           "divergence": {r: torch.load(db / f"divergence{r}.pt",
                                        weights_only=False)
                          for r in range(2)}}
    return out, inp, params, spec


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(devices=jax.devices()[:n], **axes)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0, err_msg=what)


# -- the layers ----------------------------------------------------------

@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax_sharded(worlds, name):
    """Each layer at tp 2 (rank r of the port's (data=2, model=2) mesh
    holds model shard r % 2): its output, the input's gradient and every
    parameter's gradient (gathered) against the JAX package's GSPMD
    layer on its (data=2, model=2) mesh."""
    out, inp, params, _ = worlds
    kind, kv, bias = LAYER_CASES[name]
    mod = _jax_layer(kind, kv, bias)
    mesh = _jmesh(data=2, model=2)
    x, c = jnp.asarray(inp[f"{name}/x"]), jnp.asarray(inp[f"{name}/c"])
    variables = mod.init(jax.random.PRNGKey(3), inp[f"{name}/x"])
    sharded = jpar.shard_params(mesh, variables)

    def loss(p, x):
        y = mod.apply(p, x)
        return jnp.sum(y * c), y
    with jpar.use_mesh(mesh):
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(sharded, x)
    gp = _flat(jax.tree.map(np.asarray, gp["params"]))
    for r in range(4):
        o, dx, grads = out["A"][r]["res"][name]
        _close(o.numpy(), y, f"{name} out rank {r}")
        _close(dx.numpy(), gx, f"{name} dx rank {r}")
        assert set(grads) == set(gp)
        for k, g in grads.items():
            _close(g.numpy(), gp[k].numpy(), f"{name} d{k} rank {r}")


def test_column_row_pair_matches_jax_shard_map(worlds):
    """The functional pair (`column_parallel_matmul` then
    `row_parallel_matmul`): each rank's output rows, and the weights'
    gradient shards summed over the data ranks (each holds its rows'
    part), against the JAX package's shard_map pair."""
    out, inp, _, _ = worlds
    mesh = _jmesh(data=2, model=2)
    specs = (P("data"), P(None, "model"), P("model", None))

    def f(x, w1, w2, c):
        y = jax.shard_map(
            lambda x, w1, w2: jpar.row_parallel_matmul(
                jpar.column_parallel_matmul(x, w1), w2),
            mesh=mesh, in_specs=specs, out_specs=P("data"))(x, w1, w2)
        return jnp.sum(y * c), y
    args = [jnp.asarray(inp[f"pair/{n}"]) for n in ("x", "w1", "w2", "c")]
    (_, y), (g1, g2) = jax.jit(jax.value_and_grad(
        f, argnums=(1, 2), has_aux=True))(*args)
    # Unit-normal operands, products of magnitude ~40: the JAX
    # package's own tolerance for this pair (tests/test_parallel.py).
    close = functools.partial(np.testing.assert_allclose, rtol=2e-5,
                              atol=2e-5)
    for r in range(4):
        d, m = r // 2, r % 2
        o = out["A"][r]["res"]["pair"][0]
        close(o.numpy(), np.asarray(y)[4 * d:4 * d + 4], err_msg=f"out {r}")
        d1, d2 = (sum(out["A"][dd * 2 + m]["res"]["pair"][i].numpy()
                      for dd in range(2)) for i in (1, 2))
        close(d1, np.asarray(g1)[:, 16 * m:16 * m + 16], err_msg=f"w1 {r}")
        close(d2, np.asarray(g2)[16 * m:16 * m + 16], err_msg=f"w2 {r}")


@pytest.mark.parametrize("tp", [2, 4])
def test_collective_matmuls_match_jax(worlds, tp):
    """`allgather_matmul` and `matmul_reducescatter` at tp 2 and 4
    against the JAX package's shard_map forms; the overlapped pair's
    gradients against the monolithic all-gather / reduce-scatter pair's
    (as `tests/test_parallel.py` holds them); an indivisible leading dim
    raises as in the JAX package."""
    out, inp, _, _ = worlds
    mesh = _jmesh(model=tp) if tp == 4 else _jmesh(data=2, model=2)
    ag = jax.jit(jax.shard_map(
        jpar.allgather_matmul, mesh=mesh,
        in_specs=(P("model", None), P(None, "model")),
        out_specs=P(None, "model")))(inp["ag/x"], inp["ag/w"])
    rs = jax.jit(jax.shard_map(
        jpar.matmul_reducescatter, mesh=mesh,
        in_specs=(P(None, "model"), P("model", None)),
        out_specs=P("model", None)))(inp["rs/x"], inp["rs/w"])
    specs = (P("model", None), P(None, "model"), P("model", None))

    def monolithic(x, w1, w2):
        full = jax.lax.all_gather(x, "model", tiled=True)
        return jax.lax.psum_scatter(full @ w1 @ w2, "model", tiled=True)

    def loss(x, w1, w2):
        y = jax.shard_map(monolithic, mesh=mesh, in_specs=specs,
                          out_specs=P("model", None))(x, w1, w2)
        return jnp.sum(y * y)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(inp[f"cm{tp}/{n}"] for n in ("x", "w1", "w2")))
    ag, rs = np.asarray(ag), np.asarray(rs)
    for r in range(4):
        res = out["A"][r]["res"]
        m = r % tp
        cw, rw = ag.shape[1] // tp, rs.shape[0] // tp
        _close(res[f"ag{tp}"].numpy(), ag[:, m * cw:(m + 1) * cw])
        _close(res[f"rs{tp}"].numpy(), rs[m * rw:(m + 1) * rw])
        for got, want, dim in zip(res[f"cm{tp}"], grads, (0, 1, 0)):
            want = np.split(np.asarray(want), tp, axis=dim)[m]
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                       rtol=2e-4)
        errs = dict(e.split(": ", 1) for e in out["A"][r]["errors"])
        assert errs[f"indivisible{tp}"].startswith(
            f"ValueError leading dim {4 * tp + 1} not divisible")


# -- the LM ----------------------------------------------------------------

@pytest.mark.parametrize("weight_quant", [None, "int8"])
@pytest.mark.parametrize("arch", ["gpt", "llama-gqa"])
def test_lm_param_specs_equal_jax(arch, weight_quant):
    """`lm_param_specs` gives every parameter the JAX package's spec, by
    name."""
    kw = dict(weight_quant=weight_quant)
    if arch == "llama-gqa":
        kw.update(num_kv_heads=2, pos_emb="rope", attn_bias=True,
                  **tt.LLAMA_ARCH_KW)
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=H,
                          head_dim=D, max_len=MAX_LEN, dtype=jnp.float32,
                          **kw)
    want = jt.lm_param_specs(jm, jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, P))[0]:
        name = ".".join(str(p.key) for p in path)
        name = name.replace("block_", "blocks.", 1) if name.startswith(
            "block_") else name
        flat[name] = tuple(spec)
    tm = tt.TransformerLM(VOCAB, LAYERS, H, D, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu", **kw)
    assert tt.lm_param_specs(tm) == flat


@pytest.mark.parametrize("name", list(LM_CASES))
def test_sharded_lm_forward_matches_jax(worlds, name):
    """The LM forward under (data=2, model=2) and (seq=2, model=2) (ring
    and ring_flash): each rank's gathered logits block against the JAX
    package's forward of the same weights (its own sharded-forward test
    holds the mesh to that); shard -> gather round-trips bitwise, the
    int8 model's shard is the quantized whole model's, and the caches
    hold the kv heads each rank's query heads read."""
    out, inp, params, _ = worlds
    mk, impl, pos_emb, kv, vocab = LM_CASES[name]
    toks = inp["tokens"] % vocab
    ref = np.asarray(_jax_lm("dot", pos_emb, kv, vocab).apply(
        {"params": params[name]}, jnp.asarray(toks)))
    for r in range(4):
        res = out["A"][r]["res"]
        got = res[f"lm/{name}"].numpy()
        if mk == "dm":
            want = ref[2 * (r // 2):2 * (r // 2) + 2]
        else:
            want = ref[:, 8 * (r // 2):8 * (r // 2) + 8]
        _close(got, want, f"{name} rank {r}")
        assert res[f"roundtrip/{name}"] == []
        if mk == "dm":
            assert res[f"int8/{name}"] == []
            assert res[f"local_kv/{name}"] == (1 if kv in (1, 2) else 2)


@pytest.mark.parametrize("name", ["dm-blockwise", "dm-flash-gqa",
                                  "dm-mqa-untied", "dm-vocab63"])
def test_quantized_tp_lm_matches_jax_int8(worlds, name):
    """`quantize_lm` of the tensor-parallel model over (data=2,
    model=2): each rank's gathered logits and the eval step's loss
    against the JAX package's int8 model on the quantized whole tree
    (the vocab-parallel head keeps gathering the whole vocabulary)."""
    from horovod_tpu.ops.quantization import quantize_lm_params
    out, inp, params, _ = worlds
    _, impl, pos_emb, kv, vocab = LM_CASES[name]
    toks = jnp.asarray(inp["tokens"] % vocab)
    jm = _jax_lm("dot", pos_emb, kv, vocab).clone(weight_quant="int8")
    ref = jm.apply({"params": quantize_lm_params(params[name])}, toks)
    loss = float(jt.lm_loss(ref, toks))
    ref = np.asarray(ref)
    for r in range(4):
        res = out["A"][r]["res"]
        got = res[f"int8lm/{name}"].numpy()
        assert got.shape == (2, 16, vocab)
        _close(got, ref[2 * (r // 2):2 * (r // 2) + 2], f"{name} rank {r}")
        assert abs(float(res[f"int8loss/{name}"]) - loss) <= TOL


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_over_model_mesh_matches_jax(worlds, name):
    """One SGD step over (data=2, model=2), and over (seq=2, model=2)
    with ring_flash, RoPE and GQA 4:2: the loss, the eval step's loss
    and every updated parameter (gathered) against the JAX package's
    make_lm_train_step on its (data=4, model=2) or (data=2, seq=2,
    model=2) mesh from the same weights and global batch (its plain
    ring computes the function of the port's ring_flash). The vocab-63
    model keeps embed and head whole (safe_spec) and takes the plain
    loss."""
    out, inp, params, _ = worlds
    mk, impl, pos_emb, kv, vocab = STEP_CASES[name]
    if mk == "dm":
        mesh, spec = _jmesh(data=4, model=2), P("data", None)
    else:
        mesh, spec = _jmesh(data=2, seq=2, model=2), P("data", "seq")
        impl = "ring"
    model = _jax_lm(impl, pos_emb, kv, vocab)
    tx = optax.sgd(LR)
    step = jt.make_lm_train_step(model, tx, mesh, donate=False)
    toks = jax.device_put(jnp.asarray(inp["step_tokens"] % vocab),
                          NamedSharding(mesh, spec))
    new, _, loss = step(params[name], tx.init(params[name]), toks)
    ref = params_from_jax(jax.tree.map(np.asarray, new))
    for r in range(4):
        res = out["A"][r]["res"]
        assert res[f"{name}/vocab_parallel"] is (vocab == 64)
        assert abs(float(res[f"{name}/loss"]) - float(loss)) <= TOL
        assert abs(float(res[f"{name}/eval"]) - float(loss)) <= TOL
        for n, want in ref.items():
            _close(res[f"{name}/state"][n].numpy(), want.numpy(),
                   f"rank {r} {n}")


def test_serving_caches_cut_to_the_ranks_kv_heads(worlds):
    """`shard_slot_cache` / `shard_paged_pools` cut a whole model's
    caches on the heads dim: GQA 4:2 keeps one kv head a rank; MQA keeps
    its one kv head given the query heads, and without them stays whole
    (the JAX package's `safe_spec` degrade)."""
    out, _, _, _ = worlds
    for r in range(4):
        res = out["A"][r]["res"]
        for kv, heads in ((2, 4), (2, None), (1, 4), (1, None)):
            slot, paged, same_slot, same_paged = res[f"cache/{kv}/{heads}"]
            assert slot == [(2, MAX_LEN, 1, D)] * 2
            assert paged == [(5, BS, 1, D)] * 2
            assert same_slot and same_paged


def test_tp_refusals_name_their_cause(worlds):
    """A layout tp cannot split raises before any work; the pipe axis
    raises naming its slice (the expert axis is ported,
    `tests/test_torch_port_moe.py`, and builds); a model mesh wants the
    model built over it."""
    out, _, _, _ = worlds
    errs = dict(e.split(": ", 1) for e in out["A"][0]["errors"])
    assert errs["heads"].startswith("ValueError tp=2")
    assert "straddle" in errs["heads"]
    assert errs["expert"] == "no error"
    assert errs["pipe"].startswith("NotImplementedError") and (
        "pipeline parallelism" in errs["pipe"])
    assert errs["unsharded model"].startswith(
        "ValueError a mesh with model > 1 needs the model built")
    assert errs["distributed optimizer"].startswith(
        "ValueError make_lm_train_step over a mesh averages the gradients")


def test_auto_restart_refused_on_a_mesh(worlds):
    """A restart would swap the leader's pool while a follower waits in
    an all-reduce: `auto_restart` on a serving mesh raises on every
    rank, naming ROADMAP Queue A 5."""
    out, _, _, _ = worlds
    for r in range(2):
        errs = dict(e.split(": ", 1) for e in out["B"][r]["errors"])
        assert errs["auto_restart"].startswith(
            "NotImplementedError auto_restart on a serving mesh")
        assert "Queue A 5" in errs["auto_restart"]


def test_qkv_columns_are_q_then_k_then_v_heads():
    """Rank r's fused qkv columns: its q heads, then its kv heads' k and
    v columns (not a contiguous block of the fused dim); GQA with Hkv %
    tp != 0 keeps the one kv head its query group reads."""
    cols = ttensor.qkv_columns(1, 4, 2, 2, 2).tolist()
    assert cols == [4, 5, 6, 7, 10, 11, 14, 15]
    assert ttensor.kv_heads_of(1, 8, 1, 2) == [0]
    assert ttensor.kv_heads_of(3, 8, 2, 4) == [1]
    with pytest.raises(ValueError, match="num_heads=4"):
        ttensor.kv_heads_of(0, 4, 4, 3)


# -- sharded serving --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_streams(worlds):
    """The JAX package's UNSHARDED engine on every serving case, with
    the requests the port's leader served."""
    _, inp, params, spec = worlds
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=H,
                          head_dim=D, max_len=MAX_LEN, dtype=jnp.float32)
    out = {}
    reqs = [(inp[f"serve/p{i}"], *spec["sampling"][i]) for i in range(4)]
    for pool, quant in SERVE_CASES:
        kw = dict(num_slots=2, paged=pool == "paged",
                  weight_quant=None if quant == "fp32" else "int8",
                  prefill_chunk_budget=4)
        if pool == "paged":
            kw["kv_block_size"] = BS
        with JEngine(jm, params["serve"], **kw) as eng:
            hs = [eng.submit(p, STEPS, temperature=t, top_p=tp, seed=s)
                  for p, t, tp, s in reqs]
            out[f"{pool}-{quant}"] = [list(map(int, h.result(
                timeout=300).tokens)) for h in hs]
    for key, ps in (("prefix", [inp[f"prefix/p{i}"] for i in range(3)]),
                    ("migrate", [inp["migrate/p"]])):
        out[key] = [np.asarray(jt.generate(
            jm, params["serve"], jnp.asarray(p)[None], steps=STEPS))[
                0, len(p):].tolist() for p in ps]
    return out


@pytest.mark.parametrize("pool,quant", SERVE_CASES)
def test_sharded_streams_equal_jax_unsharded_engine(worlds, jax_streams,
                                                    pool, quant):
    """The leader's streams at mesh=2 (greedy and seeded lanes mixed)
    are the JAX package's unsharded engine's, token for token, on both
    pools, fp32 and int8."""
    out, _, _, _ = worlds
    res = out["B"][0]["res"]
    assert res[f"serve/{pool}-{quant}"] == jax_streams[f"{pool}-{quant}"]
    assert res[f"weights/{pool}-{quant}"] == (
        None if quant == "fp32" else "int8")


def test_prefix_hits_across_shards(worlds, jax_streams):
    """Prompts sharing two full blocks hit the sharded paged pool's
    prefix cache (one host block id names every rank's head slice of
    the block), and their streams stay the reference's."""
    out, _, _, _ = worlds
    res = out["B"][0]["res"]
    assert res["prefix_cached"] == [0, 2 * BS, 2 * BS]
    assert res["prefix"] == jax_streams["prefix"]


@pytest.mark.parametrize("leg", ["None->2", "2->None"])
def test_forced_prefix_migration_across_layouts(worlds, jax_streams, leg):
    """Token-exact migration between a sharded and an unsharded engine,
    both ways: the forced prefix teacher-forces the tokens already
    emitted and the survivor continues the exact greedy stream."""
    out, _, _, spec = worlds
    head, tail = out["B"][0]["res"][f"migrate/{leg}"]
    ref = jax_streams["migrate"][0]
    assert head == ref[:spec["migrate_k"]]
    assert tail == ref


def test_door_shards_a_serving_model_at_its_dtypes(worlds):
    """A bf16 serving model sharded at the engine's door keeps its bf16
    kernels, its vocab-sharded head (a `VocabShard`, so the logits
    gather) and
    this rank's qkv columns (2 of 4 heads: q, k and v, 8 wide each)."""
    out, _, _, _ = worlds
    assert out["B"][0]["res"]["door"] == [
        "torch.bfloat16", "torch.bfloat16", True, (32, 48)]


def test_mesh_forms_env_stamp_and_shard_gauges(worlds):
    """An 'axis=N' str, an int and HVD_SERVE_MESH build the same layout;
    the stamp reaches /healthz and the snapshot; the per-shard KV rows
    agree and leave with the engine; a mesh wider than the world, or
    with another axis > 1, and a serving axis other than model raise; a
    follower refuses submits."""
    out, _, _, _ = worlds
    res = out["B"][0]["res"]
    for form in ("model=2", 2, "env"):
        assert res[f"form/{form}"] == [2, {"model": 2}]
    free0, free1, used0, used1 = res["gauges"]
    assert free0 > 0 and free0 == free1 and used0 == used1
    assert res["gauge_mesh"] == 2
    assert res["snap_mesh"] == [2, {"model": 2}]
    assert res["gauges_after"] == []
    for r in range(2):
        errs = dict(e.split(": ", 1) for e in out["B"][r]["errors"])
        assert errs["mesh=99"].startswith("ValueError serving mesh")
        assert "needs 99 devices" in errs["mesh=99"]
        assert errs["mesh=seq=2"].startswith("ValueError")
        assert errs["mesh=model=2,data=1,seq=1"] == "no error"
        assert errs["axis"].startswith("NotImplementedError serving mesh "
                                       "axis 'data'")
    errs = dict(e.split(": ", 1) for e in out["B"][1]["errors"])
    assert errs["follower submit"].startswith("RuntimeError submit on a "
                                              "follower")


def test_follower_dropping_a_descriptor_raises_divergence(worlds):
    """A follower that drops one free descriptor: its host state leaves
    the leader's, and the next descriptor's digest check raises
    `ShardDivergence` instead of serving on."""
    out, _, _, _ = worlds
    got = out["divergence"][1]
    assert got.startswith("ShardDivergence"), got
    assert "digest" in got


def test_router_refuses_sharded_replicas():
    """A router over sharded replicas is a later slice: a replica whose
    engine serves on a mesh is shut down and refused, naming ROADMAP
    Queue A 5."""
    from horovod_tpu_torch.serving import router

    class Sharded:
        mesh_devices = 2
        closed = False

        def shutdown(self, drain=True):
            self.closed = True
    eng = Sharded()
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        router._unsharded(eng)
    assert eng.closed
