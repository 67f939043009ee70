"""PyTorch port: mixture of experts and expert parallelism against the
JAX package.

The router (`top_k_gating`), the capacity routing (each kept (token,
choice) against the JAX package's one-hot dispatch and combine), the
`MoELayer` forward and gradients, the one-lane routing of the serving
pools (``route_rows``) against a `jax.vmap` of the JAX layer, and the
MoE `TransformerLM` (``moe_every=2``): logits after `params_from_jax`,
an AdamW step with the load-balancing term, the eval step's pure cross
entropy, greedy `generate`, and both serving pools' streams against the
JAX engine's, at a drop-free capacity factor and at the default 1.25.

One module fixture starts a four-rank gloo world that imports only the
port (``python -c``), at once, so it runs while the single-process
cases do: (data=2, expert=2), (data=2, seq=2) and (expert=2, model=2)
meshes. There the layer with global capacity, global slot order and
global aux means equals the unsharded layer (outputs, the aux summed
over the data x seq shares, every gradient), one SGD train step
equals the JAX package's step on the same mesh shape, the eval step
its eval, the all-to-all shuffle the JAX package's, and a gathered
checkpoint written by rank 0 restores into the shards. The JAX
references run here on the 8-device CPU mesh.

Tolerances, float32 on both sides (summation order only): router gates
and aux within 1e-6, indices and slot routing equal; layer and LM
outputs and gradients within 1e-5 of the largest reference magnitude;
losses and SGD parameters within 1e-5; AdamW parameters within 0.01
x lr per step (it divides by sqrt(v), so ulp-level gradient
differences become O(lr) steps where a gradient is near zero, as
`test_torch_port_train.py` holds it; the world's mesh steps use SGD,
which holds the gradients themselves, since the experts' sparse
gradients put more elements near zero); token streams identical.
"""

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
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.quantization import quantize_lm_params as jquantize
from horovod_tpu.parallel import expert as jex
from horovod_tpu.parallel.mesh import make_mesh as jmake_mesh
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu.serving import ServingEngine as JEngine
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops.quantization import quantize_lm
from horovod_tpu_torch.parallel import expert as tex
from horovod_tpu_torch.serving import ServingEngine

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
GATE_TOL = 1e-6
VOCAB, LAYERS, HEADS, HEAD_DIM, MAX_LEN, EXPERTS = 64, 2, 4, 8, 32, 4
LR = 1e-2
WD = 1e-4
LR_SGD = 0.1
# The layer's toy width: d, hidden, experts, k.
D, HID, E, K = 16, 32, 4, 2
# Capacity factors: two that drop tokens, the JAX default, drop-free.
FACTORS = [0.5, 1.0, 1.25, 8.0]
LAYER_FACTORS = [0.5, 1.25, 8.0]
SERVE_FACTORS = [1.25, 8.0]
# The world's train steps: name -> (mesh axes, capacity factor).
STEP_MESHES = {"dm": dict(data=2, expert=2), "em": dict(expert=2, model=2)}
STEP_FACTOR = 1.0

WORKER = r'''
import sys, numpy as np, torch, torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.compat.from_jax import (gather_state_dict,
                                               shard_state_dict)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel import expert as X, mesh as M, tensor as PT
from horovod_tpu_torch.serving import ServingEngine
from horovod_tpu_torch.utils import checkpoint as ckpt
rank, store, work = sys.argv[1:]
r = int(rank)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=r, size=4, init_method="file://" + store)
inp = dict(np.load(f"{work}/inputs.npz"))
spec = torch.load(f"{work}/spec.pt")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
res, errors = {}, []
meshes = {"dm": M.make_mesh(data=2, expert=2, device_type="cpu"),
          "sm": M.make_mesh(data=2, seq=2, device_type="cpu"),
          "em": M.make_mesh(expert=2, model=2, device_type="cpu")}

# The layer over (data=2, expert=2) and (data=2, seq=2): this rank's
# block of y, its aux share, its x gradient, and its parameter
# gradients (this rank's experts).
for mk in ("dm", "sm"):
    mesh = meshes[mk]
    for cf in spec["layer_factors"]:
        sd = torch.load(f"{work}/layer.pt")
        full = X.MoELayer(spec["E"], spec["hid"], spec["d"], k=spec["k"],
                          capacity_factor=cf, dtype=torch.float32,
                          device="cpu")
        m = X.MoELayer(spec["E"], spec["hid"], spec["d"], k=spec["k"],
                       capacity_factor=cf, dtype=torch.float32, mesh=mesh,
                       device="cpu")
        m.load_state_dict(PT.shard_params(mesh, full, sd))
        with M.use(mesh):
            x = M.shard_batch(mesh, T(inp["layer/x"])).requires_grad_()
            c = M.shard_batch(mesh, T(inp["layer/c"]))
            y, aux = m(x)
            ((y * c).sum() + 0.3 * aux).backward()
        res[f"layer/{mk}/{cf}"] = [y.detach(), aux.detach(), x.grad,
                                   {k: p.grad for k, p in
                                    m.named_parameters()},
                                   m.counts.tolist()]

def lm(mesh, cf):
    return tt.TransformerLM(spec["vocab"], 2, 4, 8, max_len=32,
                            dtype=torch.float32, attn_impl="blockwise",
                            moe_every=2, num_experts=spec["E_lm"],
                            moe_capacity_factor=cf, mesh=mesh,
                            device="cpu")

# One SGD step (with the aux term) and the eval step, then the whole
# updated model; the bytes the step gave the expert axis.
sd = torch.load(f"{work}/lm.pt")
for mk in spec["steps"]:
    mesh = meshes[mk]
    m = lm(mesh, spec["step_factor"])
    m.load_state_dict(shard_state_dict(m, sd, mesh))
    opt = torch.optim.SGD(m.parameters(), lr=spec["lr"])
    toks = M.shard_batch(mesh, T(inp["tokens"]))
    res[f"{mk}/eval"] = tt.make_lm_eval_step(m, mesh)(toks)
    X.reset_moe_counts(m)
    C.reset_axis_bytes("expert")
    res[f"{mk}/loss"] = tt.make_lm_train_step(m, opt, mesh)(toks)
    res[f"{mk}/expert_bytes"] = C.axis_bytes("expert")
    res[f"{mk}/counts"] = X.moe_counts(m)
    res[f"{mk}/state"] = gather_state_dict(m, m.state_dict(), mesh)
    res[f"{mk}/w1_shape"] = tuple(m.blocks[1].moe.w1.shape)
    if mk == "dm":
        # A checkpoint of the gathered state written by rank 0 restores
        # into every rank's shard bitwise.
        whole = res[f"{mk}/state"]
        ckpt.save(f"{work}/ckpt", {"model": whole})
        dist.barrier()
        back = ckpt.restore(f"{work}/ckpt", like={"model": whole},
                            broadcast=True)["model"]
        mine = shard_state_dict(m, back, mesh)
        res["ckpt"] = sorted(k for k, v in m.state_dict().items()
                             if not torch.equal(mine[k], v))

# Horovod's data-parallel path (no mesh, a DistributedOptimizer): each
# rank routes its own row alone.
m = lm(None, spec["step_factor"])
m.load_state_dict(sd)
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                               lr=spec["lr"]))
res["dp/loss"] = tt.make_lm_train_step(m, opt)(T(inp["tokens"])[r:r + 1])
res["dp/state"] = m.state_dict()

# The explicit shuffle over (data=2, expert=2)'s expert axis: this
# rank's [E, C_local, d] buffer out and back.
with M.use(meshes["dm"]):
    ei = M.axis_index("expert", meshes["dm"])
    buf = T(inp["a2a/buf"])[:, ei * 3:(ei + 1) * 3].contiguous()
    buf.requires_grad_()
    out = X.expert_alltoall_dispatch(buf)
    back = X.expert_alltoall_combine(out)
    (out * T(inp["a2a/c"])[ei]).sum().backward()
    res["a2a"] = [out.detach(), back.detach(), buf.grad]

for what, make in (
        ("pipe", lambda: M.make_mesh(pipe=2, data=2, device_type="cpu")),
        ("indivisible", lambda: X.MoELayer(3, 8, 4, mesh=meshes["dm"],
                                           device="cpu")),
        ("unsharded", lambda: tt.make_lm_train_step(
            lm(None, 1.25), torch.optim.SGD([torch.zeros(1)], lr=0.1),
            meshes["dm"])),
        ("serving", lambda: ServingEngine(
            lm(None, 1.25), num_slots=1, mesh=meshes["dm"]))):
    try:
        make()
        errors.append(f"{what}: no error")
    except (ValueError, NotImplementedError) as e:
        errors.append(f"{what}: {type(e).__name__} {e}")
torch.save({"res": res, "errors": errors}, f"{work}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * max(np.abs(ref).max(), 1.0), (err, tol)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_layer(cf):
    return jex.MoELayer(num_experts=E, hidden=HID, k=K, capacity_factor=cf,
                        dtype=jnp.float32)


def _layer_params():
    x = np.zeros((1, 4, D), np.float32)
    return jax.tree.map(np.asarray, unbox(jax.jit(_jax_layer(1.25).init)(
        jax.random.PRNGKey(3), x))["params"])


def _port_layer(params, cf, **kw):
    m = tex.MoELayer(E, HID, D, k=K, capacity_factor=cf,
                     dtype=torch.float32, device="cpu", **kw)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in params.items()})
    return m


def _layer_inputs(seed=4, shape=(4, 8)):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape, D).astype(np.float32),
            rs.randn(*shape, D).astype(np.float32))


def _jax_layer_grads(params, cf, x, c):
    """y, aux and the gradients of (y * c).sum() + 0.3 aux."""
    layer = _jax_layer(cf)

    def loss(p, xx):
        y, st = layer.apply({"params": p}, xx, mutable=["losses"])
        aux = sum(jnp.asarray(a).sum() for a in jax.tree.leaves(st))
        return (y * c).sum() + 0.3 * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(y), float(aux), np.asarray(gx), jax.tree.map(
        np.asarray, gp)


def _jax_lm(cf=1.25, **kw):
    return jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                            num_heads=HEADS, head_dim=HEAD_DIM,
                            max_len=MAX_LEN, dtype=jnp.float32,
                            moe_every=2, num_experts=EXPERTS,
                            moe_capacity_factor=cf, **kw)


def _port_lm(params, cf=1.25, **kw):
    m = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                         dtype=torch.float32, moe_every=2,
                         num_experts=EXPERTS, moe_capacity_factor=cf,
                         device="cpu", **kw)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return m


def _tokens(seed, shape=(4, 16)):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


@pytest.fixture(scope="module")
def lm_params():
    """The JAX MoE LM's weights, the router drawn at 4x its init scale
    so routing is decisive (a near-uniform router rarely overflows an
    expert at these widths)."""
    p = unbox(jax.jit(_jax_lm().init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))["params"])
    p = jax.tree.map(np.asarray, p)
    p["block_1"]["moe"]["router"] = 4.0 * p["block_1"]["moe"]["router"]
    return p


# -- the world --------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory, lm_params):
    """Start the four-rank world at module start (it runs beside the
    single-process cases); `world_out` waits for it."""
    d = tmp_path_factory.mktemp("moe_world")
    rs = np.random.RandomState(21)
    x, c = _layer_inputs(seed=22)
    inp = {"layer/x": x, "layer/c": c, "tokens": _tokens(23),
           "a2a/buf": rs.randn(4, 2 * 3, 8).astype(np.float32),
           "a2a/c": rs.randn(2, 2, 2 * 3, 8).astype(np.float32)}
    np.savez(d / "inputs.npz", **inp)
    lp = _layer_params()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in lp.items()},
               d / "layer.pt")
    torch.save(params_from_jax(lm_params), d / "lm.pt")
    spec = dict(E=E, hid=HID, d=D, k=K, layer_factors=[0.5, 8.0],
                vocab=VOCAB, E_lm=EXPERTS, steps=list(STEP_MESHES),
                step_factor=STEP_FACTOR, lr=LR_SGD)
    torch.save(spec, d / "spec.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(d / "store"), str(d)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    yield dict(dir=d, procs=procs, inputs=inp, layer_params=lp, spec=spec)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world_out(world):
    outs = []
    for p in world["procs"]:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for r, (p, out) in enumerate(zip(world["procs"], outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return [torch.load(world["dir"] / f"rank{r}.pt") for r in range(4)]


def _check_drops(cf, tokens, dropped):
    """Under a factor < 1 the experts' slots cannot hold every (token,
    choice), so some drop; at cf >= E / k every expert can take every
    token, so none does."""
    if tex.capacity(E, K, tokens, cf) * E < tokens * K:
        assert dropped > 0, (cf, dropped)
    if cf >= E / K:
        assert dropped == 0, (cf, dropped)


# -- the router and the routing ---------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "one_hot"])
def test_top_k_gating_matches_jax(case):
    """Gates and aux within 1e-6, indices equal: ties (equal logits)
    pick the lower expert id, as `lax.top_k`."""
    rs = np.random.RandomState(8)
    logits = rs.randn(32, 6).astype(np.float32)
    if case == "ties":
        logits[:, 2:5] = logits[:, :1]
    elif case == "one_hot":
        logits = np.zeros((32, 6), np.float32)
        logits[np.arange(32), rs.randint(0, 6, 32)] = 30.0
    for k in (1, 2, 3):
        jg, ji, ja = jex.top_k_gating(jnp.asarray(logits), k)
        tg, ti, ta = tex.top_k_gating(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tg.numpy(), np.asarray(jg), GATE_TOL)
        _close(float(ta), float(ja), GATE_TOL)


@pytest.mark.parametrize("cf", [0.25] + FACTORS)
def test_routing_matches_jax_dispatch_combine(cf):
    """Every kept (token, choice) sits in the (expert, slot) where the
    JAX package's one-hot dispatch puts it, with its combine weight;
    nothing else is dispatched (factors that drop and one that does
    not)."""
    rs = np.random.RandomState(9)
    T = 40
    logits = (2.0 * rs.randn(T, E)).astype(np.float32)
    gates, idx, _ = jex.top_k_gating(jnp.asarray(logits), K)
    C = tex.capacity(E, K, T, cf)
    dispatch, combine = jex._dispatch_combine(gates, idx, E, C)
    pos, keep = tex.route_tokens(torch.from_numpy(np.array(idx)), E, C)
    want_d = np.zeros((T, E, C), np.float32)
    want_c = np.zeros((T, E, C), np.float32)
    g = np.asarray(gates)
    for t in range(T):
        for j in range(K):
            if keep[t, j]:
                want_d[t, int(idx[t, j]), int(pos[t, j])] = 1.0
                want_c[t, int(idx[t, j]), int(pos[t, j])] = g[t, j]
    np.testing.assert_array_equal(want_d, np.asarray(dispatch))
    _close(want_c, np.asarray(combine), GATE_TOL)
    _check_drops(cf, T, int((~keep).sum()))


# -- the layer ----------------------------------------------------------------

@pytest.mark.parametrize("cf", LAYER_FACTORS)
def test_moe_layer_matches_jax(cf):
    """Forward, aux, and the gradients of (y * c).sum() + 0.3 aux with
    respect to the input and every parameter, within 1e-5."""
    params = _layer_params()
    x, c = _layer_inputs()
    y, aux, gx, gp = _jax_layer_grads(params, cf, x, c)
    m = _port_layer(params, cf)
    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = m(xt)
    ((ty * torch.from_numpy(c)).sum() + 0.3 * taux).backward()
    _close(_np(ty), y)
    _close(float(taux.detach()), aux)
    _close(xt.grad.numpy(), gx)
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), gp[name])
    routed, dropped = m.counts.tolist()
    assert routed == x.shape[0] * x.shape[1] * K
    _check_drops(cf, x.shape[0] * x.shape[1], dropped)


@pytest.mark.parametrize("cf", [0.5])
def test_route_rows_is_the_vmapped_jax_layer(cf):
    """``route_rows``: each row routed alone with its own capacity, as
    the JAX serving pools vmap a one-lane call over the slots."""
    params = _layer_params()
    x, _ = _layer_inputs(seed=5, shape=(5, 6))
    layer = _jax_layer(cf)
    want = jax.jit(jax.vmap(lambda row: layer.apply(
        {"params": params}, row[None])[0]))(jnp.asarray(x))
    got, _ = _port_layer(params, cf)(torch.from_numpy(x), route_rows=True)
    _close(_np(got), np.asarray(want))
    batched, _ = _port_layer(params, cf)(torch.from_numpy(x))
    whole = jax.jit(layer.apply)({"params": params}, jnp.asarray(x))
    _close(_np(batched), np.asarray(whole))
    if cf < 1.0:
        assert np.abs(np.asarray(want) - np.asarray(whole)).max() > 1e-3


# -- the LM -------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_lm_logits_match_jax(lm_params, cf):
    toks = _tokens(1)
    want = jax.jit(_jax_lm(cf).apply)({"params": lm_params},
                                      jnp.asarray(toks))
    got = _port_lm(lm_params, cf)(torch.from_numpy(toks))
    _close(_np(got), np.asarray(want))


def test_int8_lm_keeps_experts_float(lm_params):
    """`quantize_lm` of an MoE model quantizes the attention and dense
    MLP kernels and leaves the experts float (the JAX MoE layer takes
    no weight_quant); its logits equal the JAX int8 model's."""
    q = quantize_lm(_port_lm(lm_params))
    names = dict(q.named_parameters())
    assert names["blocks.1.moe.w1"].dtype == torch.float32
    assert "blocks.0.mlp.wi.kernel_q" in dict(q.named_buffers())
    assert "blocks.1.attn.qkv.kernel_q" in dict(q.named_buffers())
    jq = jquantize(lm_params)
    toks = _tokens(2)
    want = jax.jit(_jax_lm(weight_quant="int8").apply)(
        {"params": jq}, jnp.asarray(toks))
    _close(_np(q(torch.from_numpy(toks))), np.asarray(want))


def _jax_step(params, model, mesh, toks, tx):
    step = jt.make_lm_train_step(model, tx, mesh, donate=False)
    p, _, loss = step(params, tx.init(params), jnp.asarray(toks))
    return jax.tree.map(np.asarray, p), float(loss)


def _close_tree(tm, tree, tol):
    want = params_from_jax(tree)
    for name, p in tm.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), tol)


@pytest.mark.parametrize("loss_chunk", [None, 8])
def test_adamw_step_with_aux_matches_jax(lm_params, loss_chunk):
    """One AdamW step of the MoE LM with ``moe_aux_weight`` 0.01 against
    the JAX step: loss within 1e-5, parameters within 0.01 x lr."""
    toks = _tokens(3)
    tx = optax.adamw(LR, weight_decay=WD)
    mesh = jmake_mesh(data=1, devices=jax.devices()[:1])
    kw = {"loss_chunk": loss_chunk} if loss_chunk else {}
    step = jt.make_lm_train_step(_jax_lm(STEP_FACTOR), tx, mesh,
                                 donate=False, **kw)
    jp, _, jl = step(lm_params, tx.init(lm_params), jnp.asarray(toks))
    tm = _port_lm(lm_params, STEP_FACTOR)
    opt = torch.optim.AdamW(tm.parameters(), lr=LR, weight_decay=WD)
    tex.reset_moe_counts(tm)
    loss = tt.make_lm_train_step(tm, opt, loss_chunk=loss_chunk)(
        torch.from_numpy(toks))
    _close(float(loss), float(jl))
    _close_tree(tm, jax.tree.map(np.asarray, jp), 0.01 * LR)
    assert tex.moe_counts(tm)[1] > 0       # the step dropped tokens


def test_eval_step_is_pure_cross_entropy(lm_params):
    """The eval step reports the JAX eval step's loss (no aux term); the
    train step's loss sits 0.01 x aux above it on the same batch."""
    toks = _tokens(4)
    mesh = jmake_mesh(data=1, devices=jax.devices()[:1])
    want = jt.make_lm_eval_step(_jax_lm(), mesh)(lm_params,
                                                 jnp.asarray(toks))
    tm = _port_lm(lm_params)
    t = torch.from_numpy(toks)
    ev = float(tt.make_lm_eval_step(tm)(t))
    _close(ev, float(want))
    _, aux = tm(t, return_aux=True)
    train = float(tt.make_lm_train_step(
        tm, torch.optim.SGD(tm.parameters(), lr=0.0))(t))
    _close(train, ev + 0.01 * float(aux))
    assert float(aux) > 1.0


@pytest.mark.parametrize("cf", SERVE_FACTORS)
def test_generate_matches_jax(lm_params, cf):
    """Greedy `generate` (one-pass prefill of the [B, P] prompt, then
    [B, 1] ticks: the JAX package's T per call) token for token."""
    prompt = _tokens(5, (3, 6))
    want = jt.generate(_jax_lm(cf), lm_params, jnp.asarray(prompt), steps=8)
    got = tt.generate(_port_lm(lm_params, cf), torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve_prompts():
    """Five prompts of 4, 8 or 12 tokens: every prefill chunk holds 4
    tokens (the budget), so each engine compiles one chunk program."""
    rs = np.random.RandomState(6)
    return [rs.randint(0, VOCAB, (4 * int(n),)) for n in rs.randint(1, 4, 5)]


def _streams(engine, prompts, steps=6):
    hs = [engine.submit(p, steps) for p in prompts]
    return [list(map(int, h.result(timeout=300).tokens)) for h in hs]


@pytest.mark.parametrize("pool", ["fixed", "paged"])
@pytest.mark.parametrize("cf", SERVE_FACTORS)
def test_engine_streams_match_jax_engine(lm_params, pool, cf):
    """Five greedy requests through 3 slots (lanes recycle, prefill
    chunks of 4 tokens interleave with ticks) on each pool:
    the JAX engine's streams, token for token. Each prefill chunk
    routes its own tokens, each tick each lane alone, as the JAX pools
    do (at 1.25 a chunk drops tokens; a one-lane tick never does)."""
    kw = dict(num_slots=3, prefill_chunk_budget=4)
    if pool == "paged":
        kw.update(paged=True, kv_block_size=4)
    prompts = _serve_prompts()
    with JEngine(_jax_lm(cf), lm_params, **kw) as eng:
        want = _streams(eng, prompts)
    tm = _port_lm(lm_params, cf)
    tex.reset_moe_counts(tm)
    with ServingEngine(tm, **kw) as eng:
        got = _streams(eng, prompts)
    assert got == want
    assert (tex.moe_counts(tm)[1] > 0) == (cf < 8.0)


def test_spec_engine_with_moe_target_matches_jax(lm_params):
    """Speculative rounds with an MoE target (its verify block routes
    each lane alone, as the JAX round's vmap does) give the JAX spec
    engine's streams."""
    kw = dict(num_slots=2, spec_k=3)
    prompts = _serve_prompts()[:3]
    jdraft = jax.tree.map(lambda a: a + 0.02 * np.random.RandomState(
        7).randn(*a.shape).astype(a.dtype), lm_params)
    with JEngine(_jax_lm(), lm_params, spec_draft=(_jax_lm(), jdraft),
                 **kw) as eng:
        want = _streams(eng, prompts)
    with ServingEngine(_port_lm(lm_params), spec_draft=_port_lm(jdraft),
                       **kw) as eng:
        got = _streams(eng, prompts)
    assert got == want


def test_checkpoint_round_trip(lm_params, tmp_path):
    """An MoE model's state saves and restores bitwise."""
    from horovod_tpu_torch.utils import checkpoint as ckpt
    tm = _port_lm(lm_params)
    ckpt.save(str(tmp_path / "c"), {"model": tm.state_dict()})
    back = ckpt.restore(str(tmp_path / "c"), like={"model": tm.state_dict()})
    again = _port_lm(lm_params)
    again.load_state_dict(back["model"])
    t = torch.from_numpy(_tokens(8))
    assert torch.equal(again(t), tm(t))


def test_refusals_name_their_slice(lm_params):
    """LoRA leaves still raise; an HF import asked for MoE blocks
    raises (no HF MoE family is in either package)."""
    from horovod_tpu_torch.compat.hf import from_hf_state_dict
    tree = {"block_0": {"attn": {"qkv": {"lora_a": np.zeros((4, 2))}}}}
    with pytest.raises(NotImplementedError, match="LoRA"):
        params_from_jax(tree)
    with pytest.raises(ValueError, match="mixture-of-experts"):
        from_hf_state_dict("llama", {}, {}, device="cpu", moe_every=2)


# -- expert parallelism, in the world ------------------------------------------

def _full_layer_grads(world, cf):
    x, c = world["inputs"]["layer/x"], world["inputs"]["layer/c"]
    return _jax_layer_grads(world["layer_params"], cf, x, c)


@pytest.mark.parametrize("mesh", ["dm", "sm"])
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_sharded_layer_matches_unsharded(world, world_out, mesh, cf):
    """(data=2, expert=2) and (data=2, seq=2): each rank's block of the
    output and of the input gradient is the unsharded layer's, the aux
    shares of the data x seq ranks sum to the global aux, and the
    parameter gradients summed over the data x seq ranks (router) or
    gathered over the expert ranks (w1, w2) are the unsharded ones —
    global capacity, global slot order, global aux means."""
    y, aux, gx, gp = _full_layer_grads(world, cf)
    B, S = y.shape[:2]
    got_y = np.zeros_like(y)
    got_gx = np.zeros_like(gx)
    grads = {n: np.zeros_like(v) for n, v in gp.items()}
    auxes = {}
    for r in range(4):
        ty, taux, tgx, tg, counts = world_out[r]["res"][f"layer/{mesh}/{cf}"]
        a, b = divmod(r, 2)       # (data, expert) or (data, seq)
        rows = slice(a * B // 2, (a + 1) * B // 2)
        cols = slice(b * S // 2, (b + 1) * S // 2) if mesh == "sm" \
            else slice(None)
        got_y[rows, cols] = _np(ty)
        got_gx[rows, cols] = _np(tgx)
        auxes[(a, b if mesh == "sm" else 0)] = float(taux)
        for n, g in tg.items():
            if n == "router" or mesh == "sm":
                grads[n] += _np(g) / (2 if mesh == "dm" else 1)
            else:
                half = E // 2
                grads[n][b * half:(b + 1) * half] += _np(g)
        assert counts[0] == ty.shape[0] * ty.shape[1] * K
    _close(got_y, y)
    _close(got_gx, gx)
    _close(sum(auxes.values()), aux)
    for n in grads:
        _close(grads[n], gp[n])


@pytest.fixture(scope="module")
def jax_mesh_steps(world, lm_params):
    """The JAX package's train and eval steps on each world mesh shape,
    here on the 8-device CPU mesh."""
    toks = world["inputs"]["tokens"]
    tx = optax.sgd(LR_SGD)
    out = {}
    model = _jax_lm(STEP_FACTOR, attn_impl="blockwise")
    for name, axes in STEP_MESHES.items():
        mesh = jmake_mesh(devices=jax.devices()[:4], **axes)
        out[name] = _jax_step(lm_params, model, mesh, toks, tx)
    one = jmake_mesh(data=1, devices=jax.devices()[:1])
    out["eval"] = float(jt.make_lm_eval_step(model, one)(
        lm_params, jnp.asarray(toks)))
    return out


@pytest.mark.parametrize("mesh", list(STEP_MESHES))
def test_ep_train_step_matches_jax_mesh_step(world_out, jax_mesh_steps,
                                             mesh):
    """One SGD step over (data=2, expert=2) and (expert=2, model=2)
    equals the JAX package's step on the same mesh shape: the loss on
    every rank and the gathered parameters within 1e-5.
    Each expert rank holds its half of the experts, the step dropped
    tokens, and it gave the expert axis the forward's output sums and
    the backward's input-gradient sums."""
    jp, jl = jax_mesh_steps[mesh]
    want = params_from_jax(jp)
    for r in range(4):
        res = world_out[r]["res"]
        _close(float(res[f"{mesh}/loss"]), jl)
        assert res[f"{mesh}/w1_shape"][0] == EXPERTS // 2
        assert res[f"{mesh}/counts"][1] > 0
        assert res[f"{mesh}/expert_bytes"] > 0
        for name, t in res[f"{mesh}/state"].items():
            _close(_np(t), want[name].numpy())


def test_data_parallel_path_routes_each_rank_alone(world, world_out,
                                                   lm_params):
    """Without a mesh (Horovod's data-parallel path, a
    `DistributedOptimizer` over the 4 ranks) each rank routes its own
    row alone, as each JAX process applies the model to its own batch:
    one SGD step equals the mean of the JAX steps on each row (SGD is
    linear in the gradient), the loss the mean of their losses."""
    toks = world["inputs"]["tokens"]
    tx = optax.sgd(LR_SGD)
    one = jmake_mesh(data=1, devices=jax.devices()[:1])
    step = jt.make_lm_train_step(_jax_lm(STEP_FACTOR, attn_impl="blockwise"),
                                 tx, one, donate=False)
    steps = []
    for r in range(4):
        p, _, loss = step(lm_params, tx.init(lm_params),
                          jnp.asarray(toks[r:r + 1]))
        steps.append((jax.tree.map(np.asarray, p), float(loss)))
    want = params_from_jax(jax.tree.map(
        lambda *a: np.mean(np.stack(a), 0), *[p for p, _ in steps]))
    for r in range(4):
        res = world_out[r]["res"]
        _close(float(res["dp/loss"]), np.mean([l for _, l in steps]))
        for name, t in res["dp/state"].items():
            _close(_np(t), want[name].numpy())


@pytest.mark.parametrize("mesh", list(STEP_MESHES))
def test_ep_eval_step_matches_jax(world_out, jax_mesh_steps, mesh):
    for r in range(4):
        _close(float(world_out[r]["res"][f"{mesh}/eval"]),
               jax_mesh_steps["eval"])


def test_alltoall_dispatch_combine_match_jax(world, world_out):
    """`expert_alltoall_dispatch` / `_combine` over (data=2, expert=2)'s
    expert axis against the JAX package's under shard_map: each rank's
    shuffled buffer, the round trip, and the dispatch's gradient."""
    buf = world["inputs"]["a2a/buf"]
    cot = world["inputs"]["a2a/c"]
    mesh = jmake_mesh(expert=2, data=2, devices=jax.devices()[:4])
    spec = P(None, "expert", None)

    def body(b):
        return jex.expert_alltoall_dispatch(b)

    fwd = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                                out_specs=spec))
    want = np.asarray(fwd(jnp.asarray(buf)))         # [2, 2 x 6, 8]
    gwant = np.asarray(jax.grad(lambda b: (fwd(b) * jnp.concatenate(
        list(cot), axis=1)).sum())(jnp.asarray(buf)))
    for r in range(4):
        out, back, grad = world_out[r]["res"]["a2a"]
        e = r % 2
        _close(_np(out), want[:, e * 6:(e + 1) * 6])
        _close(_np(back), buf[:, e * 3:(e + 1) * 3])
        _close(_np(grad), gwant[:, e * 3:(e + 1) * 3])


def test_ep_checkpoint_and_refusals(world_out):
    """Rank 0 writes the gathered state; restored and sharded again it
    is every rank's shard bitwise. A pipe axis still raises naming its
    slice; experts that do not split over the axis, an unsharded model
    on an expert mesh, and serving over the expert axis are refused."""
    for r in range(4):
        assert world_out[r]["res"]["ckpt"] == []
    errs = dict(e.split(": ", 1) for e in world_out[0]["errors"])
    assert errs["pipe"].startswith("NotImplementedError") and (
        "pipeline parallelism" in errs["pipe"])
    assert errs["indivisible"].startswith("ValueError num_experts=3")
    assert errs["unsharded"].startswith(
        "ValueError a mesh with model > 1 needs the model built over it")
    assert "as does one with expert > 1" in errs["unsharded"]
    assert errs["serving"].startswith("NotImplementedError serving over "
                                      "the 'expert' axis")
