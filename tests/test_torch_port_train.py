"""PyTorch port: the training path against the JAX package.

The port's flash backward (`FlashAttentionFn`: the plain backward on
the CPU) against `jax.grad` of the JAX `flash_attention` with its fused
Pallas backward (interpret mode on the CPU, as the JAX tests run it);
the losses and a toy LM's train steps against the JAX
`make_lm_train_step`; `remat` and `adam_state_from_jax`.

Inputs are drawn with numpy from a seed and handed to both packages;
weights are drawn once by flax and loaded into the port with
`compat.from_jax.params_from_jax`. Tolerances, float32 on both sides
(summation order only): attention gradients and losses within 1e-5 of
the largest reference magnitude (readings <= 7e-7); parameters after
one SGD step within 1e-5 absolute (readings 3e-8). AdamW divides by
sqrt(v), which turns ulp-level gradient differences into O(lr) steps
where a gradient is near zero, so AdamW is held by its losses (1e-5
relative) and its parameters by 0.01 x lr per step and element (the
readings stay at or below 1.1e-4 x lr per step).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.parallel.mesh import make_mesh
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import (adam_state_from_jax,
                                               params_from_jax)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import flash_attention as tfa

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
VOCAB, LAYERS, HEADS, HEAD_DIM, MAX_LEN = 64, 2, 4, 8, 32
LR_SGD, LR_ADAM, WD = 0.1, 1e-2, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Toy shapes gain nothing from intra-op threads, and idle OpenMP
    threads spinning here would slow the JAX tests running beside this
    module in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * max(np.abs(ref).max(), 1.0), (err, tol)


# -- flash backward ---------------------------------------------------------

# The fused-backward cases of tests/test_transformer.py:
# (B, Sq, Sk, H, Hkv, D, flash kwargs, seed).
BWD_CASES = {
    "full": (2, 48, 48, 2, 2, 16, dict(causal=False), 101),
    "uneven": (2, 50, 50, 2, 2, 16, dict(causal=True), 102),
    "cross": (2, 32, 80, 2, 2, 16, dict(causal=False), 103),
    "offset": (2, 32, 32, 2, 2, 16, dict(causal=True, q_offset=32), 104),
    "window8": (2, 64, 64, 4, 4, 16, dict(causal=True, window=8), 9),
    "gqa": (2, 48, 48, 8, 2, 16, dict(causal=True), 4),
    "gqa_window8": (2, 48, 48, 8, 2, 16, dict(causal=True, window=8), 4),
}


def _bwd_inputs(case):
    B, Sq, Sk, H, Hkv, D, kw, seed = BWD_CASES[case]
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, H, D).astype(np.float32)
    k = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    v = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    w = rs.randn(B, Sq, H, D).astype(np.float32)
    return (q, k, v), w, kw


def _torch_grads(fn, arrays, *cots):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    loss.backward()
    return outs, [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_matches_jax_pallas(case):
    arrays, w, kw = _bwd_inputs(case)
    ref = jax.grad(lambda q, k, v: (jfa.flash_attention(
        q, k, v, block_q=16, block_k=16, bwd_impl="pallas", **kw)
        * w).sum(), argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    (out,), got = _torch_grads(
        lambda q, k, v: tfa.flash_attention(q, k, v, **kw), arrays, w)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    for g, r in zip(got, ref):
        _close(g, r)     # dK/dV at kv width: the shapes must agree too


@pytest.mark.parametrize("case", ["uneven", "gqa_window8", "cross"])
def test_flash_attention_lse_cotangent_matches_jax(case):
    """A cotangent on lse folds into dvec (dvec = rowsum(dO O) - dlse),
    as in the JAX package's `_make_flash_lse`."""
    arrays, w, kw = _bwd_inputs(case)
    B, Sq, H = arrays[0].shape[:3]
    wl = np.random.RandomState(7).randn(B, H, Sq).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, block_q=16, block_k=16,
                                         **kw)
        return (o * w).sum() + (lse * wl).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    _, got = _torch_grads(
        lambda q, k, v: tfa.flash_attention_lse(q, k, v, **kw), arrays, w,
        wl)
    for g, r in zip(got, ref):
        _close(g, r)


def _load_chip_smoke():
    """chip_smoke.py as a private module (it imports only the standard
    library at the top, so it loads without a card)."""
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bf16_rounded_p_ds_breaks_grad_tol_and_hi_lo_holds():
    """Why the bf16 backward kernels feed p and ds to the tensor cores as
    bf16 hi + bf16 lo: at [1, 2048, 2, 128] bf16 causal, the plain
    backward with p and ds rounded to ONE bf16 before the second-stage
    products (chip_smoke's planted fault) breaks chip_smoke's unchanged
    GRAD_TOL["bfloat16"] against the f32 plain backward in at least one
    of dQ, dK, dV, and the hi + lo split breaks it in none."""
    cs = _load_chip_smoke()
    rs = np.random.RandomState(31)
    q, k, v, g = (torch.from_numpy(rs.randn(1, 2048, 2, 128).astype(
        np.float32)).bfloat16() for _ in range(4))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=True)
    ref = tfa.flash_backward_plain(q, k, v, o, lse, g, causal=True)
    tol = cs.GRAD_TOL["bfloat16"]
    held = {}
    for split in (False, True):
        got = cs.rounded_backward(tfa, split)(q, k, v, o, lse, g,
                                              causal=True)
        held[split] = [cs.max_err(a, b, tol)[1] for a, b in zip(got, ref)]
    assert not all(held[False]), held
    assert all(held[True]), held


def test_bwd_impl_validation_and_env_override(monkeypatch):
    arrays, w, kw = _bwd_inputs("gqa_window8")
    q = torch.from_numpy(arrays[0])
    with pytest.raises(ValueError, match="bwd_impl"):
        tfa.flash_attention(q, q, q, bwd_impl="nope")
    monkeypatch.setenv("HOROVOD_FLASH_BWD", "recompue")
    with pytest.raises(ValueError, match="HOROVOD_FLASH_BWD"):
        tfa.flash_attention(q, q, q, causal=True)
    # auto resolves to recompute under the env var, and the recompute
    # backward matches the JAX package's recompute backward.
    monkeypatch.setenv("HOROVOD_FLASH_BWD", "recompute")
    ref = jax.grad(lambda q, k, v: (jfa.flash_attention(
        q, k, v, block_q=16, block_k=16, bwd_impl="recompute", **kw)
        * w).sum(), argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    (out,), got = _torch_grads(
        lambda q, k, v: tfa.flash_attention(q, k, v, **kw), arrays, w)
    assert type(out.grad_fn).__name__ == "FlashRecomputeFnBackward"
    for g, r in zip(got, ref):
        _close(g, r)
    # an explicit bwd_impl wins over the env var
    (out,), _ = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, bwd_impl="pallas", **kw), arrays, w)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    monkeypatch.delenv("HOROVOD_FLASH_BWD")
    assert tfa.resolve_bwd_impl("auto") == "pallas"


# -- losses and train steps -------------------------------------------------

def _jax_model(impl):
    return jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                            num_heads=HEADS, head_dim=HEAD_DIM,
                            max_len=MAX_LEN, dtype=jnp.float32,
                            attn_impl=impl)


def _port_model(impl, params, **kw):
    m = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                         dtype=torch.float32, attn_impl=impl, device="cpu",
                         **kw)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return m


@pytest.fixture(scope="module")
def params():
    return unbox(_jax_model("dot").init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32))["params"])


def _tokens(B=4, S=16, seed=3):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, S))


def _close_tree(port_model, jax_tree, tol=TOL, grads=False):
    """Every port parameter (or its .grad) against the JAX tree."""
    ref = params_from_jax(jax.tree.map(np.asarray, jax_tree))
    for name, p in port_model.named_parameters():
        got = p.grad if grads else p.detach()
        err = float((got - ref[name]).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("chunk", [None, 5, 8, 32])
def test_lm_losses_and_grads_match_jax(params, chunk):
    """`lm_loss` (chunk None) and `chunked_lm_loss` (ragged chunks 5 and
    8 over P = 15 positions, and chunk > P): the same value and
    gradients as the JAX functions."""
    jm = _jax_model("dot")
    toks = _tokens()

    def jloss(p):
        if chunk is None:
            return jt.lm_loss(jm.apply({"params": p}, jnp.asarray(toks)),
                              jnp.asarray(toks))
        hidden, head = jm.apply({"params": p}, jnp.asarray(toks),
                                return_hidden=True)
        return jt.chunked_lm_loss(hidden, head, jnp.asarray(toks),
                                  chunk=chunk)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    tm = _port_model("dot", params)
    t = torch.from_numpy(toks)
    if chunk is None:
        loss = tt.lm_loss(tm(t), t)
    else:
        hidden, head = tm(t, return_hidden=True)
        loss = tt.chunked_lm_loss(hidden, head, t, chunk=chunk)
    loss.backward()
    _close(loss.item(), float(ref_loss))
    _close_tree(tm, ref_grads, grads=True)


def _jax_steps(params, impl, tx, loss_chunk, toks, n):
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    kw = {"loss_chunk": loss_chunk} if loss_chunk else {}
    step = jt.make_lm_train_step(_jax_model(impl), tx, mesh, donate=False,
                                 **kw)
    p, opt, losses = params, tx.init(params), []
    for _ in range(n):
        p, opt, loss = step(p, opt, jnp.asarray(toks))
        losses.append(float(loss))
    return p, opt, losses


def _port_steps(params, impl, opt_fn, loss_chunk, toks, n, **model_kw):
    tm = _port_model(impl, params, **model_kw)
    opt = opt_fn(tm.parameters())
    step = tt.make_lm_train_step(tm, opt, loss_chunk=loss_chunk)
    t = torch.from_numpy(toks)
    losses = [float(step(t)) for _ in range(n)]
    return tm, opt, losses


@pytest.mark.parametrize("loss_chunk", [None, 8])
@pytest.mark.parametrize("impl", ["dot", "blockwise", "flash"])
def test_sgd_step_matches_jax(params, impl, loss_chunk):
    toks = _tokens(seed=11)
    jp, _, jl = _jax_steps(params, impl, optax.sgd(LR_SGD), loss_chunk,
                           toks, 1)
    tm, _, tl = _port_steps(params, impl,
                            lambda ps: torch.optim.SGD(ps, lr=LR_SGD),
                            loss_chunk, toks, 1)
    _close(tl, jl)
    _close_tree(tm, jp)


@pytest.mark.parametrize("loss_chunk", [None, 8])
@pytest.mark.parametrize("impl", ["dot", "blockwise", "flash"])
def test_adamw_steps_match_jax(params, impl, loss_chunk):
    toks = _tokens(seed=12)
    jp, _, jl = _jax_steps(params, impl,
                           optax.adamw(LR_ADAM, weight_decay=WD),
                           loss_chunk, toks, 3)
    tm, _, tl = _port_steps(
        params, impl,
        lambda ps: torch.optim.AdamW(ps, lr=LR_ADAM, weight_decay=WD),
        loss_chunk, toks, 3)
    _close(tl, jl)
    _close_tree(tm, jp, tol=0.01 * LR_ADAM * 3)


def test_remat_matches_plain_blocks(params):
    """`remat=True` (each block under `torch.utils.checkpoint`) gives
    the same loss and gradients as `remat=False`."""
    toks = torch.from_numpy(_tokens(seed=13))
    out = []
    for remat in (False, True):
        tm = _port_model("flash", params, remat=remat)
        hidden, head = tm(toks, return_hidden=True)
        loss = tt.chunked_lm_loss(hidden, head, toks, chunk=8)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in tm.parameters()]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_step_matches_train_loss(params):
    """The eval step reports the train step's (pre-update) loss."""
    toks = torch.from_numpy(_tokens(seed=14))
    tm = _port_model("flash", params)
    ev = tt.make_lm_eval_step(tm, loss_chunk=8)
    before = float(ev(toks))
    step = tt.make_lm_train_step(tm, torch.optim.SGD(tm.parameters(),
                                                     lr=LR_SGD))
    _close(float(step(toks)), before)
    assert float(ev(toks)) < before


def test_adam_state_from_jax_continues_a_jax_run(params):
    """Two AdamW steps in JAX, then the params and optimizer state
    carried into the port: its third step equals the JAX third step."""
    toks = _tokens(seed=15)
    tx = optax.adamw(LR_ADAM, weight_decay=WD)
    p2, opt2, _ = _jax_steps(params, "dot", tx, None, toks, 2)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    step = jt.make_lm_train_step(_jax_model("dot"), tx, mesh, donate=False)
    p3, _, jloss = step(p2, opt2, jnp.asarray(toks))
    tm = _port_model("dot", p2)
    opt = torch.optim.AdamW(tm.parameters(), lr=LR_ADAM, weight_decay=WD)
    state = adam_state_from_jax(jax.tree.map(np.asarray, opt2), tm)
    assert {float(s["step"]) for s in state.values()} == {2.0}
    opt.state.update(state)
    loss = tt.make_lm_train_step(tm, opt)(torch.from_numpy(toks))
    _close(float(loss), float(jloss))
    _close_tree(tm, p3, tol=0.01 * LR_ADAM)


def test_later_slices_raise():
    """Mixture of experts is ported (`tests/test_torch_port_moe.py`);
    LoRA weights and a pipeline mesh are still later slices."""
    from horovod_tpu_torch.parallel.mesh import make_mesh
    tree = {"block_0": {"mlp": {"wi": {"lora_a": np.zeros((4, 2))}}}}
    with pytest.raises(NotImplementedError, match="later slice"):
        params_from_jax(tree)
    with pytest.raises(NotImplementedError, match="later slice"):
        make_mesh(pipe=2, device_type="cpu")
