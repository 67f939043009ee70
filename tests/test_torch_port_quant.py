"""PyTorch port: int8 weights and the int8 KV cache against the JAX
package.

Toy size: vocab 64, 2 layers, 4 heads of 16 (GQA 2 kv heads on the
RoPE preset), max_len 32, float32. The flax float weights cross over
with `params_from_jax`; inputs come from numpy with a seed.

Tolerances, and why:
* int8 codes and scales (`quantize_int8`, `quantize_lm_params`, the
  `params_from_jax` of a quantized tree): bitwise — both codecs are
  ``amax / 127`` in f32, round half to even and a clamp, the same
  IEEE operations on the same inputs.
* int8-weight logits against JAX: 1e-5 relative to the largest logit
  (float32 both sides, summation order only); within the port the
  quantized model equals the float model on the dequantized state dict
  bitwise (the same dequant, the same product).
* greedy streams (generate, the fixed and the paged engine): token-exact.
* int8-KV decode logits against JAX's int8-KV ticks (linear, rolling
  window 6, paged block size 4): 1e-5 relative; the int8 codes the two
  packages write may differ by one step where a K/V value that differs
  in its last f32 bit sits on a rounding boundary, so pool codes are
  held to one step and their scales to 1e-5.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import quantization as jq
from horovod_tpu.parallel.tensor import _kv_quantize as jax_kv_quantize
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch.compat.from_jax import (paged_pools_from_jax,
                                               params_from_jax)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import quantization as tq
from horovod_tpu_torch.parallel.tensor import _kv_quantize
from horovod_tpu_torch.serving import PagedSlotPool, ServingEngine
from horovod_tpu_torch.serving import transfer

VOCAB, LAYERS, HEADS, HEAD_DIM, MAX_LEN = 64, 2, 4, 16, 32
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Toy shapes gain nothing from intra-op threads, and idle OpenMP
    threads spinning here would slow the JAX tests running beside this
    module in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRESETS = {
    "gpt": {},
    "llama_rope_gqa": dict(num_kv_heads=2, pos_emb="rope",
                           **jt.LLAMA_ARCH_KW),
}


def _jax_model(preset, **kw):
    return jt.TransformerLM(**{
        "vocab_size": VOCAB, "num_layers": LAYERS, "num_heads": HEADS,
        "head_dim": HEAD_DIM, "max_len": MAX_LEN, "dtype": jnp.float32,
        **PRESETS[preset], **kw})


def _port(preset, sd, **kw):
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, **{
        "max_len": MAX_LEN, "dtype": torch.float32, "device": "cpu",
        **PRESETS[preset], **kw})
    tm.load_state_dict(sd)
    return tm


@pytest.fixture(scope="module")
def trees():
    """{preset: (float params, quantized params)} of the JAX package."""
    out = {}
    for preset in PRESETS:
        params = unbox(_jax_model(preset).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32))["params"])
        out[preset] = (params, jq.quantize_lm_params(params))
    return out


def _sd(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _tokens(B, S, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, S))


def _prompts(n, seed=0, lo=1, hi=8):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(rs.randint(lo, hi)),))
            for _ in range(n)]


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= tol, err


# -- the codec ----------------------------------------------------------------

CODEC_CASES = {
    "kernel_f32": ((48, 40), 0, np.float32),
    "kernel_bf16": ((64, 24), 0, jnp.bfloat16),
    "kv_f32": ((3, 7, 2, 16), -1, np.float32),
    "kv_bf16": ((2, 9, 4, 16), -1, jnp.bfloat16),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_quantize_int8_bitwise_vs_jax(case):
    """Codes and scales of both codecs, bitwise, on f32 and bf16 inputs
    along the kernel axis (0) and the head dim (-1); an all-zero channel
    gets scale 1 and a value on a half-step boundary rounds to even;
    the dequantized values at f32 and bf16 agree bitwise too."""
    shape, axis, dt = CODEC_CASES[case]
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 3
    idx = (slice(None),) * (axis % len(shape)) + (0,)
    w[idx] = 0.0                               # an all-zero channel
    w.flat[-1] = 0.5 * np.abs(w).max() / 127 * 5  # a tie if it sets amax
    jw = jnp.asarray(w, dt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        torch.bfloat16 if dt is jnp.bfloat16 else torch.float32)
    jqv, js = jq.quantize_int8(jw, axis=axis)
    qv, s = tq.quantize_int8(tw, axis=axis)
    assert qv.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(qv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jq.dequantize_int8(jqv, js, jdt, axis=axis)
                         .astype(jnp.float32))
        got = tq.dequantize_int8(qv, s, tdt, axis=axis).float().numpy()
        np.testing.assert_array_equal(got, ref)
    if axis == -1:
        jk, jks = jax_kv_quantize(jw)
        k, ks = _kv_quantize(tw)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_quantize_lm_params_bitwise_vs_jax(trees, preset):
    """`params_from_jax` of the JAX quantized tree == `quantize_lm_params`
    of the port's float state dict, entry for entry and bit for bit; it
    loads strictly into the int8 model, whose buffers it fills; the
    dequantized dicts agree too."""
    params, qtree = trees[preset]
    got = tq.quantize_lm_params(_sd(params))
    want = _sd(qtree)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(),
                                      want[name].numpy(), err_msg=name)
    n_q = sum(name.endswith(".kernel_q") for name in got)
    assert n_q == LAYERS * (4 if preset == "gpt" else 5)  # + gate/up/down
    qm = _port(preset, want, weight_quant="int8")
    assert sorted(qm.state_dict()) == sorted(want)
    back = tq.dequantize_lm_params(got)
    ref = _sd(jq.dequantize_lm_params(qtree))
    assert sorted(back) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(back[name].numpy(), ref[name].numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_lm_equals_dequantized_model_bitwise(trees, dtype):
    """The oracle inside the port: `quantize_lm(model)`'s logits equal,
    bitwise, the float model loaded with the dequantized state dict (at
    the module dtype) — the bf16 case is the serving model's form
    (`serving_params` first). The int8 model shares every other tensor
    with the float one, survives a strict state-dict round trip and
    `.to()`, and `serving_params` leaves its int8 buffers alone."""
    params, _ = trees["llama_rope_gqa"]
    fm = _port("llama_rope_gqa", _sd(params), dtype=dtype)
    if dtype == torch.bfloat16:
        tt.serving_params(fm)
    qm = tq.quantize_lm(fm)
    assert qm.weight_quant == "int8" and tq.quantize_lm(qm) is qm
    assert qm.embed.data_ptr() == fm.embed.data_ptr()
    ref = _port("llama_rope_gqa",
                tq.dequantize_lm_params(qm.state_dict(), dtype),
                dtype=dtype)
    toks = torch.from_numpy(_tokens(2, 12, seed=1))
    with torch.no_grad():
        got, want = qm(toks), ref(toks)
    assert torch.equal(got, want)
    again = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM,
                             max_len=MAX_LEN, dtype=dtype, device="cpu",
                             weight_quant="int8",
                             **PRESETS["llama_rope_gqa"])
    again.load_state_dict(qm.state_dict())
    if dtype == torch.bfloat16:
        tt.serving_params(again)
    again = again.to("cpu")
    blk = again.blocks[0].attn.qkv
    assert blk.kernel is None and blk.kernel_q.dtype == torch.int8
    assert blk.kernel_scale.dtype == torch.float32
    with torch.no_grad():
        assert torch.equal(again(toks), got)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_int8_forward_logits_match_jax(trees, preset):
    """The int8 model's logits against the JAX int8 model's on the same
    quantized tree (1e-5 relative); both lie within the reference's
    sanity bound (0.05 of the largest float logit) of the float model."""
    params, qtree = trees[preset]
    jm = _jax_model(preset)
    toks = _tokens(2, 12, seed=2)
    ref = np.asarray(jm.clone(weight_quant="int8").apply(
        {"params": qtree}, jnp.asarray(toks)))
    qm = tq.quantize_lm(_port(preset, _sd(params)))
    with torch.no_grad():
        out = qm(torch.from_numpy(toks)).numpy()
        fl = _port(preset, _sd(params))(torch.from_numpy(toks)).numpy()
    _close(out, ref)
    assert np.abs(out - fl).max() / np.abs(fl).max() < 0.05


GEN_CASES = {
    "gpt_lax": ("gpt", {}),
    "gpt_flash_pallas": ("gpt", dict(attn_impl="flash",
                                     decode_prefix_impl="pallas",
                                     decode_prefix_block=8)),
    "llama_lax": ("llama_rope_gqa", dict(decode_prefix_block=8)),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_int8_generate_token_exact_vs_jax(trees, case):
    """Greedy `generate` of the int8 model == JAX `generate` of the int8
    model on the quantized tree; the flash case runs the card's path
    (the flash forward and decode kernels' plain versions here)."""
    preset, kw = GEN_CASES[case]
    params, qtree = trees[preset]
    jm = _jax_model(preset, **kw).clone(weight_quant="int8")
    prompt = _tokens(2, 5, seed=3)
    ref = np.asarray(jt.generate(jm, qtree, jnp.asarray(prompt), steps=12))
    qm = tq.quantize_lm(_port(preset, _sd(params), **kw))
    out = tt.generate(qm, torch.from_numpy(prompt), 12).numpy()
    np.testing.assert_array_equal(out, ref)


def _streams(model, prompts, steps, **kw):
    with ServingEngine(model, num_slots=2, **kw) as eng:
        hs = [eng.submit(p, steps) for p in prompts]
        out = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
        snap = eng.metrics_snapshot()
        wq = eng.weight_quant
    return out, snap, wq


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_int8_engine_streams_token_exact_vs_jax(trees, paged):
    """`ServingEngine(weight_quant="int8")` on a float model, fixed and
    paged: every stream == JAX `generate` of the int8 model on the
    quantized tree; a model already int8 passes through the door with
    no second transform (the same streams)."""
    params, qtree = trees["gpt"]
    jm = _jax_model("gpt").clone(weight_quant="int8")
    prompts = _prompts(5, seed=9)
    steps = 7
    refs = [np.asarray(jt.generate(jm, qtree, jnp.asarray(p)[None],
                                   steps))[0, len(p):].tolist()
            for p in prompts]
    kw = dict(paged=True, kv_block_size=4) if paged else {}
    fm = _port("gpt", _sd(params))
    out, snap, wq = _streams(fm, prompts, steps, weight_quant="int8", **kw)
    assert out == refs and wq == "int8"
    assert snap["completed"] == len(prompts)
    assert fm.weight_quant is None          # the caller's model untouched
    qm = tq.quantize_lm(fm)
    again, _, _ = _streams(qm, prompts[:2], steps, weight_quant="int8",
                           **kw)
    assert again == refs[:2]


def test_env_knob_weight_quant(trees, monkeypatch):
    """HVD_WEIGHT_QUANT=int8 quantizes at the door when weight_quant= is
    not passed; any other value, and weight_quant="int4", raise the
    reference's ValueError."""
    from horovod_tpu_torch.runtime.config import config
    fm = _port("gpt", _sd(trees["gpt"][0]))
    monkeypatch.setenv("HVD_WEIGHT_QUANT", "int8")
    config.refresh()
    try:
        with ServingEngine(fm, num_slots=1) as eng:
            assert eng.weight_quant == "int8"
            assert eng.model.blocks[0].mlp.wi.kernel is None
        monkeypatch.setenv("HVD_WEIGHT_QUANT", "int4")
        config.refresh()
        with pytest.raises(ValueError, match="weight_quant"):
            ServingEngine(fm, num_slots=1)
    finally:
        monkeypatch.delenv("HVD_WEIGHT_QUANT")
        config.refresh()
    with pytest.raises(ValueError, match="weight_quant"):
        ServingEngine(fm, num_slots=1, weight_quant="int4")


@pytest.mark.parametrize("knob", ["weight_quant", "kv_quant"])
def test_unsupported_quant_rejected_like_jax(knob):
    """An unknown quantization is the reference's ValueError naming the
    knob, in both packages."""
    with pytest.raises(ValueError, match=knob):
        m = _jax_model("gpt", **{knob: "int4"})
        if knob == "kv_quant":
            m = m.clone(decode=True)
        m.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError, match=knob):
        tt.TransformerLM(VOCAB, 1, 2, 8, device="cpu", **{knob: "int4"})


# -- the int8 KV cache --------------------------------------------------------

def _jax_decode_logits(jm, params, calls, B):
    """The JAX int8-KV decode of ``calls`` [(tokens [B, S], chunked)]
    from an empty cache: logits of every call."""
    dec = jm.clone(decode=True)
    cache = dec.init(jax.random.PRNGKey(0),
                     jnp.zeros((B, MAX_LEN), jnp.int32))["cache"]
    apply = {c: jax.jit(functools.partial(
        dec.clone(chunked_prefill=c).apply, mutable=["cache"]))
        for c in (False, True)}
    outs = []
    for toks, chunked in calls:
        logits, mut = apply[chunked]({"params": params, "cache": cache},
                                     jnp.asarray(toks))
        cache = mut["cache"]
        outs.append(np.asarray(logits))
    return outs


def _port_decode_logits(tm, calls, B):
    cache = tt.init_cache(tm, B)
    outs = []
    with torch.no_grad():
        for toks, chunked in calls:
            outs.append(tm(torch.from_numpy(toks), cache,
                           chunked_prefill=chunked).numpy())
            cache.index += toks.shape[1]
    return outs, cache


def _decode_calls(seed, B, n_ticks, chunk=3):
    """A 5-token one-pass prefill, a ``chunk``-token any-fill append,
    then teacher-forced S=1 ticks."""
    rs = np.random.RandomState(seed)
    calls = [(rs.randint(0, VOCAB, (B, 5)), False),
             (rs.randint(0, VOCAB, (B, chunk)), True)]
    calls += [(rs.randint(0, VOCAB, (B, 1)), True) for _ in range(n_ticks)]
    return calls


@pytest.mark.parametrize("cache_kind", ["linear", "linear_pallas",
                                        "linear_mask_path", "rolling_w6"])
def test_kv_int8_ticks_match_jax(trees, cache_kind):
    """int8-KV decode from an empty cache — the one-pass prefill
    (attends its raw rows), a 3-token append (writes first, then
    attends the dequantized cache), then S=1 ticks — against the JAX
    int8-KV ticks, 1e-5 relative, on the linear cache (prefix loop; the
    same under ``decode_prefix_impl="pallas"``, whose kernel both
    packages keep off int8 caches; and the cache-wide mask path where
    the block does not divide the cache), and the rolling window-6
    cache past max_len (RoPE); the
    int8 logits also stay within the reference's 0.08 of the float-KV
    logits."""
    params, _ = trees["llama_rope_gqa"]
    kw = {"linear": dict(decode_prefix_block=8),
          "linear_pallas": dict(decode_prefix_block=8,
                                decode_prefix_impl="pallas"),
          "linear_mask_path": dict(decode_prefix_block=12),
          "rolling_w6": dict(window=6)}[cache_kind]
    n_ticks = 34 if cache_kind == "rolling_w6" else 20
    calls = _decode_calls(4, 2, n_ticks)
    jm = _jax_model("llama_rope_gqa", kv_quant="int8", **kw)
    ref = _jax_decode_logits(jm, params, calls, 2)
    tm = _port("llama_rope_gqa", _sd(params), kv_quant="int8", **kw)
    got, cache = _port_decode_logits(tm, calls, 2)
    for a, b in zip(got, ref):
        _close(a, b)
    W = 6 if cache_kind == "rolling_w6" else MAX_LEN
    assert cache.k[0].shape == (2, W, 2, HEAD_DIM)
    assert cache.k[0].dtype == torch.int8
    assert cache.k_scale[0].shape == (2, W, 2)
    plain, _ = _port_decode_logits(_port("llama_rope_gqa", _sd(params),
                                         **kw), calls, 2)
    for a, b in zip(got, plain):
        assert np.abs(a - b).max() / np.abs(b).max() < 0.08


def _int8_pool_state(rs, jm, bs, lanes, fills):
    """One random int8-KV paged cache state for both packages: int8
    codes and positive scales in the JAX pool layout, shuffled tables,
    the given fills. Returns the JAX spec, pools, tables and fills."""
    spec = jt.paged_cache_spec(jm, bs)
    nb = lanes * spec.blocks_per_seq + 1
    pools = []
    for p in jt.init_paged_pools(jm, spec, nb):
        if p.dtype == jnp.int8:
            pools.append(rs.randint(-127, 128, p.shape).astype(np.int8))
        else:
            pools.append(rs.uniform(0.005, 0.03, p.shape).astype(np.float32))
    tables = np.stack([rs.permutation(np.arange(1, nb))[:spec.blocks_per_seq]
                       for _ in range(lanes)]).astype(np.int32)
    return spec, pools, tables, np.asarray(fills, np.int32)


def _leaf_names(spec):
    return [path[-1] for kind, path in zip(spec.kinds, spec.paths)
            if kind == "kv"]


def test_paged_pools_from_jax_int8_leaf_order(trees):
    """The JAX int8-KV pool list's flatten order, read from the JAX
    cache tree's own paths: each leaf lands in its (layer, K / V / K
    scale / V scale) slot of the port's tuples, and the port's pools
    have the same per-layer shapes and dtypes."""
    jm = _jax_model("gpt", kv_quant="int8", num_layers=11)
    spec = jt.paged_cache_spec(jm, 4)
    names = _leaf_names(spec)
    layers = [next(p for p in path if p.startswith("block_"))
              for kind, path in zip(spec.kinds, spec.paths) if kind == "kv"]
    pools = [np.full(p.shape, i, p.dtype) for i, p in
             enumerate(jt.init_paged_pools(jm, spec, 3))]
    out = paged_pools_from_jax(pools)
    slot = {"cached_key": 0, "cached_value": 1, "cached_key_scale": 2,
            "cached_value_scale": 3}
    for i, (name, layer) in enumerate(zip(names, layers)):
        t = out[int(layer.split("_")[1])][slot[name]]
        assert int(t.flatten()[0]) == i, (name, layer)
    tm = tt.TransformerLM(VOCAB, 11, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu", kv_quant="int8")
    mine = tt.init_paged_pools(tm, tt.paged_cache_spec(tm, 4), 3)
    for a, b in zip(mine, out):
        assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype)
                                                   for t in b]


def _assert_pools_close(tpools, jpools):
    for layer, ref in zip(tpools, paged_pools_from_jax(
            [np.asarray(p) for p in jpools])):
        k, v, ks, vs = (t[1:].numpy() for t in layer)
        rk, rv, rks, rvs = (t[1:].numpy() for t in ref)
        for a, b in ((k, rk), (v, rv)):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_allclose(ks, rks, rtol=TOL, atol=0)
        np.testing.assert_allclose(vs, rvs, rtol=TOL, atol=0)


@pytest.mark.parametrize("mode", ["off", "lax", "pallas"])
def test_kv_int8_paged_chunk_and_tick_match_jax(trees, mode):
    """From the same int8-KV pools (random codes and scales), tables and
    fills: `paged_prefill_chunk` logits (chunks of 1 and 5 tokens) and
    one `paged_decode_tick` over four lanes (one frozen) against the JAX
    functions, 1e-5; the rows both write agree (codes within one step,
    scales 1e-5). Under "pallas" the kernel stays off for int8 pools in
    both packages: the tick walks."""
    params, _ = trees["llama_rope_gqa"]
    bs = 4
    kw = dict(kv_quant="int8", decode_prefix_block=8)
    jm = _jax_model("llama_rope_gqa", **kw)
    rs = np.random.RandomState(7)
    spec, pools, tables, fills = _int8_pool_state(rs, jm, bs, 4,
                                                  [0, 13, 21, 6])
    dec = jt.slot_decode_model(jm)
    if mode == "pallas":
        dec = dec.clone(decode_prefix_impl="pallas", decode_prefix_block=bs)
    tm = _port("llama_rope_gqa", _sd(params), **kw)
    tspec = tt.paged_cache_spec(tm, bs)
    tpools = paged_pools_from_jax(pools)
    ttables = torch.from_numpy(tables)
    tfills = torch.from_numpy(fills.copy())
    jpools, jfills = [jnp.asarray(p) for p in pools], jnp.asarray(fills)
    fused = mode != "off"
    for slot, C in ((1, 1), (2, 5)):
        chunk = rs.randint(0, VOCAB, (C,))
        jpools, jfills, jlog = jt.paged_prefill_chunk(
            dec, spec, jpools, params, jnp.asarray(tables), jfills,
            jnp.int32(slot), jnp.asarray(chunk, jnp.int32), fused=fused)
        tlog = tt.paged_prefill_chunk(
            tm, tspec, tpools, ttables, tfills, slot,
            torch.from_numpy(chunk), paged_kernel=mode,
            fill=int(fills[slot]))
        _close(tlog.numpy(), np.asarray(jlog))
        fills = np.asarray(jfills)
    toks = rs.randint(0, VOCAB, (4,))
    live = np.array([True, True, False, True])
    out = jt.paged_decode_tick(
        dec, spec, jpools, params, jnp.asarray(tables), jfills,
        jnp.asarray(toks, jnp.int32), jnp.zeros(4, jnp.float32),
        jnp.ones(4, jnp.float32),
        jnp.stack([jax.random.PRNGKey(i) for i in range(4)]),
        jnp.asarray(live), jnp.zeros(4, bool), jnp.int32(-1), fused=fused)
    jpools, jemit, _, _, jfills = out
    emit, _ = tt.paged_decode_tick(
        tm, tspec, tpools, ttables, tfills, torch.from_numpy(toks),
        torch.zeros(4), torch.ones(4), None, torch.from_numpy(live),
        torch.zeros(4, dtype=torch.bool), torch.tensor(-1),
        paged_kernel=mode, prefix_len=32)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(tfills.numpy(), np.asarray(jfills))
    _assert_pools_close(tpools, jpools)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_kv_int8_engine_streams_match_jax_engine(trees, paged):
    """An int8-KV model on the fixed and the paged engine (block size
    4, "lax" walk): every stream == the JAX engine's on the same model,
    token for token."""
    params, _ = trees["llama_rope_gqa"]
    kw = dict(kv_quant="int8", decode_prefix_block=8)
    jm = _jax_model("llama_rope_gqa", **kw)
    ekw = dict(paged=True, kv_block_size=4) if paged else {}
    prompts = _prompts(5, seed=11)
    with JaxEngine(jm, params, num_slots=2, **ekw) as eng:
        hs = [eng.submit(p, 8) for p in prompts]
        ref = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
    out, snap, _ = _streams(_port("llama_rope_gqa", _sd(params), **kw),
                            prompts, 8, **ekw)
    assert out == ref and snap["completed"] == len(prompts)


def test_kv_int8_blocks_travel_with_their_scales(trees):
    """Copy-on-write copies a block's scales with its codes; a block
    export carries the scale pools as leaves of their own (and counts
    their bytes), ingests bitwise into another int8-KV pool, and is
    refused by a float-KV pool (the leaf dtypes differ)."""
    params, _ = trees["gpt"]
    q = _port("gpt", _sd(params), kv_quant="int8")
    src = PagedSlotPool(q, 2, block_size=4, prefix_cache=True)
    for layer in src._pools:
        for t in layer:
            t.copy_(torch.randint(-127, 128, t.shape).to(t.dtype)
                    if t.dtype == torch.int8 else torch.rand(t.shape))
    tt.paged_copy_block(src._pools, 3, 5)
    for layer in src._pools:
        assert len(layer) == 4
        for t in layer:
            assert torch.equal(t[5], t[3])
    prompt = np.arange(9) % VOCAB
    slot = src.admit(prompt, 4).slot
    src.prefill(slot, prompt, 0.0, None, 0)
    tr = transfer.export_blocks(src, prompt)
    assert tr is not None and tr.num_blocks == 2 and len(tr.rows) == 8
    assert [r.dtype for r in tr.rows[:4]] == [torch.int8, torch.int8,
                                              torch.float32, torch.float32]
    assert tr.nbytes == 2 * 4 * LAYERS * (2 * HEADS * HEAD_DIM + 2 * HEADS * 4)
    dst = PagedSlotPool(q, 2, block_size=4, prefix_cache=True)
    assert transfer.ingest_blocks(dst, tr) == 2
    bids = [dst.blocks._cache[h] for h in tr.chain_digests]
    got = tt.gather_block_rows(dst._pools, bids)
    for a, b in zip(got, tr.rows):
        assert torch.equal(a, b)
    plain = PagedSlotPool(_port("gpt", _sd(params)), 2, block_size=4,
                          prefix_cache=True)
    with pytest.raises(transfer.TransferCompatError):
        transfer.ingest_blocks(plain, tr)
