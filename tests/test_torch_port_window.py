"""PyTorch port: the rolling sliding-window decode cache and
`generate_bucketed` against the JAX package.

Toy size: vocab 64, 2 layers, 4 heads of 16 (GQA 2 kv heads on the
RoPE preset), max_len 32, float32, windows 4 and 6. The flax weights
cross over with `params_from_jax`; inputs come from numpy with a seed.
Tolerances: float32 on both sides, so decode logits agree to 1e-5
relative to the largest logit (summation order only); greedy streams —
`generate` past max_len, the fixed engine, `generate_bucketed` — must be
token-exact. Seeded streams are held only within the port (the port
does not reproduce `jax.random`).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import threefry
from horovod_tpu_torch.parallel.tensor import rolling_keep
from horovod_tpu_torch.serving import PagedSlotPool, ServingEngine

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


@pytest.fixture(scope="module")
def params():
    return {preset: unbox(_jax_model(preset).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32))["params"])
        for preset in PRESETS}


def _pair(params, preset, **kw):
    """(jax model, jax params, port model) on one weight set."""
    p = params[preset]
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, **{
        "max_len": MAX_LEN, "dtype": torch.float32, "device": "cpu",
        **PRESETS[preset], **kw})
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
    return _jax_model(preset, **kw), p, tm


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


def _prompts(n, seed=0, lo=1, hi=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(rs.randint(lo, hi)),))
            for _ in range(n)]


def test_rolling_keep_is_the_reference_rule():
    """Per-lane masks against the JAX rolling branch's scalar rule
    (slot s holds position last - ((last - s) mod W), valid where
    index > 0 and that position >= 0; then the band), lane by lane, at
    fills before, on and past the window."""
    W, window = 6, 6
    index = torch.tensor([0, 1, 5, 6, 7, 40], dtype=torch.int32)
    for S in (1, 3, 9):
        qpos = index[:, None].long() + torch.arange(S)
        got = rolling_keep(index, qpos, W, window).numpy()
        for b, i in enumerate(index.tolist()):
            last = i - 1
            slot_pos = last - ((last - np.arange(W)) % W)
            valid = (i > 0) & (slot_pos >= 0)
            q = i + np.arange(S)
            kv = np.concatenate([slot_pos, q])
            keep = (q[:, None] >= kv[None]) & (q[:, None] - kv[None] < window)
            keep &= np.concatenate([valid, np.ones(S, bool)])[None]
            np.testing.assert_array_equal(got[b], keep)


@pytest.mark.parametrize("S2", [3, 9], ids=["append3", "append9_gt_W"])
@pytest.mark.parametrize("P", [5, 9], ids=["prefill5", "prefill9_gt_W"])
def test_rolling_decode_logits_match_jax(params, P, S2):
    """The rolling cache (window 6, RoPE, GQA) from empty: a P-token
    one-pass prefill (its last min(P, W) rows written), an S2-token
    any-fill append (attend before write, S2 > W included), then S=1
    ticks past max_len: every call's logits against the JAX decode,
    1e-5 relative; the cache holds exactly W = 6 slots."""
    jm, p, tm = _pair(params, "llama_rope_gqa", window=6)
    rs = np.random.RandomState(P * 10 + S2)
    calls = [(rs.randint(0, VOCAB, (2, P)), False),
             (rs.randint(0, VOCAB, (2, S2)), True)]
    calls += [(rs.randint(0, VOCAB, (2, 1)), True) for _ in range(26)]
    dec = jm.clone(decode=True)
    jc = dec.init(jax.random.PRNGKey(0),
                  jnp.zeros((2, MAX_LEN), jnp.int32))["cache"]
    apply = {c: jax.jit(functools.partial(
        dec.clone(chunked_prefill=c).apply, mutable=["cache"]))
        for c in (False, True)}
    cache = tt.init_cache(tm, 2)
    assert cache.k[0].shape == (2, 6, 2, HEAD_DIM)
    for toks, chunked in calls:
        ref, mut = apply[chunked]({"params": p, "cache": jc},
                                  jnp.asarray(toks))
        jc = mut["cache"]
        with torch.no_grad():
            out = tm(torch.from_numpy(toks), cache, chunked_prefill=chunked)
        cache.index += toks.shape[1]
        _close(out.numpy(), ref)
    assert int(cache.index[0]) == P + S2 + 26 > MAX_LEN


GEN_CASES = {
    # (preset, model kwargs, prompt length, steps)
    "rope_w4_dot_past_max_len": ("llama_rope_gqa",
                                 dict(window=4, attn_impl="dot"), 5, 40),
    "rope_w4_flash_past_max_len": ("llama_rope_gqa",
                                   dict(window=4, attn_impl="flash"), 7, 36),
    "rope_w6_int8kv_past_max_len": ("llama_rope_gqa",
                                    dict(window=6, kv_quant="int8"), 5, 34),
    "learned_w6_within_max_len": ("gpt", dict(window=6), 6, 27),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_window_generate_token_exact_vs_jax(params, case):
    """Greedy `generate` of a window model against the JAX `generate`:
    with RoPE past max_len (the rolling cache's unbounded rule; the
    flash case runs the card's path, the banded flash forward's plain
    version), under int8 KV, and a learned-position model within
    max_len."""
    preset, kw, P, steps = GEN_CASES[case]
    jm, p, tm = _pair(params, preset, **kw)
    prompt = np.random.RandomState(3).randint(0, VOCAB, (2, P))
    ref = np.asarray(jt.generate(jm, p, jnp.asarray(prompt), steps=steps))
    out = tt.generate(tm, torch.from_numpy(prompt), steps).numpy()
    np.testing.assert_array_equal(out, ref)


def test_window_fixed_engine_token_exact_vs_jax(params):
    """The fixed engine serves a RoPE window model (W = 6 slots a lane)
    past max_len, as the JAX fixed engine does: every stream == the
    JAX engine's and == the port's own `generate` of the prompt."""
    jm, p, tm = _pair(params, "llama_rope_gqa", window=6)
    prompts = _prompts(5, seed=4)
    steps = 30                      # P + steps - 1 > max_len for most
    with JaxEngine(jm, p, num_slots=2) as eng:
        hs = [eng.submit(q, steps) for q in prompts]
        ref = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
    with ServingEngine(tm, num_slots=2, prefill_chunk_budget=4) as eng:
        assert eng.pool._cache.k[0].shape[1] == 6
        hs = [eng.submit(q, steps) for q in prompts]
        out = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
    assert out == ref
    for q, toks in zip(prompts[:2], out):
        gen = tt.generate(tm, torch.from_numpy(q)[None], steps)
        assert gen[0, len(q):].tolist() == toks


def test_window_refusals_match_jax(params):
    """The reference's refusals stand: a window model on the paged pool
    (no block-aligned prefix to page), and a learned-position window
    model past max_len, in both packages with the same error type."""
    jm, p, tm = _pair(params, "gpt", window=6)
    for fn in (lambda: jt.paged_cache_spec(jm, 4),
               lambda: tt.paged_cache_spec(tm, 4),
               lambda: PagedSlotPool(tm, 2, block_size=4),
               lambda: ServingEngine(tm, num_slots=2, paged=True,
                                     kv_block_size=4)):
        with pytest.raises(ValueError, match="window=None"):
            fn()
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="unbounded generation"):
        jt.generate(jm, p, jnp.asarray(prompt), steps=30)
    with pytest.raises(ValueError, match="unbounded generation"):
        tt.generate(tm, torch.from_numpy(prompt), 30)
    with ServingEngine(tm, num_slots=1) as eng:
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.arange(4), 30)


# -- generate_bucketed --------------------------------------------------------

BUCKET_CASES = {
    "gpt_eos": ("gpt", {}, dict(eos_id=7)),
    "gpt_eos_early_stop": ("gpt", {}, dict(eos_id=7, pad_id=1,
                                            early_stop=True)),
    "rope_w4_past_max_len": ("llama_rope_gqa", dict(window=4), {}),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_generate_bucketed_token_exact_vs_jax(params, case):
    """Mixed prompt lengths (buckets of one, two and three prompts, out
    of order) through both packages: every row token-exact, in input
    order, with eos / pad / early_stop passed through (an eos that
    stops some rows early), and on a window model past max_len."""
    preset, kw, gkw = BUCKET_CASES[case]
    jm, p, tm = _pair(params, preset, **kw)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, (n,)) for n in (3, 5, 3, 7, 5, 3)]
    steps = 30 if kw else 20
    ref = jt.generate_bucketed(jm, p, prompts, steps, **gkw)
    out = tt.generate_bucketed(tm, prompts, steps, **gkw)
    assert len(out) == len(ref) == len(prompts)
    for o, r, q in zip(out, ref, prompts):
        assert o.tolist() == np.asarray(r).tolist()
        assert o[:len(q)].tolist() == q.tolist()
    if "eos_id" in gkw:
        assert any(gkw["eos_id"] in o[len(q):].tolist()
                   for o, q in zip(out, prompts))


def test_generate_bucketed_refusals_and_seeded_streams(params):
    """A 2-D prompt is refused in both packages. Under sampling the
    bucket of length-n prompts draws from ``fold_in(rng, n)`` as in the
    JAX package: the caller's key is not consumed, the rows equal the
    reference's, and a row differs from the one its prompt gets when it
    uses the caller's key directly."""
    jm, p, tm = _pair(params, "gpt")
    bad = [np.zeros((2, 3), np.int32)]
    with pytest.raises(ValueError, match="1-D prompts"):
        jt.generate_bucketed(jm, p, bad, 4)
    with pytest.raises(ValueError, match="1-D prompts"):
        tt.generate_bucketed(tm, bad, 4)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, VOCAB, (n,)) for n in (4, 6, 4)]
    key = threefry.prng_key(11)
    a = tt.generate_bucketed(tm, prompts, 12, temperature=1.0, rng=key)
    assert key.tolist() == threefry.prng_key(11).tolist()
    b = tt.generate_bucketed(tm, prompts, 12, temperature=1.0, rng=key)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = jt.generate_bucketed(jm, p, [jnp.asarray(q) for q in prompts], 12,
                               temperature=1.0, rng=jax.random.PRNGKey(11))
    assert [x.tolist() for x in a] == [np.asarray(r).tolist() for r in ref]
    direct = tt.generate(tm, torch.from_numpy(np.stack([prompts[0],
                                                        prompts[2]])),
                         12, temperature=1.0, rng=threefry.prng_key(11))
    assert not torch.equal(direct[0], a[0])
