"""PyTorch port: `TransformerLM` and `generate` against the JAX package.

Both packages are built from the SAME weights: the flax params are
initialized once and loaded into the port with
`compat.from_jax.params_from_jax`. Tokens are drawn with numpy.
Tolerances: float32 end to end on both sides, so forward logits agree
to 1e-5 relative to the largest logit (summation order only); greedy
streams must be token-exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt

VOCAB, LAYERS, HEADS, HEAD_DIM, MAX_LEN = 64, 2, 4, 8, 32


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


def _pair(preset, seed=1, **kw):
    """(jax model, jax params, port model) sharing one weight set."""
    cfg = dict(PRESETS[preset], **kw)
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                          num_heads=HEADS, head_dim=HEAD_DIM,
                          max_len=MAX_LEN, dtype=jnp.float32, **cfg)
    params = unbox(jm.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 16), jnp.int32))["params"])
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {p: _pair(p) for p in PRESETS}


def _tokens(B, S, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, S))


@pytest.mark.parametrize("impl", ["dot", "blockwise", "flash"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_forward_logits_match(pairs, preset, impl):
    jm, params, tm = pairs[preset]
    jm = jm.clone(attn_impl=impl)
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu",
                          attn_impl=impl, **PRESETS[preset])
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    toks = _tokens(2, 16, seed=3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks)).numpy()
    assert out.shape == ref.shape == (2, 16, VOCAB)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


GEN_CASES = {
    # the slice's serving configuration at toy width
    "gpt_flash_pallas": ("gpt", dict(attn_impl="flash",
                                     decode_prefix_impl="pallas")),
    "gpt_blockwise_lax": ("gpt", dict(attn_impl="blockwise")),
    "llama_lax": ("llama_rope_gqa", dict(attn_impl="dot",
                                         decode_prefix_block=8)),
    "llama_flash_pallas": ("llama_rope_gqa", dict(
        attn_impl="flash", decode_prefix_block=8,
        decode_prefix_impl="pallas")),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_greedy_token_exact(pairs, case):
    preset, kw = GEN_CASES[case]
    jm, params, _ = pairs[preset]
    jm = jm.clone(**kw)
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu",
                          **dict(PRESETS[preset], **kw))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    prompt = _tokens(2, 5, seed=60)
    ref = np.asarray(jt.generate(jm, params, jnp.asarray(prompt), steps=16))
    out = tt.generate(tm, torch.from_numpy(prompt), 16).numpy()
    np.testing.assert_array_equal(out, ref)


def test_generate_matches_full_forward_oracle(pairs):
    """The decode cache path equals re-running the whole prefix."""
    _, _, tm = pairs["llama_rope_gqa"]
    prompt = torch.from_numpy(_tokens(2, 4, seed=9))
    out = tt.generate(tm, prompt, 8)
    seq = prompt
    with torch.no_grad():
        for _ in range(8):
            nxt = tm(seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], 1)
    assert torch.equal(out, seq)


def test_generate_eos_pads_after_stop(pairs):
    _, _, tm = pairs["gpt"]
    prompt = torch.from_numpy(_tokens(2, 5, seed=60))
    free = tt.generate(tm, prompt, 12)
    eos = int(free[0, 7])
    for early in (False, True):
        out = tt.generate(tm, prompt, 12, eos_id=eos, pad_id=1,
                          early_stop=early)
        row = out[0, 5:].tolist()
        stop = row.index(eos)
        assert all(t == 1 for t in row[stop + 1:])
        assert row[:stop + 1] == free[0, 5:5 + stop + 1].tolist()


def test_generate_sampling_seeded_and_validated(pairs):
    _, _, tm = pairs["gpt"]
    prompt = torch.from_numpy(_tokens(1, 3, seed=1))

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tt.generate(tm, prompt, 10, temperature=0.8, generator=g,
                           **kw)
    assert torch.equal(run(5, top_k=8), run(5, top_k=8))
    assert torch.equal(run(5, top_p=0.9), run(5, top_p=0.9))
    with pytest.raises(ValueError, match="generator"):
        tt.generate(tm, prompt, 4, temperature=0.5)
    with pytest.raises(ValueError, match="max_len"):
        tt.generate(tm, prompt, MAX_LEN)


def test_serving_params_casts_matrices_only(pairs):
    _, params, _ = pairs["gpt"]
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tt.serving_params(tm)
    for name, p in tm.named_parameters():
        want = torch.bfloat16 if p.ndim >= 2 else torch.float32
        assert p.dtype == want, name
    out = tt.generate(tm, torch.from_numpy(_tokens(1, 4, seed=2)), 4)
    assert out.shape == (1, 8)


def test_later_slices_raise():
    with pytest.raises(NotImplementedError):
        tt.TransformerLM(VOCAB, 1, 2, 8, device="cpu", kv_quant="int8")
    with pytest.raises(NotImplementedError):
        tt.make_attn_fn("ring")
    m = tt.TransformerLM(VOCAB, 1, 2, 8, max_len=16, window=4,
                         dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        tt.generate(m, torch.zeros(1, 3, dtype=torch.long), 2)


@pytest.mark.parametrize("prompt_len", [5, 13, 27])
def test_prefix_loop_reads_only_filled_slices(pairs, monkeypatch,
                                              prompt_len):
    """The slot pool's prefill chunks bound the plain prefix loop by the
    host-known fill: bitwise the loop over the whole cache, reading
    ceil(fill / decode_prefix_block) slices instead of all of them."""
    from horovod_tpu_torch.parallel.tensor import ParallelSelfAttention
    _, params, _ = pairs["llama_rope_gqa"]
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu",
                          decode_prefix_block=8,
                          **PRESETS["llama_rope_gqa"])
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    dec = tt.slot_decode_model(tm)
    prompt = torch.from_numpy(_tokens(1, prompt_len, seed=prompt_len))[0]
    reads = []
    repeat_kv = ParallelSelfAttention._repeat_kv

    def counted(self, t):
        reads[-1] += 1
        return repeat_kv(self, t)
    monkeypatch.setattr(ParallelSelfAttention, "_repeat_kv", counted)

    caches = {b: tt.init_slot_cache(tm, 2) for b in ("full", "bounded")}
    fill, want = 0, 0
    for c in tt.prefill_chunks(prompt_len, 4):
        chunk = prompt[fill:fill + c]
        reads.append(0)
        full = tt.slot_prefill_chunk(dec, caches["full"], 1, chunk)
        reads.append(0)
        bounded = tt.slot_prefill_chunk(dec, caches["bounded"], 1, chunk,
                                        fill=fill)
        assert torch.equal(full, bounded)
        fill += c
        # K and V of each slice, in every layer
        assert reads[-2] == 2 * LAYERS * (MAX_LEN // 8)
        assert reads[-1] == 2 * LAYERS * -(-fill // 8)
        want += -(-fill // 8)
    for a, b in zip(caches["full"].k + caches["full"].v,
                    caches["bounded"].k + caches["bounded"].v):
        assert torch.equal(a, b)
    assert sum(reads[1::2]) == 2 * LAYERS * want
