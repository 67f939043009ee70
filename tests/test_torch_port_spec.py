"""PyTorch port: speculative decoding against the JAX package.

Toy size, as the JAX spec-serving tests: vocab 64, 2 layers, 4 heads of
8, max_len 32, float32 (`generate_speculative` as `tests/
test_speculative.py`: max_len 64, 2 or 4 heads, rope + GQA or learned
positions). The target's flax weights and a NOISY draft (the target's
weights plus 0.05 x a standard normal draw from numpy, seed 7) cross
over with `params_from_jax`; inputs come from numpy with a seed. Both
sides compute in float32, so every greedy stream, round output,
acceptance count and fill must be identical.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import speculative as jspec
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu.serving import paging as jpaging
from horovod_tpu.serving import slots as jslots
from horovod_tpu_torch.compat.from_jax import (paged_pools_from_jax,
                                               params_from_jax)
from horovod_tpu_torch.models import speculative as tspec
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving import PagedSlotPool, ServingEngine, SlotPool

VOCAB, MAX_LEN, K = 64, 32, 3
PAGED = dict(paged=True, kv_block_size=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Toy shapes gain nothing from intra-op threads, and idle OpenMP
    threads spinning here would slow the JAX tests running beside this
    module in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(params, seed=7, scale=0.05):
    """The JAX tests' perturbed draft, drawn with numpy: each float leaf
    plus ``scale`` x a standard normal draw."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rs.standard_normal(
            p.shape).astype(np.float32)), params)


def _port(params, **kw):
    tm = tt.TransformerLM(VOCAB, 2, 4, 8, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return tm


@pytest.fixture(scope="module")
def lm():
    """(jax model, target params, noisy draft params, port target, port
    noisy draft)."""
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=2, num_heads=4,
                          head_dim=8, max_len=MAX_LEN, dtype=jnp.float32)
    params = unbox(jm.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))["params"])
    noisy = _noisy(params)
    return jm, params, noisy, _port(params), _port(noisy)


def _drafts(lm, which):
    """(JAX spec_draft, port spec_draft) for ``which``."""
    jm, params, noisy, tm, tn = lm
    if which == "self":
        return (jm, params), tm
    return (jm, noisy), tn


def _prompts(n, seed=0, lo=1, hi=8):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(rs.randint(lo, hi)),))
            for _ in range(n)]


def _jax_generate(lm, prompt, steps):
    jm, params = lm[:2]
    return np.asarray(jt.generate(jm, params, jnp.asarray(prompt)[None],
                                  steps))[0, len(prompt):].tolist()


def _streams(engine_cls, model, prompts, steps, **kw):
    with engine_cls(model, num_slots=2, **kw) as eng:
        hs = [eng.submit(p, steps) for p in prompts]
        out = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
        snap = eng.metrics_snapshot()
    return out, snap


def _jax_streams(lm, prompts, steps, **kw):
    jm, params = lm[:2]
    with JaxEngine(jm, params, num_slots=2, **kw) as eng:
        hs = [eng.submit(p, steps) for p in prompts]
        out = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
        snap = eng.metrics_snapshot()
    return out, snap


def _wait(cond, timeout=60.0, dt=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(dt)


# -- the acceptance rule ----------------------------------------------------

@pytest.mark.parametrize("k,eos,seed", [(1, -1, 0), (3, -1, 1), (3, 2, 2),
                                        (4, 1, 3), (4, 3, 4)])
def test_spec_accept_matches_jax(k, eos, seed):
    """Seeded random proposals, greedy picks, pending tokens and lane
    states (live, done, free) through both acceptance rules: identical
    outputs, including an eos mid-round. A 4-token alphabet makes
    matches, partial acceptances and eos hits common."""
    rs = np.random.RandomState(seed)
    L = 64
    props = rs.randint(0, 4, (L, k))
    greedy = np.where(rs.rand(L, k + 1) < 0.7,
                      np.concatenate([props, rs.randint(0, 4, (L, 1))], 1),
                      rs.randint(0, 4, (L, k + 1)))
    pending = rs.randint(0, 4, (L,))
    live = rs.rand(L) < 0.8
    done = rs.rand(L) < 0.25
    adv = live & ~done
    want = jt._spec_accept(
        jnp.asarray(props, jnp.int32), jnp.asarray(greedy, jnp.int32),
        jnp.asarray(pending, jnp.int32), jnp.asarray(adv),
        jnp.asarray(done), jnp.int32(eos), k)
    got = tt._spec_accept(
        torch.from_numpy(props), torch.from_numpy(greedy),
        torch.from_numpy(pending), torch.from_numpy(adv),
        torch.from_numpy(done), torch.tensor(eos), k)
    for name, w, g in zip(("emitted", "n_emit", "done", "toks",
                           "proposed"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    if eos >= 0:
        # The eos truncation was exercised somewhere in the batch.
        assert (np.asarray(want[1])[adv] < np.minimum(
            k + 1, 1 + np.cumprod(props == greedy[:, :k], 1).sum(1))[adv]
        ).any()


# -- the pool rounds --------------------------------------------------------

@pytest.mark.parametrize("draft", ["self", "noisy"])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_pool_rounds_match_jax(lm, paged, draft):
    """`SlotPool.spec_round` / `PagedSlotPool.spec_round` round by
    round against the JAX pools: two live lanes (one reaches eos and
    re-emits it as a done lane) beside a free lane; identical emitted,
    n_emit and proposed, and identical fills after every round."""
    jm, params, _, tm, _ = lm
    jdraft, tdraft = _drafts(lm, draft)
    prompts = _prompts(2, seed=13, lo=3, hi=7)
    eos = _jax_generate(lm, prompts[0], 6)[4]
    if paged:
        jpool = jpaging.PagedSlotPool(jm, params, 3, block_size=8,
                                      eos_id=eos, spec_draft=jdraft,
                                      spec_k=K)
        tpool = PagedSlotPool(tm, 3, block_size=8, eos_id=eos,
                              spec_draft=tdraft, spec_k=K)
        assert not tpool.blocks.prefix_cache
    else:
        jpool = jslots.SlotPool(jm, params, 3, eos_id=eos,
                                spec_draft=jdraft, spec_k=K)
        tpool = SlotPool(tm, 3, eos_id=eos, spec_draft=tdraft, spec_k=K)
    for p in prompts:
        ja, ta = jpool.admit(p, 16), tpool.admit(p, 16)
        assert ja.slot == ta.slot
        assert (jpool.prefill(ja.slot, p, 0.0, None, 0)
                == tpool.prefill(ta.slot, p, 0.0, None, 0))
    for r in range(5):
        if paged:
            assert jpool.grow_for_tick() == tpool.grow_for_tick() == []
        want = jpool.spec_round()
        got = tpool.spec_round()
        for name, w, g in zip(("emitted", "n_emit", "proposed"), want, got):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {r}")
        np.testing.assert_array_equal(tpool.fill_indices(),
                                      jpool.fill_indices(),
                                      err_msg=f"fills {r}")


def test_paged_round_overshoot_row_goes_to_null_block(lm):
    """A lane whose k+1 verify rows run past its block table (fill 29
    of max_len 32, k 3): the row past the table goes to the null block,
    never to a clipped id (which would overwrite position 24), so every
    real block of the lane holds what the JAX round leaves there."""
    jm, params, _, tm, _ = lm
    p = np.random.RandomState(29).randint(0, VOCAB, (29,))
    jpool = jpaging.PagedSlotPool(jm, params, 1, block_size=8,
                                  spec_draft=(jm, params), spec_k=K)
    tpool = PagedSlotPool(tm, 1, block_size=8, spec_draft=tm, spec_k=K)
    for pool in (jpool, tpool):
        pool.prefill(pool.admit(p, 3).slot, p, 0.0, None, 0)
    for w, g in zip(jpool.spec_round(), tpool.spec_round()):
        np.testing.assert_array_equal(g, w)
    chain = tpool.blocks.blocks_of(0)
    assert chain == jpool.blocks.blocks_of(0) and len(chain) == 4
    idx = torch.tensor(chain)
    want = paged_pools_from_jax([np.asarray(x) for x in jpool._pools])
    for pair, jpair in zip(tpool._pools, want):
        for t, j in zip(pair, jpair):
            np.testing.assert_allclose(t[idx].numpy(), j[idx].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_slot_prefill_advance_matches_prefill_chunk(lm):
    """The draft's prompt advance leaves the cache exactly as
    `slot_prefill_chunk` does (it only skips the LM head)."""
    tm = lm[3]
    a, b = tt.init_slot_cache(tm, 2), tt.init_slot_cache(tm, 2)
    dec = tt.slot_decode_model(tm)
    for chunk in (torch.tensor([5, 9, 1, 7]), torch.tensor([3, 3])):
        tt.slot_prefill_chunk(dec, a, 1, chunk)
        tt.slot_prefill_advance(dec, b, 1, chunk)
    assert torch.equal(a.index, b.index) and a.index.tolist() == [0, 6]
    for x, y in zip(a.k + a.v, b.k + b.v):
        assert torch.equal(x, y)


# -- generate_speculative ---------------------------------------------------

def _spec_pair(seed, layers=2, heads=2, **kw):
    """(jax model, jax params, port model) as `tests/test_speculative.py`
    builds them (vocab 64, head_dim 8, max_len 64, blockwise)."""
    port_kw = kw.pop("port_kw", {})
    kw.setdefault("pos_emb", "rope")
    jm = jt.TransformerLM(vocab_size=64, num_layers=layers,
                          num_heads=heads, head_dim=8, max_len=64,
                          attn_impl="blockwise", dtype=jnp.float32, **kw)
    params = unbox(jm.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tt.TransformerLM(64, layers, heads, 8, max_len=64,
                          dtype=torch.float32, device="cpu",
                          **{"attn_impl": "blockwise", **kw, **port_kw})
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


PROMPT = np.asarray([[3, 1, 4, 1, 5]], np.int32)
GEN_CONFIGS = {
    "rope_gqa": dict(heads=4, num_kv_heads=2),
    "rope_gqa_flash_kernels": dict(
        heads=4, num_kv_heads=2,
        port_kw=dict(attn_impl="flash", decode_prefix_impl="pallas",
                     decode_prefix_block=16)),
    "learned": dict(pos_emb="learned"),
}


@pytest.mark.parametrize("draft", ["independent", "self"])
@pytest.mark.parametrize("config", list(GEN_CONFIGS))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_generate_speculative_matches_jax(k, config, draft):
    """Tokens and stats identical to the JAX function's, and the tokens
    equal the target's greedy `generate` (the oracle). The flash
    variant runs the port's path of the card (the flash forward and the
    flash-decode kernel's plain versions on the CPU)."""
    cfg = GEN_CONFIGS[config]
    jm, jp, tm = _spec_pair(0, **cfg)
    if draft == "self":
        dm, dp, dt_ = jm, jp, tm
    else:
        dcfg = {key: v for key, v in cfg.items() if key != "heads"}
        dcfg.pop("num_kv_heads", None)
        dm, dp, dt_ = _spec_pair(99, layers=1, **dcfg)
    steps = 12
    want, wstats = jspec.generate_speculative(
        dm, dp, jm, jp, PROMPT, steps=steps, k=k, return_stats=True)
    got, gstats = tspec.generate_speculative(
        dt_, tm, torch.from_numpy(PROMPT), steps, k=k, return_stats=True)
    assert got.tolist() == np.asarray(want).tolist()
    assert gstats == wstats
    assert got.tolist() == tt.generate(tm, PROMPT, steps).tolist()
    if draft == "self":
        # Full acceptance: every round retired k_eff + 1 tokens.
        assert 1 + gstats["draft_accepted"] + gstats["rounds"] >= steps


def test_generate_speculative_tail_and_zero_steps():
    """A run that reaches the end of the cache finishes on plain target
    ticks (k_eff < 1) exactly as the JAX function does; steps <= 0
    returns the prompt."""
    jm, jp, tm = _spec_pair(2, pos_emb="learned")
    dm, dp, dt_ = _spec_pair(98, layers=1, pos_emb="learned")
    prompt = np.arange(1, 51, dtype=np.int32)[None] % 64
    steps = 64 - 50 + 1
    want, wstats = jspec.generate_speculative(
        dm, dp, jm, jp, prompt, steps=steps, k=1, return_stats=True)
    got, gstats = tspec.generate_speculative(dt_, tm, prompt, steps, k=1,
                                             return_stats=True)
    assert got.tolist() == np.asarray(want).tolist()
    assert gstats == wstats
    # Tokens not retired by a round came from the tail's plain ticks.
    assert steps - 1 - wstats["rounds"] - wstats["draft_accepted"] >= 1
    out, stats = tspec.generate_speculative(tm, tm, prompt, 0,
                                            return_stats=True)
    assert out.tolist() == prompt.tolist() and stats["tokens"] == 0


def test_generate_speculative_refusals():
    """The JAX function's refusals: batch > 1, a sliding window, a
    vocab mismatch and an over-long request."""
    jm, jp, tm = _spec_pair(3)
    dm, dp, dt_ = _spec_pair(97, layers=1)
    wm, wp, wt = _spec_pair(4, window=8)
    sm = tt.TransformerLM(32, 1, 2, 8, max_len=64, dtype=torch.float32,
                          device="cpu")
    cases = [
        ("batch-1", (dm, dp, jm, jp, np.zeros((2, 4), np.int32), 4),
         (dt_, tm, np.zeros((2, 4), np.int64), 4)),
        ("rolling-cache", (dm, dp, wm, wp, PROMPT, 4),
         (dt_, wt, PROMPT, 4)),
        ("max_len", (dm, dp, jm, jp, PROMPT, 1000), (dt_, tm, PROMPT, 1000)),
    ]
    for match, jargs, targs in cases:
        with pytest.raises(ValueError, match=match):
            jspec.generate_speculative(*jargs)
        with pytest.raises(ValueError, match=match):
            tspec.generate_speculative(*targs)
    with pytest.raises(ValueError, match="vocab"):
        tspec.generate_speculative(sm, tm, PROMPT, 4)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("draft", ["self", "noisy"])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_engine_streams_match_jax_spec_and_port_plain(lm, paged, draft):
    """Six greedy requests through two slots: the port's spec engine ==
    the JAX spec engine == the port's plain engine, token for token,
    with the JAX engine's acceptance accounting; the self-draft accepts
    everything, the noisy draft rejects something (the rewind path)."""
    kw = dict(PAGED) if paged else {}
    jdraft, tdraft = _drafts(lm, draft)
    prompts = _prompts(6, seed=0)
    steps = 8
    plain, _ = _streams(ServingEngine, lm[3], prompts, steps, **kw)
    spec, snap = _streams(ServingEngine, lm[3], prompts, steps,
                          spec_draft=tdraft, spec_k=K, **kw)
    jspec_out, jsnap = _jax_streams(lm, prompts, steps, spec_draft=jdraft,
                                    spec_k=K, **kw)
    assert spec == jspec_out
    assert spec == plain
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "spec_multi_token_ticks", "tokens_out", "ticks"):
        assert snap[key] == jsnap[key], key
    rate = snap["spec_acceptance_rate"]
    assert rate == 1.0 if draft == "self" else rate < 1.0


def test_engine_draft_as_jax_style_pair(lm):
    """``spec_draft=(draft_model, draft_params)``: params from
    `params_from_jax` load into the draft model, as the JAX engine's
    pair carries them."""
    jm, params, noisy, tm, tn = lm
    fresh = tt.TransformerLM(VOCAB, 2, 4, 8, max_len=MAX_LEN,
                             dtype=torch.float32, device="cpu")
    pair = (fresh, params_from_jax(jax.tree.map(np.asarray, noisy)))
    prompts = _prompts(3, seed=8)
    a, sa = _streams(ServingEngine, tm, prompts, 6, spec_draft=pair,
                     spec_k=K)
    b, sb = _streams(ServingEngine, tm, prompts, 6, spec_draft=tn,
                     spec_k=K)
    assert a == b and sa["spec_accepted"] == sb["spec_accepted"]


def test_multi_token_ticks_and_accounting(lm):
    tm = lm[3]
    prompts = _prompts(4, seed=3)
    out, snap = _streams(ServingEngine, tm, prompts, 8, spec_draft=tm,
                         spec_k=K)
    assert snap["spec_multi_token_ticks"] >= 1
    assert snap["tokens_per_tick"] > 1
    assert snap["spec_rounds"] >= 1 and snap["spec_proposed"] > 0
    assert snap["spec_accepted"] == snap["spec_proposed"]
    assert snap["completed"] == len(prompts)
    # One host sync per round (plus one per request: its first token).
    assert snap["host_syncs"] == snap["spec_rounds"] + len(prompts)
    assert out == [_jax_generate(lm, p, 8) for p in prompts]


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_eos_mid_round_truncates(lm, paged):
    """An eos landing inside a multi-token round truncates the stream
    exactly where the plain engine's does."""
    tm = lm[3]
    kw = dict(PAGED) if paged else {}
    prompt = _prompts(1, seed=5)[0]
    steps = 10
    eos = _jax_generate(lm, prompt, steps)[steps // 2]
    plain, _ = _streams(ServingEngine, tm, [prompt], steps, eos_id=eos,
                        **kw)
    spec, _ = _streams(ServingEngine, tm, [prompt], steps, eos_id=eos,
                       spec_draft=tm, spec_k=K, **kw)
    assert plain == spec
    assert plain[0][-1] == eos


def test_submit_refusals(lm):
    """Sampling refused; the verify's k-token headroom bound; draft
    validation (vocab, window, max_len, k)."""
    tm = lm[3]
    with ServingEngine(tm, num_slots=1, spec_draft=tm, spec_k=2) as eng:
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit(np.array([1, 2]), 4, temperature=0.7)
    with ServingEngine(tm, num_slots=1, spec_draft=tm, spec_k=4) as eng:
        with pytest.raises(ValueError, match="headroom"):
            eng.submit(np.arange(8), MAX_LEN - 8 - 1)
        # The same request fits once k is budgeted for.
        r = eng.submit(np.arange(8), MAX_LEN - 8 - 4).result(timeout=300)
        assert len(r.tokens) == MAX_LEN - 8 - 4
    bad = {
        "vocab": tt.TransformerLM(VOCAB // 2, 1, 2, 8, max_len=MAX_LEN,
                                  dtype=torch.float32, device="cpu"),
        "max_len": tt.TransformerLM(VOCAB, 1, 2, 8, max_len=MAX_LEN // 2,
                                    dtype=torch.float32, device="cpu"),
        "window": tt.TransformerLM(VOCAB, 1, 2, 8, max_len=MAX_LEN,
                                   window=4, dtype=torch.float32,
                                   device="cpu"),
    }
    for match, draft in bad.items():
        with pytest.raises(ValueError, match=match):
            ServingEngine(tm, num_slots=1, spec_draft=draft, spec_k=2)
        with pytest.raises(ValueError, match=match):
            PagedSlotPool(tm, 1, block_size=8, spec_draft=draft, spec_k=2)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tm, num_slots=1, spec_draft=tm, spec_k=0)


def test_env_knob_spec_k(lm, monkeypatch):
    """HVD_SPEC_K is read when spec_k is None (default 4)."""
    from horovod_tpu_torch.runtime.config import config
    tm = lm[3]
    with ServingEngine(tm, num_slots=1, spec_draft=tm) as eng:
        assert eng.spec_k == eng.pool.spec_k == 4
    monkeypatch.setenv("HVD_SPEC_K", "2")
    config.refresh()
    try:
        with ServingEngine(tm, num_slots=1, spec_draft=tm) as eng:
            assert eng.spec_k == eng.pool.spec_k == 2
            r = eng.submit(np.arange(1, 5), 6).result(timeout=300)
            assert ("spec_round", 2) in eng.pool._seen_shapes
        assert list(map(int, r.tokens)) == _jax_generate(
            lm, np.arange(1, 5), 6)
    finally:
        monkeypatch.undo()
        config.refresh()


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_brownout_level2_halves_k_and_keeps_tokens(lm, paged):
    """Brownout level 2 caps k at max(1, spec_k // 2) engine-wide; every
    token is unchanged (greedy spec decode is exact for any k)."""
    tm, tn = lm[3], lm[4]
    kw = dict(PAGED) if paged else {}
    prompts = _prompts(3, seed=19)
    ref, _ = _streams(ServingEngine, tm, prompts, 8, **kw)
    with ServingEngine(tm, num_slots=2, spec_draft=tn, spec_k=4,
                       brownout=True, **kw) as eng:
        eng.brownout.touch("t")
        with chaos.armed("serving.overload_storm:2"):
            # The dispatch thread may take a storm fire too: each fire
            # escalates one rung, whoever steps.
            _wait(lambda: eng.brownout.step() is not None
                  and eng.brownout.max_level() >= 2)
        _wait(lambda: eng.pool.spec_cap == 2)
        out = [list(map(int, h.result(timeout=300).tokens)) for h in
               [eng.submit(p, 8, tenant="t") for p in prompts]]
        snap = eng.metrics_snapshot()
        ks = {key[1] for key in eng.pool._seen_shapes
              if "spec_round" in key[0]}
    assert out == ref
    assert ks == {2}
    assert snap["spec_proposed"] % 2 == 0 and snap["spec_proposed"] > 0


# -- migration (the port of the JAX TestSpecMigration) ----------------------

@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_forced_prefix_bitwise_all_kill_points(lm, paged):
    """A request resubmitted with its first n tokens as forced_prefix
    continues bitwise: the accepted-token count is the resume state;
    kill points land on round boundaries and mid-round."""
    tm = lm[3]
    prompt = _prompts(1, seed=17)[0]
    steps = 10
    kw = dict(spec_draft=tm, spec_k=K, **(PAGED if paged else {}))
    ref, _ = _streams(ServingEngine, tm, [prompt], steps, **kw)
    ref = ref[0]
    assert ref == _jax_generate(lm, prompt, steps)
    with ServingEngine(tm, num_slots=2, **kw) as eng:
        for n in (1, 2, 3, 4, 7, steps - 1):
            r = eng.submit(prompt, steps,
                           forced_prefix=ref[:n]).result(timeout=300)
            assert list(map(int, r.tokens)) == ref, (paged, n)


def test_watchdog_restart_replays_exact(lm):
    """A dispatch crash mid-spec-serving heals in place and the requeued
    requests replay bitwise (`clone_fresh` carries the draft)."""
    tm = lm[3]
    prompts = _prompts(4, seed=31)
    ref, _ = _streams(ServingEngine, tm, prompts, 8, spec_draft=tm,
                      spec_k=K)
    with ServingEngine(tm, num_slots=2, spec_draft=tm, spec_k=K,
                       auto_restart=True, max_restarts=4) as eng:
        hs = [eng.submit(p, 8) for p in prompts]
        _wait(lambda: len(hs[0].tokens_so_far()) >= 2)
        with chaos.armed("serving_dispatch_crash:1"):
            _wait(lambda: eng.metrics_snapshot()["restarts"] >= 1)
        out = [list(map(int, h.result(timeout=300).tokens)) for h in hs]
        assert eng.pool.spec_on and eng.pool.spec_draft is tm
    assert out == ref


def test_cross_engine_resume(lm):
    """A stream started on a spec engine resumes bitwise on a plain
    engine and vice versa."""
    tm, tn = lm[3], lm[4]
    prompt = _prompts(1, seed=23)[0]
    steps = 9
    spec, _ = _streams(ServingEngine, tm, [prompt], steps, spec_draft=tn,
                       spec_k=K)
    plain, _ = _streams(ServingEngine, tm, [prompt], steps)
    assert spec == plain
    n = 4
    with ServingEngine(tm, num_slots=1) as eng:
        on_plain = list(map(int, eng.submit(
            prompt, steps, forced_prefix=spec[0][:n]).result(
            timeout=300).tokens))
    with ServingEngine(tm, num_slots=1, spec_draft=tn, spec_k=K) as eng:
        on_spec = list(map(int, eng.submit(
            prompt, steps, forced_prefix=plain[0][:n]).result(
            timeout=300).tokens))
    assert on_plain == spec[0] and on_spec == plain[0]


# -- the int8-weight legs -------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_int8_spec_engine_streams_match_jax_int8_generate(lm, paged):
    """The JAX `TestWeightQuantServing` legs in the port:
    `ServingEngine(weight_quant="int8")` on the float target with the
    int8 target as its own draft (a quantized model passed as the draft
    is used as it is), fixed and paged: every stream == JAX `generate`
    of the int8 model on the quantized tree, and rounds retire more than
    one token."""
    from horovod_tpu.ops.quantization import quantize_lm_params
    from horovod_tpu_torch.ops.quantization import quantize_lm
    jm, params, _, tm, _ = lm
    qm, qp = jm.clone(weight_quant="int8"), quantize_lm_params(params)
    prompts = _prompts(4, seed=4)
    refs = [np.asarray(jt.generate(qm, qp, jnp.asarray(p)[None], 7))
            [0, len(p):].tolist() for p in prompts]
    draft = quantize_lm(tm)
    out, snap = _streams(ServingEngine, tm, prompts, 7, weight_quant="int8",
                         spec_draft=draft, spec_k=K, **(PAGED if paged
                                                       else {}))
    assert out == refs
    assert snap["spec_multi_token_ticks"] >= 1


def test_generate_speculative_int8_gqa_matches_jax():
    """`test_composes_with_int8_weights_and_gqa` in the port: an int8
    GQA target and a small float draft; the output == the JAX int8
    target's greedy `generate`, and the round stats == the JAX
    function's."""
    from horovod_tpu.ops.quantization import quantize_lm_params
    from horovod_tpu_torch.ops.quantization import quantize_lm
    jm, jp, tm = _spec_pair(5, heads=4, num_kv_heads=2)
    dm, dp, dt_ = _spec_pair(96, layers=1)
    q_m, q_p = jm.clone(weight_quant="int8"), quantize_lm_params(jp)
    want = np.asarray(jt.generate(q_m, q_p, PROMPT, steps=10))
    jgot, jstats = jspec.generate_speculative(dm, dp, q_m, q_p, PROMPT,
                                              steps=10, k=3,
                                              return_stats=True)
    got, stats = tspec.generate_speculative(dt_, quantize_lm(tm), PROMPT,
                                            10, k=3, return_stats=True)
    assert got.tolist() == want.tolist() == np.asarray(jgot).tolist()
    assert stats == jstats
