"""PyTorch port: threefry sampling (`ops.threefry`) against `jax.random`,
and the seeded streams of every sampling site against the JAX package.

Keys, splits, fold-ins, random bits and uniforms must be bitwise
`jax.random`'s (jax 0.9, partitionable threefry, under the x64 mode
`tests/conftest.py` turns on). Gumbel noise is ``-log(-log(u))`` of
those uniforms, and torch's float32 ``log`` and XLA's CPU ``log`` may
round the last bit differently, so the stated rule for the noise is:
``|g - g_ref| <= ulp(g_ref) + 2**-23`` — the outer log's last bit plus
the inner log's last bit carried through (``test_gumbel_within_rule``;
over 40 seeds x 32768 draws the worst case reaches half that bound).
Seeded streams are then held TOKEN-EXACT against the JAX package (an
argmax flips only if two noisy logits sit within an ulp, which these
toys never show): `generate`, the fixed and paged engines, and a
forced-prefix resume at k = 1, 5 and 12.

The model is the JAX serving tests' toy (vocab 64, 2 layers, 4 heads of
8, max_len 64, float32), loaded into the port with `params_from_jax`.
"""

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
from horovod_tpu_torch.serving import ServingEngine
from horovod_tpu_torch.serving.slots import LaneKeys

VOCAB, MAX_LEN = 64, 64
SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 + 5]
SHAPES = [(1,), (64,), (3, 64), (32768,)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS + [-3, 2 ** 63 - 1])
def test_prng_key_split_fold_in_bitwise(seed):
    key = threefry.prng_key(seed)
    assert key.dtype == np.uint32
    np.testing.assert_array_equal(key, _jkey(seed))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(
            threefry.split(key, n), np.asarray(jax.random.split(_jkey(seed),
                                                                n)))
    for data in (0, 1, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            threefry.fold_in(key, data),
            np.asarray(jax.random.fold_in(_jkey(seed), data)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_bitwise(seed, shape):
    key = threefry.prng_key(seed)
    bits = threefry.random_bits(key, shape)
    want = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint32))
    assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
    np.testing.assert_array_equal(bits.numpy(), want.astype(np.int64))
    u = threefry.uniform(key, shape).numpy()
    ju = np.asarray(jax.random.uniform(_jkey(seed), shape, jnp.float32))
    np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_rule(seed):
    """The stated tolerance rule: the noise is within ``ulp + 2**-23``
    of `jax.random.gumbel` (``log`` rounding; module docstring), and the
    Gumbel-max argmax of `categorical` equals the reference's."""
    key = threefry.prng_key(seed)
    g = threefry.gumbel(key, (32768,)).numpy()
    jg = np.asarray(jax.random.gumbel(_jkey(seed), (32768,), jnp.float32))
    assert np.all(np.abs(g - jg) <= np.spacing(np.abs(jg)) + 2.0 ** -23)
    logits = np.random.RandomState(seed % 1000).randn(4, VOCAB)
    logits = logits.astype(np.float32)
    got = threefry.categorical(key, torch.from_numpy(logits)).numpy()
    want = np.asarray(jax.random.categorical(_jkey(seed),
                                             jnp.asarray(logits)))
    np.testing.assert_array_equal(got, want)


def test_batched_keys_equal_one_key_at_a_time():
    """A batch [L, 2] splits and draws lane by lane as if alone (the
    serving tick's one batched call), and `advance` is k carry-splits."""
    keys = np.stack([threefry.prng_key(s) for s in (3, 9, 2 ** 33)])
    pairs = threefry.split(keys)
    bits = threefry.random_bits(keys, (VOCAB,))
    for lane, key in enumerate(keys):
        np.testing.assert_array_equal(pairs[lane], threefry.split(key))
        np.testing.assert_array_equal(bits[lane].numpy(),
                                      threefry.random_bits(key, (VOCAB,)))
    k = keys[0]
    for _ in range(5):
        k = threefry.split(k)[0]
    np.testing.assert_array_equal(threefry.advance(keys[0], 5), k)


def test_lane_keys_split_each_sampled_lane_once_per_tick():
    """`LaneKeys.noise` is the reference tick's ``rng, r = split(rng)``
    per sampled lane, its noise row ``gumbel(r, [V])``; a greedy lane
    draws nothing and a copied lane continues the same stream."""
    lk = LaneKeys(3)
    key = threefry.prng_key(7)
    lk.install(1, key)
    lk.copy(1, 2)
    noise = lk.noise(VOCAB, "cpu")
    rng, r = threefry.split(key)
    want = threefry.gumbel(r, (VOCAB,))
    assert torch.equal(noise[1], want) and torch.equal(noise[2], want)
    np.testing.assert_array_equal(lk.keys[1], rng)
    lk.install(1, None)
    lk.install(2, None)
    assert lk.noise(VOCAB, "cpu") is None


@pytest.fixture(scope="module")
def lm():
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=2, num_heads=4,
                          head_dim=8, max_len=MAX_LEN, dtype=jnp.float32)
    params = unbox(jm.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))["params"])
    tm = tt.TransformerLM(VOCAB, 2, 4, 8, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("seed", [0, 2 ** 32 + 5])
def test_generate_seeded_stream_token_exact(lm, seed):
    jm, params, tm = lm
    prompt = np.random.RandomState(3).randint(0, VOCAB, (3, 5))
    for kw in ({}, {"top_p": 0.9}, {"top_k": 12}):
        ref = jt.generate(jm, params, jnp.asarray(prompt), 20,
                          temperature=0.8, rng=jax.random.PRNGKey(seed),
                          **kw)
        got = tt.generate(tm, torch.from_numpy(prompt), 20,
                          temperature=0.8, rng=threefry.prng_key(seed),
                          **kw)
        assert got.tolist() == np.asarray(ref).tolist(), kw


def _requests(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (int(rs.randint(2, 12)),)),
             0.0 if i % 3 == 0 else 0.9, 1000 + i) for i in range(n)]


@pytest.fixture(scope="module")
def jax_streams(lm):
    """The JAX engines' streams for `_requests(6, 5)` (mixed greedy and
    seeded, top_p 0.95 on the sampled ones), fixed and paged pools."""
    jm, params, _ = lm
    out = {}
    for paged in (False, True):
        with JaxEngine(jm, params, num_slots=3, max_queue=16, paged=paged,
                       kv_block_size=8) as eng:
            hs = [eng.submit(p, 16, temperature=t,
                             top_p=0.95 if t else None, seed=s)
                  for p, t, s in _requests(6, 5)]
            out[paged] = [list(map(int, h.result(timeout=300).tokens))
                          for h in hs]
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_engine_seeded_streams_token_exact(lm, jax_streams, paged):
    _, _, tm = lm
    with ServingEngine(tm, num_slots=3, max_queue=16, paged=paged,
                       kv_block_size=8) as eng:
        hs = [eng.submit(p, 16, temperature=t, top_p=0.95 if t else None,
                         seed=s) for p, t, s in _requests(6, 5)]
        got = [list(map(int, h.result(timeout=120).tokens)) for h in hs]
    assert got == jax_streams[paged]


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_forced_prefix_resume_token_exact(lm, jax_streams, paged, k):
    """A resubmit carrying the first k tokens of a seeded stream as its
    forced prefix continues the JAX package's stream (the key skips k
    carry-splits)."""
    _, _, tm = lm
    reqs = _requests(6, 5)
    with ServingEngine(tm, num_slots=3, max_queue=16, paged=paged,
                       kv_block_size=8) as eng:
        hs = []
        for i, (p, t, s) in enumerate(reqs):
            if not t:
                continue
            ref = jax_streams[paged][i]
            hs.append((ref, eng.submit(p, 16, temperature=t, top_p=0.95,
                                       seed=s, forced_prefix=ref[:k])))
        for ref, h in hs:
            assert list(map(int, h.result(timeout=120).tokens)) == ref
