"""PyTorch port: the paged KV serving path against the JAX package, and
the paged pool's own contracts.

Toy size: vocab 64, 2 layers, width 64 (4 heads of 16, GQA with 2 kv
heads), max_len 64, float32, block sizes 4 and 8. Weights cross over
with `params_from_jax`, pools with `paged_pools_from_jax`; inputs come
from numpy with a seed. The JAX side runs as its own tests run it: the
Pallas paged-decode kernel in interpret mode. Tolerance: float32 on
both sides, so values agree to rtol = atol = 1e-5 (summation order
only); greedy streams must be token-exact.
"""

import functools
import importlib.util
import pathlib
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import paged_attention as jpa
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import (paged_pools_from_jax,
                                               params_from_jax)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import paged_attention as tpa
from horovod_tpu_torch.serving import ServingEngine
from horovod_tpu_torch.serving.paging import (BlockPool, PagedSlotPool,
                                              _resolve_paged_kernel)

VOCAB, LAYERS, HEADS, HEAD_DIM, KV_HEADS, MAX_LEN = 64, 2, 4, 16, 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("off", "lax", "pallas")
REPO = pathlib.Path(__file__).resolve().parent.parent


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
    "gpt_gqa": dict(num_kv_heads=KV_HEADS),
    "llama_rope_gqa": dict(num_kv_heads=KV_HEADS, pos_emb="rope",
                           **jt.LLAMA_ARCH_KW),
}


def _pair(preset="gpt_gqa", **kw):
    """(jax model, jax params, port model) sharing one weight set."""
    cfg = dict(PRESETS[preset], decode_prefix_block=16, **kw)
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                          num_heads=HEADS, head_dim=HEAD_DIM,
                          max_len=MAX_LEN, dtype=jnp.float32, **cfg)
    params = unbox(jm.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))["params"])
    tm = tt.TransformerLM(VOCAB, LAYERS, HEADS, HEAD_DIM, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {p: _pair(p) for p in PRESETS}


def _prompts(n, seed=0, lo=1, hi=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(rs.randint(lo, hi)),))
            for _ in range(n)]


def _wait(cond, timeout=60.0, dt=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(dt)


def _t(*arrays):
    """Port-side copies of numpy inputs. Copies, not views: on the CPU
    `jnp.asarray` of a 64-byte aligned numpy array may alias its memory,
    and the JAX call that reads it runs asynchronously, so a port
    function writing in place into a shared buffer (the prefill chunk
    bumps its lane's fill) could change the JAX call's input while it
    runs."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_port_inputs_never_alias_jax_inputs():
    """The race `_t` guards against: a JAX call dispatched on an aligned
    numpy array that aliases it reads a value written after dispatch
    (the port's in-place fill bump), while a `_t` copy leaves the JAX
    input alone."""
    buf = np.zeros(64 + 16, np.uint8)
    off = (-buf.ctypes.data) % 64
    fills = buf[off:off + 16].view(np.int32)
    fills[:] = [0, 13, 40, 64]
    jf = jnp.asarray(fills)
    (tf,) = _t(fills)
    tf[1] += 1
    assert not np.shares_memory(tf.numpy(), fills)
    assert np.asarray(jf).tolist() == [0, 13, 40, 64]


def _pools_and_tables(rs, bs, lanes, nb=None):
    """Random pool bytes [nb, bs, Hkv, D] per K/V and shuffled tables
    (each lane a random permutation of pool blocks, null block 0
    excluded)."""
    T = MAX_LEN // bs
    nb = nb or lanes * T + 1
    kp = rs.randn(nb, bs, KV_HEADS, HEAD_DIM).astype(np.float32)
    vp = rs.randn(nb, bs, KV_HEADS, HEAD_DIM).astype(np.float32)
    tables = np.stack([rs.permutation(np.arange(1, nb))[:T]
                       for _ in range(lanes)]).astype(np.int32)
    return kp, vp, tables


# -- the walk and the kernel's plain version --------------------------------

@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("bs,walk_block", [(4, 4), (4, 16), (8, 16)])
def test_walk_matches_jax(S, bs, walk_block):
    """The batched walk == the JAX walk lane by lane, over shuffled
    tables. S=1 at fills 0, 3, 4 (a block boundary) and 63 (the last
    row); S=5 at fills 0, 3, 4 and 59 (the chunk ends at max_len: the
    JAX walk reads a clamped extra span past it)."""
    rs = np.random.RandomState(10 * S + bs + walk_block)
    fills = np.array([0, 3, 4, MAX_LEN - S], np.int32)
    L = len(fills)
    kp, vp, tables = _pools_and_tables(rs, bs, L)
    q = rs.randn(L, S, HEADS, HEAD_DIM).astype(np.float32)
    kn = rs.randn(L, S, KV_HEADS, HEAD_DIM).astype(np.float32)
    vn = rs.randn(L, S, KV_HEADS, HEAD_DIM).astype(np.float32)
    ref = np.stack([np.asarray(jpa.paged_prefix_attention(
        jnp.asarray(q[i])[None], jnp.asarray(kn[i])[None],
        jnp.asarray(vn[i])[None], jnp.asarray(kp)[:, None],
        jnp.asarray(vp)[:, None], jnp.asarray(tables[i]),
        jnp.int32(fills[i]), walk_block=walk_block,
        groups=HEADS // KV_HEADS))[0] for i in range(L)])
    tq, tkn, tvn, tkp, tvp, ttab, tfill = _t(q, kn, vn, kp, vp, tables,
                                             fills)
    out = tpa.paged_prefix_attention(tq, tkn, tvn, tkp, tvp, ttab, tfill,
                                     walk_block=walk_block)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # The host bound changes the trip count, never the result.
    bounded = tpa.paged_prefix_attention(
        tq, tkn, tvn, tkp, tvp, ttab, tfill, walk_block=walk_block,
        prefix_len=int(fills.max()) + S)
    np.testing.assert_array_equal(bounded.numpy(), out.numpy())


def _dense_reference(q, kn, vn, tables, fills, kp, vp):
    """Independent reference: gather each lane's table into a linear
    cache, put the new row at ``fill`` (when inside it), dense softmax
    over positions <= fill."""
    L, H, D = q.shape
    T, bs, hkv = tables.shape[1], kp.shape[1], kp.shape[2]
    out = np.zeros_like(q)
    for i in range(L):
        k = kp[tables[i]].reshape(T * bs, hkv, D).copy()
        v = vp[tables[i]].reshape(T * bs, hkv, D).copy()
        n = min(int(fills[i]) + 1, T * bs)
        if fills[i] < T * bs:
            k[fills[i]], v[fills[i]] = kn[i], vn[i]
        k = np.repeat(k[:n], H // hkv, axis=1)
        v = np.repeat(v[:n], H // hkv, axis=1)
        s = np.einsum("hd,khd->hk", q[i].astype(np.float64),
                      k.astype(np.float64)) * D ** -0.5
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        out[i] = np.einsum("hk,khd->hd", p, v)
    return out


@pytest.mark.parametrize("bs", [4, 8])
def test_paged_decode_plain_matches_jax_kernel(bs):
    """The kernel's plain version == the JAX Pallas paged-decode kernel
    (interpret mode), a dense gather reference and the port's walk at
    walk_block == block_size, at the edge cases:
    fill 0 (only the new row), fill at a block boundary (the new row
    opens a fresh block), the last row, fill == max_len (the pipelined
    tick past the budget: the whole table, no merged row), and a free
    lane whose table is all null block 0."""
    rs = np.random.RandomState(bs)
    fills = np.array([0, 3, bs, 2 * bs - 1, MAX_LEN - 1, MAX_LEN, 0],
                     np.int32)
    L = len(fills)
    kp, vp, tables = _pools_and_tables(rs, bs, L)
    tables[-1] = 0
    q = rs.randn(L, HEADS, HEAD_DIM).astype(np.float32)
    kn = rs.randn(L, KV_HEADS, HEAD_DIM).astype(np.float32)
    vn = rs.randn(L, KV_HEADS, HEAD_DIM).astype(np.float32)
    ref = np.stack([np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q[i])[None, None], jnp.asarray(kn[i])[None, None],
        jnp.asarray(vn[i])[None, None], jnp.asarray(kp)[:, None],
        jnp.asarray(vp)[:, None], jnp.asarray(tables[i]),
        jnp.int32(fills[i]), interpret=True))[0, 0] for i in range(L)])
    args = _t(q, kn, vn, tables, fills, kp, vp)
    out = tpa.paged_decode_plain(*args)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        out.numpy(), _dense_reference(q, kn, vn, tables, fills, kp, vp),
        **TOL)
    walk = tpa.paged_prefix_attention(
        args[0][:, None], args[1][:, None], args[2][:, None], args[5],
        args[6], args[3], args[4], walk_block=bs)[:, 0]
    np.testing.assert_array_equal(out.numpy(), walk.numpy())
    assert np.isfinite(out.numpy()).all()
    # The dispatcher takes the plain version for CPU tensors (the
    # kernel's launch count does not move).
    before = tpa.paged_decode_cuda.launches
    np.testing.assert_array_equal(tpa.paged_decode_attention(*args).numpy(),
                                  out.numpy())
    assert tpa.paged_decode_cuda.launches == before


def test_paged_decode_plain_detects_swapped_table_entries():
    """The comparison the chip smoke plants as a fault: swapping a
    lane's first table entry with the entry holding its fill must
    change that lane's output. (Swapping two wholly attended blocks
    cannot: attention over keys already rotated at their positions is a
    function of the SET of (key, value) rows, so that swap is
    invisible to any check.)"""
    rs = np.random.RandomState(3)
    fills = np.array([41, 41], np.int32)
    kp, vp, tables = _pools_and_tables(rs, 4, 2)
    q = rs.randn(2, HEADS, HEAD_DIM).astype(np.float32)
    kn = rs.randn(2, KV_HEADS, HEAD_DIM).astype(np.float32)
    vn = rs.randn(2, KV_HEADS, HEAD_DIM).astype(np.float32)
    out = tpa.paged_decode_plain(*_t(q, kn, vn, tables, fills, kp, vp))
    swapped = tables.copy()
    swapped[0, [0, 41 // 4]] = swapped[0, [41 // 4, 0]]
    bad = tpa.paged_decode_plain(*_t(q, kn, vn, swapped, fills, kp, vp))
    assert float((bad[0] - out[0]).abs().max()) > 1e-3
    np.testing.assert_array_equal(bad[1].numpy(), out[1].numpy())
    full = tables.copy()
    full[0, [1, 5]] = full[0, [5, 1]]
    same = tpa.paged_decode_plain(*_t(q, kn, vn, full, fills, kp, vp))
    np.testing.assert_allclose(same.numpy(), out.numpy(), **TOL)


# -- the kernel's split arithmetic ------------------------------------------

_SPLITS = (1, 2, 3, "T")


def _split_fills(bs):
    """Fill 0, a fill on and one before each boundary of every split
    count of `_SPLITS` (the new row opens a split / the split ends at
    the fill), the last row, ``T * bs`` (the whole table, no merged
    row), and 0 for the free lane last."""
    T = MAX_LEN // bs
    edges = set()
    for ns in _SPLITS:
        ns = T if ns == "T" else ns
        c = -(-T // ns) * bs
        edges |= {f for k in range(1, ns) for f in (k * c - 1, k * c)}
    return np.array([0, *sorted(edges), MAX_LEN - 1, MAX_LEN, 0], np.int32)


@functools.lru_cache(maxsize=None)
def _split_case(bs, hkv):
    """Inputs over the fills of `_split_fills` (the last lane free, on the
    all-null table) and the JAX Pallas paged-decode kernel's output on
    them (interpret mode, vmapped over the lanes as the serving tick
    runs it)."""
    rs = np.random.RandomState(100 * bs + hkv)
    fills = _split_fills(bs)
    L, T = len(fills), MAX_LEN // bs
    nb = L * T + 1
    kp = rs.randn(nb, bs, hkv, HEAD_DIM).astype(np.float32)
    vp = rs.randn(nb, bs, hkv, HEAD_DIM).astype(np.float32)
    tables = np.stack([rs.permutation(np.arange(1, nb))[:T]
                       for _ in range(L)]).astype(np.int32)
    tables[-1] = 0
    q = rs.randn(L, HEADS, HEAD_DIM).astype(np.float32)
    kn = rs.randn(L, hkv, HEAD_DIM).astype(np.float32)
    vn = rs.randn(L, hkv, HEAD_DIM).astype(np.float32)
    jkp, jvp = jnp.asarray(kp)[:, None], jnp.asarray(vp)[:, None]
    lane = jax.vmap(lambda q1, k1, v1, t1, f1: jpa.paged_decode_attention(
        q1[None, None], k1[None, None], v1[None, None], jkp, jvp, t1, f1,
        interpret=True)[0, 0])
    ref = np.asarray(lane(*map(jnp.asarray, (q, kn, vn, tables, fills))))
    return (q, kn, vn, tables, fills, kp, vp), ref


@pytest.mark.parametrize("splits", _SPLITS)
@pytest.mark.parametrize("hkv", [HEADS, KV_HEADS])       # GQA 1 and 2
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_decode_split_plain_matches_jax_kernel(bs, hkv, splits):
    """The kernel's split-and-merge arithmetic (f32) == the JAX Pallas
    paged-decode kernel (interpret mode), `paged_decode_plain` and the
    dense numpy reference, at fill 0, on and one before every split
    boundary, the last row, fill == max_len and a free lane on the
    all-null table."""
    arrays, ref = _split_case(bs, hkv)
    ns = MAX_LEN // bs if splits == "T" else splits
    args = _t(*arrays)
    out = tpa.paged_decode_split_plain(*args, ns)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(),
                               tpa.paged_decode_plain(*args).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), _dense_reference(*arrays), **TOL)


@pytest.mark.parametrize("splits", _SPLITS)
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_decode_split_plain_bf16_within_card_tolerance(bs, splits):
    """In bf16 (q scaled and rounded, p rounded against each split's own
    max before P.V, as the kernel does) the split arithmetic stays within
    the card's bf16 tolerance, 2e-3 + 1e-2 |ref|, of the f32 walk on the
    same bf16 values."""
    arrays, _ = _split_case(bs, KV_HEADS)
    ns = MAX_LEN // bs if splits == "T" else splits
    q, kn, vn, tables, fill, kp, vp = _t(*arrays)
    bf = [t.to(torch.bfloat16) for t in (q, kn, vn, kp, vp)]
    out = tpa.paged_decode_split_plain(bf[0], bf[1], bf[2], tables, fill,
                                       bf[3], bf[4], ns)
    assert out.dtype == torch.bfloat16
    f = [t.float() for t in bf]
    ref = tpa.paged_decode_plain(f[0], f[1], f[2], tables, fill, f[3], f[4])
    err = (out.float() - ref).abs()
    assert bool((err <= 2e-3 + 1e-2 * ref.abs()).all()), float(err.max())


def test_paged_decode_splits():
    """The split count is a pure function of the geometry (never of the
    fills): 4 at the timed tick (8 lanes x 8 kv heads, T 128, bs 16, 132
    SMs: 256 blocks, one wave of the card's 264 resident slots) and at
    the paged engine's 16 lanes (splits of 512 positions), 8 at 8 lanes
    x 2 kv heads, 1 for a span under 512 positions; each split holds
    ce = ceil(T / NS) whole table entries (ce * bs positions,
    block-aligned), NS * ce >= T, none starts past the table, and a
    split stages at most PAGED_MAX_SPLIT_ENTRIES."""
    assert tpa.paged_decode_splits(128, 16, 64, 132) == 4
    assert tpa.paged_decode_splits(128, 16, 128, 132) == 4
    assert tpa.paged_decode_splits(128, 16, 16, 132) == 8
    for T, bs in ((31, 16), (8, 4), (127, 4), (1, 16)):
        assert tpa.paged_decode_splits(T, bs, 1, 132) == 1
    cap = tpa.PAGED_MAX_SPLIT_ENTRIES
    for T in (1, 7, 31, 128, 129, 512, 1000, 4096, 20000):
        for bs in (1, 4, 16, 64):
            for pairs in (1, 8, 64, 128, 1000):
                ns = tpa.paged_decode_splits(T, bs, pairs, 132)
                ce = -(-T // ns)
                assert ns >= 1 and ce <= cap
                assert ns * ce >= T and (ns - 1) * ce < T
                assert all((k * ce * bs) % bs == 0 for k in range(ns + 1))


def test_cuda_wrapper_refuses_cpu_tensors():
    rs = np.random.RandomState(0)
    kp, vp, tables = _pools_and_tables(rs, 4, 1)
    q = rs.randn(1, HEADS, HEAD_DIM).astype(np.float32)
    kn = rs.randn(1, KV_HEADS, HEAD_DIM).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpa.paged_decode_cuda(*_t(q, kn, kn, tables,
                                  np.zeros(1, np.int32), kp, vp))


# -- pools across the packages ----------------------------------------------

def test_paged_pools_from_jax_layer_order():
    """The JAX pool list is in flatten order, which sorts layer names
    as strings (block_10 before block_2): the conversion must put each
    pool at its layer. Checked against the JAX spec's own paths at 11
    layers (shape evaluation only, nothing runs)."""
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=11, num_heads=2,
                          head_dim=8, max_len=16, dtype=jnp.float32)
    spec = jt.paged_cache_spec(jm, 4)
    kv_paths = [p for p, k in zip(spec.paths, spec.kinds) if k == "kv"]
    pools = []
    for path in kv_paths:
        layer = int(path[0].split("_")[1])
        val = 2 * layer + (path[-1] == "cached_value")
        pools.append(np.full((3, 1, 4, 2, 8), val, np.float32))
    out = paged_pools_from_jax(pools)
    assert len(out) == 11
    for i, (k, v) in enumerate(out):
        assert k.shape == (3, 4, 2, 8)
        assert float(k[0, 0, 0, 0]) == 2 * i
        assert float(v[0, 0, 0, 0]) == 2 * i + 1


# -- the paged primitives against the JAX package -------------------------

def _random_pool_state(rs, jm, bs, lanes, fills):
    """The same paged cache state for both packages: random pool bytes
    in the JAX layout, shuffled tables, the given fills."""
    spec = jt.paged_cache_spec(jm, bs)
    nb = lanes * spec.blocks_per_seq + 1
    shapes = [p.shape for p in jt.init_paged_pools(jm, spec, nb)]
    pools = [rs.randn(*s).astype(np.float32) for s in shapes]
    tables = np.stack([rs.permutation(np.arange(1, nb))
                       [:spec.blocks_per_seq]
                       for _ in range(lanes)]).astype(np.int32)
    return spec, pools, tables, np.asarray(fills, np.int32)


def _jax_dec(jm, mode, bs):
    dec = jt.slot_decode_model(jm)
    if mode == "pallas":
        dec = dec.clone(decode_prefix_impl="pallas",
                        decode_prefix_block=bs)
    return dec


@pytest.mark.parametrize("preset,mode", [
    ("gpt_gqa", "off"), ("gpt_gqa", "lax"), ("gpt_gqa", "pallas"),
    ("llama_rope_gqa", "lax"), ("llama_rope_gqa", "pallas")])
def test_prefill_chunk_and_tick_match_jax(pairs, preset, mode):
    """From the same pools, tables and fills: `paged_prefill_chunk`
    logits (chunks of 1 and 5 tokens) and the new rows it writes, then
    one `paged_decode_tick` over four lanes (one of them frozen, one at
    fill == max_len) — tokens, fills and every pool byte — match the
    JAX functions. The S=1 chunk takes the paged-decode kernel's plain
    version under "pallas"; the 5-token chunk walks at the model's
    decode_prefix_block (16) here, at the block size (4) in the JAX
    package. The RoPE preset checks rotation at each lane's true fill
    on the paths that read the pools in place."""
    jm, params, tm = pairs[preset]
    bs = 4
    rs = np.random.RandomState(7)
    spec, pools, tables, fills = _random_pool_state(
        rs, jm, bs, 4, [0, 13, 40, MAX_LEN])
    dec = _jax_dec(jm, mode, bs)
    fused = mode != "off"
    tspec = tt.paged_cache_spec(tm, bs)
    tpools = paged_pools_from_jax(pools)
    ttables, tfills = _t(tables, fills)
    jpools, jfills = [jnp.asarray(p) for p in pools], jnp.asarray(fills)
    for slot, C in ((1, 1), (2, 5)):
        chunk = rs.randint(0, VOCAB, (C,))
        jpools, jfills, jlog = jt.paged_prefill_chunk(
            dec, spec, jpools, params, jnp.asarray(tables), jfills,
            jnp.int32(slot), jnp.asarray(chunk, jnp.int32), fused=fused)
        tlog = tt.paged_prefill_chunk(
            tm, tspec, tpools, ttables, tfills, slot,
            torch.from_numpy(chunk), paged_kernel=mode,
            fill=int(fills[slot]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(tfills.numpy(), np.asarray(jfills))
        fills = np.asarray(jfills)
    toks = rs.randint(0, VOCAB, (4,))
    live = np.array([True, True, False, True])
    out = jt.paged_decode_tick(
        dec, spec, jpools, params, jnp.asarray(tables), jfills,
        jnp.asarray(toks, jnp.int32), jnp.zeros(4, jnp.float32),
        jnp.ones(4, jnp.float32),
        jnp.stack([jax.random.PRNGKey(i) for i in range(4)]),
        jnp.asarray(live), jnp.zeros(4, bool), jnp.int32(-1),
        fused=fused)
    jpools, jemit, _, _, jfills = out
    emit, _ = tt.paged_decode_tick(
        tm, tspec, tpools, ttables, tfills, torch.from_numpy(toks),
        torch.zeros(4), torch.ones(4), None, torch.from_numpy(live),
        torch.zeros(4, dtype=torch.bool), torch.tensor(-1),
        paged_kernel=mode, prefix_len=MAX_LEN + 1)
    # Lane 3 (fill == max_len) emits a token serving discards. Its walk
    # stops at the table's end in the port; the JAX walk ("lax") reads
    # one clamped extra span there and attends the new row once more,
    # so that one token is compared in "off" and "pallas" only.
    lanes = slice(0, 3) if mode == "lax" else slice(0, 4)
    np.testing.assert_array_equal(emit.numpy()[lanes],
                                  np.asarray(jemit)[lanes])
    np.testing.assert_array_equal(tfills.numpy(), np.asarray(jfills))
    ref_pools = paged_pools_from_jax([np.asarray(p) for p in jpools])
    for (k, v), (rk, rv) in zip(tpools, ref_pools):
        # Null block 0 holds the masked lanes' dead writes: the two
        # packages need not agree on which one lands last.
        np.testing.assert_allclose(k[1:].numpy(), rk[1:].numpy(), **TOL)
        np.testing.assert_allclose(v[1:].numpy(), rv[1:].numpy(), **TOL)


def test_tick_at_boundary_writes_only_the_null_block(pairs):
    """A lane at fill == max_len (the pipelined extra tick of a
    boundary request) has no table entry for its row: the write goes to
    null block 0, never to a clipped id (which would overwrite the
    lane's last real block)."""
    _, _, tm = pairs["gpt_gqa"]
    bs = 8
    spec = tt.paged_cache_spec(tm, bs)
    pools = tt.init_paged_pools(tm, spec, spec.blocks_per_seq + 1)
    for kp, vp in pools:
        kp.normal_()
        vp.normal_()
    tables = torch.arange(1, spec.blocks_per_seq + 1,
                          dtype=torch.int32)[None]
    fills = torch.tensor([MAX_LEN], dtype=torch.int32)
    before = [(k.clone(), v.clone()) for k, v in pools]
    for mode in MODES:
        tt.paged_decode_tick(
            tm, spec, pools, tables, fills, torch.tensor([5]),
            torch.zeros(1), torch.ones(1), None, torch.tensor([True]),
            torch.tensor([False]), torch.tensor(-1), paged_kernel=mode)
        for (k, v), (k0, v0) in zip(pools, before):
            assert torch.equal(k[1:], k0[1:]) and torch.equal(v[1:], v0[1:])
        fills.fill_(MAX_LEN)


# -- the slice as a whole against the JAX package -------------------------

_STREAM_PROMPTS = _prompts(5, seed=4, lo=1, hi=14) + [
    np.random.RandomState(5).randint(0, VOCAB, (MAX_LEN - 5,))]
_STEPS = 6   # the last prompt ends its budget exactly at max_len


@pytest.fixture(scope="module")
def jax_streams(pairs):
    jm, params, _ = pairs["gpt_gqa"]
    return [np.asarray(jt.generate(jm, params, jnp.asarray(p)[None],
                                   steps=_STEPS))[0, len(p):].tolist()
            for p in _STREAM_PROMPTS]


@pytest.mark.parametrize("mode,bs", [("off", 4), ("lax", 4),
                                     ("pallas", 4), ("pallas", 8),
                                     ("pallas", 32)])
def test_paged_engine_token_exact_vs_jax_generate(pairs, jax_streams,
                                                  mode, bs):
    """Mixed-length greedy requests (one at the P + steps - 1 ==
    max_len boundary) through 3 lanes of the paged engine, chunked
    prefill interleaved with ticks == the JAX `generate` of each
    prompt, token for token. At block size 32 the model's
    decode_prefix_block (16) cannot walk the table: "pallas" walks the
    prefill chunks at the block size instead, as the JAX pool does."""
    _, _, tm = pairs["gpt_gqa"]
    with ServingEngine(tm, num_slots=3, max_queue=16, paged=True,
                       kv_block_size=bs, paged_kernel=mode,
                       prefill_chunk_budget=8) as eng:
        assert eng.pool.kernel_mode == mode
        handles = [eng.submit(p, _STEPS) for p in _STREAM_PROMPTS]
        out = [list(map(int, h.result(timeout=120).tokens))
               for h in handles]
    assert out == jax_streams


# -- within the port ---------------------------------------------------------

def test_paged_matches_fixed_pool_greedy_and_seeded(pairs):
    """Paged (pallas mode) vs the fixed slot pool, token-exact, for
    greedy and seeded sampled requests mixed in one burst."""
    _, _, tm = pairs["llama_rope_gqa"]
    prompts = _prompts(6, seed=11, lo=2, hi=20)
    kw = [dict(), dict(temperature=0.8, top_p=0.9, seed=3)] * 3
    outs = []
    for paged in (False, True):
        with ServingEngine(tm, num_slots=2, max_queue=16, paged=paged,
                           kv_block_size=4, paged_kernel="pallas") as e:
            hs = [e.submit(p, 7, **k) for p, k in zip(prompts, kw)]
            outs.append([list(map(int, h.result(timeout=120).tokens))
                         for h in hs])
    assert outs[0] == outs[1]


def test_eos_stop_on_paged_pool_matches_fixed(pairs):
    """An eos token mid-stream stops the lane on the device (it keeps
    emitting eos and routes its rows to the null block) and the engine
    retires it: the paged streams end where the fixed pool's do."""
    _, _, tm = pairs["gpt_gqa"]
    prompts = _prompts(4, seed=15, lo=3, hi=12)
    probe = tt.generate(tm, torch.from_numpy(prompts[0])[None], 10)[0]
    eos = int(probe[len(prompts[0]) + 4])
    outs = []
    for paged in (False, True):
        with ServingEngine(tm, num_slots=2, eos_id=eos, paged=paged,
                           kv_block_size=4, paged_kernel="pallas") as e:
            hs = [e.submit(p, 10) for p in prompts]
            outs.append([(list(map(int, r.tokens)), r.finish_reason)
                         for r in (h.result(timeout=60) for h in hs)])
    assert outs[0] == outs[1]
    assert outs[1][0][1] == "eos" and outs[1][0][0][-1] == eos


def test_prefix_hit_stream_equals_cold(pairs):
    """A second request sharing a block-aligned system prompt is served
    from the prefix cache (prefill tokens skipped > 0) and its stream
    equals the cold run's."""
    _, _, tm = pairs["gpt_gqa"]
    rs = np.random.RandomState(12)
    sys_p = rs.randint(0, VOCAB, (16,))
    tail = rs.randint(0, VOCAB, (5,))
    prompt = np.concatenate([sys_p, tail])
    cold = tt.generate(tm, torch.from_numpy(prompt)[None], 8)[0, 21:]
    with ServingEngine(tm, num_slots=1, paged=True, kv_block_size=4,
                       paged_kernel="lax") as eng:
        first = eng.submit(np.concatenate([sys_p, tail[::-1]]), 8)
        first.result(timeout=60)
        hit = eng.submit(prompt, 8).result(timeout=60)
        snap = eng.metrics_snapshot()
    assert hit.prefix_tokens_cached == 16
    assert snap["prefill_tokens_skipped"] == 16 and snap["prefix_hits"] > 0
    assert list(map(int, hit.tokens)) == cold.tolist()


@pytest.mark.parametrize("mode", ["lax", "pallas"])
def test_fork_cow_streams_independent(pairs, mode):
    """Fork shares the chain; divergent appends split the shared tail
    block (copy-on-write) and each lane's continuation equals an
    unforked run — without the copy the two lanes would overwrite each
    other's KV at the same position."""
    _, _, tm = pairs["gpt_gqa"]
    prompt = _prompts(1, seed=9, lo=6, hi=12)[0]
    pool = PagedSlotPool(tm, 2, block_size=4, kernel=mode)
    adm = pool.admit(prompt, 6)
    pool.prefill(adm.slot, prompt, 0.0, None, 0)
    dst = pool.fork(adm.slot)
    assert dst is not None
    pool.blocks.check_invariants()
    forced = (3, 7)
    pool._toks[adm.slot] = forced[0]
    pool._toks[dst] = forced[1]
    t1 = pool.tick()
    assert pool.blocks.cows >= 1
    pool.blocks.check_invariants()
    t2 = pool.tick()
    P = len(prompt)
    for slot, f in ((adm.slot, forced[0]), (dst, forced[1])):
        ref = tt.generate(tm, torch.from_numpy(
            np.concatenate([prompt, [f]]))[None], 3)[0]
        assert int(t1[slot]) == int(ref[P + 1])
        assert int(t2[slot]) == int(ref[P + 2])


@pytest.mark.parametrize("swap_bytes,mode", [(None, "swap"),
                                             (0, "recompute")])
def test_preempted_stream_equals_uninterrupted(pairs, swap_bytes, mode):
    """preempt=True on the paged pool: a priority-5 arrival evicts the
    running priority-0 stream — its KV blocks shelved and re-grafted
    (swap) or recomputed from its forced prefix — and both streams
    equal uninterrupted runs. Every tick is stretched to >= 20 ms
    (chaos tick stall) so the priority-0 stream is surely still
    decoding when the priority-5 one arrives."""
    from horovod_tpu_torch.resilience import chaos
    _, _, tm = pairs["gpt_gqa"]
    lo = np.random.RandomState(13).randint(0, VOCAB, (10,))
    hi = np.arange(7, 12)
    with chaos.armed("serving_tick_stall:-1:delay=0.02"), \
            ServingEngine(tm, num_slots=1, max_queue=4, paged=True,
                          kv_block_size=4, paged_kernel="pallas",
                          preempt=True, swap_bytes=swap_bytes) as eng:
        h_lo = eng.submit(lo, 40)
        _wait(lambda: len(h_lo.tokens_so_far()) >= 8)
        h_hi = eng.submit(hi, 6, priority=5)
        r_hi, r_lo = h_hi.result(timeout=120), h_lo.result(timeout=120)
        snap = eng.metrics_snapshot()
    assert snap[f"preemptions_{mode}"] >= 1
    if mode == "swap":
        assert snap["preempt_tokens_swapped_in"] > 0
    for p, r, n in ((lo, r_lo, 40), (hi, r_hi, 6)):
        ref = tt.generate(tm, torch.from_numpy(p)[None], n)[0, len(p):]
        assert list(map(int, r.tokens)) == ref.tolist()


def test_transfer_offer_grafts_prefix_and_corruption_is_refused(pairs):
    """A prompt's published blocks exported from one engine's pool (a
    digest-chained host copy) and offered to a fresh engine are grafted
    into its prefix cache: the same prompt there skips those blocks and
    its stream equals the cold one. A transfer corrupted on the way
    (chaos site disagg.block_corrupt) fails verification and leaves the
    destination pool untouched."""
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.serving import (TransferVerifyError,
                                           export_blocks, ingest_blocks)
    _, _, tm = pairs["gpt_gqa"]
    prompt = np.random.RandomState(14).randint(0, VOCAB, (19,))
    cold = tt.generate(tm, torch.from_numpy(prompt)[None], 6)[0, 19:]
    with ServingEngine(tm, num_slots=1, paged=True, kv_block_size=4) as src:
        src.submit(prompt, 6).result(timeout=60)
    tr = export_blocks(src.pool, prompt)   # its dispatch thread is gone
    assert tr is not None and tr.num_blocks == 4
    with ServingEngine(tm, num_slots=1, paged=True, kv_block_size=4) as dst:
        assert dst.offer_transfer(tr)
        r = dst.submit(prompt, 6).result(timeout=60)
    assert r.prefix_tokens_cached == 16
    assert list(map(int, r.tokens)) == cold.tolist()
    fresh = PagedSlotPool(tm, 1, block_size=4)
    with chaos.armed("disagg.block_corrupt:1"):
        with pytest.raises(TransferVerifyError):
            ingest_blocks(fresh, tr)
    assert fresh.blocks.cached_blocks == 0
    fresh.blocks.check_invariants()


def test_cancel_and_expiry_free_blocks(pairs):
    _, _, tm = pairs["gpt_gqa"]
    with ServingEngine(tm, num_slots=1, max_queue=4, paged=True,
                       kv_block_size=4, paged_kernel="lax") as eng:
        h = eng.submit(np.arange(1, 4), 50)
        _wait(lambda: len(h.tokens_so_far()) >= 2)
        assert eng.pool.blocks.used_blocks > 0
        h.cancel()
        with pytest.raises(CancelledError):
            h.result(timeout=60)
        _wait(lambda: eng.pool.blocks.used_blocks == 0)
        late = eng.submit(np.arange(1, 4), 50, timeout_s=0.05)
        with pytest.raises(Exception, match="deadline"):
            late.result(timeout=60)
        _wait(lambda: eng.pool.blocks.used_blocks == 0)
        eng.pool.blocks.check_invariants()
        assert eng.pool.free_slots == 1


def test_oversize_request_shed_at_submit(pairs):
    _, _, tm = pairs["gpt_gqa"]
    with ServingEngine(tm, num_slots=2, paged=True, kv_block_size=4,
                       kv_blocks=5) as eng:      # 4 usable blocks
        with pytest.raises(ValueError, match="KV blocks"):
            eng.submit(np.arange(1, 10), 10)     # needs 5 blocks
        r = eng.submit(np.arange(1, 10), 4).result(timeout=60)
        assert len(r.tokens) == 4


def test_env_knobs_reach_the_pool(pairs, monkeypatch):
    from horovod_tpu_torch.runtime.config import config
    _, _, tm = pairs["gpt_gqa"]
    for k, v in (("HVD_KV_BLOCK_SIZE", "8"), ("HVD_KV_BLOCKS", "9"),
                 ("HVD_PREFIX_CACHE", "0"), ("HVD_PAGED_KERNEL", "off"),
                 ("HVD_SWAP_BYTES", "12345")):
        monkeypatch.setenv(k, v)
    config.refresh()
    try:
        with ServingEngine(tm, num_slots=2, paged=True) as eng:
            pool = eng.pool
            assert (pool.block_size, pool.num_blocks) == (8, 9)
            assert pool.blocks.prefix_cache is False
            assert pool.kernel_mode == "off"
        monkeypatch.setenv("HVD_PREFIX_CACHE", "1")
        config.refresh()
        with ServingEngine(tm, num_slots=2, paged=True,
                           preempt=True) as eng:
            assert eng._overload.swap.stats()["max_bytes"] == 12345
            assert eng.pool.blocks.watermark == 8
    finally:
        monkeypatch.undo()
        config.refresh()


def test_kernel_mode_resolution(pairs):
    _, _, tm = pairs["gpt_gqa"]
    assert _resolve_paged_kernel("auto", tm, 4) == "lax"
    assert _resolve_paged_kernel("pallas", tm, 4) == "pallas"
    assert _resolve_paged_kernel("0", tm, 4) == "off"
    with pytest.raises(ValueError, match="decode_prefix_block"):
        _resolve_paged_kernel("lax", tm, 32)   # 16 % 32 != 0
    assert _resolve_paged_kernel("auto", tm, 32) == "off"
    # "pallas" walks S > 1 chunks at the block size there.
    assert _resolve_paged_kernel("pallas", tm, 32) == "pallas"
    with pytest.raises(ValueError, match="auto|off|lax|pallas"):
        _resolve_paged_kernel("fused", tm, 4)
    with pytest.raises(ValueError, match="divide"):
        PagedSlotPool(tm, 1, block_size=7)
    # Speculative decoding forces the prefix cache off (one chunk
    # schedule drives the target's blocks and the draft's linear cache).
    pool = PagedSlotPool(tm, 1, block_size=4, prefix_cache=True,
                         spec_draft=(tm, None), spec_k=2)
    assert pool.spec_on and not pool.blocks.prefix_cache


# -- BlockPool: the JAX package's cases against the port's copy -----------

def _load_jax_paging_tests():
    """tests/test_paging.py as a private module (not collected again
    from here): its `TestBlockPool` cases call the module-global
    `BlockPool`, which each case below points at the port's copy."""
    spec = importlib.util.spec_from_file_location(
        "_jax_paging_cases", REPO / "tests" / "test_paging.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX_PAGING = _load_jax_paging_tests()
_BLOCK_POOL_CASES = sorted(n for n in vars(_JAX_PAGING.TestBlockPool)
                           if n.startswith("test_"))


@pytest.mark.parametrize("case", _BLOCK_POOL_CASES)
def test_block_pool_cases_on_port_copy(case, monkeypatch):
    monkeypatch.setattr(_JAX_PAGING, "BlockPool", BlockPool)
    getattr(_JAX_PAGING.TestBlockPool(), case)()
