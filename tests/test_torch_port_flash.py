"""PyTorch port: the flash kernels' plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU, as the JAX tests
run them), and the wrappers' dispatch rule. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_port_gpu.py.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: float32 on both sides, same algorithm (f32 scores, online
or materialized softmax), so differences are summation order only —
1e-5 absolute on the outputs and the logsumexp.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

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


def _qkv(seed, B, Sq, Sk, H, Hkv, D):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, H, D).astype(np.float32)
    k = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    v = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    return q, k, v


FWD_CASES = {
    "causal": dict(Sq=24, Sk=24, H=2, Hkv=2, causal=True),
    "noncausal": dict(Sq=24, Sk=24, H=2, Hkv=2, causal=False),
    "window": dict(Sq=32, Sk=32, H=2, Hkv=2, causal=True, window=5),
    "offsets": dict(Sq=16, Sk=24, H=2, Hkv=2, causal=True, q_offset=16,
                    k_offset=4),
    "gqa": dict(Sq=24, Sk=24, H=4, Hkv=2, causal=True),
    "ragged_sk": dict(Sq=16, Sk=19, H=2, Hkv=1, causal=False),
    "fully_masked_rows": dict(Sq=16, Sk=16, H=2, Hkv=2, causal=True,
                              q_offset=0, k_offset=6),
    "gqa_window_offset": dict(Sq=24, Sk=40, H=4, Hkv=1, causal=True,
                              window=7, q_offset=16, k_offset=0),
}


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_plain_flash_forward_matches_pallas(name):
    c = dict(FWD_CASES[name])
    Sq, Sk, H, Hkv = c.pop("Sq"), c.pop("Sk"), c.pop("H"), c.pop("Hkv")
    q, k, v = _qkv(sorted(FWD_CASES).index(name), 2, Sq, Sk, H, Hkv, 8)
    j_out, j_lse = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
        block_k=8, interpret=True, **c)
    t_out, t_lse = tfa.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **c)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=TOL, rtol=0)
    j_lse = np.asarray(j_lse)
    np.testing.assert_array_equal(np.isneginf(t_lse.numpy()),
                                  np.isneginf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(t_lse.numpy()[fin], j_lse[fin], atol=TOL,
                               rtol=0)
    if name == "fully_masked_rows":
        assert np.isneginf(j_lse).any()
        assert not t_out.numpy()[:, :6].any()


def test_flash_attention_matches_blockwise_oracle():
    """flash_attention (plain) == the port's blockwise oracle."""
    from horovod_tpu_torch.parallel.sequence import blockwise_attention
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 2, 40, 40, 2, 2, 8))
    out = tfa.flash_attention(q, k, v, causal=True, window=9)
    ref = blockwise_attention(q, k, v, causal=True, window=9,
                              block_size=16)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("hkv", [4, 2])
def test_plain_flash_decode_matches_pallas(hkv):
    """Per-lane lengths including 1 and W; the JAX kernel takes one
    scalar length, so each lane is its own B=1 call there."""
    B, W, H, D = 4, 32, 4, 8
    rs = np.random.RandomState(11 + hkv)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    kc = rs.randn(B, W, hkv, D).astype(np.float32)
    vc = rs.randn(B, W, hkv, D).astype(np.float32)
    lengths = np.array([1, 7, 16, W], np.int32)
    out = tfa.flash_decode_attention(torch.from_numpy(q),
                                     torch.from_numpy(kc),
                                     torch.from_numpy(vc),
                                     torch.from_numpy(lengths))
    for b in range(B):
        ref = jfa.flash_decode_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
            jnp.asarray(vc[b:b + 1]), jnp.int32(lengths[b]), block_k=8,
            interpret=True)
        np.testing.assert_allclose(out.numpy()[b:b + 1], np.asarray(ref),
                                   atol=TOL, rtol=0)


def test_flash_decode_zero_length_is_zero():
    q, kc, vc = (torch.from_numpy(a) for a in _qkv(3, 2, 1, 16, 4, 2, 8))
    out = tfa.flash_decode_attention(q, kc, vc,
                                     torch.tensor([0, 5], dtype=torch.int32))
    assert not out[0].any() and out[1].abs().sum() > 0


def _load_chip_smoke():
    """chip_smoke.py as a private module (it imports only the standard
    library at the top, so it loads without a card)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke",
        pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bf16_rounded_p_breaks_fwd_tol_and_hi_lo_holds():
    """Why the bf16 forward feeds p to p v as bf16 hi + lo: at [1, 1024,
    8, 128] bf16, causal with window 4 (every row attends at most four
    keys, so one p carries much of a row), the plain forward walked in
    64-key tiles with p rounded to one bf16 (chip_smoke's planted
    fault) breaks chip_smoke's unchanged TOL["bfloat16"] against the f32
    plain forward, and the hi + lo split holds it; lse, formed from the
    unrounded p, holds LSE_TOL in both."""
    cs = _load_chip_smoke()
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 1024, 8, 128).astype(
        np.float32)).bfloat16() for _ in range(3))
    kw = dict(causal=True, window=4)
    ref, rlse = tfa.flash_attention_plain(q, k, v, **kw)
    one, one_lse = cs.rounded_forward(tfa, split=False)(q, k, v, **kw)
    two, two_lse = cs.rounded_forward(tfa, split=True)(q, k, v, **kw)
    tol = cs.TOL["bfloat16"]
    err = (one.float() - ref.float()).abs()
    assert int((err > tol[0] + tol[1] * ref.float().abs()).sum()) > 10
    assert not cs.max_err(one, ref, tol)[1]
    assert cs.max_err(two, ref, tol)[1]
    for lse in (one_lse, two_lse):
        assert cs.max_err(lse, rlse, (cs.LSE_TOL, 0.0))[1]


def test_rounded_forward_unrounded_walk_is_the_plain_forward():
    """The tile walk itself (online softmax over 64-key tiles) adds no
    error: in f32 with a window that crosses tiles, the hi + lo walk
    equals the plain forward to f32 summation order."""
    cs = _load_chip_smoke()
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 2, 150, 200, 4, 2, 16))
    kw = dict(causal=True, window=70, q_offset=50)
    out, lse = cs.rounded_forward(tfa, split=True)(q, k, v, **kw)
    ref, rlse = tfa.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(rlse.numpy()))
    fin = np.isfinite(rlse.numpy())
    np.testing.assert_allclose(lse.numpy()[fin], rlse.numpy()[fin],
                               atol=TOL, rtol=0)


DECODE_W = 48
# 1, a boundary of 8 splits (chunk 6), a boundary of 3 splits (chunk 16),
# one past the next one (32), and W.
DECODE_LENGTHS = (1, 12, 16, 33, DECODE_W)


def _decode_inputs(hkv):
    rs = np.random.RandomState(20 + hkv)
    L, H, D = len(DECODE_LENGTHS), 8, 8
    q = rs.randn(L, 1, H, D).astype(np.float32)
    kc = rs.randn(L, DECODE_W, hkv, D).astype(np.float32)
    vc = rs.randn(L, DECODE_W, hkv, D).astype(np.float32)
    return q, kc, vc


@functools.lru_cache(maxsize=None)
def _jax_decode(hkv):
    """The JAX Pallas decode (interpret mode) per lane: it takes one
    scalar length, so each lane is its own B=1 call."""
    q, kc, vc = _decode_inputs(hkv)
    return np.concatenate([np.asarray(jfa.flash_decode_attention(
        jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
        jnp.asarray(vc[b:b + 1]), jnp.int32(n), block_k=8,
        interpret=True)) for b, n in enumerate(DECODE_LENGTHS)])


@pytest.mark.parametrize("hkv", [8, 2])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_decode_plain_matches_plain_and_pallas(splits, hkv):
    """The decode kernel's split-and-merge arithmetic against the plain
    decode and the JAX Pallas decode, over lengths 1, split boundaries
    and W; GQA 1 (Hkv 8) and 4 (Hkv 2)."""
    q, kc, vc = (torch.from_numpy(a) for a in _decode_inputs(hkv))
    length = torch.tensor(DECODE_LENGTHS, dtype=torch.int32)
    out = tfa.flash_decode_split_plain(q, kc, vc, length, splits)
    np.testing.assert_allclose(
        out.numpy(), tfa.flash_decode_plain(q, kc, vc, length).numpy(),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_decode(hkv), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_decode_plain_zero_length_lane(splits):
    """A lane of length 0 has every partial empty: the merge gives the
    zero row, as the plain decode does (the JAX kernel leaves length 0
    undefined)."""
    q, kc, vc = (torch.from_numpy(a) for a in _decode_inputs(2))
    length = torch.tensor([0, 5, 0, 48, 7], dtype=torch.int32)
    out = tfa.flash_decode_split_plain(q, kc, vc, length, splits)
    assert not out[0].any() and not out[2].any()
    np.testing.assert_allclose(
        out.numpy(), tfa.flash_decode_plain(q, kc, vc, length).numpy(),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("W,pairs,n_sm,want", [
    (2048, 64, 132, 4),    # the path: 8 lanes x 8 kv heads, 256 blocks
    (2048, 16, 132, 8),    # GQA 4: capped by 256 keys a split
    (1000, 64, 132, 3),    # W not a multiple of the split
    (255, 64, 132, 1),     # W < 256: one split
    (100, 1, 132, 1),
    (2048, 8, 132, 8),     # one lane
    (4096, 1, 132, 16),    # one lane, one kv head
    (2048, 264, 132, 4),   # the card full: splits of 512 keys
    (2048, 64, 66, 4),
])
def test_decode_splits(W, pairs, n_sm, want):
    n = tfa.decode_splits(W, pairs, n_sm)
    assert n == want
    assert n >= 1 and -(-W // n) >= min(W, tfa.DECODE_MIN_SPLIT_KEYS)
    # Full lanes never run a second, partial wave of split blocks unless
    # the 512-key cap asks for it.
    slots = tfa.DECODE_BLOCKS_PER_SM * n_sm
    assert n * pairs <= slots or n == max(1, W // tfa.DECODE_MAX_SPLIT_KEYS)


class TestWrapperDispatch:
    def test_cpu_tensors_take_plain_version(self):
        tfa.flash_fwd_cuda.launches = 0
        tfa.flash_decode_cuda.launches = 0
        q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 8, 8, 2, 2, 8))
        out = tfa.flash_attention(q, k, v, causal=True)
        ref, _ = tfa.flash_attention_plain(q, k, v, causal=True)
        assert torch.equal(out, ref)
        dec = tfa.flash_decode_attention(q[:, :1], k, v,
                                         torch.tensor([8], dtype=torch.int32))
        assert torch.equal(dec, tfa.flash_decode_plain(
            q[:, :1], k, v, torch.tensor([8], dtype=torch.int32)))
        assert tfa.flash_fwd_cuda.launches == 0
        assert tfa.flash_decode_cuda.launches == 0

    def test_non_cpu_tensor_never_falls_back(self):
        """A tensor that is not on the CPU goes to the kernel wrapper,
        which refuses anything but CUDA — no silent plain fallback."""
        q = torch.empty(1, 8, 2, 64, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfa.flash_attention(q, q, q, causal=True)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfa.flash_decode_attention(q[:, :1], q, q,
                                       torch.ones(1, dtype=torch.int32))

    def test_window_requires_causal(self):
        q = torch.zeros(1, 4, 1, 8)
        with pytest.raises(ValueError, match="causal"):
            tfa.flash_attention(q, q, q, window=2)

    def test_cuda_entry_point_without_card_raises(self):
        from horovod_tpu_torch.models.transformer import resolve_device
        if torch.cuda.is_available():
            pytest.skip("a card is present; the no-card path is moot")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)



# -- coverage: head_dim 256 and groups 1-8 (the HF families' geometries) ---

from horovod_tpu.ops import paged_attention as jpa  # noqa: E402
from horovod_tpu_torch.ops import paged_attention as tpa  # noqa: E402

# (H, Hkv, D): Gemma-1's head_dim 256 under MQA (groups 2 and 8), and the
# Qwen2 groups of 6 (12:2) and 7 (14:2, and 7:1).
COVERAGE = [(2, 1, 256), (8, 1, 256), (12, 2, 8), (14, 2, 8), (7, 1, 8)]
COVERAGE_IDS = [f"H{h}-Hkv{k}-D{d}" for h, k, d in COVERAGE]


@pytest.mark.parametrize("H,Hkv,D", COVERAGE, ids=COVERAGE_IDS)
def test_coverage_forward_plain_matches_pallas(H, Hkv, D):
    """The forward's plain version at the new geometries against the JAX
    Pallas forward (interpret mode), causal and banded."""
    q, k, v = _qkv(40 + D + H, 2, 24, 24, H, Hkv, D)
    for kw in (dict(causal=True), dict(causal=True, window=5)):
        j_out, j_lse = jfa.flash_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
            block_k=8, interpret=True, **kw)
        t_out, t_lse = tfa.flash_attention_lse(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            **kw)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("H,Hkv,D", COVERAGE, ids=COVERAGE_IDS)
def test_coverage_decode_plain_matches_pallas(H, Hkv, D):
    """The decode kernel's plain version and its split arithmetic at the
    new geometries against the JAX Pallas decode (interpret mode), per
    lane (it takes one scalar length)."""
    W = 32
    lengths = [1, 9, 16, W]
    rs = np.random.RandomState(60 + D + H)
    q = rs.randn(len(lengths), 1, H, D).astype(np.float32)
    kc = rs.randn(len(lengths), W, Hkv, D).astype(np.float32)
    vc = rs.randn(len(lengths), W, Hkv, D).astype(np.float32)
    ref = np.concatenate([np.asarray(jfa.flash_decode_attention(
        jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
        jnp.asarray(vc[b:b + 1]), jnp.int32(n), block_k=8,
        interpret=True)) for b, n in enumerate(lengths)])
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(tfa.flash_decode_plain(*args).numpy(), ref,
                               atol=TOL, rtol=0)
    for splits in (1, 3):
        np.testing.assert_allclose(
            tfa.flash_decode_split_plain(*args, splits).numpy(), ref,
            atol=TOL, rtol=0)


@pytest.mark.parametrize("H,Hkv,D", COVERAGE, ids=COVERAGE_IDS)
def test_coverage_paged_decode_plain_matches_pallas(H, Hkv, D):
    """The paged-decode kernel's plain version and its split arithmetic
    at the new geometries against the JAX Pallas paged-decode kernel
    (interpret mode, vmapped over the lanes), fills 0, on a block
    boundary, mid-table and at the table's end."""
    bs, T = 4, 8
    fills = np.array([0, bs, 13, T * bs - 1, T * bs], np.int32)
    rs = np.random.RandomState(80 + D + H)
    L = len(fills)
    nb = L * T + 1
    kp = rs.randn(nb, bs, Hkv, D).astype(np.float32)
    vp = rs.randn(nb, bs, Hkv, D).astype(np.float32)
    tables = np.stack([rs.permutation(np.arange(1, nb))[:T]
                       for _ in range(L)]).astype(np.int32)
    q = rs.randn(L, H, D).astype(np.float32)
    kn = rs.randn(L, Hkv, D).astype(np.float32)
    vn = rs.randn(L, Hkv, D).astype(np.float32)
    jkp, jvp = jnp.asarray(kp)[:, None], jnp.asarray(vp)[:, None]
    ref = np.stack([np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q[i])[None, None], jnp.asarray(kn[i])[None, None],
        jnp.asarray(vn[i])[None, None], jkp, jvp, jnp.asarray(tables[i]),
        jnp.int32(fills[i]), interpret=True))[0, 0] for i in range(L)])
    args = [torch.from_numpy(a) for a in (q, kn, vn, tables, fills, kp, vp)]
    np.testing.assert_allclose(tpa.paged_decode_plain(*args).numpy(), ref,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        tpa.paged_decode_split_plain(*args, 3).numpy(), ref, atol=TOL,
        rtol=0)


def test_kernel_wrappers_name_their_limits():
    """Outside the instantiations the wrappers raise naming the limit,
    before any launch: the backward at a head dim it lacks (96, a
    non-CPU tensor) names the ones it takes, 64 / 128 / 256; a head_dim
    the other kernels lack, or a decode group above 8, names what they
    take (the checks the CUDA wrappers run after the device check)."""
    meta = dict(device="meta")
    q = torch.empty(1, 8, 2, 96, **meta)
    lse = torch.empty(1, 2, 8, **meta)
    for call in (lambda: tfa.flash_backward(q, q, q, q, lse, q),
                 lambda: tfa.flash_bwd_dq_cuda(q, q, q, q, lse, lse),
                 lambda: tfa.flash_bwd_dkv_cuda(q, q, q, q, lse, lse)):
        with pytest.raises(ValueError, match="64 / 128 / 256, got 96"):
            call()
    assert tfa.BWD_HEAD_DIMS == (64, 128, 256)
    q256 = torch.empty(1, 8, 2, 256, **meta)
    with pytest.raises(ValueError) as e:     # past the head-dim check
        tfa.flash_bwd_dq_cuda(q256, q256, q256, q256, lse, lse)
    assert "head_dim" not in str(e.value)
    for D in tfa.KERNEL_HEAD_DIMS:
        tfa._check_head_dim(D)
    with pytest.raises(ValueError, match="64 / 128 / 256, got 96"):
        tfa._check_head_dim(96)
    for grp in range(1, tfa.DECODE_MAX_GROUP + 1):
        tfa._check_decode_group("flash-decode", 2 * grp, 2)
    with pytest.raises(ValueError, match="1 to 8 query heads per kv head, "
                                         "got 9"):
        tfa._check_decode_group("paged-decode", 9, 1)


# -- the backward at head_dim 256 (Gemma-1's heads, one kv head) -----------

BWD256 = {"causal": dict(causal=True), "window": dict(causal=True, window=24),
          "dlse": dict(causal=True)}


@pytest.mark.parametrize("name", sorted(BWD256))
def test_backward_head_dim_256_matches_jax_pallas(name):
    """dQ, dK and dV of the port's flash attention (`flash_backward`'s
    plain version on the CPU) against ``jax.grad`` through the JAX
    package's Pallas backward in interpret mode, at [1, 128, 2, 256]
    over one kv head; "dlse" adds a cotangent on the logsumexp. f32 on
    both sides: 1e-5."""
    import jax
    kw = BWD256[name]
    q, k, v = _qkv(256, 1, 128, 128, 2, 1, 256)
    rs = np.random.RandomState(257)
    w = rs.randn(*q.shape).astype(np.float32)
    wl = rs.randn(1, 2, 128).astype(np.float32) * (name == "dlse")

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, block_q=64, block_k=64,
                                         interpret=True, **kw)
        return (o * w).sum() + (lse * wl).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*ts, **kw)
    ((o * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(wl)).sum()).backward()
    for t, r in zip(ts, ref):
        assert t.grad.shape == r.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=TOL, rtol=TOL)
