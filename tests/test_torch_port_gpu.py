"""PyTorch port on the card: each CUDA kernel against its plain
PyTorch version, a small model's greedy stream through the kernels
against the same model on the plain versions, and a small model's
train-step gradients through the forward and backward kernels against
autograd through the dot attention.

Every test here carries the ``gpu`` marker and skips without a card
(the decision is made inside each test, never at import). This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch; there, without the JAX test harness:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: f32 kernels differ from their plain versions by summation
order only (2e-5 at these sizes; gradients, which sum over up to 200
keys or queries x 4 heads, 1e-4); bf16 outputs are rounded from f32 on
both sides, so one bf16 rounding flip is allowed: 2e-3 absolute plus
1e-2 relative, as in chip_smoke.py.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import paged_attention as tpa

FWD_CASES = [
    dict(Sq=24, Sk=24, H=2, Hkv=2, causal=True),
    dict(Sq=24, Sk=24, H=2, Hkv=2, causal=False),
    dict(Sq=130, Sk=130, H=2, Hkv=2, causal=True, window=5),
    dict(Sq=16, Sk=24, H=2, Hkv=2, causal=True, q_offset=16, k_offset=4),
    dict(Sq=70, Sk=70, H=4, Hkv=2, causal=True),
    dict(Sq=16, Sk=199, H=2, Hkv=1, causal=False),
    dict(Sq=16, Sk=16, H=2, Hkv=2, causal=True, q_offset=0, k_offset=6),
    dict(Sq=96, Sk=200, H=4, Hkv=1, causal=True, window=70, q_offset=104),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_forward_matches_plain(dtype, D):
    dev = _card()
    dt = getattr(torch, dtype)
    atol, rtol = (2e-5, 0.0) if dt == torch.float32 else (2e-3, 1e-2)
    for i, c in enumerate(FWD_CASES):
        c = dict(c)
        Sq, Sk, H, Hkv = c.pop("Sq"), c.pop("Sk"), c.pop("H"), c.pop("Hkv")
        q = _randn(i, 2, Sq, H, D).to(dev, dt)
        k = _randn(i + 100, 2, Sk, Hkv, D).to(dev, dt)
        v = _randn(i + 200, 2, Sk, Hkv, D).to(dev, dt)
        out, lse = tfa.flash_fwd_cuda(q, k, v, **c)
        ref, rlse = tfa.flash_attention_plain(q, k, v, **c)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_cuda_flash_forward_reads_strided_views():
    """q/k/v as column slices of one fused projection (the model's
    layout) — no contiguous copies needed."""
    dev = _card()
    qkv = _randn(5, 2, 40, 3 * 4 * 64).to(dev)
    q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(256, dim=-1))
    out, _ = tfa.flash_fwd_cuda(q, k, v, causal=True)
    ref, _ = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


def _bf16_close(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-3,
                               rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_bf16_forward_window4_and_fused_views(D):
    """The bf16 (wgmma) forward: causal with window 4 (rows attend at
    most four keys, where one bf16 rounding of p would fail), and q/k/v
    as column slices of one fused [B, S, 3 H D] projection."""
    dev = _card()
    bf = torch.bfloat16
    q, k, v = (_randn(60 + i, 1, 300, 4, D).to(dev, bf) for i in range(3))
    out, lse = tfa.flash_fwd_cuda(q, k, v, causal=True, window=4)
    ref, rlse = tfa.flash_attention_plain(q, k, v, causal=True, window=4)
    _bf16_close(out, ref)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)
    qkv = _randn(64, 2, 200, 3 * 4 * D).to(dev, bf)
    q, k, v = (t.unflatten(-1, (4, D)) for t in qkv.split(4 * D, dim=-1))
    out, lse = tfa.flash_fwd_cuda(q, k, v, causal=True)
    ref, rlse = tfa.flash_attention_plain(q, k, v, causal=True)
    _bf16_close(out, ref)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_bf16_forward_takes_what_the_rules_allow():
    """The wgmma forward's tensor maps take every layout the wrapper's
    rules admit (a contiguous, 16-byte aligned head_dim row): padded
    rows, a seq axis that is not the outer one, one head, Sq = 1 and
    Sq < 64; a misaligned row is refused by the wrapper, as before."""
    dev = _card()
    bf = torch.bfloat16
    pad = _randn(70, 2, 90, 2, 136).to(dev, bf)[..., :128]   # padded rows
    hsd = _randn(71, 2, 2, 90, 128).to(dev, bf).transpose(1, 2)
    one = _randn(72, 1, 90, 1, 128).to(dev, bf)
    cases = [(pad, hsd, hsd, dict(causal=True)),
             (one, one, one, dict(causal=True, window=30)),
             (pad[:, :1], hsd, hsd, dict(causal=True, q_offset=89)),
             (pad[:, :40], hsd, hsd, dict(causal=True, q_offset=50))]
    for q, k, v, kw in cases:
        out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
        ref, rlse = tfa.flash_attention_plain(q, k, v, **kw)
        _bf16_close(out, ref)
        torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)
    odd = _randn(73, 1, 8, 2, 129).to(dev, bf)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd_cuda(odd, odd, odd, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_decode_matches_plain(dtype):
    """Decode split over the cache (splits > 1): lengths 0, 1, on and one
    past the split boundaries, and W, GQA 1, 4 and 8, at the rule's split
    count and at forced ones; each call counts one launch (the split
    kernel and its merge)."""
    dev = _card()
    dt = getattr(torch, dtype)
    W, L = 1024, 6
    for hkv in (8, 2, 1):
        splits = tfa.decode_splits(W, hkv * L, tfa._sm_count(dev))
        assert splits > 1
        c = -(-W // splits)
        length = torch.tensor([0, 1, c, c + 1, W - 1, W], dtype=torch.int32,
                              device=dev)
        q = _randn(80 + hkv, L, 1, 8, 128).to(dev, dt)
        kc = _randn(90 + hkv, L, W, hkv, 128).to(dev, dt)
        vc = _randn(100 + hkv, L, W, hkv, 128).to(dev, dt)
        before = tfa.flash_decode_cuda.launches
        out = tfa.flash_decode_cuda(q, kc, vc, length)
        assert tfa.flash_decode_cuda.launches == before + 1
        ref = tfa.flash_decode_plain(q, kc, vc, length)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
        else:
            _bf16_close(out, ref)
        assert not out[0].any()
        split_ref = tfa.flash_decode_split_plain(q, kc, vc, length, splits)
        torch.testing.assert_close(split_ref.float(), ref.float(),
                                   atol=2e-5 if dt == torch.float32
                                   else 2e-3, rtol=0 if dt == torch.float32
                                   else 1e-2)
        # A forced split count (one range; more ranges than the rule's).
        for ns in (1, 2 * splits):
            forced = tfa.flash_decode_cuda(q, kc, vc, length, splits=ns)
            if dt == torch.float32:
                torch.testing.assert_close(forced, ref, atol=2e-5, rtol=0)
            else:
                _bf16_close(forced, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_matches_plain(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    atol, rtol = (2e-5, 0.0) if dt == torch.float32 else (2e-3, 1e-2)
    for hkv in (4, 2, 1):
        q = _randn(1, 4, 1, 4, 128).to(dev, dt)
        kc = _randn(2, 4, 96, hkv, 128).to(dev, dt)
        vc = _randn(3, 4, 96, hkv, 128).to(dev, dt)
        length = torch.tensor([0, 1, 50, 96], dtype=torch.int32, device=dev)
        out = tfa.flash_decode_cuda(q, kc, vc, length)
        ref = tfa.flash_decode_plain(q, kc, vc, length)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.gpu
def test_cuda_wrappers_count_and_refuse():
    dev = _card()
    q = _randn(0, 1, 8, 2, 32).to(dev)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q, causal=True)
    before = tfa.flash_fwd_cuda.launches
    q = _randn(0, 1, 8, 2, 64).to(dev)
    tfa.flash_attention(q, q, q, causal=True)
    assert tfa.flash_fwd_cuda.launches == before + 1


@pytest.mark.gpu
def test_small_model_greedy_through_kernels():
    """f32 toy model: generate through both kernels == generate with
    the model on the plain versions (token-exact)."""
    dev = _card()
    from horovod_tpu_torch.models.transformer import TransformerLM, generate
    kw = dict(max_len=64, dtype=torch.float32, num_kv_heads=2,
              decode_prefix_block=16, device=dev)
    fast = TransformerLM(128, 2, 4, 64, attn_impl="flash",
                         decode_prefix_impl="pallas", **kw).init_weights(3)
    slow = TransformerLM(128, 2, 4, 64, attn_impl="blockwise",
                         decode_prefix_impl="lax", **kw)
    slow.load_state_dict(fast.state_dict())
    prompt = torch.from_numpy(
        np.random.RandomState(4).randint(0, 128, (3, 9))).to(dev)
    f0, d0 = tfa.flash_fwd_cuda.launches, tfa.flash_decode_cuda.launches
    out = generate(fast, prompt, 20)
    assert tfa.flash_fwd_cuda.launches - f0 == 2
    assert tfa.flash_decode_cuda.launches - d0 == 19 * 2
    assert torch.equal(out, generate(slow, prompt, 20))


def _paged_case(seed, dev, dt, *, L, bs, T, hkv, fills):
    rs = np.random.RandomState(seed)
    nb = L * T + 1
    kp = _randn(seed + 1, nb, bs, hkv, 128).to(dev, dt)
    vp = _randn(seed + 2, nb, bs, hkv, 128).to(dev, dt)
    tables = torch.from_numpy(np.stack(
        [rs.permutation(np.arange(1, nb))[:T] for _ in range(L)]
    ).astype(np.int32)).to(dev)
    q = _randn(seed + 3, L, 8, 128).to(dev, dt)
    kn = _randn(seed + 4, L, hkv, 128).to(dev, dt)
    vn = _randn(seed + 5, L, hkv, 128).to(dev, dt)
    fill = torch.tensor(fills, dtype=torch.int32, device=dev)
    return q, kn, vn, tables, fill, kp, vp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_decode_matches_plain(dtype):
    """The paged-decode kernel against its plain version at the edge
    cases: fill 0 (only the new row), fill at a block boundary (the new
    row opens a fresh block), the last row, fill == max_len (the whole
    table, no merged row), and a free lane on the all-null table."""
    dev = _card()
    dt = getattr(torch, dtype)
    atol, rtol = (2e-5, 0.0) if dt == torch.float32 else (2e-3, 1e-2)
    for bs, hkv in ((16, 8), (16, 2), (4, 1)):
        T = 64 // bs
        fills = [0, 3, bs, 2 * bs - 1, 63, 64, 37, 0]
        args = _paged_case(bs + hkv, dev, dt, L=len(fills), bs=bs, T=T,
                           hkv=hkv, fills=fills)
        args[3][-1] = 0                          # free lane: null table
        out = tpa.paged_decode_cuda(*args)
        ref = tpa.paged_decode_plain(*args)
        assert torch.isfinite(out.float()).all()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.gpu
def test_cuda_paged_decode_reads_strided_views_and_counts():
    """q / k_new / v_new as slices of one fused projection (the model's
    layout); the wrapper counts launches, the dispatcher launches the
    kernel for CUDA tensors."""
    dev = _card()
    q, kn, vn, tables, fill, kp, vp = _paged_case(
        9, dev, torch.float32, L=4, bs=16, T=8, hkv=2,
        fills=[5, 16, 100, 127])
    fused = torch.cat([q.flatten(1), kn.flatten(1), vn.flatten(1)], 1)
    qs, ks, vs = fused.split([8 * 128, 2 * 128, 2 * 128], dim=1)
    qs, ks, vs = (t.unflatten(1, (-1, 128)) for t in (qs, ks, vs))
    before = tpa.paged_decode_cuda.launches
    out = tpa.paged_decode_attention(qs, ks, vs, tables, fill, kp, vp)
    assert tpa.paged_decode_cuda.launches == before + 1
    ref = tpa.paged_decode_plain(q, kn, vn, tables, fill, kp, vp)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_decode_split_boundaries(dtype):
    """The split paged-decode kernels at 8 lanes over T = 128 entries of
    16 (the timed tick's geometry), Hkv 8, 2 and 1 (GQA 1, 4, 8): fills
    0, on and one before each boundary of the path's split count, the
    last row, fill == T * bs and a free lane on the all-null table;
    against `paged_decode_plain` and `paged_decode_split_plain`, at the
    path's NS and with NS forced to 1. Each call counts one launch and
    reports its split count; a split count the kernel cannot stage is
    refused."""
    dev = _card()
    dt = getattr(torch, dtype)
    L, bs, T = 8, 16, 128
    for hkv in (8, 2, 1):
        ns_path = tpa.paged_decode_splits(T, bs, hkv * L, tfa._sm_count(dev))
        assert ns_path >= 2
        c = -(-T // ns_path) * bs
        edges = [f for k in range(1, ns_path) for f in (k * c - 1, k * c)]
        fills = ([0] + edges[:4] + [T * bs - 1, T * bs, 0])[:L]
        args = _paged_case(200 + hkv, dev, dt, L=L, bs=bs, T=T, hkv=hkv,
                           fills=fills)
        args[3][-1] = 0                          # free lane: null table
        ref = tpa.paged_decode_plain(*args)
        for ns in (ns_path, 1):
            before = tpa.paged_decode_cuda.launches
            out = tpa.paged_decode_cuda(*args, splits=ns)
            assert tpa.paged_decode_cuda.launches == before + 1
            assert tpa.paged_decode_cuda.splits_last == ns
            split_ref = tpa.paged_decode_split_plain(*args, ns)
            assert torch.isfinite(out.float()).all()
            for want in (ref, split_ref):
                if dt == torch.float32:
                    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
                else:
                    _bf16_close(out, want)
        tpa.paged_decode_cuda(*args)
        assert tpa.paged_decode_cuda.splits_last == ns_path
    with pytest.raises(ValueError, match="splits"):
        tpa.paged_decode_cuda(*args, splits=0)


@pytest.mark.gpu
def test_small_paged_engine_through_kernel():
    """f32 toy model: the paged engine on the kernel ("pallas") ==
    the paged engine on the walk ("lax"), token-exact, and the kernel
    ran on every tick of every layer."""
    dev = _card()
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serving import ServingEngine
    m = TransformerLM(128, 2, 4, 64, max_len=64, dtype=torch.float32,
                      num_kv_heads=2, decode_prefix_block=16,
                      device=dev).init_weights(3)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 128, (int(n),)) for n in (9, 20, 3, 33)]
    outs = {}
    for mode in ("lax", "pallas"):
        with ServingEngine(m, num_slots=2, paged=True, kv_block_size=16,
                           paged_kernel=mode) as eng:
            before = tpa.paged_decode_cuda.launches
            outs[mode] = [eng.submit(p, 12).result(timeout=120)
                          .tokens.tolist() for p in prompts]
            launches = tpa.paged_decode_cuda.launches - before
            ticks = eng.metrics_snapshot()["ticks"]
        if mode == "pallas":
            assert launches >= ticks * 2
    assert outs["lax"] == outs["pallas"]


# The backward kernels' cases: the forward's, plus a fully masked
# block of rows (keys all in the future), Sq != Sk with GQA 4/1, and a
# causal GQA band of 16 tiles (the bf16 kernels' 2-stage TMA ring wraps
# many times, with masked diagonal tiles and unmasked interior ones).
BWD_CASES = FWD_CASES + [
    dict(Sq=80, Sk=16, H=2, Hkv=2, causal=True, q_offset=0, k_offset=40),
    dict(Sq=130, Sk=70, H=4, Hkv=1, causal=False),
    dict(Sq=1024, Sk=1024, H=4, Hkv=2, causal=True),
]


def _bwd_inputs(i, dev, dt, D, c):
    c = dict(c)
    Sq, Sk, H, Hkv = c.pop("Sq"), c.pop("Sk"), c.pop("H"), c.pop("Hkv")
    q = _randn(i, 2, Sq, H, D).to(dev, dt)
    k = _randn(i + 100, 2, Sk, Hkv, D).to(dev, dt)
    v = _randn(i + 200, 2, Sk, Hkv, D).to(dev, dt)
    g = _randn(i + 300, 2, Sq, H, D).to(dev, dt)
    return q, k, v, g, c


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_matches_plain(dtype, D):
    """dQ and dK/dV kernels against `flash_backward_plain` on the
    forward kernel's saved (out, lse), with and without a cotangent on
    lse."""
    dev = _card()
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dt == torch.float32 else (2e-3, 1e-2)
    for i, c in enumerate(BWD_CASES):
        q, k, v, g, kw = _bwd_inputs(i, dev, dt, D, c)
        out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
        for dlse in (None, _randn(i + 400, *lse.shape).to(dev)):
            got = tfa.flash_backward(q, k, v, out, lse, g, dlse=dlse, **kw)
            ref = tfa.flash_backward_plain(q, k, v, out, lse, g, dlse=dlse,
                                           **kw)
            for a, b in zip(got, ref):
                assert a.shape == b.shape and a.dtype == b.dtype
                torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                           rtol=rtol)


@pytest.mark.gpu
def test_cuda_flash_backward_reads_strided_cotangent():
    """dO as a column slice of a wider tensor (strided rows, contiguous
    head_dim) goes to the kernels as it is; dO with a non-contiguous
    head_dim is refused by the kernel wrappers and copied by the
    dispatcher."""
    dev = _card()
    q, k, v, g, kw = _bwd_inputs(3, dev, torch.float32, 64, FWD_CASES[4])
    out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
    ref = tfa.flash_backward_plain(q, k, v, out, lse, g, **kw)
    wide = torch.cat([g, torch.zeros_like(g)], -1)[..., :64]
    assert not wide.is_contiguous()
    dvec = (g * out).sum(-1).transpose(1, 2).contiguous()
    torch.testing.assert_close(
        tfa.flash_bwd_dq_cuda(q, k, v, wide, lse, dvec, **kw), ref[0],
        atol=1e-4, rtol=1e-4)
    gt = g.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_bwd_dkv_cuda(q, k, v, gt, lse, dvec, **kw)
    for a, b in zip(tfa.flash_backward(q, k, v, out, lse, gt, **kw), ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # q/k/v as strided views of one fused [B, S, 3 H D] projection (the
    # model's layout), bf16: the tensor maps read them in place.
    qkv = _randn(7, 2, 300, 3 * 4 * 128).to(dev, torch.bfloat16)
    q, k, v = (t.unflatten(-1, (4, 128)) for t in qkv.split(512, dim=-1))
    g = _randn(8, 2, 300, 4, 128).to(dev, torch.bfloat16)
    out, lse = tfa.flash_fwd_cuda(q, k, v, causal=True)
    got = tfa.flash_backward(q, k, v, out, lse, g, causal=True)
    ref = tfa.flash_backward_plain(q, k, v, out, lse, g, causal=True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-3,
                                   rtol=1e-2)


@pytest.mark.gpu
def test_cuda_flash_backward_holds_where_one_bf16_rounding_fails():
    """At [1, 2048, 2, 128] bf16 causal the bf16 kernels (p and ds fed to
    the tensor cores as bf16 hi + lo) hold chip_smoke's GRAD_TOL against
    the plain backward, where the plain backward with p and ds rounded to
    one bf16 (chip_smoke's planted fault) does not."""
    dev = _card()
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tol = cs.GRAD_TOL["bfloat16"]
    q, k, v, g = (_randn(40 + i, 1, 2048, 2, 128).to(dev, torch.bfloat16)
                  for i in range(4))
    out, lse = tfa.flash_fwd_cuda(q, k, v, causal=True)
    ref = tfa.flash_backward_plain(q, k, v, out, lse, g, causal=True)
    got = tfa.flash_backward(q, k, v, out, lse, g, causal=True)
    assert all(cs.max_err(a, b, tol)[1] for a, b in zip(got, ref))
    bad = cs.rounded_backward(tfa)(q, k, v, out, lse, g, causal=True)
    assert not all(cs.max_err(a, b, tol)[1] for a, b in zip(bad, ref))


@pytest.mark.gpu
def test_cuda_autograd_launches_backward_kernels():
    """On the card, `flash_attention` and `flash_attention_lse` return
    outputs of `FlashAttentionFn`, whose backward launches the dQ and
    dK/dV kernels once each (no fallback)."""
    dev = _card()
    q, k, v, g, kw = _bwd_inputs(5, dev, torch.float32, 64, FWD_CASES[7])
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    n = (tfa.flash_bwd_dq_cuda.launches, tfa.flash_bwd_dkv_cuda.launches)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert (tfa.flash_bwd_dq_cuda.launches,
            tfa.flash_bwd_dkv_cuda.launches) == (n[0] + 1, n[1] + 1)
    with torch.no_grad():
        o, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
        ref = tfa.flash_backward_plain(q, k, v, o, lse, g, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    out, lse = tfa.flash_attention_lse(q, k, v, **kw)
    wl = _randn(6, *lse.shape).to(dev)
    loss = (out * g).sum() + (torch.where(torch.isfinite(lse), lse, 0.0)
                              * wl).sum()
    got = torch.autograd.grad(loss, (q, k, v))
    with torch.no_grad():
        ref = tfa.flash_backward_plain(q, k, v, o, lse, g, dlse=wl, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_small_model_train_step_through_kernels():
    """f32 toy LM: the loss and every parameter gradient of a train
    step through the forward and backward kernels equal autograd
    through the dot attention on the card (1e-4: f32, summation order
    over 2 layers); each kernel ran once per layer."""
    dev = _card()
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    kw = dict(max_len=64, dtype=torch.float32, num_kv_heads=2, device=dev)
    fast = TransformerLM(128, 2, 4, 64, attn_impl="flash",
                         **kw).init_weights(3)
    slow = TransformerLM(128, 2, 4, 64, attn_impl="dot", **kw)
    slow.load_state_dict(fast.state_dict())
    toks = torch.from_numpy(
        np.random.RandomState(4).randint(0, 128, (3, 50))).to(dev)
    wrappers = (tfa.flash_fwd_cuda, tfa.flash_bwd_dq_cuda,
                tfa.flash_bwd_dkv_cuda)
    before = [w.launches for w in wrappers]
    lf = lm_loss(fast(toks), toks)
    lf.backward()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2, 2, 2]
    ls = lm_loss(slow(toks), toks)
    ls.backward()
    torch.testing.assert_close(lf, ls, atol=1e-5, rtol=1e-5)
    for (name, a), b in zip(fast.named_parameters(), slow.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4,
                                   msg=name)
