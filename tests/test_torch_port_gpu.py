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
@pytest.mark.parametrize("D", [64, 128, 256])
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


@pytest.mark.gpu
def test_cuda_powersgd_matches_cpu():
    """The PowerSGD compressor on CUDA tensors (cuBLAS products, the
    cuSOLVER QR) against the same compressor on the CPU, three steps
    from the same gradients and state: the approximations and the error
    buffers (both independent of the QR's column signs) within 1e-4 of
    each tensor's largest entry (f32, other summation orders and QR)."""
    dev = _card()
    from horovod_tpu_torch.ops.compression import powersgd_allreduce
    shapes = [(48, 32), (32,), (2, 8, 12), (3, 2), (512, 256)]
    tx = powersgd_allreduce(rank=4)
    cpu = tx.init([torch.zeros(s) for s in shapes])
    gpu = tx.init([torch.zeros(s, device=dev) for s in shapes])
    assert all(q is None or q.is_cuda for q in gpu.qs)
    for step in range(3):
        grads = [_randn(70 + 10 * step + i, *s) for i, s in enumerate(shapes)]
        c_out, cpu = tx.update(grads, cpu)
        g_out, gpu = tx.update([g.to(dev) for g in grads], gpu)
        pairs = list(zip(g_out, c_out)) + [
            (a, b) for a, b in zip(gpu.errs, cpu.errs) if a is not None]
        for a, b in pairs:
            assert a.is_cuda
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


@pytest.mark.gpu
def test_cuda_sparse_word2vec_step_matches_cpu():
    """Two Adagrad steps of the word2vec toy through
    `DistributedOptimizer` and `make_train_step` on the card, with the
    embedding gradient a sparse CUDA tensor, against the same steps on
    the CPU (1e-5: f32, scatter order)."""
    dev = _card()
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.word2vec import Word2Vec
    rs = np.random.RandomState(8)
    batch = [torch.from_numpy(x) for x in (
        rs.randint(0, 300, 64), rs.randint(0, 300, 64),
        rs.randint(0, 300, (64, 5)))]
    states = []
    for d in (dev, torch.device("cpu")):
        m = Word2Vec(300, 32, device=d).init_weights(1)
        opt = hvd.DistributedOptimizer(torch.optim.Adagrad(m.parameters(),
                                                           lr=0.1))
        step = hvd.make_train_step(m, opt)
        for _ in range(2):
            step(*(t.to(d) for t in batch))
        assert m.embeddings.grad.is_sparse
        assert m.embeddings.grad.device.type == d.type
        states.append({k: v.cpu() for k, v in m.state_dict().items()})
    for k in states[0]:
        torch.testing.assert_close(states[0][k], states[1][k], atol=1e-5,
                                   rtol=0, msg=k)


def _spec_models(dev):
    """f32 toy target through both decode kernels' paths, and a draft of
    the same geometry: the target's weights plus 0.05 x seeded noise."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    kw = dict(max_len=64, dtype=torch.float32, num_kv_heads=2,
              attn_impl="flash", decode_prefix_impl="pallas",
              decode_prefix_block=16, device=dev)
    target = TransformerLM(128, 2, 4, 64, **kw).init_weights(3)
    draft = TransformerLM(128, 2, 4, 64, **kw)
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for p, q in zip(draft.parameters(), target.parameters()):
            p.copy_(q + 0.05 * torch.randn(q.shape, device=dev,
                                           generator=g))
    return target, draft


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_small_spec_engine_matches_plain(paged):
    """f32 toy model on the card: the speculative engine's greedy streams
    (self-draft and noisy draft) == the plain engine's, token for token;
    the self-draft accepts every proposal."""
    dev = _card()
    from horovod_tpu_torch.serving import ServingEngine
    target, draft = _spec_models(dev)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 128, (int(n),)) for n in (9, 20, 3, 33)]
    kw = dict(paged=True, kv_block_size=16, paged_kernel="pallas") \
        if paged else {}

    def streams(**spec):
        with ServingEngine(target, num_slots=2, **kw, **spec) as eng:
            out = [eng.submit(p, 12).result(timeout=120).tokens.tolist()
                   for p in prompts]
            return out, eng.metrics_snapshot()

    plain, _ = streams()
    selfd, snap_s = streams(spec_draft=target, spec_k=4)
    noisy, snap_n = streams(spec_draft=draft, spec_k=4)
    assert selfd == plain and noisy == plain
    assert snap_s["spec_acceptance_rate"] == 1.0
    assert snap_n["spec_rounds"] > snap_s["spec_rounds"]


def _spec_pool(dev, paged):
    from horovod_tpu_torch.serving import PagedSlotPool, SlotPool
    target, draft = _spec_models(dev)
    if paged:
        pool = PagedSlotPool(target, 3, block_size=16, kernel="pallas",
                             spec_draft=draft, spec_k=4)
    else:
        pool = SlotPool(target, 3, spec_draft=draft, spec_k=4)
    rs = np.random.RandomState(5)
    for n in (9, 20):
        p = rs.randint(0, 128, (n,))
        pool.prefill(pool.admit(p, 30).slot, p, 0.0, None, 0)
    pool.spec_round()            # warm: kernels built and loaded
    torch.cuda.synchronize()
    return pool


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_spec_round_launches_decode_kernel_and_syncs_once(paged):
    """One steady spec round: the draft chain launches the flash-decode
    kernel (k+1) x layers times (the verify is S=k+1 and launches
    neither decode kernel), and the round makes ONE host sync, counted
    under CUDA's sync debug mode."""
    import warnings
    dev = _card()
    pool = _spec_pool(dev, paged)
    before = (tfa.flash_decode_cuda.launches,
              tpa.paged_decode_cuda.launches)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            emitted, n_emit, proposed = pool.spec_round()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, syncs
    assert tfa.flash_decode_cuda.launches - before[0] == 5 * 2
    assert tpa.paged_decode_cuda.launches == before[1]
    assert sorted(proposed.tolist()) == [0, 4, 4]
    assert all(1 <= n <= 5 for n, p in zip(n_emit, proposed) if p)


# -- int8 weights, int8 KV and the rolling window --------------------------

@pytest.mark.gpu
def test_cuda_int8_dense_bitwise_dequantized_product():
    """An int8 `_Dense` on the card (bf16 compute) == ``x @`` its
    dequantized kernel, and == a float `_Dense` holding that kernel,
    bit for bit; the codes and scales the card computes equal the
    CPU's."""
    dev = _card()
    from horovod_tpu_torch.ops.quantization import (dequantize_int8,
                                                    quantize_int8)
    from horovod_tpu_torch.parallel.tensor import _Dense
    w = _randn(0, 256, 384) * 0.05
    x = _randn(1, 3, 7, 256).to(dev, torch.bfloat16)
    q, s = quantize_int8(w.to(dev), axis=0)
    qc, sc = quantize_int8(w, axis=0)
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    dq = _Dense(256, 384, dtype=torch.bfloat16, weight_quant="int8",
                device=dev)
    dq.kernel_q.copy_(q)
    dq.kernel_scale.copy_(s)
    fl = _Dense(256, 384, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        fl.kernel.data = dequantize_int8(q, s, torch.bfloat16)
        y = dq(x)
        assert torch.equal(y, x @ dequantize_int8(q, s, torch.bfloat16)
                           + dq.bias.to(torch.bfloat16))
        assert torch.equal(y, fl(x))


def _kv_models(dev):
    from horovod_tpu_torch.models.transformer import TransformerLM
    kw = dict(max_len=256, dtype=torch.bfloat16, attn_impl="flash",
              decode_prefix_block=64, decode_prefix_impl="pallas",
              device=dev)
    plain = TransformerLM(512, 2, 8, 128, **kw).init_weights(5)
    quant = TransformerLM(512, 2, 8, 128, kv_quant="int8", **kw)
    quant.load_state_dict(plain.state_dict())
    return plain, quant


def _forced(model, paged, prompt, forced):
    """Teacher-forced last-position logits: the prompt, then one S=1
    call per forced token, on the linear cache or a paged pool of
    16-token blocks (the kernel's mode)."""
    from horovod_tpu_torch.models import transformer as tt
    L, n = prompt.shape[0], forced.shape[1]
    dev = prompt.device
    outs = []
    with torch.no_grad():
        if not paged:
            cache = tt.init_cache(model, L)
            toks = prompt
            for t in range(n + 1):
                hidden, head = model(toks, cache, return_hidden=True)
                cache.index += toks.shape[1]
                outs.append((hidden[:, -1] @ head.to(hidden.dtype).T).float())
                toks = forced[:, t:t + 1]
            return torch.stack(outs, 1)
        spec = tt.paged_cache_spec(model, 16)
        T = spec.blocks_per_seq
        pools = tt.init_paged_pools(model, spec, L * T + 1)
        tables = (torch.arange(L * T, dtype=torch.int32, device=dev)
                  .view(L, T) + 1)
        fills = torch.zeros(L, dtype=torch.int32, device=dev)
        outs.append(torch.stack([tt.paged_prefill_chunk(
            model, spec, pools, tables, fills, b, prompt[b],
            paged_kernel="pallas", fill=0) for b in range(L)]))
        live = torch.ones(L, dtype=torch.bool, device=dev)
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        for t in range(n):
            outs.append(tt.paged_decode_logits(
                model, spec, pools, tables, fills, forced[:, t], live, done,
                paged_kernel="pallas"))
        return torch.stack(outs, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_cuda_int8_kv_walks_within_tolerance_of_bf16(paged):
    """int8 KV on the card: the plain prefix loop (linear cache) and the
    paged walk, each dequantizing per block, against the bf16-KV run of
    the same model through B3 / B4: teacher-forced logits within 0.08
    of the largest logit (the reference's int8-KV bound); the int8 runs
    launch neither decode kernel."""
    dev = _card()
    plain, quant = _kv_models(dev)
    rs = np.random.RandomState(6)
    prompt = torch.from_numpy(rs.randint(0, 512, (3, 100))).to(dev)
    forced = torch.from_numpy(rs.randint(0, 512, (3, 12))).to(dev)
    ref = _forced(plain, paged, prompt, forced)
    before = (tfa.flash_decode_cuda.launches, tpa.paged_decode_cuda.launches)
    got = _forced(quant, paged, prompt, forced)
    assert (tfa.flash_decode_cuda.launches,
            tpa.paged_decode_cuda.launches) == before
    err = float((got - ref).abs().max() / ref.abs().max())
    assert torch.isfinite(got).all() and err < 0.08, err


@pytest.mark.gpu
def test_cuda_rolling_cache_matches_cpu_run():
    """The rolling window cache on the card against the CPU run of the
    same f32 model (RoPE, GQA, window 16, max_len 64): a 40-token
    one-pass prefill, a 24-token append and S=1 ticks to position 100
    (past max_len). Logits within 1e-4 of the largest (f32 summation
    order on two devices), the cache rows the same, greedy `generate`
    past max_len token-exact."""
    dev = _card()
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      generate, init_cache)
    kw = dict(max_len=64, dtype=torch.float32, num_kv_heads=2,
              pos_emb="rope", window=16, attn_impl="flash")
    cpu = TransformerLM(128, 2, 4, 64, device="cpu", **kw).init_weights(7)
    card = TransformerLM(128, 2, 4, 64, device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(8)
    calls = [(rs.randint(0, 128, (2, 40)), False),
             (rs.randint(0, 128, (2, 24)), True)]
    calls += [(rs.randint(0, 128, (2, 1)), True) for _ in range(36)]
    caches = {m: init_cache(m, 2) for m in (cpu, card)}
    with torch.no_grad():
        for toks, chunked in calls:
            outs = []
            for m in (cpu, card):
                t = torch.from_numpy(toks).to(m.device)
                outs.append(m(t, caches[m], chunked_prefill=chunked).cpu())
                caches[m].index += t.shape[1]
            err = float((outs[1] - outs[0]).abs().max()
                        / outs[0].abs().max())
            assert err < 1e-4, err
    assert caches[card].k[0].shape == (2, 16, 2, 64)
    assert torch.allclose(caches[card].k[1].cpu(), caches[cpu].k[1],
                          atol=1e-4)
    prompt = torch.from_numpy(rs.randint(0, 128, (2, 20)))
    want = generate(cpu, prompt, 70)
    assert torch.equal(generate(card, prompt.to(dev), 70).cpu(), want)


@pytest.mark.gpu
def test_cuda_threefry_bits_equal_cpu():
    """Threefry on the card: random bits, uniforms and the batched
    per-lane draw are bitwise the CPU's (int64 add/rotate/xor only);
    the Gumbel noise agrees within the rule of
    tests/test_torch_port_threefry.py (ulp + 2**-23)."""
    dev = _card()
    from horovod_tpu_torch.ops import threefry
    keys = np.stack([threefry.prng_key(s) for s in (0, 7, 2 ** 32 + 5)])
    for key in (keys[1], keys):
        shape = (4, 1000) if key.ndim == 1 else (32768,)
        bits = threefry.random_bits(key, shape, device=dev)
        assert bits.is_cuda
        assert torch.equal(bits.cpu(), threefry.random_bits(key, shape))
        u = threefry.uniform(key, shape, device=dev).cpu()
        assert torch.equal(u, threefry.uniform(key, shape))
        g = threefry.gumbel(key, shape, device=dev).cpu().numpy()
        gc = threefry.gumbel(key, shape).numpy()
        assert np.all(np.abs(g - gc) <= np.spacing(np.abs(gc)) + 2.0 ** -23)
    np.testing.assert_array_equal(threefry.split(keys),
                                  np.stack([threefry.split(k)
                                            for k in keys]))


@pytest.mark.gpu
def test_cuda_device_mode_export_ingest_roundtrip():
    """``export_blocks(mode="device")`` keeps the rows as CUDA tensors
    and the graft into a second paged engine on the card gives the
    single engine's stream, with the prompt's full blocks matched."""
    dev = _card()
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serving import (ServingEngine, export_blocks,
                                           ingest_blocks)
    model = TransformerLM(128, 2, 4, 64, max_len=64, dtype=torch.float32,
                          device=dev).init_weights(5)
    prompt = np.random.RandomState(2).randint(0, 128, (34,))
    kw = dict(num_slots=2, paged=True, kv_block_size=16)
    with ServingEngine(model, **kw) as eng:
        ref = list(eng.submit(prompt, 8, temperature=0.8, seed=3)
                   .result(timeout=300).tokens)
    with ServingEngine(model, **kw) as eng:
        first = eng.submit(prompt, 1).result(timeout=300)
        tr = export_blocks(eng.pool, prompt, (int(first.tokens[0]),),
                           mode="device")
    assert tr.mode == "device" and tr.num_blocks == 2
    assert all(r.is_cuda for r in tr.rows)
    with ServingEngine(model, **kw) as eng:
        assert ingest_blocks(eng.pool, tr) == 2
        res = eng.submit(prompt, 8, temperature=0.8, seed=3).result(
            timeout=300)
    assert list(res.tokens) == ref
    assert res.prefix_tokens_cached == 32


# -- coverage: head_dim 256 and decode groups 1-8 ---------------------------

# (H, Hkv, D) of the instantiations the HF families bring: Gemma-1's
# head_dim 256 (MQA, group 8; and group 1), Qwen2-1.5B's group 6 at 128,
# groups 3, 5 and 7 at 64 (Qwen2-0.5B's is 7).
COVERAGE = [(8, 1, 256), (8, 8, 256), (12, 2, 128), (6, 2, 64),
            (10, 2, 64), (14, 2, 64)]


def _close(out, ref, dt):
    if dt == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        _bf16_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_coverage_forward_matches_plain(dtype):
    """The forward at head_dim 256 (Gemma's 8 heads on 1) and at 14 heads
    on 2 (Qwen2-0.5B), causal, banded, ragged and offset."""
    dev = _card()
    dt = getattr(torch, dtype)
    for i, (H, Hkv, D) in enumerate(((8, 1, 256), (2, 2, 256),
                                     (14, 2, 64))):
        for j, c in enumerate((dict(Sq=130, Sk=130, causal=True),
                               dict(Sq=130, Sk=130, causal=True, window=5),
                               dict(Sq=40, Sk=300, causal=True,
                                    q_offset=260),
                               dict(Sq=16, Sk=199, causal=False))):
            c = dict(c)
            Sq, Sk = c.pop("Sq"), c.pop("Sk")
            q = _randn(10 * i + j, 2, Sq, H, D).to(dev, dt)
            k = _randn(10 * i + j + 100, 2, Sk, Hkv, D).to(dev, dt)
            v = _randn(10 * i + j + 200, 2, Sk, Hkv, D).to(dev, dt)
            out, lse = tfa.flash_fwd_cuda(q, k, v, **c)
            ref, rlse = tfa.flash_attention_plain(q, k, v, **c)
            _close(out.float(), ref.float(), dt)
            torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_coverage_decode_matches_plain(dtype):
    """Both decode kernels at every new instantiation the HF families run,
    at split boundaries, length 0 and the table's end."""
    dev = _card()
    dt = getattr(torch, dtype)
    W, L, bs = 512, 6, 16
    for i, (H, Hkv, D) in enumerate(COVERAGE):
        splits = tfa.decode_splits(W, Hkv * L, tfa._sm_count(dev))
        c = -(-W // splits)
        lens = [0, 1, c, c + 1, W - 1, W]
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = _randn(300 + i, L, 1, H, D).to(dev, dt)
        kc = _randn(310 + i, L, W, Hkv, D).to(dev, dt)
        vc = _randn(320 + i, L, W, Hkv, D).to(dev, dt)
        before = tfa.flash_decode_cuda.launches
        out = tfa.flash_decode_cuda(q, kc, vc, length)
        assert tfa.flash_decode_cuda.launches == before + 1
        _close(out, tfa.flash_decode_plain(q, kc, vc, length), dt)
        assert not out[0].any()

        T = W // bs
        rs = np.random.RandomState(330 + i)
        nb = L * T + 1
        kp = _randn(340 + i, nb, bs, Hkv, D).to(dev, dt)
        vp = _randn(350 + i, nb, bs, Hkv, D).to(dev, dt)
        tables = torch.from_numpy(np.stack(
            [rs.permutation(np.arange(1, nb))[:T] for _ in range(L)]
        ).astype(np.int32)).to(dev)
        tables[-1] = 0                            # a free lane
        fill = torch.tensor([0, bs, c, c - 1, W - 1, 0], dtype=torch.int32,
                            device=dev)
        args = (q[:, 0], kc[:, 0], vc[:, 0], tables, fill, kp, vp)
        out = tpa.paged_decode_cuda(*args)
        assert torch.isfinite(out.float()).all()
        _close(out, tpa.paged_decode_plain(*args), dt)


@pytest.mark.gpu
def test_cuda_backward_at_head_dim_256_launches_both_kernels():
    """At head_dim 256 (Gemma-1's heads, one kv head) a CUDA backward
    launches the dQ and dK/dV kernels once each, with no plain
    fallback, and matches the plain backward; a head dim the kernels
    lack (96) raises before any launch."""
    dev = _card()
    q, k, v = (_randn(400 + i, 1, 300, h, 256).to(dev, torch.bfloat16)
               .requires_grad_() for i, h in enumerate((8, 1, 1)))
    g = _randn(403, 1, 300, 8, 256).to(dev, torch.bfloat16)
    launches = (tfa.flash_bwd_dq_cuda.launches,
                tfa.flash_bwd_dkv_cuda.launches)
    got = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=True),
                              (q, k, v), g)
    assert (tfa.flash_bwd_dq_cuda.launches,
            tfa.flash_bwd_dkv_cuda.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    with torch.no_grad():
        o, lse = tfa.flash_fwd_cuda(q, k, v, causal=True)
        ref = tfa.flash_backward_plain(q, k, v, o, lse, g, causal=True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-3,
                                   rtol=1e-2)
    x = _randn(404, 1, 64, 2, 96).to(dev, torch.bfloat16)
    lse96 = torch.zeros(1, 2, 64, device=dev)
    launches = (tfa.flash_bwd_dq_cuda.launches,
                tfa.flash_bwd_dkv_cuda.launches)
    with pytest.raises(ValueError, match="64 / 128 / 256, got 96"):
        tfa.flash_backward(x, x, x, x, lse96, x)
    assert (tfa.flash_bwd_dq_cuda.launches,
            tfa.flash_bwd_dkv_cuda.launches) == launches


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip_bitwise(tmp_path):
    """A CUDA model and its AdamW state through `utils.checkpoint`, sync
    and async: restored bitwise, placed back on the card by the
    template, and a step from the restored state equals a step from the
    original bitwise."""
    dev = _card()
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      make_lm_train_step)
    from horovod_tpu_torch.utils import checkpoint as ckpt

    def build():
        m = TransformerLM(128, 2, 4, 64, max_len=64, dtype=torch.bfloat16,
                          attn_impl="flash", device=dev).init_weights(3)
        return m, torch.optim.AdamW(m.parameters(), lr=1e-3)

    toks = torch.from_numpy(
        np.random.RandomState(5).randint(0, 128, (2, 64))).to(dev)
    m, opt = build()
    step = make_lm_train_step(m, opt)
    step(toks)
    state = {"model": m.state_dict(), "opt": opt.state_dict()}
    ckpt.save_step(str(tmp_path), 1, state)
    ckpt.save_step(str(tmp_path), 2, state, block=False)
    ckpt.wait_pending()
    m2, opt2 = build()
    for s in (1, 2):
        got = ckpt.restore(str(tmp_path / f"step_0000000{s}"),
                           like={"model": m2.state_dict(),
                                 "opt": opt2.state_dict()})
        for k, t in got["model"].items():
            assert t.device.type == "cuda" and torch.equal(
                t, state["model"][k]), k
    m2.load_state_dict(got["model"])
    opt2.load_state_dict(got["opt"])
    a = float(step(toks))
    b = float(make_lm_train_step(m2, opt2)(toks))
    assert a == b
    for p, q in zip(m.parameters(), m2.parameters()):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_cuda_elastic_average_stays_on_card_and_equals_cpu():
    """The elastic world's float64 rank-order average of gradients on the
    card: it stays there, and equals the same average of the same
    tensors on the CPU bit for bit (IEEE adds and divides, one order)."""
    from horovod_tpu_torch.resilience.membership import average
    dev = _card()
    grads = [{"w": _randn(i, 300, 7), "b": _randn(10 + i, 1)}
             for i in range(4)]
    got = average([{k: v.to(dev) for k, v in g.items()} for g in grads])
    ref = average(grads)
    for k in ref:
        assert got[k].device.type == "cuda" and got[k].dtype == torch.float64
        assert torch.equal(got[k].cpu(), ref[k])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ring_rotations_with_a_masked_rotation(dtype):
    """The kernels at a sequence-parallel ring's rotations: the last of 4
    blocks of 64 queries against the K/V block of each rotation d at
    q_offset = d x 64, window 80 (GQA 4/2). Rotation 2 holds fully
    masked rows, rotation 3 is masked whole: out 0, lse -inf, and under
    cotangents on out and lse zero, finite gradients; every rotation's
    forward and backward against the plain versions."""
    dev = _card()
    dt = getattr(torch, dtype)
    atol, rtol = (2e-5, 0.0) if dt == torch.float32 else (2e-3, 1e-2)
    gatol = 1e-4 if dt == torch.float32 else 2e-3
    n, sp, window = 64, 4, 80
    q = _randn(40, 2, n, 4, 128).to(dev, dt)
    k = _randn(41, 2, sp * n, 2, 128).to(dev, dt)
    v = _randn(42, 2, sp * n, 2, 128).to(dev, dt)
    go = _randn(43, 2, n, 4, 128).to(dev, dt)
    dlse = _randn(44, 2, 4, n).to(dev)
    for d in range(sp):
        kb = k[:, (sp - 1 - d) * n:(sp - d) * n]
        vb = v[:, (sp - 1 - d) * n:(sp - d) * n]
        kw = dict(causal=True, window=window, q_offset=d * n)
        out, lse = tfa.flash_fwd_cuda(q, kb, vb, **kw)
        ref, rlse = tfa.flash_attention_plain(q, kb, vb, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        assert torch.equal(torch.isneginf(lse), torch.isneginf(rlse))
        fin = torch.isfinite(rlse)
        torch.testing.assert_close(lse[fin], rlse[fin], atol=1e-4, rtol=0)
        got = tfa.flash_backward(q, kb, vb, out, lse, go, dlse=dlse, **kw)
        want = tfa.flash_backward_plain(q, kb, vb, out, lse, go, dlse=dlse,
                                        **kw)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a.float(), b.float(), atol=gatol,
                                       rtol=rtol)
        if d == 2:
            assert torch.isneginf(rlse).any() and fin.any()
        if d == sp - 1:
            assert torch.isneginf(lse).all() and not out.any()
            assert not any(t.any() for t in got)


# -- tensor parallelism: the decode kernels at a model rank's heads ---------

TP_RANK_SHAPES = {"gemma-4:1-d256": (4, 1, 256), "qwen2-7:1-d64": (7, 1, 64),
                  "lm-4:4-d128": (4, 4, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(TP_RANK_SHAPES))
def test_cuda_decode_kernels_at_tp_rank_heads(shape, dtype):
    """Both decode kernels at the heads one rank of a model=2 mesh holds
    (chip_smoke.py phase 15): Gemma-2B's 4 query heads over its one kv
    head at D 256, Qwen2-0.5B's 7 over 1 at D 64, and the repo LM's 4
    over 4 at D 128, against their plain versions; lanes at fill 0, a
    block boundary and a full cache."""
    dev = _card()
    dt = getattr(torch, dtype)
    atol, rtol = (2e-5, 0.0) if dt == torch.float32 else (2e-3, 1e-2)
    H, Hkv, D = TP_RANK_SHAPES[shape]
    L, W, bs = 4, 128, 16
    q = _randn(60, L, 1, H, D).to(dev, dt)
    kc = _randn(61, L, W, Hkv, D).to(dev, dt)
    vc = _randn(62, L, W, Hkv, D).to(dev, dt)
    length = torch.tensor([1, 16, 77, W], dtype=torch.int32, device=dev)
    out = tfa.flash_decode_cuda(q, kc, vc, length)
    ref = tfa.flash_decode_plain(q, kc, vc, length)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    T = W // bs
    nb = L * T + 1
    rs = np.random.RandomState(63)
    kp = _randn(64, nb, bs, Hkv, D).to(dev, dt)
    vp = _randn(65, nb, bs, Hkv, D).to(dev, dt)
    tables = torch.from_numpy(np.stack(
        [rs.permutation(np.arange(1, nb))[:T] for _ in range(L)]
    ).astype(np.int32)).to(dev)
    args = (q[:, 0], _randn(66, L, Hkv, D).to(dev, dt),
            _randn(67, L, Hkv, D).to(dev, dt), tables,
            torch.tensor([0, bs, 77, W], dtype=torch.int32, device=dev),
            kp, vp)
    out = tpa.paged_decode_cuda(*args)
    ref = tpa.paged_decode_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
def test_cuda_vocab_parallel_ce_equals_full_ce(tmp_path):
    """The vocab-parallel cross entropy on CUDA logits over a one-rank
    gloo world (its model axis of size 1: every max, sum and target
    logit reduced over the axis) equals the plain cross entropy, and so
    do their gradients."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from horovod_tpu_torch.models.transformer import vocab_parallel_ce
    from horovod_tpu_torch.parallel import mesh as pmesh
    dev = _card()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(model=1, device_type="cuda")
        logits = (3 * _randn(70, 64, 1000)).to(dev).requires_grad_()
        targets = torch.from_numpy(
            np.random.RandomState(71).randint(0, 1000, 64)).to(dev)
        with pmesh.use(mesh):
            got = vocab_parallel_ce(logits, targets, 0, mesh)
        (g_got,) = torch.autograd.grad(got.sum(), logits)
        want = F.cross_entropy(logits, targets, reduction="none")
        (g_want,) = torch.autograd.grad(want.sum(), logits)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(g_got, g_want, atol=1e-6, rtol=1e-5)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_f32_product_matches_upcast(dtype):
    """`parallel.tensor.f32_product` of half CUDA operands (the
    row-parallel partial product, one tensor-core GEMM with an f32
    output) against the f32 upcast product: every product is exact in
    f32, so they differ by f32 summation order only (1e-5 relative);
    its gradients, through a cast of the output to the operands'
    dtype, are the half product's (the same GEMMs; held at the dtype's
    default tolerance)."""
    from horovod_tpu_torch.parallel.tensor import f32_product
    dev = _card()
    dt = getattr(torch, dtype)
    x = _randn(80, 2, 64, 512).to(dev, dt).requires_grad_()
    w = (_randn(81, 512, 256) * 512 ** -0.5).to(dev, dt).requires_grad_()
    cot = _randn(82, 2, 64, 256).to(dev, dt)
    y = f32_product(x, w)
    assert y.dtype == torch.float32 and y.shape == (2, 64, 256)
    want = x.detach().float() @ w.detach().float()
    torch.testing.assert_close(y.detach(), want, atol=1e-5, rtol=1e-5)
    gx, gw = torch.autograd.grad(y.to(dt), (x, w), cot)
    hx, hw = torch.autograd.grad((x @ w), (x, w), cot)
    torch.testing.assert_close(gx, hx)      # the dtype's own tolerance
    torch.testing.assert_close(gw, hw)


def _moe_pair(dev, cf, seed=90):
    """The same f32 MoE layer on the card and on the CPU."""
    from horovod_tpu_torch.parallel.expert import MoELayer
    layers = [MoELayer(8, 64, 32, k=2, capacity_factor=cf,
                       dtype=torch.float32, device=d) for d in (dev, "cpu")]
    layers[1].reset_parameters(torch.Generator().manual_seed(seed))
    layers[0].load_state_dict(layers[1].state_dict())
    return layers


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_cuda_moe_layer_matches_cpu_and_never_syncs(cf):
    """The MoE layer on CUDA tensors against the same layer on the CPU
    (its plain run: the expert math has no kernel of its own): output,
    aux, the input's and every parameter's gradient, the routed and
    dropped counts, batched and one row at a time. Under CUDA's sync
    debug mode set to "error" the forward and backward make no host
    synchronization: the routing, capacity and dispatch stay on the
    card."""
    dev = _card()
    gpu, cpu = _moe_pair(dev, cf)
    x = _randn(91, 4, 24, 32)
    cot = _randn(92, 4, 24, 32)
    outs = []
    for layer, d in ((gpu, dev), (cpu, "cpu")):
        xx, cd = x.to(d).requires_grad_(), cot.to(d)
        torch.cuda.set_sync_debug_mode("error" if d == dev else 0)
        try:
            y, aux = layer(xx)
            yr, _ = layer(xx.detach(), route_rows=True)
            ((y * cd).sum() + 0.3 * aux).backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert y.device.type == xx.device.type
        outs.append([y.detach().cpu(), aux.detach().cpu(), yr.cpu(),
                     xx.grad.cpu()]
                    + [p.grad.cpu() for p in layer.parameters()]
                    + [layer.counts.cpu()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_block_through_the_kernels_matches_plain(dtype):
    """One MoE block (a one-layer ``moe_every=1`` LM, flash attention) on
    the card: logits and the loss's gradients through the flash forward
    and backward kernels against the same model on their plain
    versions (f32: 1e-4; bf16 at its rounding, 2e-2 on the logits and
    0.05 of each gradient's largest entry, chip_smoke's step rule)."""
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    dev = _card()
    dt = getattr(torch, dtype)
    model = TransformerLM(64, 1, 2, 64, max_len=64, dtype=dt,
                          attn_impl="flash", moe_every=1, num_experts=4,
                          device=dev).init_weights(93)
    toks = torch.from_numpy(np.random.RandomState(94).randint(
        0, 64, (2, 48))).to(dev)
    launches = tfa.flash_fwd_cuda.launches

    def run():
        model.zero_grad(set_to_none=True)
        logits, aux = model(toks, return_aux=True)
        (lm_loss(logits, toks) + 0.01 * aux).backward()
        return logits.detach().float(), [p.grad.float() for p in
                                         model.parameters()]
    k_logits, k_grads = run()
    assert tfa.flash_fwd_cuda.launches == launches + 1
    saved = (tfa._flash_forward, tfa.flash_backward)

    def plain_forward(q, k, v, causal, window, q_offset, k_offset):
        return tfa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         k_offset=k_offset)
    tfa._flash_forward, tfa.flash_backward = (plain_forward,
                                              tfa.flash_backward_plain)
    try:
        p_logits, p_grads = run()
    finally:
        tfa._flash_forward, tfa.flash_backward = saved
    if dt == torch.float32:
        torch.testing.assert_close(k_logits, p_logits, atol=1e-4, rtol=1e-4)
        for a, b in zip(k_grads, p_grads):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    else:
        assert float((k_logits - p_logits).abs().max()) <= 2e-2
        for a, b in zip(k_grads, p_grads):
            assert float((a - b).abs().max()) <= 0.05 * float(
                b.abs().max().clamp_min(1e-30))
