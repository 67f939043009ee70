"""PyTorch port on the card: each CUDA kernel against its plain
PyTorch version, and a small model's greedy stream through the kernels
against the same model on the plain versions.

Every test here carries the ``gpu`` marker and skips without a card
(the decision is made inside each test, never at import). This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch; there, without the JAX test harness:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: f32 kernels differ from their plain versions by summation
order only (2e-5 at these sizes); bf16 outputs are rounded from f32 on
both sides, so one bf16 rounding flip is allowed: 2e-3 absolute plus
1e-2 relative, as in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

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
