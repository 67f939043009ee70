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

