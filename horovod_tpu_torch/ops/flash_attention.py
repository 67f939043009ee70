"""Flash attention for the port: the flash-forward and flash-decode
kernels (CUDA C++ for Hopper, ``csrc/flash_fwd.cu`` and
``csrc/flash_decode.cu``), each beside its plain PyTorch version.

Counterpart of `horovod_tpu.ops.flash_attention` (its Pallas kernels
`_flash_kernel` and `_decode_kernel`), forward only: the fused
backward kernels are a later slice. Layout is the framework-wide
[batch, seq, heads, head_dim].

Dispatch rule, per call: a tensor on the CPU goes to the plain version
(the CPU tests, and the toy widths they use); a CUDA tensor launches
the kernel or raises — there is no fallback. Each kernel wrapper
counts its launches in a plain integer attribute (``.launches``), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from horovod_tpu_torch.parallel.sequence import (banded_causal_mask,
                                                 check_window)

NEG_INF = float("-inf")
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _gqa_group(q, k, v) -> int:
    """q heads per kv head; K/V carry Hkv heads shared by groups of
    H/Hkv query heads (consumed natively, never repeated in memory by
    the kernels)."""
    H, Hkv = q.shape[2], k.shape[2]
    if v.shape[2] != Hkv:
        raise ValueError(
            f"k and v head counts differ: {Hkv} vs {v.shape[2]}")
    if H % Hkv:
        raise ValueError(
            f"query heads ({H}) must be a multiple of kv heads "
            f"({Hkv}) for grouped-query attention")
    return H // Hkv


def _softmax_finalize(s, v):
    """Normalize f32 scores ``s`` [..., Sq, Sk] the way both kernels do:
    shift by the row max (0 on fully-masked rows, so exp(-inf) = 0),
    divide by the row sum (1 where it is 0), logsumexp -inf there."""
    m = s.amax(dim=-1, keepdim=True)
    shift = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - shift)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p, v) / denom
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      shift + torch.log(denom))
    return out, lse[..., 0]


# ---------------------------------------------------------------------------
# Flash forward.
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal: bool = False,
                          window: Optional[int] = None, q_offset: int = 0,
                          k_offset: int = 0):
    """The plain version of the flash-forward kernel: the same f32
    arithmetic on a materialized [Sq, Sk] score matrix. Returns
    ``(out [B, Sq, H, D] at q.dtype, lse [B, H, Sq] float32)``; fully
    masked rows give out 0 and lse -inf."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    group = _gqa_group(q, k, v)
    qf = q.float().transpose(1, 2) * D ** -0.5            # [B, H, Sq, D]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2))            # [B, H, Sq, Sk]
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        kp = k_offset + torch.arange(Sk, device=q.device)
        keep = banded_causal_mask(qp, kp, window)
        s = s.masked_fill(~keep, NEG_INF)
    out, lse = _softmax_finalize(s, vf)
    return out.transpose(1, 2).to(q.dtype), lse


def _check_kernel_operand(name, t, ref):
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, q on {ref.device}")
    if t.dtype != ref.dtype:
        raise ValueError(f"{name} dtype {t.dtype} != q dtype {ref.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous head_dim axis, got "
                         f"strides {t.stride()}")
    es = t.element_size()
    if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name} rows must be 16-byte aligned (pointer "
                         f"{t.data_ptr():#x}, strides {t.stride()})")


def _check_kernel_inputs(q, tensors):
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in tensors:
        _check_kernel_operand(name, t, q)


def _lib_call(name, argtypes, *args):
    """Call C entry ``name`` of ``csrc/<name>.cu`` (built and loaded at
    first use); raise if it reports a CUDA error after its launch."""
    from horovod_tpu_torch.ops import _build
    lib = _build.library(name)
    entry = getattr(lib, name)
    if entry.argtypes is None:
        entry.restype = ctypes.c_int
        entry.argtypes = argtypes
        err_str = getattr(lib, f"{name}_error_string")
        err_str.restype = ctypes.c_char_p
        err_str.argtypes = [ctypes.c_int]
    err = entry(*args)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_FWD_ARGTYPES = ([_P] * 5 + [_I] * 7 + [_L] * 12 + [_I] * 4 + [_F, _P])
_DECODE_ARGTYPES = [_P] * 5 + [_I] * 6 + [_L, _L, _F, _P]


def flash_fwd_cuda(q, k, v, *, causal: bool = False,
                   window: Optional[int] = None, q_offset: int = 0,
                   k_offset: int = 0):
    """Launch the flash-forward kernel (``csrc/flash_fwd.cu``) on CUDA
    tensors [B, S, H, D] (any strides with a contiguous, 16-byte
    aligned head_dim row). Returns ``(out, lse [B, H, Sq] f32)``."""
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v)))
    _gqa_group(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out, lse
    if Sk == 0:
        return out.zero_(), lse.fill_(NEG_INF)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "flash_fwd", _FWD_ARGTYPES,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Sk, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)),
            0 if window is None else int(window), int(q_offset),
            int(k_offset), D ** -0.5, stream)
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        window: Optional[int] = None, q_offset: int = 0,
                        k_offset: int = 0):
    """Flash attention that also returns the row logsumexp:
    ``(out [B, Sq, H, D], lse [B, H, Sq] float32)``, lse -inf (and out
    0) on fully-masked rows. Causal masking uses global positions
    ``q_offset + i >= k_offset + j``; ``window`` (requires causal)
    keeps only the last ``window`` positions. GQA-native: K/V may carry
    fewer heads than Q. Forward only."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    check_window(window)
    _gqa_group(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, k_offset=k_offset)
    return flash_fwd_cuda(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, k_offset=k_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask=None, *, causal: bool = False,
                    window: Optional[int] = None, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Fused flash attention, [B, S, H, D] -> [B, S, H, D] (output at
    q.dtype, f32 math). ``mask`` is accepted positionally as None only
    (causal/window masking only), so the function drops in as
    `ParallelSelfAttention`'s ``attn_fn``."""
    if mask is not None:
        raise NotImplementedError(
            "flash_attention supports causal masking only; use "
            "dot_product_attention for arbitrary masks")
    return flash_attention_lse(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, k_offset=k_offset)[0]


flash_attention.native_gqa = True


# ---------------------------------------------------------------------------
# Flash decode: one S=1 tick against the linear KV cache.
# ---------------------------------------------------------------------------

def _decode_shapes(q, k_cache, v_cache):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_attention wants q [B,1,H,D], "
                         f"got {tuple(q.shape)}")
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be [B, W, Hkv, D] and equal, got "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    B, W, Hkv, D = k_cache.shape
    if q.shape[0] != B or q.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k_cache.shape)}")
    H = q.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    return B, W, H, Hkv, D


def flash_decode_plain(q, k_cache, v_cache, length):
    """The plain version of the flash-decode kernel: the same f32
    arithmetic over all W cache slots with slots >= length[lane]
    masked. Returns [B, 1, H, D] at q.dtype; a lane with length 0
    returns zeros."""
    B, W, H, Hkv, D = _decode_shapes(q, k_cache, v_cache)
    if length.shape != (B,):
        raise ValueError(f"length must be [B={B}], got "
                         f"{tuple(length.shape)}")
    grp = H // Hkv
    qf = q[:, 0].float() * D ** -0.5                     # [B, H, D]
    kf = k_cache.float()
    vf = v_cache.float()
    if grp > 1:
        kf = kf.repeat_interleave(grp, dim=2)
        vf = vf.repeat_interleave(grp, dim=2)
    s = torch.einsum("bhd,bwhd->bhw", qf, kf)[:, :, None, :]  # [B,H,1,W]
    valid = torch.arange(W, device=q.device)[None, :] < length[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    out, _ = _softmax_finalize(s, vf.transpose(1, 2))    # [B, H, 1, D]
    return out.transpose(1, 2).to(q.dtype)


def flash_decode_cuda(q, k_cache, v_cache, length):
    """Launch the flash-decode kernel (``csrc/flash_decode.cu``):
    q [B, 1, H, D] (strided, contiguous head_dim), caches [B, W, Hkv,
    D] contiguous, ``length`` a device int32 tensor [B] (per-lane
    filled prefix). H/Hkv must be 1, 2, 4 or 8."""
    B, W, H, Hkv, D = _decode_shapes(q, k_cache, v_cache)
    _check_kernel_inputs(q, (("q", q), ("k_cache", k_cache),
                             ("v_cache", v_cache)))
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash-decode caches must be contiguous")
    if H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"flash-decode kernel takes 1, 2, 4 or 8 query "
                         f"heads per kv head, got {H // Hkv}")
    if not (isinstance(length, torch.Tensor) and length.dtype == torch.int32
            and length.device == q.device and length.shape == (B,)):
        raise ValueError(
            f"length must be an int32 tensor [B={B}] on {q.device}, got "
            f"{getattr(length, 'dtype', type(length))} "
            f"{tuple(getattr(length, 'shape', ()))}")
    length = length.contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "flash_decode", _DECODE_ARGTYPES,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, W,
            H, Hkv, D, q.stride(0), q.stride(2), D ** -0.5, stream)
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length) -> torch.Tensor:
    """One decode tick of attention against each lane's filled cache
    prefix. q [B, 1, H, D]; k_cache/v_cache [B, W, Hkv, D] (the linear
    decode cache, already holding the current token at position
    ``length - 1``); ``length`` the per-lane filled prefix, an int32
    tensor [B] on q's device. Returns [B, 1, H, D] at q.dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, length)
    return flash_decode_cuda(q, k_cache, v_cache, length)

