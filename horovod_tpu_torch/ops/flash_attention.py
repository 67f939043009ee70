"""Flash attention for the port: the flash-forward, flash-backward
(dQ and dK/dV) and flash-decode kernels (CUDA C++ for Hopper,
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``,
``csrc/flash_bwd_dkv.cu`` and ``csrc/flash_decode.cu``), each beside
its plain PyTorch version.

Counterpart of `horovod_tpu.ops.flash_attention` (its Pallas kernels
`_flash_kernel`, `_flash_bwd_dq_kernel`, `_flash_bwd_dkv_kernel` and
`_decode_kernel`). `flash_attention` and `flash_attention_lse` are
differentiable through `FlashAttentionFn`, the counterpart of the JAX
package's `jax.custom_vjp`: its forward runs the forward kernel and
saves (q, k, v, out, lse), its backward rebuilds the probabilities
from the saved logsumexp in the two backward kernels. Layout is the
framework-wide [batch, seq, heads, head_dim].

The forward and the two backward kernels run their bf16
instantiations (the training and prefill path) on the tensor cores
(``wgmma``, tiles fed by TMA; the shared Hopper helpers are
``csrc/hopper.cuh``) and their f32 ones on the CUDA cores. The decode
kernel splits each lane's cache over several blocks and merges their
partial softmax states in a second kernel (`decode_splits` picks the
split count; `flash_decode_split_plain` is the same arithmetic in
PyTorch).

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
                                                 blockwise_attention,
                                                 check_window)
from horovod_tpu_torch.runtime.config import env_raw

NEG_INF = float("-inf")
# Head dims the kernels are built for (the reference's Pallas kernels
# tile the whole head dim as one block and take any); the backward
# kernels take BWD_HEAD_DIMS.
KERNEL_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
# Query heads per kv head the decode kernels are built for: 1..8.
DECODE_MAX_GROUP = 8
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


def _rows_aligned(t) -> bool:
    """Every head_dim row of ``t`` starts 16-byte aligned."""
    es = t.element_size()
    return not (t.data_ptr() % 16
                or any((s * es) % 16 for s in t.stride()[:-1]))


def _check_kernel_operand(name, t, ref):
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, q on {ref.device}")
    if t.dtype != ref.dtype:
        raise ValueError(f"{name} dtype {t.dtype} != q dtype {ref.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous head_dim axis, got "
                         f"strides {t.stride()}")
    if not _rows_aligned(t):
        raise ValueError(f"{name} rows must be 16-byte aligned (pointer "
                         f"{t.data_ptr():#x}, strides {t.stride()})")


def _check_head_dim(D):
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the forward and decode kernels take head_dim "
                         f"{' / '.join(map(str, KERNEL_HEAD_DIMS))}, got "
                         f"{D}")


def _check_kernel_inputs(q, tensors):
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, "
                         f"got {q.dtype}")
    _check_head_dim(q.shape[-1])
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
# q, k, v, dO, lse, dvec, then the outputs (dq | dk, dv); dtype, B, Sq,
# Sk, H, Hkv, D; (batch, seq, head) strides of q, k, v, dO and of each
# output; causal, window, q_offset, k_offset; scale; stream.
_DQ_ARGTYPES = ([_P] * 7 + [_I] * 7 + [_L] * 15 + [_I] * 4 + [_F, _P])
_DKV_ARGTYPES = ([_P] * 8 + [_I] * 7 + [_L] * 18 + [_I] * 4 + [_F, _P])
# q, k_cache, v_cache, length, out, workspace; dtype, L, W, H, Hkv, D,
# splits; q's (lane, head) strides; scale; stream.
_DECODE_ARGTYPES = [_P] * 6 + [_I] * 7 + [_L, _L, _F, _P]


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


def _flash_forward(q, k, v, causal, window, q_offset, k_offset):
    """(out, lse) by the forward kernel, or its plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, k_offset=k_offset)
    return flash_fwd_cuda(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, k_offset=k_offset)


# ---------------------------------------------------------------------------
# Flash backward.
# ---------------------------------------------------------------------------

def flash_backward_plain(q, k, v, o, lse, g, *, causal: bool = False,
                         window: Optional[int] = None, q_offset: int = 0,
                         k_offset: int = 0, dlse=None):
    """The plain version of the two backward kernels, after the JAX
    package's `_flash_backward`: the probabilities are rebuilt from the
    saved row logsumexp, ``p = exp(scale q k^T - lse)`` with the
    forward's mask (p = 0 on rows whose lse is -inf), then
    ``dvec = rowsum(dO * O) - dlse``, ``ds = p * (dO V^T - dvec)``,
    ``dq = scale ds K``, ``dk = ds^T (scale q)``, ``dv = p^T dO``, with
    dK and dV folded over each kv head's query group. All math in f32
    on a materialized [Sq, Sk] matrix; returns ``(dq, dk, dv)`` at the
    input dtypes, dK/dV at kv width."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = _gqa_group(q, k, v)
    scale = D ** -0.5
    qs = q.float().transpose(1, 2) * scale               # [B, H, Sq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    do = g.float().transpose(1, 2)
    s = torch.matmul(qs, kf.transpose(-1, -2))            # [B, H, Sq, Sk]
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        kp = k_offset + torch.arange(Sk, device=q.device)
        s = s.masked_fill(~banded_causal_mask(qp, kp, window), NEG_INF)
    row = lse.float()[..., None]                          # [B, H, Sq, 1]
    p = torch.where(torch.isfinite(row), torch.exp(s - row),
                    torch.zeros_like(s))
    dvec = (do * o.float().transpose(1, 2)).sum(-1)       # [B, H, Sq]
    if dlse is not None:
        dvec = dvec - dlse.float()
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - dvec[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)           # [B, H, Sk, D]
    dv = torch.matmul(p.transpose(-1, -2), do)
    dk = dk.unflatten(1, (Hkv, group)).sum(2)
    dv = dv.unflatten(1, (Hkv, group)).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _check_bwd_head_dim(D):
    """The backward kernels are built for `BWD_HEAD_DIMS` only: a CUDA
    backward at another head dim raises before any work, it never falls
    back to the plain backward."""
    if D not in BWD_HEAD_DIMS:
        raise ValueError(
            f"the flash backward kernels take head_dim "
            f"{' / '.join(map(str, BWD_HEAD_DIMS))}, got {D}; use "
            f"bwd_impl='recompute' for another head dim")


def _check_decode_group(kind, H, Hkv):
    if not 1 <= H // Hkv <= DECODE_MAX_GROUP:
        raise ValueError(f"{kind} kernel takes 1 to {DECODE_MAX_GROUP} "
                         f"query heads per kv head, got {H // Hkv}")


def _bwd_operands(q, k, v, g, lse, dvec):
    """Shared checks of the two backward kernel wrappers."""
    _check_bwd_head_dim(q.shape[-1])
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v), ("dO", g)))
    _gqa_group(q, k, v)
    B, Sq, H, D = q.shape
    if g.shape != q.shape:
        raise ValueError(f"dO shape {tuple(g.shape)} != q shape "
                         f"{tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("dvec", dvec)):
        if (t.dtype != torch.float32 or t.device != q.device
                or t.shape != (B, H, Sq) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"[B, H, Sq] = {(B, H, Sq)} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return B, Sq, k.shape[1], H, k.shape[2], D


def flash_bwd_dq_cuda(q, k, v, g, lse, dvec, *, causal: bool = False,
                      window: Optional[int] = None, q_offset: int = 0,
                      k_offset: int = 0):
    """Launch the dQ kernel (``csrc/flash_bwd_dq.cu``) on CUDA tensors:
    q and dO ``g`` [B, Sq, H, D], k/v [B, Sk, Hkv, D] (any strides with
    a contiguous, 16-byte aligned head_dim row), the
    forward's ``lse`` and ``dvec = rowsum(dO * O) - dlse``, both float32
    [B, H, Sq] contiguous. bf16 runs the tensor-core kernel (wgmma, TMA
    tensor maps over the operands' own strides), f32 the CUDA-core one.
    D 64, 128 or 256 (`BWD_HEAD_DIMS`); another head dim raises. Returns dq
    [B, Sq, H, D] at q.dtype."""
    B, Sq, Sk, H, Hkv, D = _bwd_operands(q, k, v, g, lse, dvec)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if Sk == 0:
        return dq.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "flash_bwd_dq", _DQ_ARGTYPES,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Sk, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *g.stride()[:3], *dq.stride()[:3], int(bool(causal)),
            0 if window is None else int(window), int(q_offset),
            int(k_offset), D ** -0.5, stream)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, g, lse, dvec, *, causal: bool = False,
                       window: Optional[int] = None, q_offset: int = 0,
                       k_offset: int = 0):
    """Launch the dK/dV kernel (``csrc/flash_bwd_dkv.cu``); operands and
    the bf16 (wgmma) / f32 (CUDA cores) split as `flash_bwd_dq_cuda`.
    Returns ``(dk, dv)`` [B, Sk, Hkv, D] at k.dtype, each folded over
    its query-head group."""
    B, Sq, Sk, H, Hkv, D = _bwd_operands(q, k, v, g, lse, dvec)
    dk = torch.empty((B, Sk, Hkv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    if Sq == 0 or H == 0:
        return dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "flash_bwd_dkv", _DKV_ARGTYPES,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Sk, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *g.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            int(bool(causal)), 0 if window is None else int(window),
            int(q_offset), int(k_offset), D ** -0.5, stream)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def _kernel_layout(t):
    """``t`` itself when the kernels can read it through its strides (a
    contiguous, 16-byte aligned head_dim row), else a contiguous copy:
    autograd may hand the backward a cotangent in any layout."""
    return t if t.stride(-1) == 1 and _rows_aligned(t) else t.contiguous()


def flash_backward(q, k, v, o, lse, g, *, causal: bool = False,
                   window: Optional[int] = None, q_offset: int = 0,
                   k_offset: int = 0, dlse=None):
    """``(dq, dk, dv)`` of flash attention from the forward's saved
    (q, k, v, out, lse) and the cotangents ``g`` of out and ``dlse`` of
    lse (None: no cotangent). CPU tensors take `flash_backward_plain`;
    CUDA tensors launch the dQ and dK/dV kernels (or raise: at a head
    dim outside `BWD_HEAD_DIMS`, before any work)."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, g, causal=causal,
                                    window=window, q_offset=q_offset,
                                    k_offset=k_offset, dlse=dlse)
    _check_bwd_head_dim(q.shape[-1])
    dvec = (g.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        dvec = dvec - dlse.float()
    dvec = dvec.contiguous()
    g = _kernel_layout(g)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              k_offset=k_offset)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, dvec, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, dvec, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``(out, lse)`` of flash attention, differentiable in both: the
    counterpart of the JAX package's `_make_flash_lse` custom VJP (and
    of `_make_flash` under ``bwd_impl="pallas"``). The forward runs the
    forward kernel and saves (q, k, v, out, lse); the backward runs the
    two backward kernels with ``dvec = rowsum(dO * O) - dlse``. On the
    CPU the same Function runs the plain forward and the plain
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, k_offset):
        out, lse = _flash_forward(q, k, v, causal, window, q_offset,
                                  k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, window=window, q_offset=q_offset,
                       k_offset=k_offset)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, dlse=dlse,
                                    **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def _recompute_ref(q, k, v, causal, window, q_offset, k_offset):
    """The JAX package's recompute oracle (`_make_flash.ref`): the
    blockwise online-softmax attention with K/V repeated to the query
    heads inside the differentiated function, so dK/dV come back at kv
    width."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return blockwise_attention(q, k, v, block_size=128, causal=causal,
                               window=window, q_offset=q_offset,
                               k_offset=k_offset)


class FlashRecomputeFn(torch.autograd.Function):
    """``bwd_impl="recompute"``: the forward kernel's output, with the
    gradient of `_recompute_ref` (autograd through the blockwise
    attention) as its backward — the JAX package's conservative
    escape hatch, an explicit choice and never a silent substitute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, k_offset):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (causal, window, q_offset, k_offset)
        return _flash_forward(q, k, v, causal, window, q_offset,
                              k_offset)[0]

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _recompute_ref(q, k, v, *ctx.cfg)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


BWD_IMPLS = ("auto", "pallas", "recompute")


def resolve_bwd_impl(bwd_impl: str) -> str:
    """``auto`` -> ``HOROVOD_FLASH_BWD`` when set (pallas|recompute;
    anything else raises, so a typo never selects the kernel being
    escaped), else ``pallas`` (the fused backward kernels)."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(
            f"bwd_impl must be auto|pallas|recompute, got {bwd_impl!r}")
    if bwd_impl != "auto":
        return bwd_impl
    env = env_raw("HOROVOD_FLASH_BWD")
    if env is not None and env not in ("pallas", "recompute"):
        raise ValueError(
            f"HOROVOD_FLASH_BWD must be pallas|recompute, got {env!r}")
    return env or "pallas"


def _check_args(q, k, v, causal, window):
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    check_window(window)
    _gqa_group(q, k, v)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        window: Optional[int] = None, q_offset: int = 0,
                        k_offset: int = 0):
    """Flash attention that also returns the row logsumexp:
    ``(out [B, Sq, H, D], lse [B, H, Sq] float32)``, lse -inf (and out
    0) on fully-masked rows. Causal masking uses global positions
    ``q_offset + i >= k_offset + j``; ``window`` (requires causal)
    keeps only the last ``window`` positions. GQA-native: K/V may carry
    fewer heads than Q. Differentiable in both outputs through the
    fused backward (`FlashAttentionFn`)."""
    _check_args(q, k, v, causal, window)
    return FlashAttentionFn.apply(q, k, v, bool(causal),
                                  None if window is None else int(window),
                                  int(q_offset), int(k_offset))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask=None, *, causal: bool = False,
                    window: Optional[int] = None, q_offset: int = 0,
                    k_offset: int = 0, bwd_impl: str = "auto") -> torch.Tensor:
    """Fused flash attention, [B, S, H, D] -> [B, S, H, D] (output at
    q.dtype, f32 math). ``mask`` is accepted positionally as None only
    (causal/window masking only), so the function drops in as
    `ParallelSelfAttention`'s ``attn_fn``. ``bwd_impl``: "auto" (the
    fused backward kernels unless ``HOROVOD_FLASH_BWD`` says
    otherwise), "pallas" (the fused backward kernels) or "recompute"
    (autograd through the blockwise attention)."""
    if mask is not None:
        raise NotImplementedError(
            "flash_attention supports causal masking only; use "
            "dot_product_attention for arbitrary masks")
    _check_args(q, k, v, causal, window)
    args = (q, k, v, bool(causal), None if window is None else int(window),
            int(q_offset), int(k_offset))
    if resolve_bwd_impl(bwd_impl) == "recompute":
        return FlashRecomputeFn.apply(*args)
    return FlashAttentionFn.apply(*args)[0]


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


# Keys a decode split holds at least and, unless more splits are needed
# to fill the card, at most; and the split blocks resident on one SM
# (``csrc/decode_split.cuh``: 256 threads of ~120 registers, two a SM).
DECODE_MIN_SPLIT_KEYS = 256
DECODE_MAX_SPLIT_KEYS = 512
DECODE_BLOCKS_PER_SM = 2


def decode_splits(W: int, pairs: int, n_sm: int) -> int:
    """Key ranges the decode kernels (linear and paged) split each lane's
    cache of ``W`` keys into, for ``pairs`` (kv heads x lanes) blocks on
    ``n_sm`` SMs: splits of at most 512 keys, and more, down to 256 keys,
    where the split blocks of full lanes would not yet fill the card's
    resident slots (``DECODE_BLOCKS_PER_SM`` a SM) once. Never so many
    that full lanes spill a second, partial wave: at 8 lanes x 8 kv heads
    x 2048 that gives 4 splits, 256 blocks on 132 SMs; 5 would run 320
    blocks as 264 and then 56. Lanes shorter than W leave their later
    splits empty, and an empty split block only writes an empty partial,
    so the 512-key cap keeps ragged lanes short per block. Picked from
    the cache width, never from the lanes' lengths: reading those on the
    host would sync the tick."""
    by_width = W // DECODE_MAX_SPLIT_KEYS
    by_card = min(W // DECODE_MIN_SPLIT_KEYS,
                  DECODE_BLOCKS_PER_SM * n_sm // pairs)
    return max(1, by_width, by_card)


def flash_decode_split_plain(q, k_cache, v_cache, length, splits: int):
    """The decode kernel's arithmetic in PyTorch: split the cache into
    ``splits`` key ranges of ceil(W / splits), form each range's
    partial softmax state (row max m_s, row sum l_s, unnormalized o_s)
    over the lane's filled prefix, and merge them in f32, skipping
    empty ranges: ``o = sum e^(m_s - M) o_s / sum e^(m_s - M) l_s``
    with M = max m_s. A lane with length 0 gets zeros. Returns
    [B, 1, H, D] at q.dtype."""
    B, W, H, Hkv, D = _decode_shapes(q, k_cache, v_cache)
    grp = H // Hkv
    chunk = -(-W // splits)
    pad = splits * chunk - W
    qf = q[:, 0].float() * D ** -0.5                     # [B, H, D]
    kf = k_cache.float().repeat_interleave(grp, dim=2)
    vf = v_cache.float().repeat_interleave(grp, dim=2)
    s = torch.einsum("bhd,bwhd->bhw", qf, kf)            # [B, H, W]
    valid = torch.arange(W, device=q.device)[None, :] < length[:, None]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    s = s.unflatten(-1, (splits, chunk))                 # [B, H, NS, c]
    vf = torch.nn.functional.pad(vf.transpose(1, 2), (0, 0, 0, pad))
    vf = vf.unflatten(2, (splits, chunk))                # [B, H, NS, c, D]
    m = s.amax(-1)                                       # [B, H, NS]
    empty = m == NEG_INF
    p = torch.exp(s - torch.where(empty, 0.0, m)[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhsc,bhscd->bhsd", p, vf)
    top = m.amax(-1, keepdim=True)                       # [B, H, 1]
    wt = torch.where(empty, 0.0, torch.exp(m - torch.where(
        top == NEG_INF, 0.0, top)))
    den = (wt * l).sum(-1, keepdim=True)
    out = (wt[..., None] * o).sum(2) / torch.where(den == 0, 1.0, den)
    return out[:, None].to(q.dtype)


def flash_decode_cuda(q, k_cache, v_cache, length, *,
                      splits: Optional[int] = None):
    """Launch the flash-decode kernels (``csrc/flash_decode.cu``: the
    split kernel, then the merge of its partials):
    q [B, 1, H, D] (strided, 16-byte aligned rows with a contiguous
    head_dim), caches [B, W, Hkv, D] contiguous, ``length`` a device
    int32 tensor [B] (per-lane filled prefix). D must be 64, 128 or 256
    and H/Hkv 1 to 8 (`DECODE_MAX_GROUP`). ``splits`` (default:
    `decode_splits` of the geometry) is how many key ranges each lane's
    cache is cut into; the partials go to a workspace allocated here on
    the current stream."""
    B, W, H, Hkv, D = _decode_shapes(q, k_cache, v_cache)
    _check_kernel_inputs(q, (("q", q), ("k_cache", k_cache),
                             ("v_cache", v_cache)))
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash-decode caches must be contiguous")
    _check_decode_group("flash-decode", H, Hkv)
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
    if splits is None:
        splits = decode_splits(W, Hkv * B, _sm_count(q.device))
    elif splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    ws = torch.empty(splits * B * H * (D + 2), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _lib_call(
            "flash_decode", _DECODE_ARGTYPES,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), out.data_ptr(), ws.data_ptr(),
            _DTYPE_CODE[q.dtype], B, W, H, Hkv, D, splits, q.stride(0),
            q.stride(2), D ** -0.5, stream)
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def _sm_count(device) -> int:
    """The card's SM count (PyTorch caches the device properties)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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

