"""The transformer's layers, tensor parallel over the ``model`` axis:
dense pairs, MLPs, rotary embeddings and self-attention with its
decode-cache paths.

Counterpart of `horovod_tpu.parallel.tensor`. The JAX package marks
each kernel with its partition spec and lets GSPMD place it and insert
the collectives; the port is SPMD, so each layer built with ``tp`` > 1
holds THIS rank's shard and names its collectives (Megatron-LM's
layout, `ops.collectives`):

* `ColumnParallelDense`: kernel [in, out/tp] and its bias slice, the
  input through f (`copy_to_model`: identity forward, gradient summed
  over ``model`` backward);
* `RowParallelDense`: kernel [in/tp, out], its product through g
  (`reduce_from_model`: sum over ``model`` forward), the bias added once
  after the reduction;
* `ParallelSelfAttention`: H/tp query heads a rank, and the kv heads
  those heads read (`kv_heads_of`): Hkv/tp when tp divides Hkv, else
  the one kv head its query group shares. Its fused qkv shard is this
  rank's q columns, then its k and its v columns (`qkv_columns`), not
  a contiguous block of the fused dim.

`param_specs` gives the JAX package's spec of every parameter,
`shard_params` cuts a full state dict into a rank's shard and
`gather_params` reassembles it. With ``tp`` = 1 (the default) no
weight is sharded and no collective runs. Dense kernels keep the JAX
package's [in, out] layout, so `compat.from_jax.params_from_jax` maps
the flax tree one to one.

Decode state is explicit: a `LayerCache` carries one layer's K/V rows
[B, W, Hkv, D] and the per-lane fill index [B] (int32, on the device).
The attention writes this call's K/V rows into the cache IN PLACE (the
port updates where JAX returned a new cache); advancing the index is
the caller's job, once per model call, so every layer reads the same
fill. Under ``kv_quant="int8"`` the rows are int8 codes with one f32
scale per (lane, position, head) beside them (`_kv_quantize`), and
every read dequantizes at the module dtype. Under a ``window`` the
cache is a ROLLING buffer of W = window slots (position p lives in
slot p mod W), so with RoPE a lane's position grows past max_len.
Under tensor parallelism the cache holds the rank's kv heads only, and
the decode kernels run on its local heads.

Weights: ``weight_quant="int8"`` stores each dense kernel as int8
codes plus one f32 scale per output channel (`ops.quantization`),
dequantized at the module dtype before the product.

A `PagedLayerCache` is the paged form: the shared block pools
[num_blocks, block_size, Hkv, D], every lane's block table and true
fill, and where this call's rows land. Attention then reads the pools
through the tables (`ops.paged_attention`) and writes the new rows
into their blocks afterwards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.quantization import (check_quant,
                                                dequantize_int8,
                                                quantize_int8)
from horovod_tpu_torch.parallel.mesh import AXIS_EXPERT, AXIS_MODEL, seq_offset
from horovod_tpu_torch.parallel.sequence import (banded_causal_mask,
                                                 check_window)


def _native_gqa(fn) -> bool:
    """True when ``fn`` declares it consumes grouped K/V natively (the
    ``native_gqa`` marker of the flash kernels)."""
    while hasattr(fn, "func"):
        fn = fn.func
    return bool(getattr(fn, "native_gqa", False))


def lecun_normal_(t: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default Dense init: truncated normal, variance 1/fan_in
    (fan_in = dim 0 of an [in, out] kernel)."""
    std = 1.0 / math.sqrt(t.shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def _split(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise ValueError(f"{what} ({n}) does not split over tp={tp} "
                         f"model ranks")
    return n // tp


class _Dense(nn.Module):
    """``x @ kernel (+ bias)`` at the module dtype; kernel [in, out] is
    stored f32 (or pre-cast by `serving_params`) and cast at use, the
    bias stays f32 and is cast at use. Under ``weight_quant="int8"``
    the kernel is the buffers ``kernel_q`` (int8 [in, out]) and
    ``kernel_scale`` (f32 [out]), dequantized at the module dtype
    before the product, as the JAX package's ``_dense_kernel`` does
    (scaling after the product would not be bitwise the same). The
    shapes given are this rank's (the subclasses cut them)."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, dtype=None,
                 weight_quant: Optional[str] = None, device=None):
        super().__init__()
        self.dtype = dtype
        if check_quant("weight_quant", weight_quant):
            self.kernel = None
            self.register_buffer("kernel_q", torch.zeros(
                in_features, features, dtype=torch.int8, device=device))
            self.register_buffer("kernel_scale",
                                 torch.ones(features, device=device))
        else:
            self.kernel = nn.Parameter(
                torch.empty(in_features, features, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator=None):
        """lecun-normal kernel and zero bias; an int8 kernel is set to
        zero codes and unit scales (real values come from
        `ops.quantization.quantize_lm`)."""
        if self.kernel is None:
            self.kernel_q.zero_()
            self.kernel_scale.fill_(1.0)
        else:
            lecun_normal_(self.kernel.data, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def _weight(self, dt):
        return (self.kernel.to(dt) if self.kernel is not None else
                dequantize_int8(self.kernel_q, self.kernel_scale, dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = x.to(dt) @ self._weight(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ColumnParallelDense(_Dense):
    """Dense with the kernel's output dim sharded over ``axis``: this
    rank holds kernel [in, features/tp] and its bias slice, and its
    input passes f (`copy_to_model`) so the input's gradient is summed
    over the ranks."""

    def __init__(self, in_features: int, features: int, *,
                 axis: str = AXIS_MODEL, tp: int = 1, **kw):
        super().__init__(in_features,
                         _split(features, tp, "column features"), **kw)
        self.axis, self.tp = axis, tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp > 1:
            from horovod_tpu_torch.ops.collectives import copy_to_model
            x = copy_to_model(x, self.axis)
        return super().forward(x)


class _HalfProductF32(torch.autograd.Function):
    """``x @ w`` of two bf16 / f16 CUDA operands, accumulated and
    returned in f32 by one GEMM on the tensor cores
    (``torch.mm(..., out_dtype=torch.float32)``). The backward's
    products run at the operands' dtype, as the unsharded layer's do:
    the incoming gradient comes through a cast of this output to that
    dtype, so it is exact in it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = (x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32 from operands of one dtype: the product itself
    at f32, on the tensor cores for half CUDA operands
    (`_HalfProductF32`), else through an f32 upcast (a bf16 or f16
    product is exact in f32)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return _HalfProductF32.apply(x, w)
    return x.float() @ w.float()


class RowParallelDense(_Dense):
    """Dense with the kernel's input dim sharded over ``axis``: this
    rank holds kernel [in/tp, features]; the partial products are summed
    over the ranks by g (`reduce_from_model`), and the (replicated)
    bias is added once, after the reduction. Each partial product is
    kept in f32 (`f32_product`), summed in f32 and rounded to the
    module dtype once, after the sum, as the unsharded product rounds
    its f32 accumulator once."""

    def __init__(self, in_features: int, features: int, *,
                 axis: str = AXIS_MODEL, tp: int = 1, **kw):
        super().__init__(_split(in_features, tp, "row features"),
                         features, **kw)
        self.axis, self.tp = axis, tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.tp > 1:
            from horovod_tpu_torch.ops.collectives import reduce_from_model
            y = f32_product(x.to(dt), self._weight(dt))
            y = reduce_from_model(y, self.axis).to(dt)
        else:
            y = x.to(dt) @ self._weight(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ParallelMLP(nn.Module):
    """Transformer MLP block: up (``wi``), tanh-gelu, down (``wo``),
    both with biases (flax's `nn.gelu` default is the tanh form)."""

    def __init__(self, d: int, hidden: int, out: int, *, dtype=None,
                 weight_quant: Optional[str] = None, device=None,
                 tp: int = 1):
        super().__init__()
        kw = dict(dtype=dtype, weight_quant=weight_quant, device=device,
                  tp=tp)
        self.wi = ColumnParallelDense(d, hidden, **kw)
        self.wo = RowParallelDense(hidden, out, **kw)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class ParallelSwiGLU(nn.Module):
    """LLaMA-family MLP: ``down(act(gate(x)) * up(x))``, no biases;
    act is silu (SwiGLU) or tanh-gelu (Gemma GeGLU)."""

    def __init__(self, d: int, hidden: int, out: int, *, dtype=None,
                 activation: str = "silu",
                 weight_quant: Optional[str] = None, device=None,
                 tp: int = 1):
        super().__init__()
        if activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"activation must be silu|gelu_tanh, got "
                             f"{activation!r}")
        self.activation = activation
        kw = dict(use_bias=False, dtype=dtype, weight_quant=weight_quant,
                  device=device, tp=tp)
        self.gate = ColumnParallelDense(d, hidden, **kw)
        self.up = ColumnParallelDense(d, hidden, **kw)
        self.down = RowParallelDense(hidden, out, **kw)

    def forward(self, x):
        g = self.gate(x)
        act = (F.silu(g) if self.activation == "silu"
               else F.gelu(g, approximate="tanh"))
        return self.down(act * self.up(x))


@dataclass
class LayerCache:
    """One layer's decode cache: K/V rows [B, W, Hkv, D] and the
    per-lane fill index [B] int32 (positions < index are filled); under
    int8 KV the rows are int8 and ``k_scale``/``v_scale`` [B, W, Hkv]
    f32 hold their scales. W is max_len, or the window of a rolling
    cache."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class PagedLayerCache:
    """One layer's view of a paged KV cache: the block pools
    ``k_pool``/``v_pool`` [num_blocks, block_size, Hkv, D] shared by
    every lane, the lanes' block tables ``table`` [L, T] and true fills
    ``fill`` [L] (int32, on the device), and the block id / in-block
    offset [L, S] (int64) where each lane's new rows are written after
    attention (masked lanes name the null block 0). ``decode_impl``
    overrides the module's ``decode_prefix_impl`` (None keeps it).
    Under int8 KV the pools are int8 and ``k_scale_pool`` /
    ``v_scale_pool`` [num_blocks, block_size, Hkv] f32 hold the
    scales."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    table: torch.Tensor
    fill: torch.Tensor
    write_block: torch.Tensor
    write_off: torch.Tensor
    decode_impl: Optional[str] = None
    k_scale_pool: Optional[torch.Tensor] = None
    v_scale_pool: Optional[torch.Tensor] = None


class ParallelSelfAttention(nn.Module):
    """Multi-head self-attention (GQA when ``num_kv_heads`` < heads),
    its heads sharded over ``model`` when ``tp`` > 1: rank
    ``tp_rank`` runs query heads [r H/tp, (r+1) H/tp) and the kv heads
    they read (`kv_heads_of`), end to end through the softmax and the
    decode caches; the output projection is row parallel (one g a
    block). ``num_heads`` / ``num_kv_heads`` then read this rank's
    counts, ``heads_total`` / ``kv_total`` the layer's.

    ``attn_fn`` plugs in the inner attention (None = the dot baseline,
    which takes the explicit mask). Called with a `LayerCache`, the
    module runs decode mode:

    * S > 1 and not ``chunked_prefill`` — ONE-PASS PREFILL from an
      EMPTY cache (`generate`'s prompt): the rows are written and the
      block attends causally to itself through ``attn_fn`` (flash);
    * otherwise rows are written at each lane's fill and the query
      attends the filled prefix: through the flash-decode kernel for
      S == 1 under ``decode_prefix_impl="pallas"``, else the plain
      prefix loop (`_prefix_attention`), or the cache-wide mask when
      ``decode_prefix_block`` does not divide the cache.

    Called with a `PagedLayerCache`, it runs the paged form
    (`_paged_decode_attention`). Under a sliding ``window`` the cache is
    the rolling buffer: the one-pass prefill writes the block's last
    min(S, W) rows and attends the block banded through ``attn_fn``;
    every other call attends the cache plus its own rows before
    writing (`_rolling_attention`). A cache with scales (int8 KV,
    `LayerCache.k_scale`) keeps the kernels off: the plain loop and
    the walk dequantize per block, as in the JAX package.
    """

    def __init__(self, num_heads: int, head_dim: int, *, dtype=None,
                 attn_fn: Optional[Callable] = None,
                 num_kv_heads: Optional[int] = None, pos_emb: str = "none",
                 rope_theta: float = 10000.0, window: Optional[int] = None,
                 decode_prefix_block: Optional[int] = 256,
                 decode_prefix_impl: str = "lax", use_bias: bool = False,
                 out_bias: Optional[bool] = None,
                 weight_quant: Optional[str] = None, device=None,
                 tp: int = 1, tp_rank: int = 0):
        super().__init__()
        H = num_heads
        Hkv = num_kv_heads or H
        if H % Hkv:
            raise ValueError(
                f"num_heads={H} not divisible by num_kv_heads={Hkv}")
        check_window(window)
        if decode_prefix_impl not in ("lax", "pallas"):
            raise ValueError(f"decode_prefix_impl must be lax|pallas, got "
                             f"{decode_prefix_impl!r}")
        # The whole layer's head counts, and this rank's: num_heads /
        # num_kv_heads are the LOCAL counts every path below runs on.
        self.heads_total, self.kv_total = H, Hkv
        self.tp, self.tp_rank = tp, tp_rank
        kv = kv_heads_of(tp_rank, H, Hkv, tp)
        self.num_heads, self.num_kv_heads = H // tp, len(kv)
        self.head_dim = head_dim
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.pos_emb = pos_emb
        self.rope_theta = rope_theta
        self.window = window
        self.decode_prefix_block = decode_prefix_block
        self.decode_prefix_impl = decode_prefix_impl
        features = H * head_dim
        local = (self.num_heads + 2 * self.num_kv_heads) * head_dim
        self.qkv = ColumnParallelDense(
            features, local * tp, use_bias=use_bias, dtype=dtype,
            weight_quant=weight_quant, device=device, tp=tp)
        ob = use_bias if out_bias is None else out_bias
        self.out = RowParallelDense(features, features, use_bias=ob,
                                    dtype=dtype, weight_quant=weight_quant,
                                    device=device, tp=tp)
        if tp > 1 and Hkv % tp:
            # Several ranks hold the same kv head: each one's k/v weight
            # gradient is the part its own query heads contribute, so
            # the parts are summed over the ranks that share the head.
            for p in (self.qkv.kernel, self.qkv.bias):
                if p is not None:
                    p.register_hook(self._sum_shared_kv_grad)

    def _sum_shared_kv_grad(self, grad: torch.Tensor) -> torch.Tensor:
        """The qkv weight gradient with its k/v columns summed over the
        model ranks holding the same kv head: each rank scatters its
        part into a [..., 2, Hkv, D] buffer, one all-reduce over
        ``model`` sums it, and each reads back its head."""
        from horovod_tpu_torch.ops.collectives import reduce_from_model
        D, q = self.head_dim, self.num_heads * self.head_dim
        (h,) = kv_heads_of(self.tp_rank, self.heads_total, self.kv_total,
                           self.tp)
        kv = grad[..., q:].unflatten(-1, (2, D))
        buf = grad.new_zeros(*grad.shape[:-1], 2, self.kv_total, D)
        buf[..., h, :] = kv
        summed = reduce_from_model(buf)[..., h, :].flatten(-2)
        return torch.cat([grad[..., :q], summed], dim=-1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cache: Optional[LayerCache] = None,
                chunked_prefill: bool = False,
                prefix_len: Optional[int] = None) -> torch.Tensor:
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        F_, Fkv = H * D, Hkv * D
        qkv = self.qkv(x)
        lead = qkv.shape[:-1]
        q = qkv[..., :F_].unflatten(-1, (H, D))
        k = qkv[..., F_:F_ + Fkv].unflatten(-1, (Hkv, D))
        v = qkv[..., F_ + Fkv:].unflatten(-1, (Hkv, D))
        if cache is not None:
            o = self._decode_attention(q, k, v, cache, chunked_prefill,
                                       prefix_len)
        else:
            # Global positions: under a mesh with seq > 1 this rank's
            # block starts at its seq coordinate times the block length.
            S = q.shape[-3]
            pos = seq_offset(S) + torch.arange(S, device=q.device)
            q, k = self._maybe_rope(q, k, pos)
            o = self._dispatch_attn(q, k, v, mask)
        return self.out(o.reshape(*lead, F_))

    def _maybe_rope(self, q, k, positions):
        if self.pos_emb != "rope":
            return q, k
        return (apply_rope(q, positions, self.rope_theta),
                apply_rope(k, positions, self.rope_theta))

    def _repeat_kv(self, t: torch.Tensor) -> torch.Tensor:
        """Broadcast Hkv heads to the H query heads (head axis -2)."""
        reps = self.num_heads // self.num_kv_heads
        return t if reps == 1 else t.repeat_interleave(reps, dim=-2)

    def _dispatch_attn(self, q, k, v, mask):
        """THE attn_fn / native-GQA / dot dispatch (forward and
        one-pass prefill both route through here)."""
        if self.attn_fn is not None:
            if _native_gqa(self.attn_fn):
                return self.attn_fn(q, k, v, mask)
            return self.attn_fn(q, self._repeat_kv(k), self._repeat_kv(v),
                                mask)
        return dot_product_attention(q, self._repeat_kv(k),
                                     self._repeat_kv(v), mask)

    def _causal_block_attn(self, q, k, v):
        """Causal(+window) attention over the current block alone."""
        if self.attn_fn is not None:
            return self._dispatch_attn(q, k, v, None)
        pos = torch.arange(q.shape[-3], device=q.device)
        m = banded_causal_mask(pos, pos, self.window)[None, None]
        return self._dispatch_attn(q, k, v, m)

    def _cache_read(self, rows, scale):
        """Cache rows at the compute dtype: as stored, or dequantized at
        the module dtype under int8 KV (never straight to f32: the
        reference dequantizes at the module dtype)."""
        if scale is None:
            return rows
        return dequantize_int8(rows, scale, self.dtype or torch.float32,
                               axis=-1)

    def _cache_write(self, cache: LayerCache, k, v, S: int):
        """Write S new K/V rows at each lane's fill (in place), through
        the int8 codec under ``kv_quant`` (the scales land in the same
        rows). Linear cache: the start clamps to W - S like
        `lax.dynamic_update_slice`, so a lane ticked past its budget (a
        pipelined tick behind retirement) overwrites its own last row
        instead of faulting. Rolling cache: the last min(S, W) rows land
        in their slots, position mod W (earlier ones would be
        overwritten within the block anyway)."""
        B, W = cache.k.shape[:2]
        dev = cache.index.device
        lanes = torch.arange(B, device=dev)[:, None]
        if self.window is None:
            start = cache.index.clamp(max=W - S).long()
            rows = start[:, None] + torch.arange(S, device=dev)
        else:
            t = min(S, W)
            rows = (cache.index[:, None].long()
                    + torch.arange(S - t, S, device=dev)) % W
            k, v = k[:, S - t:], v[:, S - t:]
        for store, scale, new in ((cache.k, cache.k_scale, k),
                                  (cache.v, cache.v_scale, v)):
            if scale is None:
                store[lanes, rows] = new.to(store.dtype)
            else:
                store[lanes, rows], scale[lanes, rows] = _kv_quantize(new)

    def _prefix_attention(self, q, cache: LayerCache, S: int,
                          prefix_len: Optional[int] = None):
        """Attention of S new queries against each lane's filled prefix.

        ``decode_prefix_impl="pallas"`` with S == 1: the flash-decode
        kernel (`ops.flash_attention.flash_decode_attention`), with the
        per-lane lengths as a device int32 tensor — no host sync.
        Otherwise the plain prefix loop, the `lax.fori_loop` of the JAX
        package in f32 online-softmax form: q scaled in the compute
        dtype, p rounded to the cache dtype before P.V.

        The loop reads ceil(prefix_len / block) slices of
        ``decode_prefix_block`` rows, as the JAX package's data-dependent
        trip count does. ``prefix_len`` is the caller's host-side upper
        bound on every lane's fill after this call (the slot pool and
        `generate` track it), so no host sync reads the device index.
        Without it the loop runs over every slice of the cache. Either
        way the result is the same: a slice wholly past a lane's fill is
        masked to the f32 minimum, which leaves that lane's m, l and acc
        bit-for-bit unchanged (alpha = 1, p = 0). Under int8 KV the
        kernel stays off, as in the JAX package: the loop dequantizes
        each slice at the module dtype."""
        i = cache.index
        W = cache.k.shape[1]
        if (self.decode_prefix_impl == "pallas" and S == 1
                and cache.k_scale is None):
            from horovod_tpu_torch.ops.flash_attention import (
                flash_decode_attention)
            length = (i + S).clamp(max=W).to(torch.int32)
            return flash_decode_attention(q, cache.k, cache.v, length)
        blk = min(self.decode_prefix_block, W)
        B, _, H, D = q.shape
        dtype = q.dtype
        dev = q.device
        qs = (q * torch.tensor(D ** -0.5, dtype=dtype)).float()
        qpos = i[:, None].long() + torch.arange(S, device=dev)   # [B, S]
        neg = torch.finfo(torch.float32).min
        m = torch.full((B, H, S), neg, device=dev)
        l = torch.zeros(B, H, S, device=dev)
        acc = torch.zeros(B, H, S, D, device=dev)
        stop = W if prefix_len is None else min(W, max(1, prefix_len))

        def read(rows, scale, start):
            return self._repeat_kv(self._cache_read(
                rows[:, start:start + blk],
                None if scale is None else scale[:, start:start + blk]))

        for start in range(0, stop, blk):
            kb = read(cache.k, cache.k_scale, start)
            vb = read(cache.v, cache.v_scale, start)
            logits = torch.einsum("bqhd,bkhd->bhqk", qs, kb.float())
            kvpos = start + torch.arange(blk, device=dev)
            keep = kvpos[None, None, :] <= qpos[:, :, None]   # [B, S, blk]
            logits = torch.where(keep[:, None], logits, neg)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / l[..., None]
        return out.transpose(1, 2).to(dtype)

    def _paged_decode_attention(self, q, k, v, cache: PagedLayerCache,
                                prefix_len: Optional[int] = None):
        """Decode/prefill attention against a PAGED cache. RoPE rotates
        at each lane's true fill; the call's K/V rows, through the
        pool's codec (cast to the pool dtype, or int8-quantized and read
        back dequantized at the module dtype: the bytes a gathered view
        would hold), are merged into the walked blocks, and written into
        their blocks only after attention. S == 1 under
        ``decode_prefix_impl="pallas"`` runs the paged-decode kernel
        (`ops.paged_attention.paged_decode_attention`) unless the pools
        are int8; everything else walks the table at
        ``decode_prefix_block`` granularity (`paged_prefix_attention`,
        its trip count bounded by ``prefix_len``)."""
        from horovod_tpu_torch.ops.paged_attention import (
            paged_decode_attention, paged_prefix_attention)
        S = q.shape[1]
        pos = cache.fill[:, None].long() + torch.arange(S, device=q.device)
        q, k = self._maybe_rope(q, k, pos)
        quant = cache.k_scale_pool is not None
        if quant:
            (k_st, k_sc), (v_st, v_sc) = _kv_quantize(k), _kv_quantize(v)
            k_new, v_new = (self._cache_read(k_st, k_sc),
                            self._cache_read(v_st, v_sc))
        else:
            k_st = k_new = k.to(cache.k_pool.dtype)
            v_st = v_new = v.to(cache.v_pool.dtype)
        bs = cache.k_pool.shape[1]
        span = cache.table.shape[1] * bs
        blk = self.decode_prefix_block
        wb = min(int(blk), span) if blk else 0
        if cache.decode_impl == "pallas":
            # The pool's "pallas" mode accepts any model geometry, as
            # the JAX pool does (it walks at the block size): S > 1
            # chunks walk at decode_prefix_block where it tiles the
            # table, else at the block size.
            if not wb or wb % bs or span % wb:
                wb = bs
        elif not blk:
            raise ValueError(
                "paged-kernel decode requires decode_prefix_block "
                "(the walk granularity); got 0/None")
        elif wb % bs or span % wb:
            raise ValueError(
                f"paged-kernel decode needs decode_prefix_block "
                f"({blk}) to be a multiple of the KV block size "
                f"({bs}) and to divide max_len ({span})")
        impl = cache.decode_impl or self.decode_prefix_impl
        if impl == "pallas" and S == 1 and not quant:
            out = paged_decode_attention(
                q[:, 0], k_new[:, 0], v_new[:, 0], cache.table,
                cache.fill, cache.k_pool, cache.v_pool)[:, None]
        else:
            out = paged_prefix_attention(
                q, k_new, v_new, cache.k_pool, cache.v_pool, cache.table,
                cache.fill, walk_block=wb, prefix_len=prefix_len,
                k_scale_pool=cache.k_scale_pool,
                v_scale_pool=cache.v_scale_pool,
                compute_dtype=self.dtype or torch.float32)
        at = (cache.write_block, cache.write_off)
        cache.k_pool[at] = k_st
        cache.v_pool[at] = v_st
        if quant:
            cache.k_scale_pool[at] = k_sc
            cache.v_scale_pool[at] = v_sc
        return out

    def _rolling_attention(self, q, k, v, cache: LayerCache, qpos):
        """The rolling window cache's any-fill path (S = 1 ticks and the
        engine's chunked prefill). It attends BEFORE writing (a
        same-call write could evict the oldest key still inside an
        earlier query row's band), over the W cache slots (dequantized
        under int8 KV) followed by the call's RAW rows, under
        `rolling_keep`; then the rows are written."""
        W = cache.k.shape[1]
        keep = rolling_keep(cache.index, qpos, W, self.window)
        key = torch.cat([self._cache_read(cache.k, cache.k_scale), k], 1)
        val = torch.cat([self._cache_read(cache.v, cache.v_scale), v], 1)
        out = dot_product_attention(q, self._repeat_kv(key),
                                    self._repeat_kv(val), keep[:, None])
        self._cache_write(cache, k, v, q.shape[1])
        return out

    def _decode_attention(self, q, k, v, cache: LayerCache,
                          chunked_prefill: bool,
                          prefix_len: Optional[int] = None):
        if isinstance(cache, PagedLayerCache):
            return self._paged_decode_attention(q, k, v, cache,
                                                prefix_len)
        S = q.shape[1]
        W = cache.k.shape[1]
        pos = cache.index[:, None].long() + torch.arange(S, device=q.device)
        # Keys enter the cache already rotated at their absolute
        # position, so the prefix never needs re-rotation.
        q, k = self._maybe_rope(q, k, pos)
        if S > 1 and not chunked_prefill:
            # One-pass prefill; contract: the cache was EMPTY (index 0),
            # so attending the cached prefix equals causal (+window)
            # attention over this block alone, on its raw rows — the
            # model's kernel (flash) runs it. Like the JAX package under
            # jit, the contract is not re-checked here (that would read
            # the device index).
            self._cache_write(cache, k, v, S)
            return self._causal_block_attn(q, k, v)
        if self.window is not None:
            return self._rolling_attention(q, k, v, cache, pos)
        # Write first, then attend the (dequantized) cache: the
        # current rows read back through the codec later ticks see.
        self._cache_write(cache, k, v, S)
        blk = self.decode_prefix_block
        if blk and W % min(blk, W) == 0:
            return self._prefix_attention(q, cache, S, prefix_len)
        keep = banded_causal_mask(pos, torch.arange(W, device=q.device))
        return dot_product_attention(
            q, self._repeat_kv(self._cache_read(cache.k, cache.k_scale)),
            self._repeat_kv(self._cache_read(cache.v, cache.v_scale)),
            keep[:, None])


def rolling_keep(index: torch.Tensor, qpos: torch.Tensor, W: int,
                 window: int) -> torch.Tensor:
    """[B, S, W + S] bool: which of a rolling cache's W slots and the
    call's S rows each query attends, per lane. ``index`` [B] is the
    lane's fill before the call, ``qpos`` [B, S] its query positions.
    Slot s holds the newest position <= index - 1 congruent to s mod W
    (negative, or an empty lane: never written); every position obeys
    the band rule (`banded_causal_mask`)."""
    last = index[:, None].long() - 1
    slot_pos = last - ((last - torch.arange(W, device=index.device)) % W)
    valid = (last >= 0) & (slot_pos >= 0)
    keep = banded_causal_mask(qpos, torch.cat([slot_pos, qpos], 1),
                              window)
    return keep & torch.cat([valid, torch.ones_like(qpos, dtype=torch.bool)],
                            1)[:, None, :]


def _kv_quantize(t: torch.Tensor):
    """The KV-cache codec (``kv_quant="int8"``): symmetric int8 over the
    head dim, one f32 scale per (..., position, head), through
    `ops.quantization.quantize_int8`."""
    return quantize_int8(t, axis=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (Su et al. 2021), half-split layout.

    ``x`` [..., S, H, D] with D even; ``positions`` [S] or per-lane
    [B, S] absolute token positions. Computed in f32, returned at
    x.dtype."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs            # [.., S, half]
    cos = torch.cos(angles)[..., None, :]                    # [.., S, 1, h]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention, [..., seq, heads, head_dim] layout; the
    masked logits take the dtype's minimum (not -inf), as in the JAX
    package."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...qhd,...khd->...hqk", q * scale, k)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


# ---------------------------------------------------------------------------
# Tensor-parallel layout: which heads a rank holds, the specs, and the
# cut of a full state dict into a rank's shard (and back).
# ---------------------------------------------------------------------------

def kv_heads_of(rank: int, num_heads: int, num_kv_heads: int,
                tp: int) -> list:
    """The kv heads that model rank ``rank`` of ``tp`` holds: Hkv/tp
    contiguous heads when tp divides Hkv, else the ONE kv head its H/tp
    query heads share, (r H/tp) // (H/Hkv) (MQA, or Gemma-2B's one kv
    head over two ranks). A layout where a rank's query heads would span
    kv heads unevenly raises before any work."""
    H, Hkv = num_heads, num_kv_heads
    if tp < 1 or H % tp:
        raise ValueError(f"num_heads={H} does not split over tp={tp} "
                         f"model ranks")
    if Hkv % tp == 0:
        n = Hkv // tp
        return list(range(rank * n, (rank + 1) * n))
    group, local = H // Hkv, H // tp
    if group % local:
        raise ValueError(
            f"tp={tp}: {local} query heads a rank straddle the groups of "
            f"{group} query heads per kv head (num_heads={H}, "
            f"num_kv_heads={Hkv})")
    return [rank * local // group]


def qkv_columns(rank: int, num_heads: int, num_kv_heads: int,
                head_dim: int, tp: int) -> torch.Tensor:
    """The columns of the fused qkv dim [(H + 2 Hkv) D] that rank
    ``rank`` holds, in its local order: its q heads, then its kv heads'
    k columns, then their v columns. (A contiguous block of the fused
    dim would mix q heads with k heads.)"""
    H, Hkv, D = num_heads, num_kv_heads, head_dim
    local = H // tp
    ar = torch.arange(D)
    kv = kv_heads_of(rank, H, Hkv, tp)
    q = torch.arange(rank * local * D, (rank + 1) * local * D)
    k = [H * D + h * D + ar for h in kv]
    v = [(H + Hkv) * D + h * D + ar for h in kv]
    return torch.cat([q, *k, *v])


def column_parallel_matmul(x: torch.Tensor,
                           w_shard: torch.Tensor) -> torch.Tensor:
    """``x @ W[:, shard]``: input replicated, output column-sharded. No
    communication; the pairing row-parallel matmul carries the sum."""
    return x @ w_shard


def row_parallel_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor,
                        axis_name: str = AXIS_MODEL) -> torch.Tensor:
    """``sum_tp(x[:, shard] @ W[shard, :])``: the one all-reduce of a
    column -> row pair (Megatron's g), over ``axis_name`` of the ambient
    mesh."""
    from horovod_tpu_torch.ops.collectives import reduce_from_model
    return reduce_from_model(x_shard @ w_shard, axis_name)


def allgather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                     axis_name: str = AXIS_MODEL) -> torch.Tensor:
    """``all_gather(x_shard) @ w`` without the gathered input: ``x_shard``
    [s, K] is this rank's row block of a [N s, K] input, ``w`` [K, F]
    resident. Each step multiplies the block in hand while the next
    blocks travel the ring in both directions (`ppermute`), so the
    gather takes N/2 steps. Returns the whole [N s, F] product in
    source-rank order; differentiable."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                 ring_perms)
    n, idx = axis_size(axis_name), axis_index(axis_name)
    fwd, bwd = ring_perms(axis_name)
    parts = [None] * n
    parts[idx] = x_shard @ w
    hi = lo = x_shard
    for step in range(1, n // 2 + 1):
        # After `step` hops `hi` holds rank (idx - step)'s block and
        # `lo` rank (idx + step)'s; they meet at the even-N half step.
        last = step == n // 2 and n % 2 == 0
        if last:
            hi = collectives.ppermute(hi, axis_name, fwd)
        else:
            hi, lo = (collectives.ppermute(hi, axis_name, fwd),
                      collectives.ppermute(lo, axis_name, bwd))
        parts[(idx - step) % n] = hi @ w
        if not last:
            parts[(idx + step) % n] = lo @ w
    return torch.cat(parts, dim=0)


def matmul_reducescatter(x: torch.Tensor, w_shard: torch.Tensor,
                         axis_name: str = AXIS_MODEL) -> torch.Tensor:
    """``reduce_scatter(x @ w_shard)`` with each block's product made as
    its accumulator rides the ring: ``x`` [R, Ks] holds this rank's
    contraction shard (R divisible by N), ``w_shard`` [Ks, F] the
    matching rows of W. Returns this rank's [R/N, F] block of the summed
    product; differentiable."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                 ring_perms)
    n, idx = axis_size(axis_name), axis_index(axis_name)
    if x.shape[0] % n:
        raise ValueError(
            f"leading dim {x.shape[0]} not divisible by axis size {n}")
    c = x.shape[0] // n
    fwd, _ = ring_perms(axis_name)

    def chunk_mm(j):
        return x[j * c:(j + 1) * c] @ w_shard

    # Block j enters the ring at rank j + 1 and lands on rank j after
    # n - 1 hops, holding every rank's partial product.
    acc = chunk_mm((idx - 1) % n)
    for t in range(1, n):
        acc = collectives.ppermute(acc, axis_name, fwd)
        acc = acc + chunk_mm((idx - t - 1) % n)
    return acc


def param_specs(module: nn.Module) -> dict:
    """{state-dict name: partition spec} of every parameter and buffer
    of ``module``, by the JAX package's rules: a column-parallel kernel
    ``(None, 'model')`` with its bias and scale ``('model',)``, a
    row-parallel kernel ``('model', None)`` with its scale ``(None,)``
    and its bias replicated ``()``, an MoE layer's ``w1`` / ``w2``
    ``('expert', None, None)`` and its router ``()``, everything else
    ``()``."""
    from horovod_tpu_torch.parallel.expert import MoELayer
    specs = {}
    for prefix, mod in module.named_modules():
        if isinstance(mod, MoELayer):
            rule = {"w1": (AXIS_EXPERT, None, None),
                    "w2": (AXIS_EXPERT, None, None)}
        elif isinstance(mod, ColumnParallelDense):
            rule = {"kernel": (None, mod.axis), "kernel_q": (None, mod.axis),
                    "kernel_scale": (mod.axis,), "bias": (mod.axis,)}
        elif isinstance(mod, RowParallelDense):
            rule = {"kernel": (mod.axis, None), "kernel_q": (mod.axis, None),
                    "kernel_scale": (None,), "bias": ()}
        else:
            continue
        for leaf, spec in rule.items():
            specs[f"{prefix}.{leaf}" if prefix else leaf] = spec
    return {name: specs.get(name, ())
            for name in module.state_dict(keep_vars=True)}


def _qkv_owners(module: nn.Module) -> dict:
    """{state-dict name of a fused qkv leaf: its attention module}."""
    out = {}
    for prefix, mod in module.named_modules():
        if isinstance(mod, ParallelSelfAttention):
            base = f"{prefix}.qkv." if prefix else "qkv."
            for leaf in ("kernel", "kernel_q", "kernel_scale", "bias"):
                out[base + leaf] = mod
    return out


def shard_params(mesh, module: nn.Module, state_dict=None,
                 specs=None) -> dict:
    """This rank's shard of a FULL state dict (default ``module``'s own)
    of ``module`` (the layer or model, sharded or not: only its
    structure is read): every leaf cut by its spec (`param_specs`
    unless given) through `parallel.mesh.place_with_specs`'s rule, and
    each fused qkv leaf by `qkv_columns`. Load the result into the
    layer built with ``tp`` = the mesh's ``model`` size. The SPMD form
    of the JAX package's ``shard_params(mesh, variables)``."""
    from horovod_tpu_torch.parallel.mesh import (axis_index, model_degree,
                                                 place_with_specs)
    sd = module.state_dict() if state_dict is None else state_dict
    specs = param_specs(module) if specs is None else specs
    tp = model_degree(mesh)
    r = axis_index(AXIS_MODEL, mesh) if tp > 1 else 0
    owners = _qkv_owners(module)
    out = {}
    for name, t in sd.items():
        attn = owners.get(name)
        if attn is not None and tp > 1:
            cols = qkv_columns(r, attn.heads_total, attn.kv_total,
                               attn.head_dim, tp).to(t.device)
            out[name] = t.index_select(t.ndim - 1, cols).contiguous()
        else:
            out[name] = place_with_specs(mesh, t, specs.get(name, ()))
    return out


def gather_params(mesh, module: nn.Module, state_dict=None,
                  specs=None) -> dict:
    """The inverse of `shard_params`: the FULL state dict from every
    rank's shard (default ``module``'s own; a collective over the mesh's
    ``model`` and ``expert`` axes, so every rank of them calls it).
    ``specs`` must be the effective ones the shards were cut by (a
    dimension kept whole by `safe_spec` names no axis)."""
    from horovod_tpu_torch.ops.collectives import _gather
    from horovod_tpu_torch.parallel.mesh import axis_group, axis_size
    sd = module.state_dict() if state_dict is None else state_dict
    specs = param_specs(module) if specs is None else specs
    cut = {a: axis_size(a, mesh) for a in (AXIS_MODEL, AXIS_EXPERT)}
    tp = cut[AXIS_MODEL]
    owners = _qkv_owners(module) if tp > 1 else {}
    out = {}
    for name, t in sd.items():
        attn = owners.get(name)
        if attn is None:
            for dim, entry in enumerate(specs.get(name, ())):
                if cut.get(entry, 1) > 1:
                    t = torch.cat(_gather(t.detach(),
                                          axis_group(entry, mesh)), dim=dim)
            out[name] = t
            continue
        parts = _gather(t.detach(), axis_group(AXIS_MODEL, mesh))
        H, Hkv, D = attn.heads_total, attn.kv_total, attn.head_dim
        full = t.new_zeros(*t.shape[:-1], (H + 2 * Hkv) * D)
        for rank, part in enumerate(parts):
            cols = qkv_columns(rank, H, Hkv, D, tp).to(t.device)
            full.index_copy_(t.ndim - 1, cols, part)
        out[name] = full
    return out


def unbox(state_dict: dict) -> dict:
    """A plain copy of ``state_dict``: the port's parameters carry no
    partitioning boxes to strip (the JAX package's ``unbox``)."""
    return dict(state_dict)
