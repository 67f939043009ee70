"""The transformer's layers on one device: dense pairs, MLPs, rotary
embeddings and self-attention with its decode-cache paths.

Counterpart of `horovod_tpu.parallel.tensor`, single-device: the
column/row-parallel names are kept so each module's counterpart is
easy to find, but no weight is sharded (tensor parallelism over NCCL is
a later slice). Dense kernels keep the JAX package's [in, out] layout,
so `compat.from_jax.params_from_jax` maps the flax tree one to one.

Decode state is explicit: a `LayerCache` carries one layer's K/V rows
[B, W, Hkv, D] and the per-lane fill index [B] (int32, on the device).
The attention writes this call's K/V rows into the cache IN PLACE (the
port updates where JAX returned a new cache); advancing the index is
the caller's job, once per model call, so every layer reads the same
fill.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

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


class _Dense(nn.Module):
    """``x @ kernel (+ bias)`` at the module dtype; kernel [in, out] is
    stored f32 (or pre-cast by `serving_params`) and cast at use, the
    bias stays f32 and is cast at use."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, features, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.kernel.data, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ColumnParallelDense(_Dense):
    """Dense whose output dim the JAX package shards over ``model``
    (one device here)."""


class RowParallelDense(_Dense):
    """Dense whose input dim the JAX package shards over ``model``
    (one device here)."""


class ParallelMLP(nn.Module):
    """Transformer MLP block: up (``wi``), tanh-gelu, down (``wo``),
    both with biases (flax's `nn.gelu` default is the tanh form)."""

    def __init__(self, d: int, hidden: int, out: int, *, dtype=None,
                 device=None):
        super().__init__()
        self.wi = ColumnParallelDense(d, hidden, dtype=dtype, device=device)
        self.wo = RowParallelDense(hidden, out, dtype=dtype, device=device)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class ParallelSwiGLU(nn.Module):
    """LLaMA-family MLP: ``down(act(gate(x)) * up(x))``, no biases;
    act is silu (SwiGLU) or tanh-gelu (Gemma GeGLU)."""

    def __init__(self, d: int, hidden: int, out: int, *, dtype=None,
                 activation: str = "silu", device=None):
        super().__init__()
        if activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"activation must be silu|gelu_tanh, got "
                             f"{activation!r}")
        self.activation = activation
        kw = dict(use_bias=False, dtype=dtype, device=device)
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
    """One layer's linear decode cache: K/V rows [B, W, Hkv, D] and the
    per-lane fill index [B] int32 (positions < index are filled)."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor


class ParallelSelfAttention(nn.Module):
    """Multi-head self-attention (GQA when ``num_kv_heads`` < heads).

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

    A sliding ``window`` applies to the non-decode forward; the rolling
    window cache is a later slice and raises.
    """

    def __init__(self, num_heads: int, head_dim: int, *, dtype=None,
                 attn_fn: Optional[Callable] = None,
                 num_kv_heads: Optional[int] = None, pos_emb: str = "none",
                 rope_theta: float = 10000.0, window: Optional[int] = None,
                 decode_prefix_block: Optional[int] = 256,
                 decode_prefix_impl: str = "lax", use_bias: bool = False,
                 out_bias: Optional[bool] = None, device=None):
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
        self.num_heads, self.num_kv_heads = H, Hkv
        self.head_dim = head_dim
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.pos_emb = pos_emb
        self.rope_theta = rope_theta
        self.window = window
        self.decode_prefix_block = decode_prefix_block
        self.decode_prefix_impl = decode_prefix_impl
        features = H * head_dim
        self.qkv = ColumnParallelDense(
            features, features + 2 * Hkv * head_dim, use_bias=use_bias,
            dtype=dtype, device=device)
        ob = use_bias if out_bias is None else out_bias
        self.out = RowParallelDense(features, features, use_bias=ob,
                                    dtype=dtype, device=device)

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
            pos = torch.arange(q.shape[-3], device=q.device)
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

    @staticmethod
    def _cache_write(cache: LayerCache, k, v, S: int):
        """Write S new K/V rows at each lane's fill (in place). The start
        clamps to W - S like `lax.dynamic_update_slice`, so a lane ticked
        past its budget (a pipelined tick behind retirement) overwrites
        its own last row instead of faulting."""
        B, W = cache.k.shape[:2]
        start = cache.index.clamp(max=W - S).long()
        rows = start[:, None] + torch.arange(S, device=start.device)
        lanes = torch.arange(B, device=start.device)[:, None]
        cache.k[lanes, rows] = k.to(cache.k.dtype)
        cache.v[lanes, rows] = v.to(cache.v.dtype)

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
        bit-for-bit unchanged (alpha = 1, p = 0)."""
        i = cache.index
        W = cache.k.shape[1]
        if self.decode_prefix_impl == "pallas" and S == 1:
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
        for start in range(0, stop, blk):
            kb = self._repeat_kv(cache.k[:, start:start + blk])
            vb = self._repeat_kv(cache.v[:, start:start + blk])
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

    def _decode_attention(self, q, k, v, cache: LayerCache,
                          chunked_prefill: bool,
                          prefix_len: Optional[int] = None):
        if self.window is not None:
            raise NotImplementedError(
                "sliding-window decode (the rolling window cache) is a "
                "later slice of the PyTorch port")
        S = q.shape[1]
        W = cache.k.shape[1]
        pos = cache.index[:, None].long() + torch.arange(S, device=q.device)
        # Keys enter the cache already rotated at their absolute
        # position, so the prefix never needs re-rotation.
        q, k = self._maybe_rope(q, k, pos)
        self._cache_write(cache, k, v, S)
        if S > 1 and not chunked_prefill:
            # One-pass prefill; contract: the cache was EMPTY (index 0),
            # so attending the cached prefix equals causal attention
            # over this block alone — the model's kernel (flash) runs it.
            # Like the JAX package under jit, the contract is not
            # re-checked here (that would read the device index).
            return self._causal_block_attn(q, k, v)
        blk = self.decode_prefix_block
        if blk and W % min(blk, W) == 0:
            return self._prefix_attention(q, cache, S, prefix_len)
        keep = banded_causal_mask(pos, torch.arange(W, device=q.device))
        return dot_product_attention(q, self._repeat_kv(cache.k),
                                     self._repeat_kv(cache.v),
                                     keep[:, None])


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
