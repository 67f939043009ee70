"""Flagship model: the GPT-style transformer LM, its offline generator
and the slot primitives behind continuous-batching serving.

Counterpart of `horovod_tpu.models.transformer` on one device:
`TransformerLM` holds its own weights (an `nn.Module`; load the JAX
package's with `compat.from_jax.params_from_jax`), `generate` is the
offline decoder and serving oracle, and the ``slot_*`` functions are the
device surface of `serving.slots.SlotPool`.

Decode state is an explicit `KVCache` (per-layer K/V rows, their
int8-KV scales under ``kv_quant``, and a per-lane int32 fill index on
the device) updated in place; where the JAX package vmaps a B=1 step
over the slot axis, the port runs ONE batched call over all lanes with
per-lane fill and position tensors. A ``window`` model's cache is the
rolling buffer of ``window`` slots, and with RoPE it generates past
max_len.

Attention kernels: ``dot`` (materialized softmax), ``blockwise``
(online-softmax loop) and ``flash`` (the CUDA flash-forward and
flash-backward kernels, their plain versions on the CPU); sequence
parallel over a mesh's ``seq`` axis, ``ring`` / ``ring_flash`` (K/V
rotating, the flash kernels on every rotation) and ``ulysses`` /
``ulysses_flash`` (all-to-all head swap). The
``paged_*`` functions are the device surface of
`serving.paging.PagedSlotPool` (block pools read through block
tables). Training: `lm_loss`, `chunked_lm_loss` (the fused head + CE
over sequence chunks), `make_lm_train_step`, `make_lm_eval_step` and
`init_lm_state`, data-parallel over `torch.distributed` through
`horovod_tpu_torch.optim`, or over a mesh of ``data``, ``seq``,
``expert`` and ``model`` (`parallel.mesh`). A model built with ``mesh=``
whose ``model`` axis is > 1 is tensor parallel: each rank holds its
shard of the blocks (`parallel.tensor`), the embedding and an untied
head hold its vocab rows (``lm_param_specs``), the loss is a
vocab-parallel cross entropy, and `generate` and the serving pools run
on the rank's local heads (every rank of the axis makes the same call).
``moe_every`` > 0 puts mixture-of-experts blocks in (`parallel.expert`),
whose experts a mesh's ``expert`` axis shards; the train step adds
their load-balancing term. LoRA is a later slice; int8 weights come
from `ops.quantization.quantize_lm`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch import optim
from horovod_tpu_torch.ops import threefry
from horovod_tpu_torch.ops.quantization import check_quant
from horovod_tpu_torch.parallel.mesh import (AXIS_MODEL, abstract_mesh,
                                             seq_degree, seq_offset)
from horovod_tpu_torch.parallel.sequence import (banded_causal_mask,
                                                 blockwise_attention,
                                                 check_window)
from horovod_tpu_torch.parallel.tensor import (LayerCache,
                                               PagedLayerCache, ParallelMLP,
                                               ParallelSelfAttention,
                                               ParallelSwiGLU,
                                               kv_heads_of)

SEQ_PARALLEL_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
ATTN_IMPLS = ("dot", "blockwise", "flash") + SEQ_PARALLEL_IMPLS

# The LLaMA-family knob set (same keys as the JAX package's).
LLAMA_ARCH_KW = dict(norm="rmsnorm", mlp_impl="swiglu", tied_head=False)


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU
    (``device="cpu"``, as the tests do). Asking for CUDA without a card
    raises — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


def make_attn_fn(impl: str, *, causal: bool = True, block_size: int = 512,
                 window: Optional[int] = None, flash_block_q: int = 128,
                 flash_block_k: int = 128) -> Optional[Callable]:
    """attn_fn for `ParallelSelfAttention` (None = the dot baseline,
    which takes the explicit mask instead). ``ring``/``ring_flash``/
    ``ulysses``/``ulysses_flash`` run sequence parallel over the ``seq``
    axis of the ambient mesh (`parallel.mesh.use`) on this rank's
    block; off-mesh they are the blockwise attention on the whole
    sequence, the same math on one device. ``flash_block_q/k`` (the
    Pallas tile sizes of the JAX package) are accepted at their
    defaults only, and for ``impl="flash"`` only: the CUDA kernels pick
    their own tiles."""
    check_window(window)
    if (flash_block_q, flash_block_k) != (128, 128):
        if impl != "flash":
            raise ValueError(
                f"flash_block_q/flash_block_k apply to attn_impl='flash' "
                f"only (got impl={impl!r})")
        raise ValueError("the CUDA flash kernels choose their own tiles; "
                         "flash_block_q/flash_block_k must stay 128")
    if impl == "dot":
        return None

    def _no_mask(m):
        if m is not None:
            raise NotImplementedError(
                f"attn_impl={impl!r} supports causal masking only; use "
                f"impl='dot' for arbitrary masks")

    if impl == "blockwise":
        def attn(q, k, v, m):
            _no_mask(m)
            return blockwise_attention(q, k, v, causal=causal,
                                       window=window, block_size=block_size)
        return attn
    if impl == "flash":
        from horovod_tpu_torch.ops.flash_attention import flash_attention

        def attn(q, k, v, m):
            _no_mask(m)
            return flash_attention(q, k, v, causal=causal, window=window)
        attn.native_gqa = True
        return attn
    if impl in ("ring", "ring_flash", "ulysses", "ulysses_flash"):
        from horovod_tpu_torch.parallel import sequence as sq
        if impl == "ulysses":
            sp_fn = sq.ulysses_attention_gspmd
        elif impl == "ulysses_flash":
            from horovod_tpu_torch.ops.flash_attention import \
                flash_attention
            sp_fn = functools.partial(sq.ulysses_attention_gspmd,
                                      attn_impl=flash_attention)
        elif impl == "ring_flash":
            sp_fn = functools.partial(sq.ring_attention_gspmd,
                                      block_impl="flash")
        else:
            sp_fn = sq.ring_attention_gspmd
        native_gqa = impl in ("ring_flash", "ulysses_flash")

        def attn(q, k, v, m):
            _no_mask(m)
            from horovod_tpu_torch.parallel.mesh import abstract_mesh
            if abstract_mesh() is None:
                # Off-mesh (one device): blockwise is the same math.
                if native_gqa and k.shape[2] != q.shape[2]:
                    g = q.shape[2] // k.shape[2]
                    k = k.repeat_interleave(g, dim=2)
                    v = v.repeat_interleave(g, dim=2)
                return blockwise_attention(q, k, v, causal=causal,
                                           window=window,
                                           block_size=block_size)
            return sp_fn(None, q, k, v, causal=causal, window=window)
        # K/V stay at kv-head width through the hops and all-to-alls.
        attn.native_gqa = native_gqa
        return attn
    raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` arithmetic: statistics in f32 with the fast
    variance E[x^2] - E[x]^2 (clamped at 0), scale/bias f32, output at
    the module dtype. ``rms=True`` is flax `nn.RMSNorm` (scale only,
    no centering)."""

    def __init__(self, d: int, *, eps: float, dtype, rms: bool = False,
                 device=None):
        super().__init__()
        self.eps, self.dtype, self.rms = eps, dtype, rms
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = (None if rms else
                     nn.Parameter(torch.zeros(d, device=device)))

    def forward(self, x):
        x32 = x.float()
        if self.rms:
            var = (x32 * x32).mean(-1, keepdim=True)
            y = x32 * (torch.rsqrt(var + self.eps) * self.scale.float())
        else:
            mean = x32.mean(-1, keepdim=True)
            var = ((x32 * x32).mean(-1, keepdim=True)
                   - mean * mean).clamp_min(0.0)
            y = ((x32 - mean)
                 * (torch.rsqrt(var + self.eps) * self.scale.float())
                 + self.bias.float())
        return y.to(self.dtype or x.dtype)


def _make_norm(kind: str, d: int, dtype, eps: float, device):
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"norm must be layernorm|rmsnorm, got {kind!r}")
    return LayerNorm(d, eps=eps, dtype=dtype, rms=kind == "rmsnorm",
                     device=device)


class TransformerBlock(nn.Module):
    """Pre-LN block: attention + MLP (gelu, swiglu or geglu), or with
    ``moe`` a mixture of experts in place of the MLP (`parallel.expert.
    MoELayer`, hidden ``mlp_ratio * d``, float even in an int8-weight
    model, as the JAX block gives the experts no ``weight_quant``).
    ``forward`` returns ``(x, aux)``: aux the MoE layer's
    load-balancing term, None in a dense block."""

    def __init__(self, cfg: "TransformerLM", device, moe: bool = False):
        super().__init__()
        d = cfg.num_heads * cfg.head_dim
        self.window = cfg.window
        self.attn_fn = make_attn_fn(cfg.attn_impl, window=cfg.window)
        self.ln_attn = _make_norm(cfg.norm, d, cfg.dtype, cfg.ln_eps, device)
        self.attn = ParallelSelfAttention(
            cfg.num_heads, cfg.head_dim, dtype=cfg.dtype,
            attn_fn=self.attn_fn, num_kv_heads=cfg.num_kv_heads,
            pos_emb="rope" if cfg.pos_emb == "rope" else "none",
            rope_theta=cfg.rope_theta, window=cfg.window,
            decode_prefix_block=cfg.decode_prefix_block,
            decode_prefix_impl=cfg.decode_prefix_impl,
            use_bias=cfg.attn_bias, out_bias=cfg.attn_out_bias,
            weight_quant=cfg.weight_quant, device=device, tp=cfg.tp,
            tp_rank=cfg.tp_rank)
        self.ln_mlp = _make_norm(cfg.norm, d, cfg.dtype, cfg.ln_eps, device)
        hidden = cfg.mlp_hidden or cfg.mlp_ratio * d
        self.moe = None
        if moe:
            from horovod_tpu_torch.parallel.expert import MoELayer
            self.moe = MoELayer(
                cfg.num_experts, cfg.mlp_ratio * d, d, k=cfg.moe_k,
                capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype,
                mesh=cfg.mesh if cfg.ep > 1 else None, device=device)
        elif cfg.mlp_impl in ("swiglu", "geglu"):
            self.mlp = ParallelSwiGLU(
                d, hidden, d, dtype=cfg.dtype, device=device,
                activation="gelu_tanh" if cfg.mlp_impl == "geglu"
                else "silu", weight_quant=cfg.weight_quant, tp=cfg.tp)
        elif cfg.mlp_impl == "gelu":
            self.mlp = ParallelMLP(d, hidden, d, dtype=cfg.dtype,
                                   weight_quant=cfg.weight_quant,
                                   device=device, tp=cfg.tp)
        else:
            raise ValueError(f"mlp_impl must be gelu|swiglu|geglu, got "
                             f"{cfg.mlp_impl!r}")

    def forward(self, x, cache: Optional[LayerCache] = None,
                chunked_prefill: bool = False,
                prefix_len: Optional[int] = None, route_rows: bool = False):
        mask = None
        if self.attn_fn is None and cache is None:
            pos = torch.arange(x.shape[-2], device=x.device)
            mask = banded_causal_mask(pos, pos, self.window)[None, None]
        x = x + self.attn(self.ln_attn(x), mask, cache, chunked_prefill,
                          prefix_len)
        if self.moe is None:
            return x + self.mlp(self.ln_mlp(x)), None
        y, aux = self.moe(self.ln_mlp(x), route_rows)
        return x + y, aux


@dataclass
class KVCache:
    """Decode cache of a whole model: per-layer K/V rows [lanes, W, Hkv,
    D] (W = max_len, or the window of a rolling cache) and ONE per-lane
    fill index [lanes] int32 shared by every layer (all layers advance
    together). Under int8 KV the rows are int8 and ``k_scale`` /
    ``v_scale`` hold per-layer [lanes, W, Hkv] f32 scales."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: torch.Tensor
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    def layer_tensors(self, i: int) -> tuple:
        """Layer ``i``'s tensors in pool order: (K, V), then (K scale,
        V scale) under int8 KV."""
        if self.k_scale is None:
            return self.k[i], self.v[i]
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]

    def tensors(self) -> list:
        """Every row tensor of every layer (not the index)."""
        return [t for i in range(len(self.k)) for t in self.layer_tensors(i)]

    def layer(self, i: int) -> LayerCache:
        k, v, *scales = self.layer_tensors(i)
        return LayerCache(k, v, self.index, *scales)

    def lanes(self, start: int, stop: Optional[int] = None) -> "KVCache":
        """Views of lanes [start, stop) — writes land in this cache."""
        stop = start + 1 if stop is None else stop

        def cut(ts):
            return None if ts is None else [t[start:stop] for t in ts]
        return KVCache(cut(self.k), cut(self.v), self.index[start:stop],
                       cut(self.k_scale), cut(self.v_scale))


class TransformerLM(nn.Module):
    """Decoder-only LM: [B, S] int tokens -> [B, S, V] logits.

    The constructor mirrors the JAX module's fields that the port
    serves and trains (gpt preset by default: learned positions,
    LayerNorm, gelu MLP, tied head) plus ``device``. Weights are
    created on ``device`` (CUDA unless ``device="cpu"``) and drawn by
    `init_weights(seed)`. ``remat=True`` recomputes each block's
    activations in the backward (`torch.utils.checkpoint`, as the JAX
    module's `nn.remat`). ``weight_quant="int8"`` stores the block
    matmul kernels as int8 codes plus per-channel scales (load them
    with `ops.quantization.quantize_lm`); ``kv_quant="int8"`` stores
    the decode cache as int8 plus per-(position, head) scales.
    ``moe_every`` > 0 makes block i a mixture of experts iff (i + 1) %
    moe_every == 0 (``num_experts`` experts, the top ``moe_k`` a token,
    ``moe_capacity_factor``; `parallel.expert.MoELayer`). ``mesh``
    (`parallel.mesh.make_mesh`) with ``model`` > 1 builds this
    rank's tensor-parallel shard: H/tp query heads a block and the kv
    heads they read, column/row-parallel dense pairs, and the
    embedding's (and an untied head's) vocab rows [r V/tp, (r+1) V/tp)
    when tp divides the vocab (else both stay whole); the MoE blocks
    stay whole over ``model``, as in the JAX package. With ``expert``
    > 1 each MoE block holds this rank's E/ep experts. Its collectives
    run over the mesh's ``model`` and ``expert`` axes; load a full
    state dict with ``compat.from_jax.shard_state_dict``.
    `clone(**changes)` builds the same configuration with some fields
    changed (weights not copied).

    ``forward(..., return_aux=True)`` returns ``(out, aux)``, aux the
    sum of the MoE blocks' load-balancing terms (0 in a dense model);
    ``route_rows=True`` routes each row of the batch through the MoE
    blocks alone, with its own capacity (the serving pools' calls,
    where the JAX package vmaps a one-lane call over the slots).
    """

    def __init__(self, vocab_size: int, num_layers: int, num_heads: int,
                 head_dim: int, *, num_kv_heads: Optional[int] = None,
                 pos_emb: str = "learned", rope_theta: float = 10000.0,
                 window: Optional[int] = None, mlp_ratio: int = 4,
                 max_len: int = 2048, dtype=torch.bfloat16,
                 attn_impl: str = "blockwise",
                 decode_prefix_block: Optional[int] = 256,
                 decode_prefix_impl: str = "lax",
                 weight_quant: Optional[str] = None,
                 kv_quant: Optional[str] = None, attn_bias: bool = False,
                 attn_out_bias: Optional[bool] = None, ln_eps: float = 1e-6,
                 norm: str = "layernorm", mlp_impl: str = "gelu",
                 mlp_hidden: Optional[int] = None, tied_head: bool = True,
                 embed_scale: Optional[float] = None, remat: bool = False,
                 moe_every: int = 0, num_experts: int = 8, moe_k: int = 2,
                 moe_capacity_factor: float = 1.25, mesh=None,
                 device=None):
        config = dict(locals())
        super().__init__()
        self._config = {k: v for k, v in config.items()
                        if k not in ("self", "device", "__class__")}
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"pos_emb must be 'learned' or 'rope', got "
                             f"{pos_emb!r}")
        self.device = resolve_device(device)
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_kv_heads
        self.pos_emb, self.rope_theta, self.window = pos_emb, rope_theta, window
        self.mlp_ratio, self.max_len, self.dtype = mlp_ratio, max_len, dtype
        self.attn_impl = attn_impl
        self.decode_prefix_block = decode_prefix_block
        self.decode_prefix_impl = decode_prefix_impl
        self.weight_quant = check_quant("weight_quant", weight_quant)
        self.kv_quant = check_quant("kv_quant", kv_quant)
        self.attn_bias, self.attn_out_bias = attn_bias, attn_out_bias
        self.ln_eps, self.norm, self.mlp_impl = ln_eps, norm, mlp_impl
        self.mlp_hidden, self.tied_head = mlp_hidden, tied_head
        self.embed_scale = embed_scale
        self.remat = remat
        self.moe_every, self.num_experts = moe_every, num_experts
        self.moe_k, self.moe_capacity_factor = moe_k, moe_capacity_factor
        from horovod_tpu_torch.parallel.mesh import (AXIS_EXPERT, axis_index,
                                                     axis_size, model_degree)
        self.mesh = mesh
        self.tp = model_degree(mesh) if mesh is not None else 1
        self.tp_rank = axis_index(AXIS_MODEL, mesh) if self.tp > 1 else 0
        self.ep = axis_size(AXIS_EXPERT, mesh) if mesh is not None else 1
        # Raises before any work on a head layout tp cannot split.
        kv_heads_of(self.tp_rank, num_heads, self.num_kv, self.tp)
        self.vocab_parallel = self.tp > 1 and vocab_size % self.tp == 0
        rows = vocab_size // self.tp if self.vocab_parallel else vocab_size
        self.vocab_start = self.tp_rank * rows if self.vocab_parallel else 0
        d = num_heads * head_dim
        dev = self.device
        self.embed = nn.Parameter(torch.empty(rows, d, device=dev))
        self.pos = (nn.Parameter(torch.empty(max_len, d, device=dev))
                    if pos_emb != "rope" else None)
        self.blocks = nn.ModuleList(
            TransformerBlock(self, dev, moe=self.is_moe_block(i))
            for i in range(num_layers))
        self.ln_f = _make_norm(norm, d, dtype, ln_eps, dev)
        self.lm_head = (None if tied_head else
                        nn.Parameter(torch.empty(rows, d, device=dev)))

    @property
    def num_kv(self) -> int:
        return self.num_kv_heads or self.num_heads

    def is_moe_block(self, i: int) -> bool:
        """Block ``i`` is a mixture of experts (the JAX package's rule)."""
        return self.moe_every > 0 and (i + 1) % self.moe_every == 0

    @property
    def sharded(self) -> bool:
        """Built over a mesh that cuts its weights (``model`` or
        ``expert`` > 1): each rank holds its own shard."""
        return self.tp > 1 or self.ep > 1

    @property
    def local_kv(self) -> int:
        """kv heads this rank's caches hold (`num_kv` at tp = 1)."""
        return len(kv_heads_of(self.tp_rank, self.num_heads, self.num_kv,
                               self.tp))

    @property
    def unbounded(self) -> bool:
        """RoPE with a window: the rolling cache generates any length
        (every other model is bounded by max_len)."""
        return self.pos_emb == "rope" and self.window is not None

    def clone(self, **changes) -> "TransformerLM":
        """A new model of this configuration with ``changes`` applied, on
        the same device; its weights are uninitialized."""
        return TransformerLM(**{**self._config, **changes},
                             device=self.device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Draw every weight from ``seed`` with a `torch.Generator` on
        the model's device, with the JAX module's initializers: N(0,
        0.02) embedding / positions / untied head, lecun-normal dense
        kernels and experts, zero biases, unit norm scales. A sharded
        model (tensor or expert parallel) draws the whole model's
        weights and keeps its shard, so every layout gives the same
        model."""
        if self.sharded:
            from horovod_tpu_torch.compat.from_jax import shard_state_dict
            full = self.clone(mesh=None).init_weights(seed)
            self.load_state_dict(shard_state_dict(self, full.state_dict(),
                                                  self.mesh))
            return self
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed.normal_(0.0, 0.02, generator=g)
        if self.pos is not None:
            self.pos.normal_(0.0, 0.02, generator=g)
        for mod in self.modules():
            if hasattr(mod, "reset_parameters") and mod is not self:
                mod.reset_parameters(g)
        if self.lm_head is not None:
            self.lm_head.normal_(0.0, 0.02, generator=g)
        return self

    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head

    def logits_head(self):
        """The LM head as the projection and the loss take it: the
        weight [V, d], or, vocab parallel, this rank's rows wrapped in a
        `VocabShard` with the mesh and first row the model owns."""
        if self.vocab_parallel:
            return VocabShard(self.head(), self.mesh, self.vocab_start)
        return self.head()

    def forward(self, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                *, chunked_prefill: bool = False,
                prefix_len: Optional[int] = None,
                return_hidden: bool = False, return_aux: bool = False,
                route_rows: bool = False):
        """``cache`` None: the training-mode forward. With a `KVCache`:
        a decode call appending ``tokens`` [lanes, S] at each lane's
        fill (the caller advances ``cache.index`` afterwards);
        ``chunked_prefill`` picks the any-fill prefix path for S > 1
        instead of the one-pass empty-cache prefill; ``prefix_len``, a
        host-side upper bound on every lane's fill after the call, bounds
        the plain prefix loop to the filled slices (None: all of them).
        ``return_hidden`` returns ``(hidden [B, S, d], head)`` instead
        of logits, ``head`` as `logits_head` gives it (the [V, d]
        weight, or a `VocabShard`): project with `project_logits`.
        ``return_aux`` and ``route_rows``: see the class docstring."""
        if self.sharded and abstract_mesh() is None:
            from horovod_tpu_torch.parallel.mesh import use
            with use(self.mesh):
                return self.forward(tokens, cache,
                                    chunked_prefill=chunked_prefill,
                                    prefix_len=prefix_len,
                                    return_hidden=return_hidden,
                                    return_aux=return_aux,
                                    route_rows=route_rows)
        B, S = tokens.shape
        offset = 0
        if cache is None:
            offset = seq_offset(S)
            if (seq_degree() > 1
                    and self.attn_impl not in SEQ_PARALLEL_IMPLS):
                raise ValueError(
                    f"attn_impl={self.attn_impl!r} attends within this "
                    f"rank's block only; a mesh with seq > 1 needs one of "
                    f"{SEQ_PARALLEL_IMPLS}")
        x = self._lookup(tokens)
        if self.embed_scale is not None:
            x = x * torch.tensor(self.embed_scale, dtype=x.dtype)
        if self.pos is not None:
            if cache is not None:
                # Position from each lane's fill (clamped like the JAX
                # package's dynamic_slice).
                start = cache.index.clamp(max=self.max_len - S).long()
                x = x + self.pos[start[:, None]
                                 + torch.arange(S, device=x.device)]
            else:
                # Under a mesh with seq > 1, this rank's block of the
                # global positions.
                x = x + self.pos[offset:offset + S]
        x = x.to(self.dtype)
        aux = x.new_zeros((), dtype=torch.float32)
        for i, blk in enumerate(self.blocks):
            if cache is None and self.remat:
                x, a = checkpoint(blk, x, None, False, None, route_rows,
                                  use_reentrant=False)
            else:
                x, a = blk(x, None if cache is None else cache.layer(i),
                           chunked_prefill, prefix_len, route_rows)
            if a is not None:
                aux = aux + a
        x = self.ln_f(x)
        head = self.logits_head()
        out = (x, head) if return_hidden else project_logits(x, head)
        return (out, aux) if return_aux else out

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens``; vocab parallel, each rank
        looks up the ids in its rows (zeros elsewhere) and g sums them."""
        if not self.vocab_parallel:
            return self.embed[tokens]
        from horovod_tpu_torch.ops.collectives import reduce_from_model
        rows = self.embed.shape[0]
        local = tokens.long() - self.vocab_start
        outside = (local < 0) | (local >= rows)
        x = self.embed[local.clamp(0, rows - 1)]
        x = torch.where(outside[..., None], torch.zeros((), dtype=x.dtype,
                                                        device=x.device), x)
        return reduce_from_model(x)


@dataclass(frozen=True)
class VocabShard:
    """This rank's rows [V/tp, d] of a vocab-parallel LM head (or tied
    embedding): vocab ids [start, start + V/tp), the other rows on the
    ``model`` axis of ``mesh``. `TransformerLM.logits_head` builds it
    from what the model owns, at each call."""

    weight: torch.Tensor
    mesh: object
    start: int


def project_logits(hidden: torch.Tensor, head) -> torch.Tensor:
    """``hidden @ head.T`` at the hidden dtype: the LM head's logits.
    A `VocabShard` (a tensor-parallel model's head) multiplies through
    f and gathers the ranks' vocab blocks into whole logits."""
    if not isinstance(head, VocabShard):
        return hidden @ head.to(hidden.dtype).T
    from horovod_tpu_torch.ops.collectives import (copy_to_model,
                                                   gather_from_model)
    local = copy_to_model(hidden, mesh=head.mesh) @ head.weight.to(
        hidden.dtype).T
    return gather_from_model(local, mesh=head.mesh)


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor,
                      start: int, mesh) -> torch.Tensor:
    """Per-row cross entropy [N] of vocab-sharded f32 logits [N, V/tp]
    (this rank's columns [start, start + V/tp)) against global target
    ids [N], without gathering the logits: the max, the sum of
    exponentials and the target's logit are each reduced over the
    ``model`` axis."""
    from horovod_tpu_torch.ops.collectives import max_over, reduce_from_model
    rows = logits.shape[-1]
    m = max_over(logits.detach().amax(dim=-1), mesh=mesh)
    z = logits - m[:, None]
    sumexp = reduce_from_model(z.exp().sum(dim=-1), mesh=mesh)
    local = targets.long() - start
    inside = (local >= 0) & (local < rows)
    picked = z.gather(1, local.clamp(0, rows - 1)[:, None])[:, 0]
    picked = torch.where(inside, picked, torch.zeros_like(picked))
    return sumexp.log() - reduce_from_model(picked, mesh=mesh)


def _ce_rows(logits: torch.Tensor, targets: torch.Tensor,
             head) -> torch.Tensor:
    """Per-row CE of f32 logits against ``targets``: plain, or vocab
    parallel when ``head`` is a `VocabShard`."""
    if not isinstance(head, VocabShard):
        return F.cross_entropy(logits, targets.reshape(-1).long(),
                               reduction="none")
    return vocab_parallel_ce(logits, targets.reshape(-1), head.start,
                             head.mesh)


# ---------------------------------------------------------------------------
# Train step: data parallel over torch.distributed (one process per
# card; the gradient allreduce is `optim.DistributedOptimizer`'s), or
# over a (data, seq, model) mesh (the step averages over data and seq).
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy, [B, S, V] logits vs [B, S] tokens of any
    integer dtype (the data pipeline's rows are int32; the logits cast
    to f32 first, as the JAX package does)."""
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                           tokens[:, 1:].reshape(-1).long())


def _weighted_ce_chunk(hc, w, yc, mc, head):
    logits = torch.einsum("bcd,vd->bcv", hc, w).float()
    ce = _ce_rows(logits.flatten(0, 1), yc, head)
    return (ce * mc.reshape(-1)).sum()


def chunked_weighted_ce(hidden: torch.Tensor, head,
                        targets: torch.Tensor, weights: torch.Tensor, *,
                        chunk: int) -> torch.Tensor:
    """SUM of ``weights * CE(hidden @ head.T, targets)`` over sequence
    chunks of ``chunk`` positions, each under `torch.utils.checkpoint`
    (as `jax.checkpoint` in the JAX package): the [B, S, V] logits never
    materialize, each chunk's are recomputed in the backward. The
    einsum runs at the hidden dtype and its logits are cast to f32
    after it, as in the JAX package. A ragged last chunk is sliced, not
    padded (the JAX package's padding rows carry weight 0). A
    `VocabShard` ``head`` takes each chunk's CE vocab parallel, the
    hidden through f once."""
    w = head
    if isinstance(head, VocabShard):
        from horovod_tpu_torch.ops.collectives import copy_to_model
        hidden = copy_to_model(hidden, mesh=head.mesh)
        w = head.weight
    w = w.to(hidden.dtype)
    total = hidden.new_zeros((), dtype=torch.float32)
    for o in range(0, hidden.shape[1], chunk):
        total = total + checkpoint(
            _weighted_ce_chunk, hidden[:, o:o + chunk], w,
            targets[:, o:o + chunk], weights[:, o:o + chunk], head,
            use_reentrant=False)
    return total


def chunked_lm_loss(hidden: torch.Tensor, embed: torch.Tensor,
                    tokens: torch.Tensor, *, chunk: int = 512
                    ) -> torch.Tensor:
    """Next-token cross entropy fused with the LM head over sequence
    chunks (`chunked_weighted_ce`): the same value and gradients as
    `lm_loss` on the full logits, with the [B, S, V] logits never held
    at once — at B8 x S2048 x V32k they are the LM's largest
    activation."""
    B, S, _ = hidden.shape
    P = S - 1
    total = chunked_weighted_ce(
        hidden[:, :-1], embed, tokens[:, 1:],
        torch.ones((B, P), dtype=torch.float32, device=hidden.device),
        chunk=chunk)
    return total / (B * P)


def _lm_data_loss(model: TransformerLM, tokens: torch.Tensor,
                  loss_chunk: Optional[int], aux_weight: float = 0.0
                  ) -> torch.Tensor:
    """Chunked-vs-plain loss dispatch shared by the train and eval steps
    (one site, so eval == train loss cannot drift), plus ``aux_weight``
    times the MoE blocks' load-balancing terms (the train step's; the
    eval step passes 0, pure cross entropy)."""
    if loss_chunk:
        (hidden, head), aux = model(tokens, return_hidden=True,
                                    return_aux=True)
        loss = chunked_lm_loss(hidden, head, tokens, chunk=loss_chunk)
    else:
        logits, aux = model(tokens, return_aux=True)
        loss = lm_loss(logits, tokens)
    return loss + aux_weight * aux if aux_weight else loss


def _shard_targets(tokens: torch.Tensor):
    """(targets, weights) [B, S_l] of this rank's token block under the
    ambient mesh: each position's next token, the last position's from
    the first column of the next ``seq`` rank (a `ppermute`), weight 0
    on the global sequence's last position (it has no label)."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import (AXIS_SEQ, axis_index,
                                                 axis_size, ring_perms)
    sp, idx = axis_size(AXIS_SEQ), axis_index(AXIS_SEQ)
    nxt = tokens[:, :1]
    if sp > 1:
        _, from_next = ring_perms(AXIS_SEQ)
        nxt = collectives.ppermute(tokens[:, :1].contiguous(), AXIS_SEQ,
                                   from_next)
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    weights = torch.ones(tokens.shape, dtype=torch.float32,
                         device=tokens.device)
    if idx == sp - 1:
        weights[:, -1] = 0.0
    return targets, weights


def _lm_shard_loss(model: TransformerLM, tokens: torch.Tensor, mesh,
                   loss_chunk: Optional[int],
                   aux_weight: float = 0.0) -> torch.Tensor:
    """This rank's share of the global next-token cross entropy under
    ``mesh``: the SUM of its block's CE (boundary labels from the next
    seq rank) over the global label count B * (S - 1), plus
    ``aux_weight`` times its share of the MoE blocks' load-balancing
    terms (`parallel.expert`: the data x seq ranks' shares sum to the
    global term), all times the data x seq rank count. Averaging those
    ranks' gradients (or values) then gives the gradient (value) of the
    one global mean, as the JAX package's loss over the whole [B, S]
    batch; the model and expert ranks hold replicas of it."""
    from horovod_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SEQ, axis_size
    targets, weights = _shard_targets(tokens)
    B, S = tokens.shape
    dp, sp = axis_size(AXIS_DATA, mesh), axis_size(AXIS_SEQ, mesh)
    count = (B * dp) * (S * sp - 1)
    (hidden, head), aux = model(tokens, return_hidden=True,
                                return_aux=True)
    if loss_chunk:
        total = chunked_weighted_ce(hidden, head, targets, weights,
                                    chunk=loss_chunk)
    elif isinstance(head, VocabShard):
        # Vocab parallel: the [B, S, V] logits are never gathered.
        from horovod_tpu_torch.ops.collectives import copy_to_model
        local = copy_to_model(hidden, mesh=head.mesh) @ head.weight.to(
            hidden.dtype).T
        ce = _ce_rows(local.float().flatten(0, 1), targets, head)
        total = (ce * weights.reshape(-1)).sum()
    else:
        logits = project_logits(hidden, head)
        ce = F.cross_entropy(logits.float().flatten(0, 1),
                             targets.reshape(-1).long(), reduction="none")
        total = (ce * weights.reshape(-1)).sum()
    # The model and expert ranks hold replicas of the loss; the
    # gradients are averaged over the data and seq ranks only.
    loss = total * (dp * sp / count)
    return loss + (dp * sp * aux_weight) * aux if aux_weight else loss


# The axes the train step averages gradients over. Never ``model``: its
# ranks hold different shards, and their replicated leaves are equal
# already (f and g keep them so).
_GRAD_AXES = ("data", "seq")


def _replica_average(model: nn.Module, mesh) -> None:
    """Average every ``.grad`` of ``model`` over the ranks that hold the
    same shard (each axis of `_GRAD_AXES` in turn, one flat buffer an
    axis), in place."""
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)
    import torch.distributed as dist
    from horovod_tpu_torch.parallel.mesh import axis_group, axis_size
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    for axis in _GRAD_AXES:
        n = axis_size(axis, mesh)
        if n == 1 or not grads:
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=axis_group(axis, mesh))
        flat /= n
        for g, new in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(new)


def _check_tp_model(model: TransformerLM, mesh) -> None:
    from horovod_tpu_torch.parallel.mesh import (AXIS_EXPERT, axis_size,
                                                 model_degree)
    cut_mesh = mesh is not None and (model_degree(mesh) > 1
                                     or axis_size(AXIS_EXPERT, mesh) > 1)
    if (cut_mesh or model.sharded) and model.mesh is not mesh:
        raise ValueError("a mesh with model > 1 needs the model built "
                         "over it (TransformerLM(..., mesh=mesh)), as does "
                         "one with expert > 1, and a sharded model runs "
                         "over its own mesh")


def _check_mesh_world(mesh, optimizer=None) -> None:
    if mesh.size() != optim.world_size():
        raise ValueError(
            f"a mesh of {mesh.size()} ranks needs horovod_tpu_torch.init() "
            f"over the same world (world size {optim.world_size()})")
    if optimizer is not None and optim.is_distributed(optimizer):
        raise ValueError(
            "make_lm_train_step over a mesh averages the gradients over "
            "the data and seq ranks itself: give it the optimizer "
            "unwrapped, not a DistributedOptimizer (whose average over "
            "every rank would also run over the model axis)")


def make_lm_train_step(model: TransformerLM,
                       optimizer: torch.optim.Optimizer, mesh=None, *,
                       moe_aux_weight: float = 0.01,
                       loss_chunk: Optional[int] = None) -> Callable:
    """``step(tokens) -> loss``: one train step of ``model`` -- loss,
    gradients, their average, then ``optimizer.step()``. Returns the
    loss averaged over ranks as a 0-d device tensor (the JAX step's
    ``lax.pmean``): no ``.item()`` and no host sync inside the step.
    ``loss_chunk`` runs the fused head + CE in chunks of that many
    positions. An MoE model's loss adds ``moe_aux_weight`` times the sum
    of its blocks' load-balancing terms, as the JAX step does. Each call
    is a ``train_step`` span on the timeline
    (`utils.timeline.step_bracket`), as in the JAX package.

    Without ``mesh``: data parallel, ``tokens`` this rank's rows [B, S];
    the optimizer's step averages the gradients over the ranks, so at
    world size > 1 it must be an `optim.DistributedOptimizer` (a plain
    one would let the replicas drift apart).

    With a mesh (`parallel.mesh.make_mesh` over ``data``, ``seq``,
    ``expert`` and ``model``, over the world that `init` formed), as the
    JAX package's mesh step takes a plain optax transform: ``tokens`` is
    this rank's block [B/dp, S/sp] (`parallel.mesh.shard_batch`; the
    model and expert ranks of one data rank read the same block), the
    model runs under the mesh (global positions and global MoE routing;
    ``attn_impl`` ring or Ulysses for seq > 1; with ``model`` or
    ``expert`` > 1 the shard built over ``mesh``), the loss is the one
    mean over the global batch's B * (S - 1) labels, and the step itself
    averages the gradients over the data and seq ranks (`_GRAD_AXES`),
    never over ``model`` or ``expert`` (an expert rank's experts are its
    own), before the update of ``optimizer``, which must not be a
    `DistributedOptimizer`."""
    _check_tp_model(model, mesh)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            _check_mesh_world(mesh, optimizer)
        elif optim.world_size() > 1 and not optim.is_distributed(optimizer):
            raise ValueError(
                "make_lm_train_step at world size > 1 needs a "
                "DistributedOptimizer (it averages the gradients)")
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = _lm_data_loss(model, tokens, loss_chunk, moe_aux_weight)
            loss.backward()
        else:
            from horovod_tpu_torch.parallel.mesh import use
            with use(mesh):
                loss = _lm_shard_loss(model, tokens, mesh, loss_chunk,
                                      moe_aux_weight)
                loss.backward()
            _replica_average(model, mesh)
        optimizer.step()
        return optim.mean_over_ranks(loss.detach())

    from horovod_tpu_torch.utils.timeline import step_bracket
    return step_bracket(step)


def make_lm_eval_step(model: TransformerLM, mesh=None, *,
                      loss_chunk: Optional[int] = None) -> Callable:
    """``eval(tokens) -> mean next-token cross entropy`` (nats), the
    forward-only twin of `make_lm_train_step` (same loss sites, same
    ``mesh`` contract), averaged over ranks; perplexity = exp(loss).
    For an MoE model this is PURE cross entropy: the train step's
    load-balancing term is a regularizer, not part of the likelihood,
    so the train step's loss sits ``moe_aux_weight * aux`` above it on
    the same batch, as in the JAX package."""
    _check_tp_model(model, mesh)

    @torch.no_grad()
    def ev(tokens: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            return optim.mean_over_ranks(_lm_data_loss(model, tokens,
                                                       loss_chunk))
        from horovod_tpu_torch.parallel.mesh import use
        _check_mesh_world(mesh)
        with use(mesh):
            return optim.mean_over_ranks(
                _lm_shard_loss(model, tokens, mesh, loss_chunk))

    return ev


def init_lm_state(model: TransformerLM, optimizer: torch.optim.Optimizer,
                  seed: int = 0):
    """Draw the model's weights from ``seed`` and broadcast parameters
    and optimizer state from rank 0, so every rank starts identically
    (a no-op broadcast at world size 1 or before `init()`); under a
    (data, seq) mesh the parameters are replicated over the whole
    world, so this is its placement too. A sharded model (tensor or
    expert parallel) draws the whole model and keeps its shard on every
    rank, so nothing is broadcast (the shards differ by rank). Returns
    ``(model, optimizer)``."""
    model.init_weights(seed)
    if model.sharded:
        return model, optimizer
    optim.broadcast_parameters(model.state_dict(), root_rank=0)
    optim.broadcast_optimizer_state(optimizer, root_rank=0)
    return model, optimizer


def lm_param_specs(model: TransformerLM) -> dict:
    """{state-dict name: partition spec} of every parameter of
    ``model``, by the JAX package's rules (its `lm_param_specs`): the
    blocks' dense pairs and the experts as `parallel.tensor.param_specs`
    gives them, ``embed`` and ``lm_head`` ``('model', None)``, ``pos``,
    the routers and the norms replicated ``()``. For inspection;
    `tp_specs` gives the layout a shard is actually cut by."""
    from horovod_tpu_torch.parallel.tensor import param_specs
    specs = param_specs(model)
    for name in ("embed", "lm_head"):
        if name in specs:
            specs[name] = (AXIS_MODEL, None)
    return specs


def adopt_state(model: nn.Module, state: dict) -> nn.Module:
    """Point every parameter and buffer of ``model`` at the tensor of
    ``state`` under its name, storage and dtype included (no copy, no
    cast), keeping the parameter objects and the gradient hooks they
    carry (`ParallelSelfAttention`'s shared-kv sum), which
    ``load_state_dict(assign=True)`` would replace. The names must
    match exactly. Returns ``model``."""
    own = model.state_dict(keep_vars=True)
    if set(own) != set(state):
        raise KeyError(f"state names differ from the model's: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    for name, t in own.items():
        if tuple(t.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: shape {tuple(state[name].shape)}, "
                             f"the model holds {tuple(t.shape)}")
        t.data = state[name]
    return model


def shard_model(model: TransformerLM, mesh) -> TransformerLM:
    """The tensor-parallel twin of the whole ``model`` over ``mesh``
    (same configuration, built with ``mesh=``) holding this rank's
    shard of its weights, each at the dtype ``model`` keeps it (a
    serving model's bf16 kernels stay bf16). The shard owns its
    storage, so ``model`` can be freed."""
    from horovod_tpu_torch.compat.from_jax import shard_state_dict
    sharded = model.clone(mesh=mesh)
    sd = shard_state_dict(sharded, model.state_dict(), mesh)
    adopt_state(sharded, {k: v.clone() for k, v in sd.items()})
    return sharded.train(model.training)


def tp_specs(model: TransformerLM, mesh=None) -> dict:
    """`lm_param_specs` degraded as `parallel.mesh.safe_spec` degrades
    them on the whole model's shapes over ``mesh`` (default the
    model's): ``embed`` / ``lm_head`` stay whole when tp does not divide
    the vocab."""
    from horovod_tpu_torch.parallel.mesh import model_degree
    tp = model.tp if mesh is None else model_degree(mesh)
    specs = lm_param_specs(model)
    if tp == 1 or model.vocab_size % tp:
        for name in ("embed", "lm_head"):
            if name in specs:
                specs[name] = (None, None)
    return specs


def serving_params(model: TransformerLM,
                   dtype=torch.bfloat16) -> TransformerLM:
    """Cast the big (ndim >= 2) float params to the serving dtype in
    place; 1-D params (norm scales, biases) stay f32 for their
    higher-precision epilogues. Returns ``model``."""
    for p in model.parameters():
        if p.ndim >= 2 and p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def init_cache(model: TransformerLM, lanes: int) -> KVCache:
    """Zero-filled decode cache for ``lanes`` sequences, on the model's
    device: ``max_len`` rows a lane, or exactly ``window`` slots for a
    sliding-window model (not min(max_len, window): a cache shorter than
    the window would evict in-band keys once positions pass max_len);
    int8 rows plus f32 scales under ``kv_quant``."""
    W = model.max_len if model.window is None else model.window
    shape = (lanes, W, model.local_kv, model.head_dim)
    dev = model.device
    L = model.num_layers

    def zeros(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(L)]
    if model.kv_quant is None:
        return KVCache(zeros(shape, model.dtype), zeros(shape, model.dtype),
                       torch.zeros(lanes, dtype=torch.int32, device=dev))
    return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8),
                   torch.zeros(lanes, dtype=torch.int32, device=dev),
                   zeros(shape[:-1], torch.float32),
                   zeros(shape[:-1], torch.float32))


def nucleus_mask(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Top-p truncation: every logit outside the smallest prefix of the
    sorted distribution with cumulative probability >= top_p goes to
    the f32 minimum; the first token is always kept. ``top_p`` is a
    float or a tensor broadcastable to [..., 1] (per-lane)."""
    neg = torch.finfo(logits.dtype).min
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = csum - probs < top_p
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, neg),
                       logits)


def sample_token(logits: torch.Tensor, temperature: torch.Tensor,
                 top_p: torch.Tensor,
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-lane token from [L, V] f32 logits with per-lane tensors
    ``temperature`` / ``top_p`` [L]: temperature <= 0 picks argmax,
    top_p >= 1 disables the nucleus. ``noise`` [L, V] is each sampled
    lane's Gumbel noise (rows of greedy lanes are ignored); None when
    no lane samples, which skips the sampled branch entirely."""
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        return greedy
    temp = temperature[:, None]
    tp = top_p[:, None]
    scaled = logits / torch.clamp_min(temp, 1e-6)
    scaled = torch.where(tp < 1.0, nucleus_mask(scaled, tp), scaled)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _last_logits(model: TransformerLM, cache: KVCache, toks, *,
                 prefix_len: Optional[int] = None) -> torch.Tensor:
    """One decode call; projects ONLY the last position through the LM
    head (prefill never materializes [B, P, V] logits) and advances
    every lane's fill by the call's length."""
    hidden, head = model(toks, cache, prefix_len=prefix_len,
                         return_hidden=True)
    cache.index += toks.shape[1]
    return project_logits(hidden[:, -1], head).float()


@torch.no_grad()
def generate(model: TransformerLM, prompt, steps: int, *,
             temperature: float = 0.0, rng=None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_id: Optional[int] = None, pad_id: int = 0,
             early_stop: bool = False) -> torch.Tensor:
    """Autoregressive generation with a KV cache: the prompt [B, P]
    prefills in ONE forward (through the model's kernel, flash under
    ``attn_impl="flash"``), then one decode call per token (the
    flash-decode kernel under ``decode_prefix_impl="pallas"``).
    Returns [B, P + steps] on the model's device.

    Greedy at ``temperature=0``; otherwise Gumbel-max sampling keyed by
    ``rng`` (a threefry key, `ops.threefry.prng_key`), split as the JAX
    package splits it, so a seeded stream equals the reference's;
    optionally truncated to ``top_k`` and/or the ``top_p`` nucleus.
    ``eos_id``: finished rows emit ``pad_id`` afterwards; ``early_stop`` (requires eos_id) ends the
    loop once every row is done — that check reads the device once
    per token. ``P + steps - 1`` must fit max_len, except for a RoPE
    model with a ``window`` (its rolling cache generates any length)."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    B, P = prompt.shape
    if steps <= 0:
        return prompt
    if temperature > 0 and rng is None:
        raise ValueError("sampling (temperature > 0) requires rng")
    if (top_k is not None or top_p is not None) and temperature <= 0:
        raise ValueError("top_k/top_p require temperature > 0")
    if top_p is not None and not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and not 1 <= top_k <= model.vocab_size:
        raise ValueError(f"top_k must be in [1, vocab_size="
                         f"{model.vocab_size}], got {top_k}")
    if eos_id is not None and not 0 <= eos_id < model.vocab_size:
        raise ValueError(f"eos_id must be in [0, vocab_size="
                         f"{model.vocab_size}), got {eos_id}")
    if eos_id is not None and not 0 <= pad_id < model.vocab_size:
        raise ValueError(f"pad_id must be in [0, vocab_size="
                         f"{model.vocab_size}), got {pad_id}")
    if early_stop and eos_id is None:
        raise ValueError("early_stop requires eos_id (without a stop "
                         "token there is nothing to stop early on)")
    if not model.unbounded and P + steps - 1 > model.max_len:
        raise ValueError(f"prompt ({P}) + steps ({steps}) - 1 exceeds "
                         f"max_len={model.max_len} (use pos_emb='rope' "
                         f"with window= for unbounded generation)")
    if rng is None:
        rng = threefry.prng_key(0)
    cache = init_cache(model, B)
    gen = _generate_scan(model, cache, prompt, threefry.as_keys(rng),
                         steps, float(temperature), top_k, top_p, eos_id,
                         pad_id,
                         greedy=temperature <= 0, early_stop=early_stop)
    return torch.cat([prompt, gen], dim=1)


def _generate_scan(model, cache, prompt, rng, steps, temperature,
                   top_k=None, top_p=None, eos=None, pad=0, *,
                   greedy=False, early_stop=False) -> torch.Tensor:
    """The prefill + decode loop of `generate` (the JAX package's
    compiled scan; a Python loop here, with no host read unless
    ``early_stop``). The key chain is the reference's: ``rng, r0 =
    split(rng)`` for the prefill's token, then ``r, r_tick = split(r)``
    each tick, every key drawing the noise of the whole [B, V] batch.
    Returns the [B, steps] generated tokens."""

    def pick(logits, r):
        if greedy:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        neg = torch.finfo(logits.dtype).min
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, neg), logits)
        if top_p is not None:
            logits = nucleus_mask(logits, top_p)
        return threefry.categorical(r, logits)

    rng, r0 = threefry.split(rng)
    tok = pick(_last_logits(model, cache, prompt), r0)
    done = (tok == eos) if eos is not None else None
    out = [tok]
    P = prompt.shape[1]
    for t in range(steps - 1):
        if early_stop and bool(done.all()):
            out.append(torch.full_like(tok, pad))
            continue
        rng, r_tick = threefry.split(rng)
        nxt = pick(_last_logits(model, cache, tok[:, None],
                                prefix_len=P + t + 1), r_tick)
        if eos is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
            done = done | (nxt == eos)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def generate_bucketed(model: TransformerLM, prompts, steps: int, **kw):
    """Mixed-length batched generation by length bucketing: ``prompts``
    is a list of 1-D token sequences; same-length prompts share one
    `generate` call, and the results come back in input order as a
    list of 1-D [P_i + steps] tensors. Every `generate` keyword passes
    through (eos_id / pad_id keep their per-row contract, and
    ``early_stop`` stops each bucket at its own last finisher); under
    sampling the bucket of length-``n`` prompts draws from
    ``fold_in(rng, n)``, as in the JAX package."""
    arrs = [torch.as_tensor(p) for p in prompts]
    by_len: dict = {}
    for idx, p in enumerate(arrs):
        if p.ndim != 1:
            raise ValueError(
                f"generate_bucketed wants 1-D prompts, got shape "
                f"{tuple(p.shape)}; for an already-rectangular batch call "
                f"generate directly")
        by_len.setdefault(p.shape[0], []).append(idx)
    out: list = [None] * len(arrs)
    for n, idxs in by_len.items():
        bkw = kw
        if kw.get("rng") is not None:
            bkw = dict(kw, rng=threefry.fold_in(kw["rng"], n))
        res = generate(model, torch.stack([arrs[i] for i in idxs]), steps,
                       **bkw)
        for row, i in enumerate(idxs):
            out[i] = res[row]
    return out


# ---------------------------------------------------------------------------
# Slot-aware decode (the device surface of `serving.slots.SlotPool`).
#
# A slot pool is a `KVCache` whose lanes are the decode slots: every
# slot holds a different request at a different fill. Prefill appends
# one prompt chunk into ONE slot's lanes (views of the pool tensors)
# through the any-fill ``chunked_prefill`` path; the decode tick runs
# ONE batched model call over every slot with per-lane fills, and the
# per-lane lengths reach the flash-decode kernel as a device int32
# tensor — no host sync inside the tick.
# ---------------------------------------------------------------------------

def slot_decode_model(model: TransformerLM) -> Callable:
    """The decode call every slot primitive shares: any-fill
    (``chunked_prefill``) appends returning ``(hidden, head)``, each
    lane routed through the MoE blocks alone (``route_rows``: the JAX
    package vmaps a one-lane call over the slots, so a lane's capacity
    counts its own tokens only)."""
    return functools.partial(model, chunked_prefill=True,
                             return_hidden=True, route_rows=True)


def init_slot_cache(model: TransformerLM, num_slots: int) -> KVCache:
    """Zero-filled slot-pool cache: one lane per slot (K/V [num_slots,
    W, Hkv, D] per layer as `init_cache`, fill indices [num_slots])."""
    return init_cache(model, num_slots)


@torch.no_grad()
def slot_reset(cache: KVCache, slot: int):
    """Zero one slot's rows and fill index (alloc/retire hygiene: stale
    K/V past the fill is never attended, but zeroed rows keep the
    slot's state trivially inspectable)."""
    for t in cache.tensors():
        t[slot].zero_()
    cache.index[slot] = 0


@torch.no_grad()
def slot_prefill_chunk(dec_model: Callable, cache: KVCache, slot: int,
                       chunk: torch.Tensor,
                       fill: Optional[int] = None) -> torch.Tensor:
    """Append one [C]-token prompt chunk into slot ``slot`` (in place)
    and return its last-position logits [V] f32 on the device.
    ``fill``: the slot's fill before the chunk, as the host knows it;
    the attention then reads only the filled cache slices."""
    sub = cache.lanes(slot)
    hidden, head = dec_model(
        chunk[None, :], sub,
        prefix_len=None if fill is None else fill + chunk.shape[0])
    sub.index += chunk.shape[0]
    return project_logits(hidden[0, -1], head).float()


def prefill_chunks(length: int, max_chunk: Optional[int] = None) -> list:
    """Binary decomposition of a prompt length into descending
    power-of-two chunk sizes (13 -> [8, 4, 1]); ``max_chunk`` caps
    every chunk at the largest power of two <= max_chunk (the
    HVD_PREFILL_CHUNK_BUDGET knob's interleaving)."""
    if length <= 0:
        raise ValueError(f"prompt length must be positive, got {length}")
    out = []
    if max_chunk is not None and max_chunk >= 1:
        cap = 1 << (int(max_chunk).bit_length() - 1)   # pow2 floor
        out = [cap] * (length // cap)
        length -= cap * (length // cap)
    return out + [1 << b for b in range(length.bit_length() - 1, -1, -1)
                  if length >> b & 1]


def _freeze_cache_indices(new_index: torch.Tensor, old_index: torch.Tensor,
                          advance: torch.Tensor) -> torch.Tensor:
    """Per-lane select between the advanced and the old fill index: a
    lane that must not move (FREE or mid-prefill slots riding the
    batched tick, finished-but-unretired slots) keeps its index. The
    K/V row such a lane wrote at that frozen position is harmless —
    masks attend positions < index, and the next real writer lands on
    the same row."""
    return torch.where(advance, new_index, old_index)


@torch.no_grad()
def slot_decode_tick(dec_model: Callable, cache: KVCache,
                     toks: torch.Tensor, temps: torch.Tensor,
                     top_ps: torch.Tensor, noise: Optional[torch.Tensor],
                     live: torch.Tensor, done: torch.Tensor,
                     eos: torch.Tensor):
    """One continuous-batching decode tick over EVERY slot, as one
    batched model call. Returns ``(next_toks [num_slots], done)``; the
    cache advances in place.

    * ``live`` [S] bool — host-known active lanes; the others ride the
      call with FROZEN fill indices (`_freeze_cache_indices`).
    * ``done`` [S] bool + ``eos`` (-1 disables) — on-device stop: a lane
      that emitted eos keeps emitting eos and stops advancing, so the
      host can retire from the asynchronously copied token buffer.
    * ``noise`` — per-lane Gumbel noise for sampled lanes (None: every
      lane is greedy)."""
    hidden, head = dec_model(toks[:, None], cache)
    old = cache.index.clone()
    cache.index.copy_(_freeze_cache_indices(old + 1, old, live & ~done))
    logits = project_logits(hidden[:, -1], head).float()
    nxt = sample_token(logits, temps, top_ps, noise)
    emit = torch.where(done, eos.to(nxt.dtype), nxt)
    return emit, done | (emit == eos)


# ---------------------------------------------------------------------------
# The paged slot cache (the device surface of `serving.paging`).
#
# Device KV lives in per-layer block pools [num_blocks, block_size, Hkv,
# D] shared by every lane; each lane indexes them through its row of the
# block table [num_slots, blocks_per_seq] int32, and its true fill is
# one int32 per lane, shared by every layer. Block 0 is the NULL block:
# never allocated, never attended; masked lanes route their dead writes
# there. Three modes (`serving.paging._resolve_paged_kernel`):
#
# * "off" — each call gathers every lane's whole table into a linear
#   [lanes, max_len] view (`_paged_view`), runs the linear decode path
#   on it and scatters the call's new rows back into their blocks (the
#   oracle);
# * "lax" — attention walks only the filled blocks through the tables
#   (`ops.paged_attention.paged_prefix_attention`) at the model's
#   decode_prefix_block granularity, the S=1 tick going to the
#   paged-decode kernel when the model's decode_prefix_impl is "pallas";
# * "pallas" — as "lax", with every S=1 call on the paged-decode kernel
#   (CUDA on the card, its plain version on the CPU). S > 1 prefill
#   chunks never reach the kernel and keep walking at the model's
#   decode_prefix_block where it tiles the table, else at the block
#   size (the JAX package always walks them at the block size: the
#   same values, ~16x fewer steps at 256-token granularity).
#
# Unlike the JAX package, whose programs return new pools, the pools,
# tables and fills here are updated IN PLACE.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PagedCacheSpec:
    """Block geometry of one paged slot cache: ``block_size`` tokens per
    block, ``blocks_per_seq`` table entries per lane (max_len /
    block_size)."""

    block_size: int
    blocks_per_seq: int

    @property
    def view_len(self) -> int:
        return self.block_size * self.blocks_per_seq


def paged_cache_spec(model: TransformerLM,
                     block_size: int) -> PagedCacheSpec:
    """The paged geometry of ``model``: ``block_size`` must divide
    max_len exactly (the gathered view is then shape-identical to the
    linear cache), and the model must have no sliding window (a
    rolling buffer has no block-aligned prefix to page or share)."""
    if model.window is not None:
        raise ValueError(
            "paged KV cache requires window=None (a rolling-window "
            "cache has no block-aligned prefix to page or share)")
    if block_size < 1 or model.max_len % block_size:
        raise ValueError(
            f"block_size must divide max_len={model.max_len} exactly, "
            f"got {block_size}")
    return PagedCacheSpec(int(block_size), model.max_len // block_size)


def init_paged_pools(model: TransformerLM, spec: PagedCacheSpec,
                     num_blocks: int) -> list:
    """Zero-filled block pools on the model's device, one tuple per
    layer: ``(k_pool, v_pool)`` [num_blocks, block_size, Hkv, D], and
    under int8 KV ``(k_pool, v_pool, k_scale_pool, v_scale_pool)``, the
    pools int8 and the scale pools [num_blocks, block_size, Hkv] f32.
    Block 0 is the null block."""
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved null "
            f"block), got {num_blocks}")
    shape = (num_blocks, spec.block_size, model.local_kv, model.head_dim)
    dev = model.device
    if model.kv_quant is None:
        return [tuple(torch.zeros(shape, dtype=model.dtype, device=dev)
                      for _ in range(2))
                for _ in range(model.num_layers)]
    return [tuple(torch.zeros(shape, dtype=torch.int8, device=dev)
                  for _ in range(2))
            + tuple(torch.zeros(shape[:-1], device=dev) for _ in range(2))
            for _ in range(model.num_layers)]


def _serve_kv_axis(axis: Optional[str] = None) -> str:
    """The mesh axis serving KV shards ride (``HVD_SERVE_MESH_AXIS``,
    default ``model``: kv heads live with their query groups). The port
    serves over ``model`` only; any other axis raises."""
    if axis is None:
        from horovod_tpu_torch.runtime.config import config as _cfg
        axis = _cfg.serve_mesh_axis or AXIS_MODEL
    if axis != AXIS_MODEL:
        raise NotImplementedError(
            f"serving mesh axis {axis!r} (HVD_SERVE_MESH_AXIS): the port "
            f"shards serving over the 'model' axis only")
    return axis


def _kv_index(mesh, hkv: int, num_heads: Optional[int]) -> Optional[list]:
    """The kv heads this rank keeps of a whole cache's ``hkv``, or None
    to keep them all: Hkv/tp contiguous heads when tp divides Hkv; else
    (given ``num_heads``) the one its query group reads, as a
    tensor-parallel model's cache holds it, and (without it) all of
    them, the JAX package's `safe_spec` degrade."""
    from horovod_tpu_torch.parallel.mesh import axis_index, model_degree
    tp = model_degree(mesh)
    if tp == 1 or (hkv % tp and num_heads is None):
        return None
    return kv_heads_of(axis_index(AXIS_MODEL, mesh),
                       num_heads or hkv, hkv, tp)


def shard_slot_cache(cache: KVCache, mesh, axis: Optional[str] = None, *,
                     num_heads: Optional[int] = None) -> KVCache:
    """This rank's kv heads of a whole slot-pool cache (`init_slot_cache`
    of the unsharded model): K/V and their int8 scales cut on the heads
    dim over the serving axis (`_serve_kv_axis`); the fill index stays
    whole. ``num_heads`` (the model's query heads) picks a GQA rank's
    one kv head when tp does not divide Hkv."""
    _serve_kv_axis(axis)
    idx = _kv_index(mesh, cache.k[0].shape[2], num_heads)

    def cut(ts):
        if ts is None or idx is None:
            return ts
        return [t[:, :, idx].contiguous() for t in ts]
    return KVCache(cut(cache.k), cut(cache.v), cache.index,
                   cut(cache.k_scale), cut(cache.v_scale))


def shard_paged_pools(pools, mesh, axis: Optional[str] = None, *,
                      num_heads: Optional[int] = None) -> list:
    """This rank's kv heads of whole paged block pools (`init_paged_pools`
    of the unsharded model): every pool cut on its heads dim (dim 2 of
    [num_blocks, block_size, Hkv, ...]), so a host block id names the
    same block on every rank. Same GQA rule as `shard_slot_cache`."""
    _serve_kv_axis(axis)
    idx = _kv_index(mesh, pools[0][0].shape[2], num_heads)
    if idx is None:
        return pools
    return [tuple(t[:, :, idx].contiguous() for t in layer)
            for layer in pools]


def _pools_cache(pools) -> tuple:
    """Per-layer pool lists (K, V, K scales or None, V scales or None)."""
    k, v = [layer[0] for layer in pools], [layer[1] for layer in pools]
    if len(pools[0]) == 2:
        return k, v, None, None
    return k, v, [layer[2] for layer in pools], [layer[3] for layer in pools]


def _paged_view(pools, tables, fills) -> KVCache:
    """Every lane's [lanes, max_len, Hkv, D] linear cache view (its
    scales too, under int8 KV) gathered through its block table (the
    "off" mode), with index = the fills. The view is a copy: writes
    into it do not reach the pools."""
    idx = tables.long()

    def gather(ts):
        return None if ts is None else [t[idx].flatten(1, 2) for t in ts]
    k, v, ks, vs = _pools_cache(pools)
    return KVCache(gather(k), gather(v), fills.clone(), gather(ks),
                   gather(vs))


def _paged_apply(model: TransformerLM, spec: PagedCacheSpec, pools,
                 tables, fills, toks, write_block, write_off,
                 paged_kernel: str, prefix_len: Optional[int]):
    """THE dispatch site the prefill chunk and the tick share: one
    any-fill decode call of ``toks`` [lanes, S] over the lanes of
    ``tables``/``fills``, the new K/V rows ending in the pools at
    (``write_block``, ``write_off``) [lanes, S]. Returns ``(hidden,
    head)``; the caller advances the fills."""
    S = toks.shape[1]
    if paged_kernel == "off":
        view = _paged_view(pools, tables, fills)
        hidden, head = model(toks, view, chunked_prefill=True,
                             prefix_len=prefix_len, return_hidden=True,
                             route_rows=True)
        # The rows the linear path just wrote (its start clamps to
        # W - S, as the write did).
        start = fills.long().clamp(max=spec.view_len - S)
        rows = start[:, None] + torch.arange(S, device=toks.device)
        lanes = torch.arange(toks.shape[0], device=toks.device)[:, None]
        for i, layer in enumerate(pools):
            for pool, rows_of in zip(layer, view.layer_tensors(i)):
                pool[write_block, write_off] = rows_of[lanes, rows]
        return hidden, head
    k, v, ks, vs = _pools_cache(pools)
    cache = PagedKVCache(k, v, tables, fills, write_block, write_off,
                         decode_impl=("pallas" if paged_kernel == "pallas"
                                      else None), k_scale=ks, v_scale=vs)
    return model(toks, cache, chunked_prefill=True, prefix_len=prefix_len,
                 return_hidden=True, route_rows=True)


@dataclass
class PagedKVCache:
    """Paged decode cache of a whole model, as the model's forward
    takes it: per-layer pools, the lanes' tables and fills, and the
    write targets of this call (see `PagedLayerCache`). ``index`` is
    the fill (learned positions read it). ``k_scale``/``v_scale``: the
    per-layer scale pools under int8 KV."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    table: torch.Tensor
    fill: torch.Tensor
    write_block: torch.Tensor
    write_off: torch.Tensor
    decode_impl: Optional[str] = None
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @property
    def index(self) -> torch.Tensor:
        return self.fill

    def layer(self, i: int) -> PagedLayerCache:
        return PagedLayerCache(
            self.k[i], self.v[i], self.table, self.fill, self.write_block,
            self.write_off, self.decode_impl,
            None if self.k_scale is None else self.k_scale[i],
            None if self.v_scale is None else self.v_scale[i])


@torch.no_grad()
def paged_prefill_chunk(model: TransformerLM, spec: PagedCacheSpec, pools,
                        tables, fills, slot: int, chunk: torch.Tensor, *,
                        paged_kernel: str = "lax",
                        fill: Optional[int] = None) -> torch.Tensor:
    """Append one [C]-token prompt chunk into lane ``slot``'s paged cache
    (pools and ``fills[slot]`` updated in place) and return its
    last-position logits [V] f32 on the device. The call is the any-fill
    ``chunked_prefill`` path, correct at any fill, including one that
    starts past a shared-prefix span the admission matched and skipped.
    ``fill``: the lane's fill before the chunk as the host knows it; it
    bounds the walk (and the "off" view's prefix loop) to the filled
    blocks. The chunk must end within max_len."""
    C = chunk.shape[0]
    table = tables[slot:slot + 1]
    f = fills[slot:slot + 1]
    pos = f.long()[:, None] + torch.arange(C, device=chunk.device)
    bids = table.long().gather(1, pos // spec.block_size)
    hidden, head = _paged_apply(
        model, spec, pools, table, f, chunk[None, :], bids,
        pos % spec.block_size, paged_kernel,
        None if fill is None else fill + C)
    f += C
    return project_logits(hidden[0, -1], head).float()


@torch.no_grad()
def paged_decode_logits(model: TransformerLM, spec: PagedCacheSpec, pools,
                        tables, fills, toks: torch.Tensor,
                        live: torch.Tensor, done: torch.Tensor, *,
                        paged_kernel: str = "lax",
                        prefix_len: Optional[int] = None) -> torch.Tensor:
    """The model half of `paged_decode_tick`: ``toks`` [lanes] through
    one batched model call over EVERY lane, pools and fills updated in
    place; returns the logits [lanes, V] f32. A lane that must not
    advance (``live`` False, or ``done``) keeps its fill and routes its
    row to the null block. A lane at fill == max_len (the pipelined
    tick at the P + max_new - 1 == max_len boundary) has no table entry
    for its row: the write goes to the null block too, never to a
    clipped id, which would overwrite the lane's last real block.
    ``prefix_len``: a host-side upper bound on every advancing lane's
    fill after the tick (bounds the walk; None walks whole tables)."""
    bs, T = spec.block_size, spec.blocks_per_seq
    adv = live & ~done
    blk = fills.long() // bs
    owner = tables.long().gather(1, blk.clamp(max=T - 1)[:, None])[:, 0]
    bids = torch.where(adv & (blk < T), owner, torch.zeros_like(owner))
    offs = fills.long() % bs
    hidden, head = _paged_apply(model, spec, pools, tables, fills,
                                toks[:, None], bids[:, None],
                                offs[:, None], paged_kernel, prefix_len)
    fills.copy_(torch.where(adv, fills + 1, fills))
    return project_logits(hidden[:, -1], head).float()


@torch.no_grad()
def paged_decode_tick(model: TransformerLM, spec: PagedCacheSpec, pools,
                      tables, fills, toks: torch.Tensor,
                      temps: torch.Tensor, top_ps: torch.Tensor,
                      noise: Optional[torch.Tensor], live: torch.Tensor,
                      done: torch.Tensor, eos: torch.Tensor, *,
                      paged_kernel: str = "lax",
                      prefix_len: Optional[int] = None):
    """One continuous-batching decode tick over EVERY lane of a paged
    pool (`paged_decode_logits`, then sampling). Returns ``(next_toks
    [lanes], done)``, with the occupancy semantics of
    `slot_decode_tick` in paged form."""
    logits = paged_decode_logits(model, spec, pools, tables, fills, toks,
                                 live, done, paged_kernel=paged_kernel,
                                 prefix_len=prefix_len)
    nxt = sample_token(logits, temps, top_ps, noise)
    emit = torch.where(done, eos.to(nxt.dtype), nxt)
    return emit, done | (emit == eos)


@torch.no_grad()
def paged_copy_block(pools, src: int, dst: int):
    """Device-side block copy of every pool, scale pools included (in
    place) — the copy-on-write primitive: before a lane appends into a
    block it shares, the allocator gives it a private copy and this
    materializes the bytes."""
    for layer in pools:
        for t in layer:
            t[dst] = t[src]


def gather_block_rows(pools, block_ids) -> list:
    """The rows of every pool for a block-id list, in leaf order (layer
    0 K, layer 0 V, then under int8 KV layer 0's K and V scales, then
    layer 1 ...): [len(block_ids), block_size, Hkv, D] each, the scales
    [len(block_ids), block_size, Hkv] — the KV-block export. Stays on
    the device; the caller decides whether to bounce through the
    host."""
    dev = pools[0][0].device
    idx = torch.as_tensor(list(block_ids), dtype=torch.long, device=dev)
    return [t[idx] for layer in pools for t in layer]


# ---------------------------------------------------------------------------
# Speculative decoding over the slot pools: one draft-verify ROUND per
# scheduler step replaces the S=1 tick for greedy requests. The draft
# proposes k tokens per lane (k+1 batched S=1 ticks chained on the
# device, the extra one writing p_k's K/V for a full acceptance), the
# target verifies each lane's whole [pending, p_1..p_k] block in ONE
# any-fill S=k+1 append, acceptance and eos truncation are computed on
# the device, and both caches rewind by setting their fill indices —
# rejected rows are invisible to every mask and overwritten by later
# appends. Between 1 and k+1 tokens retire per lane and round; greedy
# acceptance makes the stream exactly the target's greedy decode.
#
# The JAX package's round returns new caches; here the draft chain and
# the verify write their k+1 rows in place and the rewind then sets
# each index to its pre-round value plus the tokens the round consumed
# (0 for a lane that must not advance).
# ---------------------------------------------------------------------------

def _rewind_indices(cache: KVCache, pre: torch.Tensor, delta: torch.Tensor):
    """Set the cache's per-lane fill index to ``pre + delta`` in place
    (the speculative rewind: pre-round fill plus the tokens the round
    consumed; delta 0 freezes a lane). K/V rows past the index are
    stale but invisible — every decode mask attends positions < index
    only, and the next append overwrites them."""
    cache.index.copy_(pre + delta)


def _greedy(hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary of ``hidden`` [..., d] through the LM
    head, at the hidden dtype (as the JAX round's einsum)."""
    return torch.argmax(project_logits(hidden, head), dim=-1)


def _spec_draft_chain(drf_dec: Callable, drf_cache: KVCache,
                      toks: torch.Tensor, adv: torch.Tensor, k: int,
                      prefix_len: Optional[int] = None) -> torch.Tensor:
    """k+1 batched S=1 draft ticks chained on the device (no host
    sync): tick j feeds the previous greedy pick, so the chain proposes
    p_1..p_k; the (k+1)-th pick is discarded — that tick exists to
    write p_k's K/V, which a FULL acceptance needs in the draft cache
    (a partial acceptance rewinds it away). Lanes not in ``adv`` keep
    frozen indices (`_freeze_cache_indices`). ``prefix_len``: a host
    upper bound on every advancing lane's fill before the chain.
    Returns the proposals [L, k+1]."""
    props = []
    cur = toks
    for j in range(k + 1):
        hidden, head = drf_dec(
            cur[:, None], drf_cache,
            prefix_len=None if prefix_len is None else prefix_len + j + 1)
        old = drf_cache.index
        drf_cache.index.copy_(_freeze_cache_indices(old + 1, old, adv))
        cur = _greedy(hidden[:, -1], head)
        props.append(cur)
    return torch.stack(props, dim=1)


def _spec_accept(props: torch.Tensor, greedy: torch.Tensor,
                 pending: torch.Tensor, adv: torch.Tensor,
                 done: torch.Tensor, eos: torch.Tensor, k: int):
    """The acceptance rule, batched and pure integer tensor code: per
    lane, the longest prefix of ``props`` [L, k] matching the target's
    greedy picks ``greedy`` [L, k+1], plus the target's own next token,
    truncated at the first emitted eos (the on-device stop, with the
    tick's done semantics: a done lane re-emits eos once and never
    advances; a non-live lane emits nothing). Returns (emitted [L, k+1]
    — the first n_emit columns are the round's tokens, later columns
    padding —, n_emit [L], done, next pending token [L], proposed
    [L])."""
    match = (props == greedy[:, :k]).long()
    a = torch.cumprod(match, dim=1).sum(dim=1)
    jj = torch.arange(k + 1, device=props.device)[None, :]
    g_at_a = greedy.gather(1, a[:, None])
    props_pad = torch.cat([props, props[:, :1]], dim=1)
    emitted = torch.where(jj < a[:, None], props_pad,
                          torch.where(jj == a[:, None], g_at_a,
                                      torch.zeros_like(g_at_a)))
    n = a + 1
    hit = (emitted == eos) & (jj <= a[:, None])
    eos_idx = torch.where(hit, jj, k + 1).amin(dim=1)
    n = torch.minimum(n, eos_idx + 1)
    new_done = done | (adv & (eos_idx <= a))
    n = torch.where(adv, n, done.long())
    emitted = torch.where((~adv & done)[:, None] & (jj == 0),
                          eos.to(emitted.dtype), emitted)
    last = emitted.gather(1, (n - 1).clamp(0, k)[:, None])[:, 0]
    toks_out = torch.where(adv, last, torch.where(
        done, eos.to(pending.dtype), pending)).to(pending.dtype)
    proposed = torch.where(adv, k, 0)
    return emitted, n, new_done, toks_out, proposed


@torch.no_grad()
def slot_spec_round(dec_model: Callable, drf_dec: Callable, cache: KVCache,
                    drf_cache: KVCache, toks: torch.Tensor,
                    live: torch.Tensor, done: torch.Tensor,
                    eos: torch.Tensor, k: int, *,
                    prefix_len: Optional[int] = None):
    """One speculative draft-verify round over every LINEAR slot lane
    (greedy only). The verify is ONE batched S=k+1 any-fill append over
    every lane (the plain prefix loop, read up to ``prefix_len + k +
    1`` when the host bound ``prefix_len`` on every advancing lane's
    pre-round fill is given), then both caches rewind. Returns
    ``(emitted [L, k+1], n_emit [L], done, toks, proposed)``; each live
    lane retires 1..k+1 tokens, exactly the target's greedy stream."""
    adv = live & ~done
    pre_t = cache.index.clone()
    pre_d = drf_cache.index.clone()
    props = _spec_draft_chain(drf_dec, drf_cache, toks, adv, k, prefix_len)
    block = torch.cat([toks[:, None], props[:, :k]], dim=1)
    hidden, head = dec_model(
        block, cache,
        prefix_len=None if prefix_len is None else prefix_len + k + 1)
    greedy = _greedy(hidden, head)
    emitted, n_emit, done, toks, proposed = _spec_accept(
        props[:, :k], greedy, toks, adv, done, eos, k)
    delta = torch.where(adv, n_emit, 0)
    _rewind_indices(cache, pre_t, delta)
    _rewind_indices(drf_cache, pre_d, delta)
    return emitted, n_emit, done, toks, proposed


@torch.no_grad()
def paged_spec_round(model: TransformerLM, drf_dec: Callable,
                     spec: PagedCacheSpec, pools, drf_cache: KVCache,
                     tables, fills, toks: torch.Tensor, live: torch.Tensor,
                     done: torch.Tensor, eos: torch.Tensor, k: int, *,
                     paged_kernel: str = "lax",
                     prefix_len: Optional[int] = None):
    """The paged twin of `slot_spec_round`: the draft rides its own
    linear slot cache, the verify is a batched S=k+1 paged append
    (`_paged_apply`: the table walk, or the gathered view under
    "off"), the k+1 new rows per lane go to their blocks and only the
    fills (and the draft index) rewind — stale rows past a fill sit in
    the lane's reserved blocks, invisible to every mask. A row past the
    table, or of a lane that must not advance, goes to the null block
    0, never to a clipped id (`paged_decode_logits`'s boundary
    contract). Pools, fills and the draft cache update in place."""
    adv = live & ~done
    pre_d = drf_cache.index.clone()
    props = _spec_draft_chain(drf_dec, drf_cache, toks, adv, k, prefix_len)
    block = torch.cat([toks[:, None], props[:, :k]], dim=1)
    bs, T = spec.block_size, spec.blocks_per_seq
    pos = fills.long()[:, None] + torch.arange(k + 1, device=fills.device)
    blk = pos // bs
    owner = tables.long().gather(1, blk.clamp(max=T - 1))
    bids = torch.where(adv[:, None] & (blk < T), owner,
                       torch.zeros_like(owner))
    hidden, head = _paged_apply(
        model, spec, pools, tables, fills, block, bids, pos % bs,
        paged_kernel,
        None if prefix_len is None else prefix_len + k + 1)
    greedy = _greedy(hidden, head)
    emitted, n_emit, done, toks, proposed = _spec_accept(
        props[:, :k], greedy, toks, adv, done, eos, k)
    delta = torch.where(adv, n_emit, 0)
    _rewind_indices(drf_cache, pre_d, delta)
    fills.copy_(fills + delta)
    return emitted, n_emit, done, toks, proposed


@torch.no_grad()
def slot_prefill_advance(dec_model: Callable, cache: KVCache, slot: int,
                         chunk: torch.Tensor,
                         fill: Optional[int] = None):
    """The draft cache's prompt advance: `slot_prefill_chunk` without
    the LM-head product — speculative decoding needs only the draft's
    K/V warm; the first token is always the target's."""
    sub = cache.lanes(slot)
    dec_model(chunk[None, :], sub,
              prefix_len=None if fill is None else fill + chunk.shape[0])
    sub.index += chunk.shape[0]
