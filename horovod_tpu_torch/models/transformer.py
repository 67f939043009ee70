"""Flagship model: the GPT-style transformer LM, its offline generator
and the slot primitives behind continuous-batching serving.

Counterpart of `horovod_tpu.models.transformer` on one device:
`TransformerLM` holds its own weights (an `nn.Module`; load the JAX
package's with `compat.from_jax.params_from_jax`), `generate` is the
offline decoder and serving oracle, and the ``slot_*`` functions are the
device surface of `serving.slots.SlotPool`.

Decode state is an explicit `KVCache` (per-layer K/V rows and a
per-lane int32 fill index on the device) updated in place; where the
JAX package vmaps a B=1 step over the slot axis, the port runs ONE
batched call over all lanes with per-lane fill and position tensors.

Attention kernels: ``dot`` (materialized softmax), ``blockwise``
(online-softmax loop) and ``flash`` (the CUDA flash-forward kernel,
its plain version on the CPU). Sequence-parallel attention, MoE,
LoRA, int8 weights/KV and the paged cache are later slices.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
from torch import nn

from horovod_tpu_torch.parallel.sequence import (banded_causal_mask,
                                                 blockwise_attention,
                                                 check_window)
from horovod_tpu_torch.parallel.tensor import (LayerCache, ParallelMLP,
                                               ParallelSelfAttention,
                                               ParallelSwiGLU)

ATTN_IMPLS = ("dot", "blockwise", "flash")

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
                 window: Optional[int] = None) -> Optional[Callable]:
    """attn_fn for `ParallelSelfAttention` (None = the dot baseline,
    which takes the explicit mask instead)."""
    check_window(window)
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
        raise NotImplementedError(
            f"attn_impl={impl!r} (sequence parallelism) is a later slice "
            f"of the PyTorch port")
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
    """Pre-LN block: attention + MLP (gelu, swiglu or geglu)."""

    def __init__(self, cfg: "TransformerLM", device):
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
            device=device)
        self.ln_mlp = _make_norm(cfg.norm, d, cfg.dtype, cfg.ln_eps, device)
        hidden = cfg.mlp_hidden or cfg.mlp_ratio * d
        if cfg.mlp_impl in ("swiglu", "geglu"):
            self.mlp = ParallelSwiGLU(
                d, hidden, d, dtype=cfg.dtype, device=device,
                activation="gelu_tanh" if cfg.mlp_impl == "geglu"
                else "silu")
        elif cfg.mlp_impl == "gelu":
            self.mlp = ParallelMLP(d, hidden, d, dtype=cfg.dtype,
                                   device=device)
        else:
            raise ValueError(f"mlp_impl must be gelu|swiglu|geglu, got "
                             f"{cfg.mlp_impl!r}")

    def forward(self, x, cache: Optional[LayerCache] = None,
                chunked_prefill: bool = False,
                prefix_len: Optional[int] = None):
        mask = None
        if self.attn_fn is None and cache is None:
            pos = torch.arange(x.shape[-2], device=x.device)
            mask = banded_causal_mask(pos, pos, self.window)[None, None]
        x = x + self.attn(self.ln_attn(x), mask, cache, chunked_prefill,
                          prefix_len)
        return x + self.mlp(self.ln_mlp(x))


@dataclass
class KVCache:
    """Linear decode cache of a whole model: per-layer K/V rows
    [lanes, max_len, Hkv, D] and ONE per-lane fill index [lanes] int32
    shared by every layer (all layers advance together)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: torch.Tensor

    def layer(self, i: int) -> LayerCache:
        return LayerCache(self.k[i], self.v[i], self.index)

    def lanes(self, start: int, stop: Optional[int] = None) -> "KVCache":
        """Views of lanes [start, stop) — writes land in this cache."""
        stop = start + 1 if stop is None else stop
        return KVCache([t[start:stop] for t in self.k],
                       [t[start:stop] for t in self.v],
                       self.index[start:stop])


class TransformerLM(nn.Module):
    """Decoder-only LM: [B, S] int tokens -> [B, S, V] logits.

    The constructor mirrors the JAX module's fields that this slice
    serves (gpt preset by default: learned positions, LayerNorm, gelu
    MLP, tied head) plus ``device``. Weights are created on ``device``
    (CUDA unless ``device="cpu"``) and drawn by `init_weights(seed)`.
    ``weight_quant`` / ``kv_quant`` (int8) are a later slice and raise.
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
                 embed_scale: Optional[float] = None, device=None):
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"pos_emb must be 'learned' or 'rope', got "
                             f"{pos_emb!r}")
        if weight_quant is not None or kv_quant is not None:
            raise NotImplementedError(
                "int8 weights / int8 KV cache are a later slice of the "
                "PyTorch port")
        self.device = resolve_device(device)
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_kv_heads
        self.pos_emb, self.rope_theta, self.window = pos_emb, rope_theta, window
        self.mlp_ratio, self.max_len, self.dtype = mlp_ratio, max_len, dtype
        self.attn_impl = attn_impl
        self.decode_prefix_block = decode_prefix_block
        self.decode_prefix_impl = decode_prefix_impl
        self.attn_bias, self.attn_out_bias = attn_bias, attn_out_bias
        self.ln_eps, self.norm, self.mlp_impl = ln_eps, norm, mlp_impl
        self.mlp_hidden, self.tied_head = mlp_hidden, tied_head
        self.embed_scale = embed_scale
        d = num_heads * head_dim
        dev = self.device
        self.embed = nn.Parameter(torch.empty(vocab_size, d, device=dev))
        self.pos = (nn.Parameter(torch.empty(max_len, d, device=dev))
                    if pos_emb != "rope" else None)
        self.blocks = nn.ModuleList(
            TransformerBlock(self, dev) for _ in range(num_layers))
        self.ln_f = _make_norm(norm, d, dtype, ln_eps, dev)
        self.lm_head = (None if tied_head else
                        nn.Parameter(torch.empty(vocab_size, d, device=dev)))

    @property
    def num_kv(self) -> int:
        return self.num_kv_heads or self.num_heads

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Draw every weight from ``seed`` with a `torch.Generator` on
        the model's device, with the JAX module's initializers: N(0,
        0.02) embedding / positions / untied head, lecun-normal dense
        kernels, zero biases, unit norm scales."""
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

    def forward(self, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                *, chunked_prefill: bool = False,
                prefix_len: Optional[int] = None,
                return_hidden: bool = False):
        """``cache`` None: the training-mode forward. With a `KVCache`:
        a decode call appending ``tokens`` [lanes, S] at each lane's
        fill (the caller advances ``cache.index`` afterwards);
        ``chunked_prefill`` picks the any-fill prefix path for S > 1
        instead of the one-pass empty-cache prefill; ``prefix_len``, a
        host-side upper bound on every lane's fill after the call, bounds
        the plain prefix loop to the filled slices (None: all of them).
        ``return_hidden`` returns ``(hidden [B, S, d], head [V, d])``
        instead of logits."""
        B, S = tokens.shape
        x = self.embed[tokens]
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
                x = x + self.pos[:S]
        x = x.to(self.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if cache is None else cache.layer(i),
                    chunked_prefill, prefix_len)
        x = self.ln_f(x)
        head = self.head()
        if return_hidden:
            return x, head
        return x @ head.to(self.dtype).T


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
    """Zero-filled decode cache for ``lanes`` sequences of up to
    ``max_len`` tokens, on the model's device."""
    if model.window is not None:
        raise NotImplementedError(
            "sliding-window decode (the rolling window cache) is a later "
            "slice of the PyTorch port")
    shape = (lanes, model.max_len, model.num_kv, model.head_dim)
    dev = model.device
    return KVCache(
        [torch.zeros(shape, dtype=model.dtype, device=dev)
         for _ in range(model.num_layers)],
        [torch.zeros(shape, dtype=model.dtype, device=dev)
         for _ in range(model.num_layers)],
        torch.zeros(lanes, dtype=torch.int32, device=dev))


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise drawn from ``generator`` (on its own device),
    the sampling noise of Gumbel-max: argmax(logits + noise) is a
    categorical sample."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


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
    return (hidden[:, -1] @ head.to(hidden.dtype).T).float()


@torch.no_grad()
def generate(model: TransformerLM, prompt, steps: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_id: Optional[int] = None, pad_id: int = 0,
             early_stop: bool = False) -> torch.Tensor:
    """Autoregressive generation with a KV cache: the prompt [B, P]
    prefills in ONE forward (through the model's kernel, flash under
    ``attn_impl="flash"``), then one decode call per token (the
    flash-decode kernel under ``decode_prefix_impl="pallas"``).
    Returns [B, P + steps] on the model's device.

    Greedy at ``temperature=0``; otherwise Gumbel-max sampling with
    noise from ``generator`` (a `torch.Generator`; seeded streams do
    not reproduce `jax.random`'s), optionally truncated to ``top_k``
    and/or the ``top_p`` nucleus. ``eos_id``: finished rows emit
    ``pad_id`` afterwards; ``early_stop`` (requires eos_id) ends the
    loop once every row is done — that check reads the device once
    per token."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    B, P = prompt.shape
    if steps <= 0:
        return prompt
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires generator")
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
    if P + steps - 1 > model.max_len:
        raise ValueError(f"prompt ({P}) + steps ({steps}) - 1 exceeds "
                         f"max_len={model.max_len}")
    cache = init_cache(model, B)
    gen = _generate_scan(model, cache, prompt, generator, steps,
                         float(temperature), top_k, top_p, eos_id, pad_id,
                         greedy=temperature <= 0, early_stop=early_stop)
    return torch.cat([prompt, gen], dim=1)


def _generate_scan(model, cache, prompt, generator, steps, temperature,
                   top_k=None, top_p=None, eos=None, pad=0, *,
                   greedy=False, early_stop=False) -> torch.Tensor:
    """The prefill + decode loop of `generate` (the JAX package's
    compiled scan; a Python loop here, with no host read unless
    ``early_stop``). Returns the [B, steps] generated tokens."""

    def pick(logits):
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
        noise = _gumbel(logits.shape, generator, logits.device)
        return torch.argmax(logits + noise, dim=-1)

    tok = pick(_last_logits(model, cache, prompt))
    done = (tok == eos) if eos is not None else None
    out = [tok]
    P = prompt.shape[1]
    for t in range(steps - 1):
        if early_stop and bool(done.all()):
            out.append(torch.full_like(tok, pad))
            continue
        nxt = pick(_last_logits(model, cache, tok[:, None],
                                prefix_len=P + t + 1))
        if eos is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
            done = done | (nxt == eos)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


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
    (``chunked_prefill``) appends returning ``(hidden, head)``."""
    return functools.partial(model, chunked_prefill=True,
                             return_hidden=True)


def init_slot_cache(model: TransformerLM, num_slots: int) -> KVCache:
    """Zero-filled slot-pool cache: one lane per slot (K/V [num_slots,
    max_len, Hkv, D] per layer, fill indices [num_slots])."""
    return init_cache(model, num_slots)


@torch.no_grad()
def slot_reset(cache: KVCache, slot: int):
    """Zero one slot's rows and fill index (alloc/retire hygiene: stale
    K/V past the fill is never attended, but zeroed rows keep the
    slot's state trivially inspectable)."""
    for t in cache.k + cache.v:
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
    return (hidden[0, -1] @ head.to(hidden.dtype).T).float()


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
    logits = (hidden[:, -1] @ head.to(hidden.dtype).T).float()
    nxt = sample_token(logits, temps, top_ps, noise)
    emit = torch.where(done, eos.to(nxt.dtype), nxt)
    return emit, done | (emit == eos)
