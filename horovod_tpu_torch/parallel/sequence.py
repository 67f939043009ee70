"""Sequence primitives: the band rule, the blockwise (online-softmax)
attention, and ring and Ulysses sequence parallelism.

Counterpart of `horovod_tpu.parallel.sequence`. Layout is [batch, seq,
heads, head_dim]. The JAX package's sequence-parallel functions run
inside `shard_map` on each device's block; the port is SPMD, so
`ring_attention` and `ulysses_attention` take THIS rank's block
[B/dp, S/sp, H, D] and run over the ``seq`` axis of the ambient mesh
(`parallel.mesh.use`), through the differentiable `ops.collectives`
transfers:

* `ring_attention` -- Q stays put, K/V rotate sp - 1 times around the
  ``seq`` ring (`ppermute`), with an online softmax (``block_impl=
  "xla"``, the plain loop) or the flash-forward kernel on every
  rotation (``"flash"``: partials merged by their logsumexp,
  `_merge_partials`, the lse cotangent flowing into the flash
  backward);
* `ulysses_attention` -- two all-to-alls swap the sharded dim from
  sequence to heads around a local attention (blockwise, or the flash
  kernel for ``ulysses_flash``).

K/V stay at kv-head width through the hops and all-to-alls when the
local attention takes grouped K/V natively (the flash kernels).
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional

import torch

from horovod_tpu_torch.parallel.mesh import AXIS_SEQ


def check_window(window: Optional[int]) -> None:
    """THE window argument contract (one site for every entry point)."""
    if window is not None and window < 1:
        raise ValueError(
            f"window must be >= 1 (None disables), got {window}")


def banded_causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """[..., Sq, Sk] bool: k <= q and (with ``window``) q - k < window.

    THE band rule: the dot baseline, the decode cache masks and the
    blockwise/flash kernels all derive from it. Positions are GLOBAL;
    ``q_pos`` may carry leading (per-lane) dims, [..., Sq]."""
    keep = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        keep = keep & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return keep


def _online_block(carry, q, k, v, logit_bias):
    """One online-softmax accumulation step; carry = (o [B,Sq,H,D],
    m [B,H,Sq], l [B,H,Sq]), all float32."""
    o, m, l = carry
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if logit_bias is not None:
        logits = logits + logit_bias
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # Fully masked rows keep m == -inf; guard the shift so
    # exp(-inf - -inf) never produces NaN.
    shift = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                        m_new)
    p = torch.exp(logits - shift[..., None])
    corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                       torch.exp(m - shift))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_size: int = 512, causal: bool = False,
                        window: Optional[int] = None, q_offset: int = 0,
                        k_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention: a loop over K/V chunks with an
    online softmax in float32, [B, Sq, H, D] x [B, Sk, H, D] ->
    [B, Sq, H, D] without the [Sq, Sk] matrix. ``q_offset``/``k_offset``
    are the global positions of element 0; ``window`` (requires causal)
    keeps only the last ``window`` positions."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    check_window(window)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    nblk = max(1, -(-Sk // block_size))
    blk = -(-Sk // nblk)
    q32 = q.float()
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    o = torch.zeros(B, Sq, H, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), float("-inf"), device=dev)
    l = torch.zeros(B, H, Sq, device=dev)
    for i in range(nblk):
        kc = k[:, i * blk:(i + 1) * blk]
        vc = v[:, i * blk:(i + 1) * blk]
        bias = None
        if causal:
            k_pos = k_offset + i * blk + torch.arange(kc.shape[1],
                                                      device=dev)
            keep = banded_causal_mask(q_pos, k_pos, window)
            bias = torch.where(keep, 0.0, float("-inf"))[None, None]
        o, m, l = _online_block((o, m, l), q32, kc.float(), vc, bias)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def _accepts_kwarg(fn, name: str) -> bool:
    """True if ``fn`` can be called with keyword ``name`` (directly, via
    **kwargs, or through functools.partial layers); callables that
    cannot be introspected pass."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    params = sig.parameters
    if name in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def _merge_partials(o1, l1, o2, l2):
    """Exact merge of two softmax partials over disjoint key sets.

    o [B, S, H, D] float32 (normalized partial outputs), l [B, H, S]
    float32 (row logsumexp, -inf where the partial saw no key). Rows
    that neither partial saw stay out 0 and lse -inf, with zero, finite
    gradients: the shift is 0 there (never exp(-inf - -inf)), and the
    logarithm and divisions only see a denominator of 1."""
    m = torch.maximum(l1, l2)
    m_ = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w1 = torch.exp(l1 - m_)
    w2 = torch.exp(l2 - m_)
    den = w1 + w2
    empty = den == 0.0
    wt = torch.where(empty, torch.ones_like(den), den)
    o = (o1 * (w1 / wt).transpose(1, 2)[..., None]
         + o2 * (w2 / wt).transpose(1, 2)[..., None])
    lse = torch.where(empty, torch.full_like(den, float("-inf")),
                      m_ + torch.log(wt))
    return o, lse


def _ring_rotation_live(idx: int, d: int, causal: bool) -> bool:
    """Whether rank ``idx`` attends the K/V block resident at rotation
    ``d`` (the block of rank idx - d mod sp). Under the causal mask a
    wrapped block (idx < d) lies wholly in the future: the rank skips
    its kernel and takes the empty partial, and still joins the
    rotation's transfer."""
    return not (causal and idx < d)


def _empty_partial(q):
    """(o = 0 [B, S, H, D], lse = -inf [B, H, S]), float32."""
    B, S, H, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((B, H, S), float("-inf"), device=q.device))


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with ``others`` joined to its graph (zero
    gradients): keeps every ring transfer on the path of the output,
    so every rank runs every transfer's backward (a rank whose last
    K/V blocks feed no kernel would otherwise skip their transfers and
    leave its neighbours waiting)."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d)
                     for s, t, d in ctx.shapes))


def _ring_attention_flash(q, k, v, *, axis_name, causal, window):
    """Ring attention with the flash-forward kernel on every rotation.

    At rotation d the resident K/V block sits d hops behind this rank,
    so its causal structure is the kernel's own with ``q_offset =
    d * S`` (local block positions); a wrapped block (`_ring_rotation_
    live` false) takes the empty partial instead. Partials merge by
    their logsumexp (`_merge_partials`); the lse cotangent reaches
    `FlashAttentionFn` as ``dlse``."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.ops.flash_attention import flash_attention_lse
    from horovod_tpu_torch.parallel.mesh import axis_index, axis_size
    from horovod_tpu_torch.parallel.mesh import ring_perms
    sp = axis_size(axis_name)
    idx = axis_index(axis_name)
    S = q.shape[1]
    perm, _ = ring_perms(axis_name)
    o_acc, lse_acc = _empty_partial(q)
    kc, vc = k, v
    for d in range(sp):
        if _ring_rotation_live(idx, d, causal):
            o_d, lse_d = flash_attention_lse(
                q, kc, vc, causal=causal, window=window, q_offset=d * S,
                k_offset=0)
            o_acc, lse_acc = _merge_partials(o_acc, lse_acc, o_d.float(),
                                             lse_d)
        if d < sp - 1:
            kc, vc = collectives.ppermute((kc, vc), axis_name, perm)
    return _Anchor.apply(o_acc, kc, vc).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = AXIS_SEQ, causal: bool = False,
                   window: Optional[int] = None,
                   block_impl: str = "xla") -> torch.Tensor:
    """Ring attention over axis ``axis_name`` of the ambient mesh, on
    this rank's contiguous sequence block [B, S/sp, H, D]. K/V rotate
    sp - 1 times around the ring; Q never moves; the result is full
    attention over the global sequence (up to accumulation order).
    ``block_impl="xla"`` accumulates each rotation with the plain
    online softmax (wrapped blocks under the causal mask contribute
    nothing, through the -inf bias), K/V at the query head count;
    ``"flash"`` runs the flash-forward kernel on each rotation
    (`_ring_attention_flash`; grouped K/V taken natively)."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                 ring_perms)
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    check_window(window)
    if block_impl not in ("xla", "flash"):
        raise ValueError(
            f"block_impl must be xla|flash, got {block_impl!r}")
    if block_impl == "flash":
        return _ring_attention_flash(q, k, v, axis_name=axis_name,
                                     causal=causal, window=window)
    sp = axis_size(axis_name)
    idx = axis_index(axis_name)
    B, S, H, D = q.shape
    dev = q.device
    q32 = q.float()
    q_pos = idx * S + torch.arange(S, device=dev)
    o = torch.zeros(B, S, H, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), float("-inf"), device=dev)
    l = torch.zeros(B, H, S, device=dev)
    perm, _ = ring_perms(axis_name)
    kc, vc = k, v
    for step in range(sp):
        bias = None
        if causal:
            # Block kc originated on rank (idx - step) mod sp.
            k_pos = ((idx - step) % sp) * S + torch.arange(S, device=dev)
            keep = banded_causal_mask(q_pos, k_pos, window)
            bias = torch.where(keep, 0.0, float("-inf"))[None, None]
        o, m, l = _online_block((o, m, l), q32, kc.float(), vc, bias)
        if step < sp - 1:
            kc, vc = collectives.ppermute((kc, vc), axis_name, perm)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str = AXIS_SEQ, causal: bool = False,
                      window: Optional[int] = None,
                      attn_impl=None) -> torch.Tensor:
    """DeepSpeed-Ulysses over axis ``axis_name`` of the ambient mesh:
    [B, S/sp, H, D] --all-to-all--> [B, S, H/sp, D], local attention
    (``attn_impl(q, k, v, *, causal, window)``, default blockwise),
    --all-to-all--> [B, S/sp, H, D]. Needs H % sp == 0, and Hkv % sp ==
    0 for grouped K/V. K/V are repeated to the query heads after the
    swap only when ``attn_impl`` does not take grouped K/V natively
    (no ``native_gqa`` marker)."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import axis_size
    sp = axis_size(axis_name)
    H = q.shape[2]
    if H % sp:
        raise ValueError(
            f"ulysses_attention needs heads % seq_degree == 0, got "
            f"{H} heads over seq axis of size {sp}; use ring_attention "
            f"for head counts that don't divide")
    if k.shape[2] != H and k.shape[2] % sp:
        raise ValueError(
            f"ulysses_attention with grouped K/V needs kv_heads % "
            f"seq_degree == 0, got {k.shape[2]} kv heads over seq "
            f"axis of size {sp}; use ring_attention instead")
    check_window(window)
    gqa_repeat = (k.shape[2] != H
                  and not getattr(attn_impl, "native_gqa", False))
    kw = {} if window is None else {"window": window}
    if attn_impl is None:
        attn_impl = functools.partial(blockwise_attention, causal=causal,
                                      **kw)
    else:
        if window is not None and not _accepts_kwarg(attn_impl, "window"):
            raise ValueError(
                f"window={window} was requested but the custom "
                f"attn_impl {getattr(attn_impl, '__name__', attn_impl)!r} "
                f"does not accept a 'window' keyword; add "
                f"window: int | None = None to its signature (contract: "
                f"attn_impl(q, k, v, *, causal, window) -> out)")
        attn_impl = functools.partial(attn_impl, causal=causal, **kw)
    # seq -> heads: split heads (dim 2), gather the sequence (dim 1).
    qh, kh, vh = collectives.alltoall((q, k, v), axis_name=axis_name,
                                      split_axis=2, concat_axis=1)
    if gqa_repeat:
        g = qh.shape[2] // kh.shape[2]
        kh = kh.repeat_interleave(g, dim=2)
        vh = vh.repeat_interleave(g, dim=2)
    oh = attn_impl(qh, kh, vh)
    return collectives.alltoall(oh, axis_name=axis_name, split_axis=1,
                                concat_axis=2)


def _ambient_mesh(mesh):
    from horovod_tpu_torch.parallel.mesh import abstract_mesh
    if mesh is not None:
        return mesh
    mesh = abstract_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or call under "
                         "horovod_tpu_torch.parallel.mesh.use()")
    return mesh


def ring_attention_gspmd(mesh, q, k, v, *, causal: bool = False,
                         window: Optional[int] = None,
                         seq_axis: str = AXIS_SEQ,
                         block_impl: str = "xla") -> torch.Tensor:
    """`ring_attention` over ``mesh`` (None: the ambient mesh) as the
    model calls it: this rank's block [B/dp, S/sp, H, D] in and out,
    the ring over ``seq_axis``."""
    from horovod_tpu_torch.parallel.mesh import use
    with use(_ambient_mesh(mesh)):
        return ring_attention(q, k, v, axis_name=seq_axis, causal=causal,
                              window=window, block_impl=block_impl)


def ulysses_attention_gspmd(mesh, q, k, v, *, causal: bool = False,
                            window: Optional[int] = None,
                            seq_axis: str = AXIS_SEQ,
                            attn_impl=None) -> torch.Tensor:
    """`ulysses_attention` over ``mesh`` (None: the ambient mesh) on
    this rank's block [B/dp, S/sp, H, D]; heads % seq degree == 0."""
    from horovod_tpu_torch.parallel.mesh import use
    with use(_ambient_mesh(mesh)):
        return ulysses_attention(q, k, v, axis_name=seq_axis,
                                 causal=causal, window=window,
                                 attn_impl=attn_impl)
