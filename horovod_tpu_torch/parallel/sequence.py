"""Single-device sequence primitives: the band rule and the blockwise
(online-softmax) attention that is the plain oracle for flash forward.

Counterpart of `horovod_tpu.parallel.sequence` (`check_window`,
`banded_causal_mask`, `blockwise_attention`). Ring and Ulysses sequence
parallelism are a later slice of the port. Layout is [batch, seq,
heads, head_dim].
"""

from __future__ import annotations

from typing import Optional

import torch


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
