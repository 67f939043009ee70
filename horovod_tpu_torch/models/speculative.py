"""Speculative decoding (greedy): the draft proposes, the target verifies.

Counterpart of `horovod_tpu.models.speculative`. A DRAFT model
proposes ``k`` tokens autoregressively (k cheap S=1 ticks), then the
TARGET scores the whole ``[pending, p_1..p_k]`` block in ONE any-fill
``chunked_prefill`` append; the longest prefix of proposals matching
the target's argmax is accepted, plus the target's own next token —
between 1 and k+1 tokens per target forward. Greedy acceptance makes
the output exactly the target's greedy decode (`generate` at
temperature 0); the draft only changes how many target forwards are
spent per token.

The cache trick: the verify writes K/V for every proposed position; on
a rejection the caches forget the rejected tail by setting the fill
index back (`KVCache.index`) — rows past it are invisible to the mask
and overwritten by later appends. Rolling-window caches overwrite
slots physically, so ``window`` models are refused.

Execution: a host loop (acceptance length is data-dependent). The
prompt prefills through the one-pass forward (the flash-forward kernel
under ``attn_impl="flash"``); the draft ticks and the tail ticks are
S=1 decode calls (the flash-decode kernel under
``decode_prefix_impl="pallas"``), chained on the device; one readback
per round brings the proposals and the verify's greedy picks to the
host.

Scope: batch 1 (acceptance diverges per row), greedy only.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.models.transformer import (
    TransformerLM, _greedy, _last_logits, init_cache,
)


@torch.no_grad()
def generate_speculative(draft_model: TransformerLM,
                         target_model: TransformerLM, prompt, steps: int,
                         *, k: int = 4, return_stats: bool = False):
    """Greedy generation from ``target_model`` accelerated by
    ``draft_model`` proposals; returns ``[1, P + steps]`` tokens equal
    to `generate(target_model, prompt, steps)` (the models hold their
    weights; the JAX function's params arguments have no counterpart).

    ``k``: proposals per round. Each round costs k draft ticks and ONE
    target forward over k+1 positions and yields 1..k+1 tokens.
    ``return_stats`` also returns ``{"rounds", "draft_accepted",
    "tokens"}``."""
    prompt = torch.as_tensor(prompt, device=target_model.device).long()
    if prompt.ndim != 2 or prompt.shape[0] != 1:
        raise ValueError(
            f"speculative decoding is batch-1 (got {tuple(prompt.shape)}); "
            f"the per-lane cache index cannot diverge per row")
    if target_model.window is not None or draft_model.window is not None:
        raise ValueError(
            "sliding-window (rolling-cache) models cannot rewind "
            "rejected proposals; use models.transformer.generate")
    if draft_model.vocab_size != target_model.vocab_size:
        raise ValueError("draft and target vocab sizes differ")
    stats = {"rounds": 0, "draft_accepted": 0, "tokens": 0}
    if steps <= 0:
        return (prompt, stats) if return_stats else prompt
    P = prompt.shape[1]
    # Same bound as `generate`: the final token is never fed.
    for m, name in ((target_model, "target"), (draft_model, "draft")):
        if P + steps - 1 > m.max_len:
            raise ValueError(
                f"prompt+steps-1={P + steps - 1} exceeds {name} "
                f"max_len={m.max_len}")

    t_cache = init_cache(target_model, 1)
    d_cache = init_cache(draft_model, 1)
    # The prompt through the one-pass prefill (numerics as `generate`);
    # the draft only warms its cache, its logits are never read.
    tl = _last_logits(target_model, t_cache, prompt)
    draft_model(prompt, d_cache, return_hidden=True)
    d_cache.index += P
    pending = torch.argmax(tl, dim=-1)                       # [1]

    out = [int(pending[0])]
    consumed = P          # tokens whose K/V both caches hold
    max_fill = min(target_model.max_len, draft_model.max_len)
    while len(out) < steps:
        # The verify appends k_eff + 1 rows; keep them within the cache.
        k_eff = min(k, steps - len(out), max_fill - consumed - 1)
        if k_eff < 1:
            # Cache nearly full: finish with plain target ticks (the
            # final token never needs to be fed).
            while len(out) < steps:
                tl = _last_logits(target_model, t_cache, pending[:, None],
                                  prefix_len=consumed + 1)
                pending = torch.argmax(tl, dim=-1)
                out.append(int(pending[0]))
                consumed += 1
            break
        # The draft proposes k_eff tokens, one tick each, from the
        # pending (not yet fed) token; `cur` stays on the device across
        # the chain.
        cur = pending[:, None]
        block = [cur]
        for j in range(k_eff):
            dl = _last_logits(draft_model, d_cache, cur,
                              prefix_len=consumed + j + 1)
            cur = torch.argmax(dl, dim=-1)[:, None]
            block.append(cur)
        # The target verifies the round in one forward: fed [pending,
        # p_1..p_k], it gives its greedy choice after each. Proposals
        # and picks reach the host in the round's one read.
        block = torch.cat(block, dim=1)
        hidden, head = target_model(block, t_cache, chunked_prefill=True,
                                    prefix_len=consumed + k_eff + 1,
                                    return_hidden=True)
        greedy_dev = _greedy(hidden[0], head)                # [k_eff + 1]
        both = torch.cat([block[0, 1:], greedy_dev]).tolist()
        proposals, greedy = both[:k_eff], both[k_eff:]
        a = 0
        while a < k_eff and greedy[a] == proposals[a]:
            a += 1
        # Accept p_1..p_a plus the target's own token (a == k_eff: every
        # proposal matched and greedy[k_eff] is the free bonus).
        new = proposals[:a] + [greedy[a]]
        out.extend(new)
        stats["rounds"] += 1
        stats["draft_accepted"] += a
        consumed += 1 + a      # pending + accepted proposals
        pending = greedy_dev[a:a + 1]      # new[-1], still on the device
        if a == k_eff:
            # Full acceptance: p_k entered the TARGET cache through the
            # verify but was never fed to the draft (its ticks stop at
            # p_{k-1}), so the draft cache lacks position consumed - 1:
            # write it before the rewind admits that row.
            draft_model(block[:, -1:], d_cache, chunked_prefill=True,
                        prefix_len=consumed, return_hidden=True)
        t_cache.index.fill_(consumed)
        d_cache.index.fill_(consumed)

    tokens = torch.cat([prompt, torch.tensor(
        [out[:steps]], device=prompt.device)], dim=1)
    stats["tokens"] = len(out[:steps])
    if return_stats:
        return tokens, stats
    return tokens
