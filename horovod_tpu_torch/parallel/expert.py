"""Mixture of experts: the top-k router, capacity routing, the expert
MLPs, and expert parallelism over the ``expert`` mesh axis.

Counterpart of `horovod_tpu.parallel.expert` (GShard / Switch routing
with a fixed capacity per expert). `MoELayer` computes the JAX module's
function:

* the router [d, E] in f32 scores each token; `top_k_gating` keeps the
  k most probable experts (the lower expert id first on a tie, as
  ``lax.top_k``) with their probabilities renormalized, and the
  Switch load-balancing term ``aux = E * sum_e mean_prob(e) *
  frac_top1(e)``;
* each expert takes at most ``C = max(1, ceil(capacity_factor * k * T /
  E))`` tokens, T the token rows of the call. Slots are claimed
  choice-major: every token's first choice before any second choice,
  each level in token order (the JAX package's cumsum over the k * T
  flattening). A (token, choice) past its expert's capacity gets
  combine weight 0, and the residual carries the token;
* the expert products run at the compute dtype through tanh-gelu
  (flax's `nn.gelu` default), and the output is the gate-weighted sum
  of the token's kept experts.

The JAX package builds dispatch and combine as one-hot [T, E, C]
tensors and einsums; here they are index maps (a gather into the
[E, C, d] expert buffers, a gather back out), the same function
without the [T, k, E, C] one-hot (335 MB a layer at T = 4096, E = 8,
C = 1280 in f32).

Routing scope. Under GSPMD the JAX layer sees the GLOBAL batch: C and
the slot order run over every token of the [B, S] batch across the
``data`` and ``seq`` shards. So under an ambient mesh with data or seq
> 1, a rank's slot positions are offset by what the other ranks' tokens
claimed before its own (one all-gather of per-row [k, E] counts over
each axis), C counts the global tokens, and ``me`` / ``ce`` of the aux
are global means. The aux a rank returns there is its SHARE: its own
tokens' probabilities against the global top-1 fractions, so the
shares of the data x seq ranks sum to the global aux and each rank's
gradient is its tokens' part (the train step scales it as it scales
the loss). Off-mesh (and in Horovod's data-parallel path, where each
process applies the model to its own batch, as in the JAX package)
each call routes its own tokens. ``route_rows=True`` routes each row of
the input alone, with its own C: the serving pools' decode ticks and
spec rounds, where the JAX package vmaps a one-lane call over the
slots, so an idle lane takes no capacity and a one-token tick never
drops.

Expert parallelism. A layer built over a mesh whose ``expert`` axis is
ep > 1 holds experts [r E/ep, (r+1) E/ep) on expert rank r. Tokens are
replicated over ``expert``: every rank routes them all (the same
routing), runs its own experts on the tokens sent there, and the
partial outputs are summed over the axis (Megatron's g); the token rows
and gates entering the experts pass f (the identity forward, their
gradient summed over the axis backward), so the router and every layer
below get the whole gradient on each expert rank. All three are
all-reduces, which gloo takes on CUDA tensors.
`expert_alltoall_dispatch` / `expert_alltoall_combine` are the explicit
all-to-all shuffle of the JAX package for code that moves its own
dispatch buffers.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                             AXIS_SEQ, abstract_mesh,
                                             axis_index, axis_size)


def top_k_gating(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k router over [tokens..., E] raw scores. Returns ``(gates
    [..., k]`` the chosen experts' probabilities renormalized by their
    sum (clipped at 1e-9), ``indices [..., k]`` the chosen expert ids,
    most probable first, ties to the lower id, and ``aux`` the
    Switch load-balancing loss ``E * sum_e mean_prob(e) *
    frac_top1(e)``, 1 at a uniform router)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, indices = _top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(indices[..., 0].reshape(-1), E).float().mean(0)
    return gates, indices, E * (me * ce).sum()


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, descending, the
    lower index first among equal values (a stable sort; `torch.topk`
    promises no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(num_experts: int, k: int, tokens: int,
             capacity_factor: float) -> int:
    """Slots a layer gives each expert for a call of ``tokens`` rows:
    ``max(1, ceil(capacity_factor * k * tokens / num_experts))``."""
    return max(1, math.ceil(capacity_factor * k * tokens / num_experts))


def slot_positions(indices: torch.Tensor, num_experts: int,
                   offset: torch.Tensor) -> torch.Tensor:
    """Each (token, choice)'s slot in its expert's buffer. ``indices``
    [G, T, k]: G groups of T tokens in routing order; ``offset`` [G, k,
    E]: the slots of each expert that choice level j of group g finds
    taken before its first token. Within a group and level, tokens
    claim slots in token order. Returns [G, T, k] int64."""
    onehot = F.one_hot(indices.transpose(1, 2), num_experts)  # [G,k,T,E]
    taken = onehot.cumsum(2) - onehot + offset[:, :, None, :]
    pos = taken.gather(-1, indices.transpose(1, 2)[..., None])[..., 0]
    return pos.transpose(1, 2)


def route_tokens(indices: torch.Tensor, num_experts: int,
                 capacity_: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing of one call's [T, k] expert choices, as the JAX
    package's `_dispatch_combine` orders it: ``(pos [T, k], keep [T,
    k])``, each (token, choice)'s slot in its expert and whether it
    lies within ``capacity_``."""
    indices = indices.long()
    counts = _level_counts(indices[None], num_experts)
    pos = slot_positions(indices[None], num_experts,
                         _exclusive(counts, 1))[0]
    return pos, pos < capacity_


def _level_counts(indices: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[G, k, E]: how many tokens of each group chose each expert at
    each choice level."""
    return F.one_hot(indices, num_experts).sum(1)


def _exclusive(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.cumsum(dim) - x


def _gather_counts(counts: torch.Tensor, mesh) -> Tuple[torch.Tensor, int]:
    """The per-row counts [G, k, E] of every data x seq rank in the
    global token order (data rank, row, seq rank), flattened to [dp * G
    * sp, k, E], and this rank's first entry in it (its row 0)."""
    from horovod_tpu_torch.ops.collectives import _gather
    from horovod_tpu_torch.parallel.mesh import axis_group
    dp, sp = axis_size(AXIS_DATA, mesh), axis_size(AXIS_SEQ, mesh)
    G = counts.shape[0]
    c = counts[None]                                     # [1, G, k, E]
    if sp > 1:
        c = torch.stack(_gather(c[0], axis_group(AXIS_SEQ, mesh)))
    if dp > 1:
        c = torch.stack(_gather(c, axis_group(AXIS_DATA, mesh)))
    else:
        c = c[None]
    table = c.permute(0, 2, 1, 3, 4).reshape(dp * G * sp, *counts.shape[1:])
    first = (axis_index(AXIS_DATA, mesh) * G * sp
             + axis_index(AXIS_SEQ, mesh))
    return table, first


class MoELayer(nn.Module):
    """Mixture-of-experts MLP: ``router`` [d, E] f32, ``w1`` [E, d,
    hidden] and ``w2`` [E, hidden, d] as the JAX module stores them (its
    parameter names, so `compat.from_jax.params_from_jax` maps them one
    to one), drawn by `reset_parameters` with flax's lecun-normal.
    ``dtype`` is the compute dtype of the expert products (None: the
    input's). Built with ``mesh`` whose ``expert`` axis is ep > 1, the
    layer holds this rank's E/ep experts (``w1`` [E/ep, d, hidden]).

    ``forward(x, route_rows=False) -> (y, aux)``: x [..., d]; y like x;
    aux the 0-d f32 load-balancing term (this rank's share under a mesh
    with data or seq > 1; see the module docstring). The rows of x are
    its lead dims but the last: ``route_rows`` routes each alone.
    ``counts`` accumulates [routed, dropped] (token, choice) pairs of
    every call on the device (`reset_moe_counts` zeroes it); a
    recomputed forward (remat) counts again."""

    def __init__(self, num_experts: int, hidden: int, d: int, *,
                 k: int = 2, capacity_factor: float = 1.25, dtype=None,
                 mesh=None, device=None):
        super().__init__()
        if not 1 <= k <= num_experts:
            raise ValueError(f"k={k} must lie in [1, num_experts="
                             f"{num_experts}]")
        self.num_experts, self.hidden, self.k = num_experts, hidden, k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.mesh = mesh
        self.ep = 1 if mesh is None else axis_size(AXIS_EXPERT, mesh)
        self.ep_rank = 0 if self.ep == 1 else axis_index(AXIS_EXPERT, mesh)
        if num_experts % self.ep:
            raise ValueError(f"num_experts={num_experts} does not split "
                             f"over expert={self.ep} ranks")
        local = num_experts // self.ep
        self.router = nn.Parameter(torch.empty(d, num_experts,
                                               device=device))
        self.w1 = nn.Parameter(torch.empty(local, d, hidden, device=device))
        self.w2 = nn.Parameter(torch.empty(local, hidden, d, device=device))
        self.register_buffer("counts", torch.zeros(
            2, dtype=torch.int64, device=device), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's lecun-normal (truncated normal, variance 1/fan_in) on
        the WHOLE layer's shapes: fan_in d for the router, and for an
        expert kernel [E, in, out] in * E (flax's receptive field takes
        in the expert axis)."""
        E = self.num_experts
        for p, fan_in in ((self.router, self.router.shape[0]),
                          (self.w1, E * self.w1.shape[1]),
                          (self.w2, E * self.w2.shape[1])):
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def forward(self, x: torch.Tensor, route_rows: bool = False):
        *lead, d = x.shape
        G = math.prod(lead[:-1])
        T = lead[-1] if lead else 1
        E, k = self.num_experts, self.k
        xt = x.reshape(G, T, d)
        logits = xt.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)
        gates, indices = _top_k(probs, k)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        counts = _level_counts(indices, E)                  # [G, k, E]

        mesh = abstract_mesh() if abstract_mesh() is not None else self.mesh
        shards = 1 if mesh is None else (axis_size(AXIS_DATA, mesh)
                                         * axis_size(AXIS_SEQ, mesh))
        if route_rows:
            tokens, routed = T, G * T
            offset = _exclusive(counts, 1)
            top1 = counts[:, 0].sum(0)
        else:
            if shards > 1:
                table, first = _gather_counts(counts, mesh)
                sp = axis_size(AXIS_SEQ, mesh)
                mine = torch.arange(G, device=x.device) * sp + first
            else:
                table, mine = counts, torch.arange(G, device=x.device)
            tokens = routed = G * T * shards
            total = table.sum(0)                            # [k, E]
            offset = (_exclusive(total, 0)[None]
                      + _exclusive(table, 0)[mine])
            top1 = total[0]
        C = capacity(E, k, tokens, self.capacity_factor)
        pos = slot_positions(indices, E, offset)            # [G, T, k]
        keep = pos < C
        # This rank's share of E * sum_e mean_prob(e) * frac_top1(e)
        # over the tokens routed together (the whole of it off a data /
        # seq mesh; over the call's rows under route_rows).
        aux = E * (probs.sum((0, 1)) / routed
                   * (top1.float() / routed)).sum()
        with torch.no_grad():
            self.counts[0] += keep.numel()
            self.counts[1] += (~keep).sum()

        El = self.w1.shape[0]
        e0 = self.ep_rank * El
        local = indices - e0
        sel = keep & (local >= 0) & (local < El)
        # Each expert's buffer: C slots, or under route_rows C a row.
        if route_rows:
            rows_c = G * C
            pos = pos + (torch.arange(G, device=x.device) * C)[:, None, None]
        else:
            rows_c = C
        dummy = El * rows_c
        slot = torch.where(sel, local * rows_c + pos, dummy).reshape(-1, k)
        n = G * T
        tok = torch.arange(n, device=x.device)[:, None].expand(n, k)
        # Slot -> token row (n: the zero row); unselected pairs write the
        # dummy slot, which is cut off.
        src = torch.full((dummy + 1,), n, dtype=torch.long, device=x.device)
        src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
        cdt = self.dtype or x.dtype
        rows, weights = xt.reshape(n, d), gates.reshape(n, k)
        if self.ep > 1:
            from horovod_tpu_torch.ops.collectives import copy_to_model
            rows = copy_to_model(rows, AXIS_EXPERT, self.mesh)
            weights = copy_to_model(weights, AXIS_EXPERT, self.mesh)
        rows = torch.cat([rows.to(cdt), rows.new_zeros(1, d, dtype=cdt)])
        ein = rows[src[:dummy]].view(El, rows_c, d)
        h = F.gelu(torch.bmm(ein, self.w1.to(cdt)), approximate="tanh")
        out = torch.bmm(h, self.w2.to(cdt)).view(dummy, d)
        out = torch.cat([out, out.new_zeros(1, d)])
        w = torch.where(sel.reshape(n, k), weights, 0.0)
        y = torch.bmm(w[:, None, :], out[slot].float())[:, 0]
        if self.ep > 1:
            from horovod_tpu_torch.ops.collectives import reduce_from_model
            y = reduce_from_model(y, AXIS_EXPERT, self.mesh)
        return y.to(cdt).reshape(x.shape).to(x.dtype), aux


def moe_layers(model: nn.Module) -> list:
    """The `MoELayer` modules of ``model``, in module order."""
    return [m for m in model.modules() if isinstance(m, MoELayer)]


def moe_counts(model: nn.Module) -> Tuple[int, int]:
    """(routed, dropped) (token, choice) pairs over every MoE layer of
    ``model`` since the last `reset_moe_counts` (reads the device)."""
    layers = moe_layers(model)
    if not layers:
        return 0, 0
    total = torch.stack([m.counts for m in layers]).sum(0)
    return int(total[0]), int(total[1])


def reset_moe_counts(model: nn.Module) -> None:
    for m in moe_layers(model):
        m.counts.zero_()


# ---------------------------------------------------------------------------
# The explicit SPMD shuffle over the ``expert`` axis.
# ---------------------------------------------------------------------------

def expert_alltoall_dispatch(expert_inputs: torch.Tensor, *,
                             axis_name: str = AXIS_EXPERT) -> torch.Tensor:
    """[E, C_local, d] dispatch buffers of this rank -> the buffers
    every rank holds for THIS rank's experts: [E/ep, ep * C_local, d]
    (a tiled all-to-all, split on the experts, concatenated on the
    slots, in rank order). Differentiable."""
    from horovod_tpu_torch.ops.collectives import alltoall
    return alltoall(expert_inputs, axis_name=axis_name, split_axis=0,
                    concat_axis=1)


def expert_alltoall_combine(expert_outputs: torch.Tensor, *,
                            axis_name: str = AXIS_EXPERT) -> torch.Tensor:
    """The inverse shuffle: [E/ep, ep * C_local, d] -> [E, C_local, d]."""
    from horovod_tpu_torch.ops.collectives import alltoall
    return alltoall(expert_outputs, axis_name=axis_name, split_axis=1,
                    concat_axis=0)
