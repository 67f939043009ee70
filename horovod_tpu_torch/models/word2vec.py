"""Word2vec skip-gram: the sparse-gradient exerciser.

Counterpart of `horovod_tpu/models/word2vec.py:26-67` (Horovod's
``examples/tensorflow_word2vec.py``): skip-gram with NCE-style sampled
logits. The center-word lookup is ``F.embedding(..., sparse=True)``, so
``embeddings.grad`` is a sparse COO tensor over the looked-up rows
only, which `DistributedOptimizer` allreduces by allgathering its
(indices, values) instead of the whole [vocab, dim] table
(`ops.sparse`). ``nce_weights`` is looked up densely, as the JAX model
treats it. Parameters of the JAX model carry across with
`compat.from_jax.word2vec_params_from_jax`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.sparse import IndexedSlices


class Word2Vec(nn.Module):
    """``forward(center [B], context [B], negative [B, K])`` -> the mean
    NCE-style loss. ``sparse=False`` makes the embedding gradient dense
    (the reference for the sparse path)."""

    def __init__(self, vocab_size: int = 50000, embed_dim: int = 128, *,
                 device=None, sparse: bool = True):
        super().__init__()
        dev = torch.device("cuda" if device is None else device)
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.sparse = sparse
        self.embeddings = nn.Parameter(
            torch.empty(vocab_size, embed_dim, device=dev))
        self.nce_weights = nn.Parameter(
            torch.empty(vocab_size, embed_dim, device=dev))

    def init_weights(self, seed: int = 0) -> "Word2Vec":
        """The JAX model's initializers from a seeded generator (drawn
        on the CPU, so a seed gives the same weights on every device):
        embeddings uniform on [0, 1); nce_weights normal with standard
        deviation 1/sqrt(dim) after truncation to two deviations (flax's
        ``truncated_normal``)."""
        g = torch.Generator().manual_seed(seed)
        std = 1.0 / math.sqrt(self.embed_dim) / .87962566103423978
        with torch.no_grad():
            emb = torch.rand(self.embeddings.shape, generator=g)
            out = torch.empty(self.nce_weights.shape)
            nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
            self.embeddings.copy_(emb)
            self.nce_weights.copy_(out)
        return self

    def forward(self, center: torch.Tensor, context: torch.Tensor,
                negative: torch.Tensor) -> torch.Tensor:
        v = F.embedding(center, self.embeddings, sparse=self.sparse)
        u_pos = F.embedding(context, self.nce_weights)      # [B, D]
        u_neg = F.embedding(negative, self.nce_weights)     # [B, K, D]
        pos_logit = (v * u_pos).sum(-1)                     # [B]
        neg_logit = torch.einsum("bd,bkd->bk", v, u_neg)    # [B, K]
        loss = (-F.logsigmoid(pos_logit)
                - F.logsigmoid(-neg_logit).sum(-1))
        return loss.mean()


def embedding_grad_as_slices(dense_grad: torch.Tensor,
                             touched_ids: torch.Tensor) -> IndexedSlices:
    """A dense embedding-table gradient as `IndexedSlices` over the
    touched rows, with the JAX function's exact layout: the sorted
    unique ids padded with -1 to ``touched_ids.numel()`` slots, each
    pad slot's index replaced by the safe id 0 and its values zeroed,
    so ``to_dense`` is exact with duplicate ids."""
    flat = touched_ids.reshape(-1)
    uniq = torch.unique(flat)
    ids = torch.full_like(flat, -1)
    ids[:uniq.numel()] = uniq
    valid = ids >= 0
    safe_ids = torch.where(valid, ids, torch.zeros_like(ids))
    values = dense_grad[safe_ids]
    values = values * valid[:, None].to(values.dtype)
    return IndexedSlices(values, safe_ids,
                         dense_shape=tuple(dense_grad.shape))
