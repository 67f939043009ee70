"""PowerSGD: rank-r factorized gradient allreduce with error feedback.

Counterpart of `horovod_tpu/ops/compression.py:49-182` (Vogels et al.,
NeurIPS 2019). Per matrix-shaped gradient M [n, m] (leading dims
folded), with a persistent right factor Q [m, r]:

    M  = grad + error            (error feedback)
    P  = M @ Q        -> allreduce-mean            (r·n floats)
    P̂  = orthonormalize(P)       (thin QR)
    Q' = Mᵀ @ P̂       -> allreduce-mean            (r·m floats)
    approx = P̂ @ Q'ᵀ  ≈ rank-r( mean(M) )
    error  = M - approx          (carried to the next step)

Bytes on the wire drop from n·m to r·(n+m) per matrix; both factor
allreduces ride the fused buckets of uncompressed gradients
(`optim.allreduce_gradients`: fusion threshold, wire dtype). Leaves
that are not matrices (1-D biases and norms), sparse gradients and
matrices too small to win (r·(n+m)·2 > n·m) take the exact allreduce.
All compression math runs in float32 whatever the gradient's dtype
(error feedback in low precision breaks the convergence guarantee);
the outputs are cast back. No step waits for the host: the products,
the QR (`torch.linalg.qr`, reduced) and the allreduces are all queued
on the device.

`DistributedOptimizer(compression="powersgd")` keeps each parameter's
Q and error in the wrapped optimizer's ``state[p]``; `powersgd_allreduce`
is the same compressor as a pair of functions over a list of gradients
and a `PowerSGDState`, the JAX transformation's shape.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence

import torch

__all__ = ["powersgd_allreduce", "PowerSGDState", "PowerSGD"]


class PowerSGDState(NamedTuple):
    """Per-leaf factor and error-feedback state, parallel to the
    gradient leaves (None = the leaf takes the exact allreduce)."""
    qs: tuple
    errs: tuple
    # Seed the Qs were drawn from (with each leaf's index).
    seed: int


def _matrix_view(p: torch.Tensor) -> torch.Tensor:
    """Fold leading dims: [d0, ..., dk, m] -> [n, m]."""
    return p.reshape(-1, p.shape[-1])


def _is_dense(p: Any) -> bool:
    return isinstance(p, torch.Tensor) and p.layout == torch.strided


def _compressible(p: Any, rank: int) -> bool:
    """At least 2-D, floating, dense, and the factors at most half the
    matrix: r·(n+m)·2 <= n·m."""
    if not _is_dense(p) or p.ndim < 2 or not p.is_floating_point():
        return False
    m = int(p.shape[-1])
    n = p.numel() // m if m else 0
    return rank * (n + m) * 2 <= n * m


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Thin-QR orthonormal basis of P's columns (Vogels et al. use
    Gram-Schmidt; QR spans the same subspace in one call)."""
    q, _ = torch.linalg.qr(p)
    return q


def initial_q(m: int, rank: int, seed: int, index: int,
              device=None) -> torch.Tensor:
    """Leaf ``index``'s first Q [m, rank], float32, standard normal from
    a CPU `torch.Generator` seeded from (``seed``, ``index``): the same
    draw on every rank and every device. (The JAX package draws from
    threefry; tests carry its state across instead,
    `compat.from_jax.powersgd_state_from_jax`.)"""
    g = torch.Generator().manual_seed(seed * (1 << 32) + index)
    return torch.randn((m, rank), generator=g).to(device)


class PowerSGD:
    """The compressor of `powersgd_allreduce`: `init(params)` ->
    `PowerSGDState`; `update(grads, state)` -> (reduced grads, state).
    ``grads`` is a list parallel to the params; a None entry (a
    parameter without a gradient) passes through untouched."""

    def __init__(self, rank: int = 4, *, threshold: Optional[int] = None,
                 reduce_dtype: Optional[torch.dtype] = None,
                 seed: int = 17):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.rank, self.threshold = rank, threshold
        self.reduce_dtype, self.seed = reduce_dtype, seed

    def init(self, params: Sequence[torch.Tensor]) -> PowerSGDState:
        qs, errs = [], []
        for idx, p in enumerate(params):
            if _compressible(p, self.rank):
                m2 = _matrix_view(p)
                qs.append(initial_q(m2.shape[1], self.rank, self.seed, idx,
                                    p.device))
                errs.append(torch.zeros(m2.shape, dtype=torch.float32,
                                        device=p.device))
            else:
                qs.append(None)
                errs.append(None)
        return PowerSGDState(tuple(qs), tuple(errs), self.seed)

    def update(self, grads: Sequence[Any], state: PowerSGDState):
        from horovod_tpu_torch.optim import allreduce_gradients
        leaves = list(grads)
        if len(leaves) != len(state.qs):
            raise ValueError(
                f"PowerSGD state holds {len(state.qs)} leaves but the "
                f"gradient tree has {len(leaves)} — init with the same "
                f"param tree the gradients come from")

        # Eligibility re-checked on the GRADIENT leaf: a sparse gradient
        # or a shape surprise at a compressible slot takes the exact
        # path (its error feedback stays frozen), never _matrix_view.
        def _still_ok(i):
            leaf, q = leaves[i], state.qs[i]
            return (q is not None and _is_dense(leaf) and leaf.ndim >= 2
                    and leaf.shape[-1] == q.shape[0])

        comp = [i for i in range(len(leaves)) if _still_ok(i)]
        exact = [i for i in range(len(leaves))
                 if i not in set(comp) and leaves[i] is not None]

        reduced: List[Any] = list(leaves)
        if exact:
            ex = allreduce_gradients(
                [leaves[i] for i in exact], average=True,
                threshold=self.threshold, reduce_dtype=self.reduce_dtype)
            for i, r in zip(exact, ex):
                reduced[i] = r

        new_qs, new_errs = list(state.qs), list(state.errs)
        if comp:
            ms = [_matrix_view(leaves[i]).float() + state.errs[i]
                  for i in comp]
            ps = [m @ state.qs[i] for m, i in zip(ms, comp)]
            ps = allreduce_gradients(ps, average=True,
                                     threshold=self.threshold,
                                     reduce_dtype=self.reduce_dtype)
            phats = [_orthonormalize(p) for p in ps]
            qs = [m.T @ ph for m, ph in zip(ms, phats)]
            qs = allreduce_gradients(qs, average=True,
                                     threshold=self.threshold,
                                     reduce_dtype=self.reduce_dtype)
            for m, ph, q, i in zip(ms, phats, qs, comp):
                approx = ph @ q.T
                new_errs[i] = m - approx
                new_qs[i] = q
                reduced[i] = approx.reshape(leaves[i].shape).to(
                    leaves[i].dtype)
        return reduced, PowerSGDState(tuple(new_qs), tuple(new_errs),
                                      state.seed)


def powersgd_allreduce(rank: int = 4, *, threshold: Optional[int] = None,
                       reduce_dtype: Optional[torch.dtype] = None,
                       seed: int = 17) -> PowerSGD:
    """Rank-``rank`` PowerSGD compress-allreduce (see the module doc):
    `update` replaces each eligible gradient with the rank-r
    approximation of the cross-rank MEAN gradient and keeps the
    residual as error feedback; other leaves are exact-allreduced. At
    world size 1 the allreduces are identities and the compressor is a
    local rank-r projection with error feedback: one step's output
    differs from its input, but the cumulative update converges to the
    cumulative gradient."""
    return PowerSGD(rank, threshold=threshold, reduce_dtype=reduce_dtype,
                    seed=seed)
