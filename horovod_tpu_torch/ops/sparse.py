"""The sparse (embedding) gradient path.

Counterpart of `horovod_tpu/ops/sparse.py:26-59`: instead of densifying
an embedding gradient and allreducing it, allgather its (values,
indices) pair — an allreduce of the *represented* dense tensor at the
bytes of the touched rows (Horovod's ``tf.IndexedSlices`` dispatch).
`IndexedSlices` also converts to and from PyTorch's own sparse form, the
COO gradient of ``F.embedding(..., sparse=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class IndexedSlices:
    """A sparse slice set: ``dense[indices[i]] += values[i]``; indices
    may repeat (their values sum)."""

    values: torch.Tensor                    # [nnz, ...]
    indices: torch.Tensor                   # [nnz] integer
    dense_shape: Optional[Tuple[int, ...]] = None

    def to_dense(self) -> torch.Tensor:
        """The dense tensor, by a scatter-add (`index_add_`), so
        duplicate indices sum."""
        if self.dense_shape is None:
            raise ValueError("IndexedSlices.to_dense requires dense_shape")
        out = self.values.new_zeros(self.dense_shape)
        return out.index_add_(0, self.indices.to(torch.long), self.values)

    @classmethod
    def from_sparse(cls, t: torch.Tensor) -> "IndexedSlices":
        """The slices of a sparse COO tensor whose first dim is sparse
        (an embedding gradient), coalesced: one slice per touched row."""
        if t.sparse_dim() != 1:
            raise ValueError(f"expected one sparse dim, got "
                             f"{t.sparse_dim()}")
        t = t.coalesce()
        return cls(t.values(), t.indices()[0], tuple(t.shape))

    def to_sparse(self) -> torch.Tensor:
        """A sparse COO tensor with these slices (uncoalesced)."""
        if self.dense_shape is None:
            raise ValueError("IndexedSlices.to_sparse requires dense_shape")
        # The indices come from this package (a gather or a coalesce),
        # so the invariant check (a host sync on the card) is skipped.
        return torch.sparse_coo_tensor(
            self.indices.to(torch.long).reshape(1, -1), self.values,
            self.dense_shape, check_invariants=False)


def allreduce_indexed_slices(ts: IndexedSlices, average: bool = True,
                             name: Optional[str] = None) -> IndexedSlices:
    """Allreduce an `IndexedSlices` by allgathering its values and then
    its indices (ranks may touch different numbers of rows), dividing
    the values by the world size when averaging. The result keeps every
    rank's slices (indices repeat across ranks; `to_dense` sums them)."""
    from horovod_tpu_torch.ops import eager
    from horovod_tpu_torch.runtime import state as _state
    st = _state.check_initialized()
    values = eager.allgather(
        ts.values, name=None if name is None else name + "_values")
    indices = eager.allgather(
        ts.indices, name=None if name is None else name + "_indices")
    if average:
        values = values / st.size
    return IndexedSlices(values, indices, ts.dense_shape)
