"""Tensor fusion: the bucketed gradient allreduce.

Counterpart of `horovod_tpu.ops.fusion` (Horovod's Tensor Fusion): many
small gradients are packed into one flat buffer per bucket and reduced
by ONE `torch.distributed.all_reduce` (NCCL on the card), amortizing
the per-collective latency. Buckets group same-dtype tensors and close
at ``HOROVOD_FUSION_THRESHOLD`` bytes (default 64 MiB; 0 disables
fusion: one collective per tensor). `plan_buckets` is the JAX
package's, copied.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime.config import config


def _leaf_bytes(leaf) -> int:
    return int(np.prod(leaf.shape)) * leaf.dtype.itemsize if leaf.ndim else leaf.dtype.itemsize


def plan_buckets(leaves: List[Any],
                 threshold: Optional[int] = None) -> List[List[int]]:
    """Greedy same-dtype bucketing up to `threshold` bytes.

    Mirrors the coordinator's greedy merge of consecutive same-dtype
    allreduce responses under the fusion threshold
    (`mpi_ops.cc:1392-1419`). Returns a list of buckets, each a list of
    leaf indices. threshold<=0 disables fusion (singleton buckets).
    """
    if threshold is None:
        threshold = config.fusion_threshold
    if threshold <= 0:
        return [[i] for i in range(len(leaves))]
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, leaf in enumerate(leaves):
        b = _leaf_bytes(leaf)
        if cur and (leaf.dtype != cur_dtype or cur_bytes + b > threshold):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
        cur_dtype = leaf.dtype
    if cur:
        buckets.append(cur)
    return buckets


def fused_allreduce_leaves(leaves: List[torch.Tensor], *,
                           average: bool = True,
                           threshold: Optional[int] = None,
                           reduce_dtype: Optional[torch.dtype] = None
                           ) -> List[torch.Tensor]:
    """Allreduce ``leaves`` over the default process group, one
    `all_reduce` per same-dtype bucket of flattened leaves (optionally
    reduced in ``reduce_dtype`` and cast back), divided by the world
    size when ``average``. Returns new tensors shaped like the leaves.
    Asynchronous on the card: nothing here waits for the host."""
    out: List[Any] = [None] * len(leaves)
    world = dist.get_world_size()
    for bucket in plan_buckets(leaves, threshold):
        dtype = leaves[bucket[0]].dtype
        flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
        if reduce_dtype is not None:
            flat = flat.to(reduce_dtype)
        dist.all_reduce(flat)
        flat = flat.to(dtype)
        if average:
            flat = flat / world
        off = 0
        for i in bucket:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view_as(leaves[i])
            off += n
    return out
