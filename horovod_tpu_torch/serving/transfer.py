"""KV-block transfer between paged pools: the prefill -> decode handoff
of disaggregated serving (`serving.disagg`), and what swap preemption
shelves and re-grafts.

Counterpart of `horovod_tpu.serving.transfer`. The wire format and its
two primitives:

* **`export_blocks`** — pull a prompt's FULL resident block rows out of
  a `PagedSlotPool` as host tensors (``mode="host"``) or as tensors on
  the pool's device (``mode="device"``: on one card the rows stay CUDA
  tensors for the graft), stamped with two digest layers:
  the allocator's blake2b *chain* digests (each block's identity
  commits to the entire token prefix behind it) and per-block *byte*
  digests over the exported KV rows themselves, bound to the chain.
* **`ingest_blocks`** — verify both layers against the manifest and
  graft the rows into a destination pool's `BlockPool` as refcount-0
  LRU-resident cached blocks (fresh block ids).

The graft lands in the PREFIX CACHE, not in a live lane: the resumed
request is admitted through the ordinary front door, `BlockPool.match`
hits the grafted chain, and prefill covers only the sub-block tail.

Any failure — geometry mismatch, digest mismatch (the
``disagg.block_corrupt`` chaos site flips a byte here), an export that
raced the allocator — raises a typed `TransferError`; callers fall
back to token-level forced-prefix recompute, and the stream stays
token-exact either way. The digests read host bytes once per export
in either mode (a host sync, once per handoff, off the tick ring).
A re-commit of the rows under another mesh's layouts (the JAX
package's ``shard_paged_pools`` after a cross-mesh graft) belongs to
the multi-GPU slice of the port (ROADMAP Queue A 8) and raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.models.transformer import gather_block_rows
from horovod_tpu_torch.obs import spans as _spans
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving.admission import ServingError

_DIGEST_SIZE = 16
_EXPORT_RETRIES = 5


class TransferError(ServingError):
    """A KV-block transfer could not be completed; callers fall back
    to token-level forced-prefix recompute."""


class TransferExportError(TransferError):
    """Export raced the source allocator past its retry budget."""


class TransferCompatError(TransferError):
    """Destination pool geometry/dtype does not match the manifest."""


class TransferVerifyError(TransferError):
    """Digest verification failed on ingest — the bytes on the wire
    are not the bytes the manifest committed to."""


@dataclasses.dataclass(frozen=True)
class BlockTransfer:
    """One handoff manifest: the prompt it came from, the tokens the
    prefill sampled, the block rows (one stacked tensor per pool, in
    `gather_block_rows`' leaf order: layer 0 K, layer 0 V, then under
    int8 KV layer 0's K and V scales [n, block_size, Hkv], then layer
    1 ...; each row tensor carries its leaf's dtype, which ingest
    checks against the destination's), and the two digest layers
    binding them together.

    ``rows`` are CPU tensors in ``"host"`` mode and tensors on the
    source pool's device in ``"device"`` mode; everything else is host
    metadata."""

    prompt: np.ndarray                       # int64 [P]
    emitted: Tuple[int, ...]                 # tokens prefill sampled
    block_size: int
    chain_digests: Tuple[bytes, ...]         # allocator prefix chain
    byte_digests: Tuple[bytes, ...]          # KV-row content x chain
    rows: List                               # per-leaf [n, bs, Hkv(, D)]
    kv_shapes: Tuple[Tuple[int, ...], ...]   # per-leaf row shape [1:]
    kv_dtypes: Tuple[str, ...]
    mode: str = "host"
    # Causal-span parent for the transfer.* spans the ingest side
    # emits: the exporter's handoff span id, so both halves of the
    # handoff hang under ONE node of the request's trace tree.
    trace_id: str = ""
    parent_span: str = ""
    t_export: float = 0.0

    @property
    def num_blocks(self) -> int:
        return len(self.chain_digests)

    @property
    def nbytes(self) -> int:
        return int(sum(r.numel() * r.element_size() for r in self.rows))


def _row_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of one CPU tensor (bf16 included, which numpy has
    no dtype for)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _byte_digest(leaf_rows: List[torch.Tensor], chain: bytes) -> bytes:
    """Content digest of ONE transferred block: the block's row bytes
    from every pool, bound to its chain digest — so a row that is valid
    KV for some OTHER prefix position still fails verify."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    for r in leaf_rows:
        h.update(_row_bytes(r))
    h.update(chain)
    return h.digest()


def export_blocks(pool, prompt, emitted=(), *, mode: str = "host",
                  trace_id: str = "",
                  parent_span: str = "") -> Optional[BlockTransfer]:
    """Extract ``prompt``'s full resident prefix blocks from a
    `PagedSlotPool` as a `BlockTransfer`, or None when there is nothing
    worth shipping (non-paged pool, prefix cache off, prompt shorter
    than one block, or no blocks resident).

    Runs on the source pool's dispatch thread: the rows are read behind
    an epoch check — the allocator's ``_epoch`` is recorded before the
    digest lookup and re-checked after the host read, and a bump in
    between (an evict recycling one of the blocks) retries the export.
    The read is stream-ordered after every tick already dispatched.
    ``emitted`` records the tokens the source sampled (the decode side
    resumes after them)."""
    if mode not in ("host", "device"):
        raise ValueError(
            f"transfer mode must be host|device, got {mode!r}")
    blocks = getattr(pool, "blocks", None)
    if blocks is None or not getattr(blocks, "prefix_cache", False):
        return None
    bs = pool.block_size
    # hvd: disable=HVD001(prompt is host-side tokens, never a device array — no sync)
    prompt = np.ascontiguousarray(np.asarray(prompt, np.int64))
    n = len(prompt) // bs
    if n == 0:
        return None
    sid = _spans.begin_span("transfer.export", trace_id=trace_id,
                            parent_id=parent_span, mode=mode)
    chain = blocks._chain(prompt, n)
    for _ in range(_EXPORT_RETRIES):
        epoch = blocks._epoch
        bids = []
        for h in chain:
            bid = blocks._cache.get(h)
            if bid is None:
                break
            bids.append(bid)
        if not bids:
            _spans.end_span(sid, status="not_resident")
            return None
        rows = gather_block_rows(pool._pools, bids)
        # hvd: disable=HVD001(the transfer's designed host bounce — export runs off the decode tick ring, once per handoff; device mode reads the bytes for the digests only)
        host_rows = [r.cpu() for r in rows]
        if mode == "host":
            rows = host_rows
        if blocks._epoch != epoch:
            continue   # an evict/alloc raced the gather — retry
        m = len(bids)
        byte_digests = tuple(
            _byte_digest([r[i] for r in host_rows], chain[i])
            for i in range(m))
        tr = BlockTransfer(
            prompt=prompt, emitted=tuple(int(t) for t in emitted),
            block_size=bs, chain_digests=tuple(chain[:m]),
            byte_digests=byte_digests, rows=rows,
            kv_shapes=tuple(tuple(r.shape[1:]) for r in rows),
            kv_dtypes=tuple(str(r.dtype) for r in rows),
            mode=mode, trace_id=trace_id, parent_span=parent_span,
            t_export=time.time())
        _spans.end_span(sid, status="ok", blocks=m, bytes=tr.nbytes)
        return tr
    _spans.end_span(sid, status="raced")
    raise TransferExportError(
        f"block export raced the allocator {_EXPORT_RETRIES} times "
        f"(pool under eviction pressure)")


def _leaves(pool) -> list:
    return [t for layer in pool._pools for t in layer]


def _check_compat(pool, tr: BlockTransfer):
    if tr.block_size != pool.block_size:
        raise TransferCompatError(
            f"block_size mismatch: transfer {tr.block_size}, "
            f"destination {pool.block_size}")
    leaves = _leaves(pool)
    if len(tr.rows) != len(leaves):
        raise TransferCompatError(
            f"cache leaf count mismatch: transfer {len(tr.rows)}, "
            f"destination {len(leaves)}")
    for k, (r, p) in enumerate(zip(tr.rows, leaves)):
        if tuple(r.shape[1:]) != tuple(p.shape[1:]):
            raise TransferCompatError(
                f"leaf {k} row shape mismatch: transfer "
                f"{tuple(r.shape[1:])}, destination "
                f"{tuple(p.shape[1:])}")
        if r.dtype != p.dtype:
            raise TransferCompatError(
                f"leaf {k} dtype mismatch: transfer {r.dtype}, "
                f"destination {p.dtype}")


def ingest_blocks(pool, tr: BlockTransfer) -> int:
    """Verify ``tr`` and graft its blocks into ``pool``'s prefix cache
    under fresh block ids. Returns how many blocks were NEWLY adopted
    (already-resident digests are skipped — ingest is idempotent).

    Runs on the destination pool's dispatch thread. Adoption stops once
    taking another block would evict a block of its own chain (tiny
    pools); a partial graft is fine — `match` hits a shorter prefix
    and prefill covers more tail. Any verification failure raises
    `TransferVerifyError` and leaves the pool untouched."""
    blocks = getattr(pool, "blocks", None)
    if blocks is None or not getattr(blocks, "prefix_cache", False):
        return 0
    if getattr(pool, "mesh", None) is not None:
        raise NotImplementedError(
            "re-committing transferred blocks under a mesh's layouts "
            "(sharded serving): a later slice of the PyTorch port "
            "(ROADMAP Queue A 8)")
    m = tr.num_blocks
    vsid = _spans.begin_span("transfer.verify", trace_id=tr.trace_id,
                             parent_id=tr.parent_span, blocks=m)
    try:
        _check_compat(pool, tr)
        if not (len(tr.byte_digests) == m
                and all(len(r) == m for r in tr.rows)):
            raise TransferVerifyError(
                f"manifest arity mismatch: {m} chain digests, "
                f"{len(tr.byte_digests)} byte digests, rows "
                f"{[len(r) for r in tr.rows]}")
        # Host copies for verification (and for the corrupt drill —
        # flipping the copy models a wire fault without touching the
        # caller's buffers).
        # hvd: disable=HVD001(verify wants host bytes; once per handoff, off the tick ring)
        rows_h = [r.cpu().clone() for r in tr.rows]
        if chaos.fires("disagg.block_corrupt"):
            rows_h[0].view(torch.uint8).view(-1)[0] ^= 0xFF
        # Layer 1: the chain digests must be the prompt's own chain.
        expect = blocks._chain(tr.prompt, m)
        if tuple(expect) != tuple(tr.chain_digests):
            raise TransferVerifyError(
                "chain digest mismatch: manifest digests are not the "
                "prompt's prefix chain")
        # Layer 2: row bytes must be the bytes the exporter hashed.
        for i in range(m):
            got = _byte_digest([r[i] for r in rows_h],
                               tr.chain_digests[i])
            if got != tr.byte_digests[i]:
                raise TransferVerifyError(
                    f"block {i} byte digest mismatch (transfer "
                    f"corrupted in flight)")
    except TransferError as e:
        _spans.end_span(vsid, status="failed", error=type(e).__name__)
        raise
    _spans.end_span(vsid, status="ok")
    isid = _spans.begin_span("transfer.ingest", trace_id=tr.trace_id,
                             parent_id=tr.parent_span, blocks=m)
    leaves = _leaves(pool)
    rows_dev = [r.to(leaves[k].device) for k, r in enumerate(tr.rows)]
    # Adopt in chain order; stop before cannibalizing our own chain
    # (evicting an earlier grafted block to make room for a later one
    # would break the contiguous prefix `match` needs).
    ours = set()
    adopted = 0
    for i in range(m):
        h = tr.chain_digests[i]
        if h in blocks._cache:
            ours.add(blocks._cache[h])
            continue
        evictable = sum(1 for bid in blocks._lru if bid not in ours)
        if blocks.free_blocks + evictable < 1:
            break
        bid = blocks.adopt(h)
        if bid is None:
            break
        ours.add(bid)
        for k, leaf in enumerate(leaves):
            leaf[bid] = rows_dev[k][i]
        adopted += 1
    _spans.end_span(isid, adopted=adopted)
    return adopted
