"""Paged KV-cache block allocator + shared-prefix caching.

Counterpart of `horovod_tpu.serving.paging`. The fixed slot pool
reserves a private ``max_len`` KV region per slot, so device KV
capacity is ``num_slots x max_len`` however long requests actually
run, and identical system prompts are re-prefilled on every request.
This module is the vLLM-style fix, in two halves:

* **`BlockPool`** — the HOST allocator (a copy of the JAX package's,
  which is host-only). The device KV cache is carved into fixed-size
  blocks (``HVD_KV_BLOCK_SIZE`` tokens each, default 16); each
  sequence owns a block table. Blocks are refcounted, allocation is a
  free list, and freeing a hash-registered block parks it in an LRU of
  RESIDENT refcount-0 blocks — the prefix cache. Appending into a
  block whose refcount > 1 (a forked sequence sharing its tail) is
  copy-on-write: the allocator hands the writer a private copy first.
* **`PagedSlotPool`** — the SlotPool-compatible device pool. Decode
  lanes (``num_slots``) are program width: KV bytes are ``num_blocks x
  block_size`` rows per layer, decoupled from lane count. Prefill and
  the tick run the paged primitives of `models.transformer`
  (`paged_prefill_chunk`, `paged_decode_tick`) over per-layer block
  pools read through the block tables; the tick ring (pinned host
  buffers + CUDA events) and per-request threefry sampling
  (`serving.slots.LaneKeys`) are `serving.slots.SlotPool`'s.

Shared-prefix caching: admission hashes the prompt's block-aligned
prefix chain (`BlockPool.match`) against resident blocks, PINS the
hits, and the scheduler skips prefill for the matched span. A
sequence's full prompt blocks are published when its prefill
completes, stay resident after it retires (LRU), and are evicted
oldest-first only when allocation needs the space. Matching is capped
at the prompt's LAST token (one tail token always re-prefills: the
final chunk's logits seed the first sampled token).

Restart semantics: `clone_fresh` rebuilds an EMPTY pool — the old
device state is mid-unknown-tick and untrusted — so a watchdog
restart's replay re-prefills from the prompt.

Speculative decoding (``spec_draft``): the draft rides a LINEAR slot
cache beside the paged target (the paging win is the target's), the
verify is a batched S=k+1 paged append through the table walk, and
prefix caching is forced off so one chunk schedule drives both caches
(a matched prefix would skip the target's prefill, but the draft still
needs those tokens).
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.annotations import hot_path
from horovod_tpu_torch.ops import threefry
from horovod_tpu_torch.models.transformer import (
    TransformerLM, init_paged_pools, init_slot_cache,
    paged_cache_spec, paged_copy_block, paged_decode_tick,
    paged_prefill_chunk, paged_spec_round, prefill_chunks,
    slot_decode_model, slot_prefill_advance, slot_reset,
)
from horovod_tpu_torch.serving.slots import (
    Admission, LaneKeys, TickHandle, _first_token, read_round,
    resolve_spec_draft, spec_k_eff, validate_spec_draft,
)


def _resolve_paged_kernel(mode: Optional[str],
                          model: TransformerLM,
                          block_size: int) -> str:
    """Normalize the paged-attention dispatch mode ("off" | "lax" |
    "pallas"). None reads HVD_PAGED_KERNEL. "auto" picks the lax
    block-table walk, falling back to "off" (the full-span gather, the
    oracle) when the geometry cannot walk: the walk accumulates at
    ``decode_prefix_block`` granularity, which must be a multiple of
    the KV block size and divide max_len. "pallas" names the
    hand-written CUDA paged-decode kernel for the S=1 tick (its plain
    version on CPU tensors) and takes any geometry: it walks S > 1
    chunks at ``decode_prefix_block`` where that tiles the table, else
    at the block size. An explicit "lax" raises instead of silently
    degrading."""
    if mode is None:
        from horovod_tpu_torch.runtime.config import config as _cfg
        mode = _cfg.paged_kernel or "auto"
    mode = {"0": "off", "1": "lax"}.get(str(mode), str(mode))
    if mode not in ("auto", "off", "lax", "pallas"):
        raise ValueError(
            f"paged kernel mode must be auto|off|lax|pallas "
            f"(HVD_PAGED_KERNEL), got {mode!r}")
    if mode in ("off", "pallas"):
        return mode
    blk = model.decode_prefix_block
    wb = min(int(blk), model.max_len) if blk else 0
    ok = bool(wb) and wb % block_size == 0 and model.max_len % wb == 0
    if not ok:
        if mode == "auto":
            return "off"
        raise ValueError(
            f"paged kernel mode {mode!r} needs decode_prefix_block "
            f"({blk}) to be a multiple of kv_block_size "
            f"({block_size}) and divide max_len ({model.max_len})")
    return "lax" if mode == "auto" else mode


class BlockPool:
    """Host-side refcounted block allocator with hash-based prefix
    reuse and LRU eviction.

    Block ids are ``1 .. num_blocks-1``; block 0 is the reserved NULL
    block (masked device lanes dump dead writes there — never
    allocated, never attended). Every allocatable block is in exactly
    ONE of three states (`check_invariants` pins this under churn):

    * **free** — on the free list, content meaningless;
    * **active** — refcount >= 1, owned by >= 1 live sequence;
    * **cached** — refcount 0 but hash-registered: content is a valid
      block-aligned prompt prefix, kept RESIDENT in the LRU so a later
      admission can pin it instead of re-prefilling; evicted
      oldest-first when allocation outruns the free list.

    Single-threaded by contract (the engine's dispatch thread), like
    every other pool structure.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = True,
                 max_seq_tokens: Optional[int] = None,
                 on_evict: Optional[Callable[[], None]] = None):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the null "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        # Cap on positions one sequence can ever WRITE (the paged pool
        # passes the model's max_len): a request the engine accepts at
        # the boundary (P + max_new - 1 == max_len) would otherwise
        # reserve ceil((P+max_new)/bs) = blocks_per_seq + 1 blocks —
        # one more than its block-table row can hold. The device never
        # stores past max_len: the one pipelined boundary tick's
        # row has no table entry and its write is routed to the null
        # block (see paged_decode_tick) — so the reservation clamps
        # too.
        self.max_seq_tokens = max_seq_tokens
        self._on_evict = on_evict
        # Overload control: when set, admission reserves blocks for
        # only min(max_new, watermark) decode tokens instead of the
        # worst case — the pool admits deeper at the same bytes,
        # chains GROW on demand
        # (`extend`, driven by `PagedSlotPool.grow_for_tick`), and a
        # growth failure is resolved by preempting a victim instead of
        # deadlocking. None (the default) keeps the original
        # worst-case reservation: running sequences can never hit
        # allocation failure mid-decode. Only the engine's preemption
        # wiring may set this — optimistic admission WITHOUT a
        # preemption path reintroduces the mid-decode failure mode.
        self.watermark: Optional[int] = None
        # Descending so pop() hands out ascending ids (debuggability).
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}          # active blocks only
        self._hash_of: Dict[int, bytes] = {}    # registered blocks
        self._cache: Dict[bytes, int] = {}      # digest -> block id
        self._lru: "OrderedDict[int, bytes]" = OrderedDict()
        self._seqs: Dict[int, List[int]] = {}   # key (lane) -> chain
        # Residency epoch + memo for `match`: the scheduler's
        # peek-side gate (`can_admit`) and the admit that follows hash
        # the SAME prompt back-to-back, and a head request blocked on
        # block availability re-checks every dispatch loop — the memo
        # collapses those to one chain hash per (prompt, residency
        # state). Any pin/alloc/evict/free/publish bumps the epoch.
        self._epoch = 0
        self._match_memo: Optional[Tuple[bytes, int,
                                         List[int], int]] = None
        self.hits = 0          # prefix blocks served from the cache
        self.misses = 0        # queried prefix blocks not resident
        self.evictions = 0     # cached blocks reclaimed by allocation
        self.cows = 0          # copy-on-write splits

    # -- accounting ---------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """What an allocation can still claim: free + evictable."""
        return len(self._free) + len(self._lru)

    def blocks_of(self, key: int) -> List[int]:
        return list(self._seqs.get(key, ()))

    def resident(self, digest: bytes) -> bool:
        """Whether a full block with this content digest is resident
        in the prefix cache — the scheduler's swap-restore check (a
        shelved transfer whose blocks are all still resident needs no
        re-graft)."""
        return digest in self._cache

    def _needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case blocks for one request: the prompt plus every
        generated token's KV row (the pipelined tick writes at most
        position prompt+max_new-1; see the scheduler's retire lag),
        clamped to ``max_seq_tokens`` — positions past it are never
        written."""
        tokens = prompt_len + max_new
        if self.max_seq_tokens is not None:
            tokens = min(tokens, self.max_seq_tokens)
        return -(-tokens // self.block_size)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Could this request EVER be admitted (worst-case need vs the
        whole pool, ignoring current residency)? The engine's submit
        validation: a request too big for the pool must shed at the
        front door, not park at the queue head starving everything
        behind it (the degrade-by-shedding contract)."""
        return self._needed(prompt_len, max_new) <= self.num_blocks - 1

    # -- the prefix hash chain ----------------------------------------

    def _chain(self, tokens, nblocks: int) -> List[bytes]:
        """Digests of the first ``nblocks`` block-aligned prefixes:
        h_i = H(h_{i-1} || tokens[i*bs:(i+1)*bs]) — a chain, so a
        block's digest commits to the ENTIRE prefix behind it, never
        just its own 16 tokens."""
        # hvd: disable=HVD001(tokens are host-side prompt ids from the admission queue, never a device array — no sync)
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        out, h = [], b""
        for i in range(nblocks):
            blk = toks[i * self.block_size:(i + 1) * self.block_size]
            h = hashlib.blake2b(h + blk.tobytes(),
                                digest_size=16).digest()
            out.append(h)
        return out

    def match(self, prompt) -> Tuple[List[int], int]:
        """Longest resident block-aligned prefix of ``prompt``:
        returns (block ids, blocks queried). Capped at the LAST prompt
        token — at least one tail token must re-prefill so the final
        chunk yields the logits the first sampled token comes from.
        Pure lookup: nothing is pinned. Memoized per (prompt,
        residency epoch) so the can_admit/admit pair — and a head
        request re-checked every dispatch loop — hash the chain
        once."""
        if not self.prefix_cache:
            return [], 0
        # hvd: disable=HVD001(prompt is host-side admission-queue tokens, never a device array — no sync)
        key = np.ascontiguousarray(np.asarray(prompt, np.int64)).tobytes()
        memo = self._match_memo
        if memo is not None and memo[0] == key \
                and memo[1] == self._epoch:
            return list(memo[2]), memo[3]
        limit = (len(prompt) - 1) // self.block_size
        ids = []
        for h in self._chain(prompt, limit):
            bid = self._cache.get(h)
            if bid is None:
                break
            ids.append(bid)
        self._match_memo = (key, self._epoch, list(ids), limit)
        return ids, limit

    # -- allocation ---------------------------------------------------

    def _evict_one(self) -> int:
        bid, digest = self._lru.popitem(last=False)   # oldest first
        del self._cache[digest]
        del self._hash_of[bid]
        self._epoch += 1
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict()
        return bid

    def _alloc_one(self) -> int:
        bid = self._free.pop() if self._free else self._evict_one()
        self._ref[bid] = 1
        self._epoch += 1
        return bid

    def _pin(self, bid: int):
        if bid in self._lru:           # resurrect a cached block
            del self._lru[bid]
        self._ref[bid] = self._ref.get(bid, 0) + 1
        self._epoch += 1

    def _headroom(self, matched: List[int]) -> int:
        """Blocks an allocation can still claim AFTER pinning
        ``matched``: the free list plus the LRU minus matched blocks
        that currently sit IN the LRU — pinning resurrects those, so
        they stop being evictable (counting them double let a tight
        admission pass its capacity check and then die evicting from
        an empty LRU)."""
        in_lru = sum(1 for bid in matched if bid in self._lru)
        return len(self._free) + len(self._lru) - in_lru

    def _reserve_new(self, max_new: int) -> int:
        """Decode tokens RESERVED at admission: the worst case, or the
        optimistic watermark when one is set (preemption armed)."""
        if self.watermark is None:
            return max_new
        return min(max_new, max(1, int(self.watermark)))

    def can_admit(self, prompt, max_new: int) -> bool:
        """Would `admit` succeed right now? Pure check (nothing
        allocated or pinned) — the scheduler's peek-side gate, so a
        request that doesn't fit stays at the queue head instead of
        churning pop/requeue."""
        matched, _ = self.match(prompt)
        need = self._needed(
            len(prompt), self._reserve_new(max_new)) - len(matched)
        return need <= self._headroom(matched)

    def admit(self, key: int, prompt, max_new: int) -> Optional[
            "Admission"]:
        """Reserve the request's whole worst-case block chain for lane
        ``key``: pin the matched prefix blocks, allocate the rest
        (evicting LRU-cached blocks as needed). Reserving up front
        (rather than growing on demand) means a running sequence can
        NEVER hit allocation failure mid-decode — admission is the one
        gate, and blocks still free at ACTUAL lengths on retire.
        Returns None when the pool cannot hold it (``slot`` is filled
        in by the caller — the allocator doesn't own lanes)."""
        if key in self._seqs:
            raise ValueError(f"sequence key {key} already admitted")
        matched, queried = self.match(prompt)
        total = self._needed(len(prompt), self._reserve_new(max_new))
        need = total - len(matched)
        if need > self._headroom(matched):
            return None
        for bid in matched:
            self._pin(bid)
        chain = matched + [self._alloc_one() for _ in range(need)]
        self._seqs[key] = chain
        self.hits += len(matched)
        self.misses += queried - len(matched)
        return Admission(slot=-1,
                         skipped=len(matched) * self.block_size,
                         matched_blocks=len(matched),
                         queried_blocks=queried)

    def extend(self, key: int, total_tokens: int) -> bool:
        """Grow lane ``key``'s chain to cover ``total_tokens``
        positions (clamped to ``max_seq_tokens`` — the device drops
        writes past the row anyway). The on-demand half of
        watermark-based optimistic admission: True when the chain
        already covers it or new blocks were allocated, False when
        the pool is out of blocks (the lane is STRANDED — the caller
        must preempt someone before dispatching its next write, else
        the write lands in the null block and corrupts the stream)."""
        chain = self._seqs.get(key)
        if chain is None:
            raise ValueError(f"sequence key {key} not admitted")
        tokens = total_tokens
        if self.max_seq_tokens is not None:
            tokens = min(tokens, self.max_seq_tokens)
        need = -(-tokens // self.block_size) - len(chain)
        if need <= 0:
            return True
        if need > len(self._free) + len(self._lru):
            return False
        for _ in range(need):
            chain.append(self._alloc_one())
        return True

    def publish(self, key: int, prompt):
        """Register lane ``key``'s full prompt blocks in the prefix
        index (called when its prefill completes — from here on, an
        identical block-aligned prefix chain is a cache hit). First
        writer wins on a digest collision between two concurrent cold
        prefills of the same prompt; the loser's private block simply
        stays unregistered."""
        if not self.prefix_cache:
            return
        ids = self._seqs.get(key, [])
        full = min(len(prompt) // self.block_size, len(ids))
        for h, bid in zip(self._chain(prompt, full), ids[:full]):
            if h not in self._cache and bid not in self._hash_of:
                self._cache[h] = bid
                self._hash_of[bid] = h
                self._epoch += 1

    def chain_digests(self, tokens, nblocks: int) -> List[bytes]:
        """Public chain-digest accessor (the transfer layer's
        manifest identity; see serving/transfer.py)."""
        return self._chain(tokens, nblocks)

    def adopt(self, digest: bytes) -> Optional[int]:
        """Register a FOREIGN block under ``digest`` as a refcount-0
        LRU-resident cached block — the ingest half of a KV-block
        transfer (serving/transfer.py). The caller scatters the
        block's device bytes into the returned id; from then on it is
        indistinguishable from a locally published prefix block: an
        admission `match` pins it, eviction reclaims it oldest-first.
        Returns None when the digest is already resident (idempotent
        ingest) or when no block can be claimed without eviction
        pressure the caller should not pay (full pool, empty LRU)."""
        if not self.prefix_cache or digest in self._cache:
            return None
        if not self._free and not self._lru:
            return None
        bid = self._free.pop() if self._free else self._evict_one()
        self._cache[digest] = bid
        self._hash_of[bid] = digest
        self._lru[bid] = digest
        self._epoch += 1
        return bid

    def fork(self, src: int, dst: int):
        """Share ``src``'s whole chain with a new sequence ``dst``
        (n-best sampling / speculative branches): every block gains a
        ref. Appends by either sequence hit copy-on-write at the
        shared tail (`ensure_writable`)."""
        if dst in self._seqs:
            raise ValueError(f"sequence key {dst} already admitted")
        chain = self._seqs[src]
        for bid in chain:
            self._pin(bid)
        self._seqs[dst] = list(chain)

    def ensure_writable(self, key: int,
                        block_index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write gate: lane ``key`` is about to APPEND into
        chain position ``block_index``. A block shared with anyone
        else (refcount > 1 — a fork tail, or a pinned published
        prefix) must not be mutated in place: allocate a private
        block, swap it into the chain, and return ``(src, dst)`` so
        the caller materializes the copy on device
        (`paged_copy_block`). None = already exclusively owned.
        Raises RuntimeError when no block can be claimed — forking
        needs headroom beyond the per-sequence reservations."""
        chain = self._seqs[key]
        bid = chain[block_index]
        if self._ref[bid] == 1 and bid not in self._hash_of:
            return None
        if self._ref[bid] == 1:
            # Sole owner but PUBLISHED: future matchers would pin a
            # block whose tail this append is about to overwrite.
            # Unregister instead of copying — content up to the hash's
            # span is still the registered prefix, but the simple,
            # provably safe rule is: a written block leaves the index.
            h = self._hash_of.pop(bid)
            del self._cache[h]
            self._epoch += 1
            return None
        if self.available_blocks < 1:
            raise RuntimeError(
                "copy-on-write needs a free block; fork headroom "
                "exhausted")
        nid = self._alloc_one()
        self._ref[bid] -= 1
        chain[block_index] = nid
        self.cows += 1
        return bid, nid

    def free_seq(self, key: int) -> List[int]:
        """Release lane ``key``'s chain: every block drops a ref;
        refcount-0 blocks go to the LRU if hash-registered (resident
        prefix cache) or the free list otherwise. Idempotent per key.
        Returns the released chain (tests)."""
        chain = self._seqs.pop(key, [])
        for bid in chain:
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                del self._ref[bid]
                self._epoch += 1
                if bid in self._hash_of and self.prefix_cache:
                    self._lru[bid] = self._hash_of[bid]
                else:
                    self._hash_of.pop(bid, None)
                    self._free.append(bid)
        return chain

    def check_invariants(self):
        """Every allocatable block in exactly one of free/active/
        cached; maps mutually consistent; live chains hold refs that
        sum up exactly. Raises AssertionError — the churn tests call
        this after every operation."""
        free, active, cached = (set(self._free), set(self._ref),
                                set(self._lru))
        assert 0 not in free | active | cached, "null block leaked"
        assert not (free & active), (free, active)
        assert not (free & cached), (free, cached)
        assert not (active & cached), (active, cached)
        assert free | active | cached == set(
            range(1, self.num_blocks)), "block lost or duplicated"
        assert all(r >= 1 for r in self._ref.values()), self._ref
        # Refcounts are EXACTLY the per-chain memberships.
        counts: Dict[int, int] = {}
        for chain in self._seqs.values():
            for bid in chain:
                counts[bid] = counts.get(bid, 0) + 1
        assert counts == self._ref, (counts, self._ref)
        # Hash index <-> block registry agree both ways; LRU subset.
        assert {v: k for k, v in self._cache.items()} == self._hash_of
        for bid, h in self._lru.items():
            assert self._hash_of.get(bid) == h, (bid, h)

    def stats(self) -> Dict[str, int]:
        return {"blocks_free": self.free_blocks,
                "blocks_used": self.used_blocks,
                "blocks_cached": self.cached_blocks,
                "prefix_hits": self.hits,
                "prefix_misses": self.misses,
                "prefix_evictions": self.evictions,
                "cows": self.cows}



class PagedSlotPool:
    """The paged twin of `serving.slots.SlotPool`: same lifecycle
    protocol (the scheduler and engine drive both through `can_admit` /
    `admit` / `begin_prefill` / `prefill_chunk` / `finish_prefill` /
    `tick_dispatch` / `tick_sync` / `free` / `warmup` /
    `clone_fresh`), but the device KV lives in per-layer block pools
    shared by every lane, each lane indexing them through its row of
    the block table.

    ``num_blocks`` sets device KV bytes (``num_blocks x block_size``
    rows per layer and per K/V; block 0 is the null block). The default
    — ``num_slots x max_len / block_size + 1`` — matches the fixed slot
    pool's bytes. ``kernel`` is the paged-attention mode
    (`_resolve_paged_kernel`; None reads HVD_PAGED_KERNEL).
    ``spec_draft`` / ``spec_k`` arm speculative decoding as on
    `SlotPool` (prefix caching then off). All device work on the
    caller's thread (the engine's dispatch thread).
    """

    def __init__(self, model: TransformerLM, num_slots: int, *,
                 num_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 on_evict: Optional[Callable[[], None]] = None,
                 kernel: Optional[str] = None, spec_draft=None,
                 spec_k: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        from horovod_tpu_torch.runtime.config import config as _cfg
        if block_size is None:
            block_size = _cfg.kv_block_size
        if prefix_cache is None:
            prefix_cache = _cfg.prefix_cache
        self.model = model
        self.device = dev = model.device
        self.num_slots = num_slots
        self.eos_id = eos_id
        self._eos = torch.tensor(-1 if eos_id is None else eos_id,
                                 device=dev)
        self.spec = paged_cache_spec(model, block_size)
        self.block_size = self.spec.block_size
        self.kernel_mode = _resolve_paged_kernel(kernel, model,
                                                 self.block_size)
        # Speculative decoding: the draft rides a LINEAR slot cache;
        # prefix caching is off so one chunk schedule drives both.
        self.spec_draft = resolve_spec_draft(spec_draft)
        self.spec_k = int(spec_k) if spec_draft is not None else 0
        self.drf_model = self._drf_cache = None
        if self.spec_draft is not None:
            validate_spec_draft(model, self.spec_draft, self.spec_k)
            self.drf_model = slot_decode_model(self.spec_draft)
            self._drf_cache = init_slot_cache(self.spec_draft, num_slots)
            prefix_cache = False
        # Brownout level >= 2 caps the speculative k mid-stream.
        self.spec_cap: Optional[int] = None
        if num_blocks is None:
            num_blocks = num_slots * self.spec.blocks_per_seq + 1
        self.num_blocks = int(num_blocks)
        self.blocks = BlockPool(self.num_blocks, self.block_size,
                                prefix_cache=prefix_cache,
                                max_seq_tokens=model.max_len,
                                on_evict=on_evict)
        self._on_evict = on_evict
        self._pools = init_paged_pools(model, self.spec, self.num_blocks)
        T = self.spec.blocks_per_seq
        self._tables = torch.zeros((num_slots, T), dtype=torch.int32,
                                   device=dev)
        self._fills = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self._toks = torch.zeros(num_slots, dtype=torch.long, device=dev)
        self._temps = torch.zeros(num_slots, device=dev)
        self._top_ps = torch.ones(num_slots, device=dev)
        self._live = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self._done = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self._keys = LaneKeys(num_slots)
        self._free_lanes: List[int] = list(range(num_slots))
        # Host-side admission state: what admit() granted, consumed by
        # begin_prefill/finish_prefill; plus a CONSERVATIVE per-lane
        # fill estimate driving the copy-on-write gate and bounding the
        # walk (over-estimating only copies early / walks one masked
        # span more — never corrupts).
        self._admit_info: Dict[int, Tuple[np.ndarray, int]] = {}
        self._est_fill = np.zeros((num_slots,), np.int64)
        self._ticking: set = set()     # lanes live on the host's view
        # Two pinned host buffers alternate under the one-deep ring
        # (as in SlotPool).
        pin = dev.type == "cuda"
        self._host = [torch.empty(num_slots, dtype=torch.long,
                                  pin_memory=pin) for _ in range(2)]
        self._ring = 0
        self.maybe_compiling = False
        self._seen_shapes: set = set()
        self.compiles = 0

    # -- shared plumbing (mirrors SlotPool) ---------------------------

    @property
    def spec_on(self) -> bool:
        return self.spec_draft is not None

    def _note_shape(self, key):
        if key not in self._seen_shapes:
            self.compiles += 1
            self._seen_shapes.add(key)
            from horovod_tpu_torch.obs import catalog as _obs_catalog
            from horovod_tpu_torch.obs import events as _events
            _obs_catalog.serving_metrics()["compiles"].inc()
            _events.emit("serving.compile", shape=repr(key))

    def _to_device(self, arr) -> torch.Tensor:
        """A host array on the pool's device without a stream sync (a
        pageable host->device copy would wait for the in-flight tick;
        a pinned one is enqueued like any kernel)."""
        t = torch.as_tensor(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def release(self):
        """Drop the block pools (and a draft's cache) of a pool whose
        engine has stopped for good, as `SlotPool.release` does."""
        self._pools = self._drf_cache = None

    def clone_fresh(self) -> "PagedSlotPool":
        """The watchdog's restart primitive: a brand-new pool — fresh
        block allocator, EMPTY prefix cache — over the same model and
        geometry. The old device state is mid-unknown-tick and
        untrusted, and a hash index over untrusted bytes would serve
        corrupt prefixes, so the cache restarts cold."""
        fresh = PagedSlotPool(
            self.model, self.num_slots, num_blocks=self.num_blocks,
            block_size=self.block_size, eos_id=self.eos_id,
            prefix_cache=self.blocks.prefix_cache,
            on_evict=self._on_evict, kernel=self.kernel_mode,
            spec_draft=self.spec_draft, spec_k=self.spec_k)
        fresh._seen_shapes = set(self._seen_shapes)
        fresh.compiles = self.compiles
        # The engine armed the watermark and the spec cap once at
        # construction; a fresh pool back on worst-case reservation
        # would shrink admission depth mid-flight.
        fresh.blocks.watermark = self.blocks.watermark
        fresh.spec_cap = self.spec_cap
        return fresh

    def fill_indices(self) -> np.ndarray:
        """Per-lane device fill (introspection; reads the device)."""
        return self._fills.cpu().numpy()

    # -- occupancy ----------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free_lanes)

    @property
    def busy_slots(self) -> int:
        return self.num_slots - len(self._free_lanes)

    def has_free(self) -> bool:
        return bool(self._free_lanes)

    def kv_stats(self) -> Dict[str, int]:
        return self.blocks.stats()

    # -- admission ----------------------------------------------------

    def can_admit(self, prompt, max_new: int) -> bool:
        """Free lane AND enough blocks (after prefix credit) — the
        scheduler's peek-side gate: lanes are cheap program width,
        blocks are the real KV bytes."""
        return bool(self._free_lanes) and self.blocks.can_admit(
            prompt, max_new)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Could the request EVER be admitted (worst-case need vs the
        whole pool)? The engine's submit-time shed gate."""
        return self.blocks.fits(prompt_len, max_new)

    def admit(self, prompt, max_new: int) -> Optional[Admission]:
        """Claim a lane + the request's block chain; None when either
        is short. The matched prefix span (``skipped``) is already
        resident — `begin_prefill` starts the lane's fill there and the
        scheduler streams only the tail."""
        if not self._free_lanes:
            return None
        # hvd: disable=HVD001(prompt is host-side admission-queue tokens, never a device array — no sync)
        prompt = np.asarray(prompt)
        slot = self._free_lanes[-1]
        adm = self.blocks.admit(slot, prompt, max_new)
        if adm is None:
            return None
        self._free_lanes.pop()
        self._admit_info[slot] = (prompt, adm.skipped)
        return Admission(slot=slot, skipped=adm.skipped,
                         matched_blocks=adm.matched_blocks,
                         queried_blocks=adm.queried_blocks)

    # -- prefill ------------------------------------------------------

    def begin_prefill(self, slot: int):
        """Install the lane's device state for its admitted request:
        fill starts AT the matched-prefix span (the skip), the block
        table row is the admitted chain, live/done clear. No device
        zeroing — block content beyond the fill is never attended, and
        recycled blocks are overwritten before the fill reaches them."""
        _, skipped = self._admit_info.get(slot, (None, 0))
        chain = self.blocks.blocks_of(slot)
        row = np.zeros((self.spec.blocks_per_seq,), np.int32)
        row[:len(chain)] = chain
        self.maybe_compiling = ("paged_begin",) not in self._seen_shapes
        try:
            self._tables[slot].copy_(self._to_device(row),
                                     non_blocking=True)
            self._fills[slot] = int(skipped)
            if self.spec_on:
                slot_reset(self._drf_cache, slot)
            self._live[slot] = False
            self._done[slot] = False
            self._note_shape(("paged_begin",))
        finally:
            self.maybe_compiling = False
        self._est_fill[slot] = skipped
        self._ticking.discard(slot)

    def _cow_span(self, slot: int, start: int, end: int):
        """Copy-on-write gate for writes covering positions [start,
        end): any chain block in that span shared with another sequence
        is split to a private copy first (device bytes via
        `paged_copy_block`, table entry updated). With prefix caching
        alone this never fires — matched blocks are FULL and writes land
        past them — but forked sequences make it load-bearing."""
        chain = self.blocks.blocks_of(slot)
        lo, hi = start // self.block_size, (end - 1) // self.block_size
        for idx in range(lo, min(hi, len(chain) - 1) + 1):
            swap = self.blocks.ensure_writable(slot, idx)
            if swap is None:
                continue
            src, dst = swap
            paged_copy_block(self._pools, src, dst)
            self._tables[slot, idx] = dst

    def prefill_chunk(self, slot: int, chunk):
        """Append one prompt chunk into lane ``slot``'s paged cache;
        returns the chunk's last-position logits (a device tensor — no
        host sync). The same binary-decomposition chunk schedule as the
        slot pool."""
        # hvd: disable=HVD001(chunk is host-side prompt tokens from the admission queue, never a device array — no sync)
        chunk = np.asarray(chunk)
        c = int(chunk.shape[0])
        fill = int(self._est_fill[slot])
        self._cow_span(slot, fill, fill + c)
        self.maybe_compiling = (
            ("paged_prefill", c) not in self._seen_shapes)
        try:
            toks = self._to_device(chunk.astype(np.int64))
            logits = paged_prefill_chunk(
                self.model, self.spec, self._pools, self._tables,
                self._fills, slot, toks, paged_kernel=self.kernel_mode,
                fill=fill)
            if self.spec_on:
                # Mirror the chunk into the draft cache (advance only).
                slot_prefill_advance(self.drf_model, self._drf_cache, slot,
                                     toks, fill=fill)
            self._note_shape(("paged_prefill", c))
            self._est_fill[slot] = fill + c
            return logits
        finally:
            self.maybe_compiling = False

    def finish_prefill(self, slot: int, logits, temperature: float,
                       top_p: Optional[float], seed: int, *,
                       rng_skip: int = 0) -> int:
        """Close a prefill exactly as the slot pool does (same
        `_first_token` discipline; ``rng_skip`` resumes a forced-prefix
        continuation's stream mid-way), then PUBLISH the prompt's full
        blocks to the prefix index: from this moment an identical
        block-aligned prefix is a cache hit, even while this request is
        still decoding."""
        self.maybe_compiling = ("first_token",) not in self._seen_shapes
        try:
            tp = 1.0 if top_p is None else float(top_p)
            tok, rng = _first_token(logits, float(temperature), tp,
                                    threefry.prng_key(seed),
                                    int(rng_skip))
            self._note_shape(("first_token",))
            self._toks[slot] = tok
            self._temps[slot] = float(temperature)
            self._top_ps[slot] = tp
            self._keys.install(slot, rng)
            self._live[slot] = True
            self._done[slot] = self.eos_id is not None and tok == self.eos_id
            info = self._admit_info.pop(slot, None)
            if info is not None:
                self.blocks.publish(slot, info[0])
            self._ticking.add(slot)
            return tok
        finally:
            self.maybe_compiling = False

    def prefill(self, slot: int, prompt, temperature: float,
                top_p: Optional[float], seed: int, *,
                max_chunk: Optional[int] = None) -> int:
        """begin/chunks/finish in one call (tests, simple callers) —
        starts at the admitted skip, streams only the tail."""
        prompt = np.asarray(prompt)
        _, skipped = self._admit_info.get(slot, (None, 0))
        self.begin_prefill(slot)
        logits = None
        off = skipped
        for c in prefill_chunks(int(prompt.shape[0]) - skipped,
                                max_chunk):
            logits = self.prefill_chunk(slot, prompt[off:off + c])
            off += c
        return self.finish_prefill(slot, logits, temperature, top_p,
                                   seed)

    def graft(self, transfer) -> int:
        """Ingest a `BlockTransfer` into this pool's prefix cache
        (`serving.transfer.ingest_blocks`): verify digests, adopt the
        blocks under fresh ids, copy the rows in. Returns blocks newly
        adopted; raises `TransferError` on any verification failure
        (the pool is left untouched)."""
        from horovod_tpu_torch.serving.transfer import ingest_blocks
        return ingest_blocks(self, transfer)

    def fork(self, slot: int) -> Optional[int]:
        """Clone lane ``slot`` into a fresh lane sharing its ENTIRE
        block chain (refcounted — zero KV bytes copied up front):
        sampling state (the threefry key included), fill and done
        flag are duplicated, so both lanes continue from the identical
        sequence state. The first append by either lane into the shared
        tail block triggers copy-on-write. None when no lane is free."""
        if not self._free_lanes:
            return None
        dst = self._free_lanes.pop()
        self.blocks.fork(slot, dst)
        for t in (self._tables, self._fills, self._toks, self._temps,
                  self._top_ps, self._live, self._done):
            t[dst] = t[slot]
        self._keys.copy(slot, dst)
        self._est_fill[dst] = self._est_fill[slot]
        if slot in self._ticking:
            self._ticking.add(dst)
        return dst

    # -- watermark growth ---------------------------------------------

    def _spec_k_eff(self) -> int:
        return spec_k_eff(self.spec_k, self.spec_cap)

    def grow_for_tick(self) -> List[int]:
        """Under watermark admission, grow every ticking lane's chain
        to cover the positions its NEXT dispatch writes (one for a plain
        tick, up to k+1 for a spec round) and mirror any new block into
        the device table. Returns the lanes that could NOT
        be grown (pool dry) — STRANDED: the scheduler must preempt
        before dispatching, because a write past the chain lands in the
        null block and corrupts the stream. No-op when the watermark is
        unset: worst-case admission already covered every position."""
        if self.blocks.watermark is None or not self._ticking:
            return []
        cap = self.spec.view_len
        span = self._spec_k_eff() + 1 if self.spec_on else 1
        stranded: List[int] = []
        for slot in sorted(self._ticking):
            est = int(self._est_fill[slot])
            top = min(est + span, cap)
            if top <= est:
                continue
            before = len(self.blocks.blocks_of(slot))
            if not self.blocks.extend(slot, top):
                stranded.append(slot)
                continue
            chain = self.blocks.blocks_of(slot)
            for idx in range(before, len(chain)):
                self._tables[slot, idx] = chain[idx]
        return stranded

    # -- the tick (split for pipelining) ------------------------------

    @hot_path
    def tick_dispatch(self) -> TickHandle:
        """Enqueue one paged decode tick over every lane and start the
        async device->host copy of its tokens; same pipelining contract
        as the slot pool. Before dispatch, the copy-on-write gate runs
        for each host-live lane's next write position (a handful of
        dict lookups unless a lane was forked). The walk is bounded by
        the largest host-estimated fill of a ticking lane, so no host
        sync reads the device fills."""
        bound = 1
        for slot in list(self._ticking):
            est = int(self._est_fill[slot])
            if est // self.block_size < self.spec.blocks_per_seq:
                self._cow_span(slot, est, est + 1)
            bound = max(bound, est + 1)
        self.maybe_compiling = ("paged_tick",) not in self._seen_shapes
        try:
            self._toks, self._done = paged_decode_tick(
                self.model, self.spec, self._pools, self._tables,
                self._fills, self._toks, self._temps, self._top_ps,
                self._keys.noise(self.model.vocab_size, self.device),
                self._live, self._done, self._eos,
                paged_kernel=self.kernel_mode, prefix_len=bound)
            self._note_shape(("paged_tick",))
        finally:
            self.maybe_compiling = False
        for slot in self._ticking:
            # Conservative host fill advance (the device freezes done
            # lanes — over-estimating only triggers an early COW check,
            # clamped to the allocated chain).
            self._est_fill[slot] += 1
        buf = self._host[self._ring]
        self._ring ^= 1
        buf.copy_(self._toks, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return TickHandle(buf, event)

    @staticmethod
    @hot_path
    def tick_sync(handle: TickHandle) -> np.ndarray:
        """Block for one dispatched tick's [num_slots] token vector."""
        if handle.event is not None:
            # The pipelined ring's DESIGNED sync point.
            handle.event.synchronize()
        return handle.buf.numpy().copy()

    def tick(self) -> np.ndarray:
        return self.tick_sync(self.tick_dispatch())

    # -- speculative rounds -------------------------------------------

    @hot_path
    def spec_round(self):
        """One batched draft-verify round over every paged lane (the
        contract of `SlotPool.spec_round`, paged target): the
        copy-on-write gate first runs over each ticking lane's whole
        write span [est, est + k + 1); afterwards the host fill
        estimates advance by n_emit. Returns ``(emitted [L, k+1], n_emit
        [L], proposed [L])`` numpy through ONE device-to-host read."""
        assert self.spec_on, "spec_round on a pool without spec_draft"
        k = self._spec_k_eff()
        bound = 0
        for slot in list(self._ticking):
            est = int(self._est_fill[slot])
            top = min(est + k + 1, self.spec.view_len)
            if est < top:
                self._cow_span(slot, est, top)
            bound = max(bound, est)
        self.maybe_compiling = (
            ("paged_spec_round", k) not in self._seen_shapes)
        try:
            (emitted, n_emit, self._done, self._toks,
             proposed) = paged_spec_round(
                self.model, self.drf_model, self.spec, self._pools,
                self._drf_cache, self._tables, self._fills, self._toks,
                self._live, self._done, self._eos, k,
                paged_kernel=self.kernel_mode, prefix_len=bound)
            self._note_shape(("paged_spec_round", k))
        finally:
            self.maybe_compiling = False
        emitted, n_emit, proposed = read_round(emitted, n_emit, proposed)
        for slot in self._ticking:
            # Conservative host fill advance (a done lane's eos re-emit
            # does not advance; over-estimating only copies early).
            self._est_fill[slot] += int(n_emit[slot])
        return emitted, n_emit, proposed

    # -- warmup -------------------------------------------------------

    def warmup(self, max_chunk: Optional[int] = None) -> dict:
        """Run every kind of device call once before the first request
        (begin, every pow2 prefill chunk, first token, the paged tick)
        on lane 0 against the null table — the writes land in the null
        block, which is never attended, so no allocation is needed and
        the pool ends pristine. On the card this builds the CUDA
        kernels before the hot path."""
        t0 = time.time()
        before = self.compiles
        cap = self.model.max_len
        if max_chunk is not None and max_chunk >= 1:
            cap = min(cap, int(max_chunk))
        cap = 1 << (max(1, cap).bit_length() - 1)   # pow2 floor
        sizes = [1 << b for b in range(cap.bit_length())]
        logits = None
        for c in sizes:
            self.begin_prefill(0)
            logits = self.prefill_chunk(0, np.zeros((c,), np.int64))
        self.finish_prefill(0, logits, 0.0, None, 0)
        if self.spec_on:
            # Spec mode never dispatches the plain tick: warm the round.
            self.spec_round()
        else:
            self.tick()
        # Lane 0 back to pristine FREE state (the draft lane is reset
        # by begin_prefill).
        self.begin_prefill(0)
        self._est_fill[0] = 0
        self._toks[0] = 0
        return {"compiles": self.compiles - before,
                "seconds": time.time() - t0,
                "prefill_sizes": sizes}

    def free(self, slot: int):
        """Retire a lane: release its block chain to the allocator
        (hash-registered blocks stay RESIDENT in the LRU — the prefix
        cache outliving the request is the point), stop the lane on the
        device, neutralize its sampling state. Blocks return at the
        request's ACTUAL footprint, never max_len."""
        if slot in self._free_lanes:
            raise ValueError(f"slot {slot} is already free")
        self.blocks.free_seq(slot)
        self._admit_info.pop(slot, None)
        self._ticking.discard(slot)
        self._est_fill[slot] = 0
        if self.spec_on:
            slot_reset(self._drf_cache, slot)
        self._tables[slot] = 0
        self._fills[slot] = 0
        self._live[slot] = False
        self._done[slot] = False
        self._toks[slot] = 0
        self._temps[slot] = 0.0
        self._top_ps[slot] = 1.0
        self._keys.install(slot, None)
        self._free_lanes.append(slot)
