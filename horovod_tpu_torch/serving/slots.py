"""Slot-pool KV cache: the device state behind continuous batching.

Counterpart of `horovod_tpu.serving.slots`. The pool is a `KVCache`
whose lanes are the decode slots (`models.transformer`'s slot
primitives); this module adds the host bookkeeping the scheduler
needs: a free list, per-slot sampling state (temperature, top_p and a
per-request threefry key), per-slot live/done occupancy flags, and
reset-on-retire hygiene.

Slot lifecycle::

    FREE --alloc()--> begin_prefill() [reset]
      ^                 --prefill_chunk()*--> finish_prefill()
      |                                           |  (live flag set)
      +------------------- free() <--- ACTIVE --tick_dispatch()*

The tick is split for pipelining: `tick_dispatch()` enqueues the
batched tick, starts a ``non_blocking`` copy of its token buffer into
pinned host memory and records a CUDA event; `tick_sync(handle)` waits
on that event. The scheduler dispatches tick N+1 before syncing tick
N, so the transfer and the host bookkeeping hide behind the device's
compute — one designed host sync per tick, made late.

Speculative decoding (``spec_draft``): the draft model rides its own
slot cache, prefilled chunk for chunk beside the target's, and
`spec_round` replaces the tick — one batched draft-verify round that
retires 1..k+1 tokens per lane, greedy only, with ONE device-to-host
read per round.

Sampling: each request owns a threefry key, ``PRNGKey(seed)`` split as
the JAX package splits it (`ops.threefry`): ``rng, r0 = split(key)``
for the first token, then ``rng, r = split(rng)`` each tick, ``r``
keying the lane's Gumbel noise. The stream is keyed by token ordinal,
independent of the slot and the batch, and equals the reference's for
the same seed. Keys live on the host (`LaneKeys`); greedy requests
hold none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.annotations import hot_path
from horovod_tpu_torch.ops import threefry
from horovod_tpu_torch.models.transformer import (
    TransformerLM, init_slot_cache, prefill_chunks, sample_token,
    slot_decode_model, slot_decode_tick, slot_prefill_advance,
    slot_prefill_chunk, slot_reset, slot_spec_round,
)


def resolve_spec_draft(spec_draft) -> Optional[TransformerLM]:
    """The draft model of a ``spec_draft`` argument: a `TransformerLM`
    (it holds its weights), or the JAX package's ``(draft_model,
    draft_params)`` pair, whose params are None (the model's own
    weights) or a state dict loaded into the model (e.g.
    `compat.from_jax.params_from_jax` of the JAX draft's params)."""
    if spec_draft is None or isinstance(spec_draft, TransformerLM):
        return spec_draft
    draft_model, draft_params = spec_draft
    if draft_params is not None:
        draft_model.load_state_dict(draft_params)
    return draft_model


def validate_spec_draft(model: TransformerLM, draft: TransformerLM,
                        spec_k: int):
    """Shared spec-decode construction checks (both pools, so the
    engine too): k leaves room for at least one proposal, the draft shares
    the target's vocab and device, neither model rolls a sliding-window
    cache (the rewind would overwrite live rows), and the draft cache
    covers every position the target can reach."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if draft.vocab_size != model.vocab_size:
        raise ValueError(
            f"spec draft vocab ({draft.vocab_size}) != target vocab "
            f"({model.vocab_size})")
    if draft.device != model.device:
        raise ValueError(
            f"spec draft on {draft.device}, target on {model.device}")
    if model.window is not None or draft.window is not None:
        raise ValueError(
            "speculative decoding cannot rewind a sliding-window "
            "(rolling) cache; use window=None models")
    if draft.max_len < model.max_len:
        raise ValueError(
            f"spec draft max_len ({draft.max_len}) must cover the "
            f"target's ({model.max_len})")


def spec_k_eff(spec_k: int, spec_cap: Optional[int]) -> int:
    """The speculative k a round dispatches: ``spec_k`` unless a
    brownout cap shrinks it (floor 1 — a zero-k round is a plain
    tick)."""
    if spec_cap is None:
        return spec_k
    return max(1, min(spec_k, int(spec_cap)))


def read_round(emitted, n_emit, proposed):
    """A spec round's results on the host through ONE device-to-host
    copy (three reads would be three syncs): ``(emitted [L, k+1],
    n_emit [L], proposed [L])`` numpy."""
    # hvd: disable=HVD001(the spec round's ONE designed sync — acceptance is data-dependent and every retired token rides this read)
    host = torch.cat([emitted, n_emit[:, None], proposed[:, None]],
                     dim=1).cpu().numpy()
    return host[:, :-2], host[:, -2], host[:, -1]


@torch.no_grad()
def _first_token(logits: torch.Tensor, temp: float, top_p: float,
                 key: Optional[np.ndarray], skips: int
                 ) -> Tuple[int, Optional[np.ndarray]]:
    """First-token sample closing a prefill, from [V] f32 logits: split
    the request key exactly as `generate` does (``rng, r0 =
    split(key)``; the tick keeps splitting ``rng``). Returns ``(token,
    rng)``; ``key`` and ``rng`` are None for a greedy request.

    ``skips`` (normally 0) advances the key by that many carry-splits
    first — the forced-prefix continuation hook: a request resubmitted
    with its first k generated tokens folded into the prompt samples
    token k+1 from the SAME key the original stream would have used
    (each token consumes one split). The int() readback is the one
    per-request sync."""
    noise = rng = None
    if temp > 0:
        rng, r0 = threefry.split(threefry.advance(key, skips))
        noise = threefry.gumbel(r0, logits.shape, device=logits.device)
        noise = noise[None]
    dev = logits.device
    tok = sample_token(logits[None], torch.full((1,), temp, device=dev),
                       torch.full((1,), top_p, device=dev), noise)
    # hvd: disable=HVD001(the ONE designed per-request sync — TTFT wants the first token now)
    return int(tok[0]), rng


class LaneKeys:
    """The host side of a pool's sampling: one threefry key per sampled
    lane. `install` sets a lane's key when its first token is drawn;
    `noise` splits every sampled lane's key once (``rng, r =
    split(rng)``, the reference tick's split) and draws the lanes'
    Gumbel noise on the device in one batched call keyed by the
    ``r``s. Greedy lanes hold no key and their noise rows are unused."""

    def __init__(self, num_slots: int):
        self.keys = np.zeros((num_slots, 2), np.uint32)
        self.sampled: set = set()

    def install(self, slot: int, rng: Optional[np.ndarray]):
        """Set ``slot``'s key (None: the lane is greedy)."""
        if rng is None:
            self.sampled.discard(slot)
        else:
            self.keys[slot] = rng
            self.sampled.add(slot)

    def copy(self, src: int, dst: int):
        """``dst`` continues ``src``'s stream (a fork or a preemption
        twin): a copy of the key pair."""
        self.install(dst, self.keys[src].copy() if src in self.sampled
                     else None)

    def noise(self, vocab: int, device) -> Optional[torch.Tensor]:
        """[num_slots, vocab] Gumbel noise for this tick (None when no
        lane samples), advancing each sampled lane's key by one split."""
        if not self.sampled:
            return None
        lanes = sorted(self.sampled)
        pairs = threefry.split(self.keys[lanes])
        self.keys[lanes] = pairs[:, 0]
        draw = np.zeros_like(self.keys)
        draw[lanes] = pairs[:, 1]
        return threefry.gumbel(draw, (vocab,), device=device)


@dataclass(frozen=True)
class Admission:
    """One granted admission: the decode lane, how many prompt tokens
    the KV cache already holds (``skipped`` — prefill starts there; 0
    outside the paged pool's prefix cache), and the block-level hit
    accounting behind it (`serving.paging`)."""

    slot: int
    skipped: int = 0          # prompt tokens covered by matched blocks
    matched_blocks: int = 0   # prefix blocks pinned from the cache
    queried_blocks: int = 0   # block-aligned prefix blocks looked up


class TickHandle:
    """One in-flight decode tick: the host buffer its tokens are being
    copied into and the event that marks the copy done (None on the
    CPU, where the copy is synchronous)."""

    __slots__ = ("buf", "event")

    def __init__(self, buf, event):
        self.buf = buf
        self.event = event


class SlotPool:
    """A fixed pool of ``num_slots`` decode slots over one shared
    slot-pool KV cache on the model's device.

    All device work happens on the caller's thread (the engine's
    dispatch thread). ``eos_id`` arms on-device stop detection (None =
    disabled). ``spec_draft`` (see `resolve_spec_draft`) with ``spec_k``
    >= 1 proposals a round arms speculative decoding: `spec_round` then
    replaces the tick."""

    def __init__(self, model: TransformerLM, num_slots: int, *,
                 eos_id: Optional[int] = None, spec_draft=None,
                 spec_k: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.model = model
        self.dec_model = slot_decode_model(model)
        self.device = model.device
        self.num_slots = num_slots
        self.eos_id = eos_id
        dev = self.device
        self._eos = torch.tensor(-1 if eos_id is None else eos_id,
                                 device=dev)
        self._cache = init_slot_cache(model, num_slots)
        # Speculative decoding: the draft rides its own linear slot
        # cache, prefilled chunk for chunk beside the target's.
        self.spec_draft = resolve_spec_draft(spec_draft)
        self.spec_k = int(spec_k) if spec_draft is not None else 0
        self.drf_model = self._drf_cache = None
        if self.spec_draft is not None:
            validate_spec_draft(model, self.spec_draft, self.spec_k)
            self.drf_model = slot_decode_model(self.spec_draft)
            self._drf_cache = init_slot_cache(self.spec_draft, num_slots)
        # Brownout level >= 2 caps the speculative k mid-stream (greedy
        # spec decode is token-exact for any k).
        self.spec_cap: Optional[int] = None
        self._toks = torch.zeros(num_slots, dtype=torch.long, device=dev)
        self._temps = torch.zeros(num_slots, device=dev)
        self._top_ps = torch.ones(num_slots, device=dev)
        self._live = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self._done = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        # Host mirror of the sampling state: the sampled lanes' keys
        # (the tick draws their noise).
        self._keys = LaneKeys(num_slots)
        self._free: List[int] = list(range(num_slots))
        # Host mirror of each slot's fill (prompt tokens streamed in so
        # far, plus the tokens spec rounds emitted — an upper bound, as
        # a done lane's eos re-emit does not advance): bounds the prefix
        # loop of the next chunk or round to the filled cache slices
        # without reading the device index.
        self._fill: List[int] = [0] * num_slots
        # Two pinned host buffers alternate under the one-deep ring:
        # tick N+2 reuses tick N's buffer only after N was synced.
        pin = dev.type == "cuda"
        self._host = [torch.empty(num_slots, dtype=torch.long,
                                  pin_memory=pin) for _ in range(2)]
        self._ring = 0
        # True while a call of a kind this pool has not run before is
        # in flight — the first launch builds the CUDA kernels, which
        # must not read as a stuck tick to the engine watchdog.
        self.maybe_compiling = False
        self._seen_shapes: set = set()
        self.compiles = 0

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

    def clone_fresh(self) -> "SlotPool":
        """A brand-new pool over the same model — the engine watchdog's
        restart primitive (the old pool may be mid-tick in a hung
        thread, so its cache and free list are untrusted)."""
        fresh = SlotPool(self.model, self.num_slots, eos_id=self.eos_id,
                         spec_draft=self.spec_draft, spec_k=self.spec_k)
        fresh._seen_shapes = set(self._seen_shapes)
        fresh.compiles = self.compiles
        fresh.spec_cap = self.spec_cap
        return fresh

    def fill_indices(self) -> np.ndarray:
        """Per-slot cache fill index (introspection; reads the device)."""
        return self._cache.index.cpu().numpy()

    # -- occupancy ----------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def busy_slots(self) -> int:
        return self.num_slots - len(self._free)

    def has_free(self) -> bool:
        return bool(self._free)

    # -- lifecycle ----------------------------------------------------

    def alloc(self) -> Optional[int]:
        """Claim a free slot; None when the pool is full."""
        if not self._free:
            return None
        return self._free.pop()

    def can_admit(self, prompt, max_new: int) -> bool:
        """Scheduler admission gate: free slots are the only capacity
        axis (every slot reserves its W KV rows: max_len, or a rolling
        window's)."""
        del prompt, max_new
        return self.has_free()

    def admit(self, prompt, max_new: int) -> Optional[Admission]:
        """Claim a slot for one request (never skips prefix tokens)."""
        del prompt, max_new
        slot = self.alloc()
        return None if slot is None else Admission(slot=slot)

    def begin_prefill(self, slot: int):
        """Zero ``slot``'s rows and clear its live/done flags — the
        mandatory preamble before streaming a prompt in."""
        self.maybe_compiling = ("reset",) not in self._seen_shapes
        try:
            slot_reset(self._cache, slot)
            if self.spec_on:
                slot_reset(self._drf_cache, slot)
            self._fill[slot] = 0
            self._live[slot] = False
            self._done[slot] = False
            self._note_shape(("reset",))
        finally:
            self.maybe_compiling = False

    def prefill_chunk(self, slot: int, chunk):
        """Append one prompt chunk (1-D int tokens) into ``slot``;
        returns its last-position logits (a device tensor — no host
        sync). The slot stays non-live, so interleaved ticks freeze its
        fill index."""
        # hvd: disable=HVD001(chunk is host-side prompt tokens from the admission queue — no sync)
        chunk = np.asarray(chunk)
        c = int(chunk.shape[0])
        self.maybe_compiling = ("prefill", c) not in self._seen_shapes
        try:
            toks = torch.as_tensor(chunk, dtype=torch.long)
            if self.device.type == "cuda":
                # A pageable host->device copy would synchronize the
                # stream (waiting on the in-flight tick); a pinned one
                # is enqueued like any kernel.
                toks = toks.pin_memory().to(self.device, non_blocking=True)
            logits = slot_prefill_chunk(self.dec_model, self._cache, slot,
                                        toks, fill=self._fill[slot])
            if self.spec_on:
                # The draft's cache holds the same prompt before any
                # round: same chunk, advance only (no logits).
                slot_prefill_advance(self.drf_model, self._drf_cache, slot,
                                     toks, fill=self._fill[slot])
            self._fill[slot] += c
            self._note_shape(("prefill", c))
            return logits
        finally:
            self.maybe_compiling = False

    def finish_prefill(self, slot: int, logits, temperature: float,
                       top_p: Optional[float], seed: int, *,
                       rng_skip: int = 0) -> int:
        """Close a prefill: sample the request's FIRST token from the
        final chunk's ``logits`` (the per-request host sync), install
        the slot's sampling state and mark the lane live. ``rng_skip``
        resumes the request's sample stream that many tokens in."""
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
            # A first token that IS eos arms the on-device stop at once.
            self._done[slot] = self.eos_id is not None and tok == self.eos_id
            return tok
        finally:
            self.maybe_compiling = False

    def prefill(self, slot: int, prompt, temperature: float,
                top_p: Optional[float], seed: int, *,
                max_chunk: Optional[int] = None) -> int:
        """Stream ``prompt`` into ``slot`` in one call and return the
        FIRST generated token (begin/chunks/finish composed)."""
        prompt = np.asarray(prompt)
        self.begin_prefill(slot)
        logits = None
        off = 0
        for c in prefill_chunks(int(prompt.shape[0]), max_chunk):
            logits = self.prefill_chunk(slot, prompt[off:off + c])
            off += c
        return self.finish_prefill(slot, logits, temperature, top_p, seed)

    # -- the tick (split for pipelining) ------------------------------

    @hot_path
    def tick_dispatch(self) -> TickHandle:
        """Enqueue one batched decode tick over every slot and start
        the async device->host copy of its tokens; returns at once."""
        self.maybe_compiling = ("tick",) not in self._seen_shapes
        try:
            self._toks, self._done = slot_decode_tick(
                self.dec_model, self._cache, self._toks, self._temps,
                self._top_ps,
                self._keys.noise(self.model.vocab_size, self.device),
                self._live, self._done, self._eos)
            self._note_shape(("tick",))
        finally:
            self.maybe_compiling = False
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
        """Synchronous tick (dispatch + immediate sync)."""
        return self.tick_sync(self.tick_dispatch())

    # -- speculative rounds -------------------------------------------

    @hot_path
    def spec_round(self):
        """One batched draft-verify round over every lane: the draft
        proposes k tokens per live lane, the target verifies each lane's
        block in one S=k+1 append, and 1..k+1 tokens retire per lane —
        exactly the target's greedy stream. Returns ``(emitted [L, k+1],
        n_emit [L], proposed [L])`` numpy through ONE device-to-host
        read (`read_round`), the round's one host sync."""
        assert self.spec_on, "spec_round on a pool without spec_draft"
        k = spec_k_eff(self.spec_k, self.spec_cap)
        self.maybe_compiling = ("spec_round", k) not in self._seen_shapes
        try:
            (emitted, n_emit, self._done, self._toks,
             proposed) = slot_spec_round(
                self.dec_model, self.drf_model, self._cache,
                self._drf_cache, self._toks, self._live, self._done,
                self._eos, k, prefix_len=max(self._fill))
            self._note_shape(("spec_round", k))
        finally:
            self.maybe_compiling = False
        emitted, n_emit, proposed = read_round(emitted, n_emit, proposed)
        for slot in range(self.num_slots):
            self._fill[slot] += int(n_emit[slot])
        return emitted, n_emit, proposed

    # -- warmup -------------------------------------------------------

    def warmup(self, max_chunk: Optional[int] = None) -> dict:
        """Run every kind of device call once before the first request
        — slot reset, each power-of-two prefill chunk, the first-token
        sample and the tick — so the CUDA kernels are built and loaded
        before the hot path. Lane 0 is scratch and re-zeroed after."""
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
        self.begin_prefill(0)
        self._toks[0] = 0
        return {"compiles": self.compiles - before,
                "seconds": time.time() - t0, "prefill_sizes": sizes}

    def release(self):
        """Drop the KV caches of a pool whose engine has stopped for
        good (a router's dead replica), so their device memory serves
        the replacement; the pool takes no device call afterwards."""
        self._cache = self._drf_cache = None

    def free(self, slot: int):
        """Retire a slot: zero its rows, clear its flags and sampling
        state, and return it to the free list."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        slot_reset(self._cache, slot)
        if self.spec_on:
            slot_reset(self._drf_cache, slot)
        self._fill[slot] = 0
        self._live[slot] = False
        self._done[slot] = False
        self._toks[slot] = 0
        self._temps[slot] = 0.0
        self._top_ps[slot] = 1.0
        self._keys.install(slot, None)
        self._free.append(slot)
