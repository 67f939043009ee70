"""Slot-pool KV cache: the device state behind continuous batching.

Counterpart of `horovod_tpu.serving.slots`. The pool is a `KVCache`
whose lanes are the decode slots (`models.transformer`'s slot
primitives); this module adds the host bookkeeping the scheduler
needs: a free list, per-slot sampling state (temperature, top_p and a
per-request `torch.Generator`), per-slot live/done occupancy flags, and
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

Sampling: each request owns a `torch.Generator` seeded from its seed;
every token it samples draws one Gumbel-noise vector from it, so the
stream is keyed by token ordinal and independent of the slot and the
batch. Greedy requests draw nothing. Streams do not reproduce
`jax.random`'s threefry bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from horovod_tpu_torch.annotations import hot_path
from horovod_tpu_torch.models.transformer import (
    TransformerLM, _gumbel, init_slot_cache, prefill_chunks, sample_token,
    slot_decode_model, slot_decode_tick, slot_prefill_chunk, slot_reset,
)


@torch.no_grad()
def _first_token(logits: torch.Tensor, temp: float, top_p: float,
                 generator: Optional[torch.Generator],
                 skips: int) -> int:
    """First-token sample closing a prefill, from [V] f32 logits.

    ``skips`` (normally 0) discards that many noise draws first — the
    forced-prefix continuation hook: a request resubmitted with its
    first k generated tokens folded into the prompt samples token k+1
    from the draw the original stream would have used (one draw per
    sampled token). The int() readback is the one per-request sync."""
    noise = None
    if temp > 0:
        for _ in range(skips):
            _gumbel(logits.shape, generator, logits.device)
        noise = _gumbel(logits.shape, generator, logits.device)[None]
    dev = logits.device
    tok = sample_token(logits[None], torch.full((1,), temp, device=dev),
                       torch.full((1,), top_p, device=dev), noise)
    # hvd: disable=HVD001(the ONE designed per-request sync — TTFT wants the first token now)
    return int(tok[0])


@dataclass(frozen=True)
class Admission:
    """One granted admission: the decode lane and how many prompt
    tokens the cache already holds (always 0 on the fixed pool; the
    paged pool's prefix cache is a later slice)."""

    slot: int
    skipped: int = 0


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
    disabled)."""

    def __init__(self, model: TransformerLM, num_slots: int, *,
                 eos_id: Optional[int] = None):
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
        self._toks = torch.zeros(num_slots, dtype=torch.long, device=dev)
        self._temps = torch.zeros(num_slots, device=dev)
        self._top_ps = torch.ones(num_slots, device=dev)
        self._live = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self._done = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        # Host mirror of the sampling state: lanes with temperature > 0
        # and their per-request generators (the tick draws their noise).
        self._gens: List[Optional[torch.Generator]] = [None] * num_slots
        self._sampled: set = set()
        self._free: List[int] = list(range(num_slots))
        # Host mirror of each slot's fill while it prefills (prompt
        # tokens streamed in so far): bounds the prefix loop of the
        # next chunk to the filled cache slices without reading the
        # device index.
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
        fresh = SlotPool(self.model, self.num_slots, eos_id=self.eos_id)
        fresh._seen_shapes = set(self._seen_shapes)
        fresh.compiles = self.compiles
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
        axis (every slot reserves max_len KV rows)."""
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
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device).manual_seed(
                    int(seed))
            tok = _first_token(logits, float(temperature), tp, gen,
                               int(rng_skip))
            self._note_shape(("first_token",))
            self._toks[slot] = tok
            self._temps[slot] = float(temperature)
            self._top_ps[slot] = tp
            self._gens[slot] = gen
            if gen is not None:
                self._sampled.add(slot)
            else:
                self._sampled.discard(slot)
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

    def _noise(self) -> Optional[torch.Tensor]:
        """Per-lane Gumbel noise for the sampled lanes (one draw each
        from its request's generator); None when every lane is greedy."""
        if not self._sampled:
            return None
        V = self.model.vocab_size
        noise = torch.zeros(self.num_slots, V, device=self.device)
        for slot in sorted(self._sampled):
            noise[slot] = _gumbel((V,), self._gens[slot], self.device)
        return noise

    @hot_path
    def tick_dispatch(self) -> TickHandle:
        """Enqueue one batched decode tick over every slot and start
        the async device->host copy of its tokens; returns at once."""
        self.maybe_compiling = ("tick",) not in self._seen_shapes
        try:
            self._toks, self._done = slot_decode_tick(
                self.dec_model, self._cache, self._toks, self._temps,
                self._top_ps, self._noise(), self._live, self._done,
                self._eos)
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
        self.tick()
        self.begin_prefill(0)
        self._toks[0] = 0
        return {"compiles": self.compiles - before,
                "seconds": time.time() - t0, "prefill_sizes": sizes}

    def free(self, slot: int):
        """Retire a slot: zero its rows, clear its flags and sampling
        state, and return it to the free list."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        slot_reset(self._cache, slot)
        self._fill[slot] = 0
        self._live[slot] = False
        self._done[slot] = False
        self._toks[slot] = 0
        self._temps[slot] = 0.0
        self._top_ps[slot] = 1.0
        self._gens[slot] = None
        self._sampled.discard(slot)
        self._free.append(slot)
