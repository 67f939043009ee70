"""Continuous (iteration-level) batching over the slot pool.

Request-level batching — `generate_bucketed`'s model — picks a batch,
decodes it to completion, then picks the next: short requests finish
early and their rows decode padding until the batch's straggler is
done, so the accelerator batch drains as load-imbalance grows. The
MLPerf TPU-pod lesson (arXiv:1909.09756) is that throughput at scale
is won by keeping the accelerator batch FULL; for serving that means
scheduling at token granularity: every tick, finished sequences are
RETIRED from their slots and queued prompts are PREFILLED into the
freed slots, so the decode batch stays full under load (Yu et al.,
OSDI '22 "Orca" — iteration-level scheduling).

Each `step()` runs one scheduling iteration on the engine's dispatch
thread, PIPELINED (the Horovod lesson of hiding host work behind
device work, applied to decode)::

    sweep dead queued  ->  advance chunked prefills (budgeted)
                       ->  DISPATCH decode tick N (async)
                       ->  SYNC tick N-1 (overlaps tick N's compute):
                             append tokens, retire finished

Two serialization points of a naive loop are gone:

* **Async tick pipelining** — the tick's token readback used to block
  the dispatch thread every step before it could do anything else; now
  tick N+1 is dispatched BEFORE tick N's tokens are read, so the
  transfer and all host bookkeeping hide behind device compute (a
  one-deep in-flight ring; `SlotPool.tick_dispatch`/`tick_sync`).
  Retirement therefore lags one tick; the device-side done mask
  guarantees the lagged tick emits eos, never a post-eos token.
* **Interleaved chunked prefill** (Sarathi-style) — `prefill()` used
  to stream a whole prompt back-to-back, freezing every in-flight
  request's TPOT for the duration; now at most
  ``prefill_chunk_budget`` prompt tokens are streamed per step
  (HVD_PREFILL_CHUNK_BUDGET), with mid-prefill slots tracked in
  `prefilling` and their fill indices frozen through interleaved
  ticks by the pool's live mask.

Requests also leave slots for non-completion reasons — cancellation,
deadline expiry, a non-draining shutdown — all resolved here so the
engine degrades by shedding, never by hanging.

Counterpart of `horovod_tpu.serving.scheduler` in the PyTorch port,
over the fixed slot pool and the paged pool (`serving.paging`): on the
paged pool it grows block chains just in time for each tick
(watermark admission), shelves a preempted stream's KV blocks and
re-grafts them on resume (swap preemption), and ingests inbound
KV-block transfers before admission (the graft deque). In speculative
mode (a pool with ``spec_on``) the synchronous draft-verify round
replaces the pipelined tick ring: each round's one host sync retires
1..k+1 tokens per lane.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import CancelledError, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from horovod_tpu_torch.annotations import hot_path
from horovod_tpu_torch.obs import events as _events
from horovod_tpu_torch.obs import spans as _spans
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving.admission import (
    AdmissionQueue, DeadlineExceededError, EngineClosedError, Request,
)
from horovod_tpu_torch.serving.metrics import EngineMetrics
from horovod_tpu_torch.serving.slots import SlotPool

from horovod_tpu_torch.analysis import lockcheck


@dataclass(frozen=True)
class CompletedRequest:
    """The future's payload for a successfully finished request."""

    request_id: int
    prompt: np.ndarray            # [P] the submitted tokens
    tokens: np.ndarray            # generated tokens (eos included)
    finish_reason: str            # "eos" | "length"
    ttft_s: float
    tpot_s: Optional[float]       # None for single-token outputs
    e2e_s: float
    trace_id: str = ""            # the request's observability id
    # Prompt tokens served from the paged pool's shared-prefix cache
    # (prefill skipped them); 0 on the fixed pool / cache misses.
    prefix_tokens_cached: int = 0

    @property
    def full_sequence(self) -> np.ndarray:
        """prompt ++ generated — `generate`'s row, truncated at eos."""
        return np.concatenate([self.prompt, self.tokens])


@dataclass
class _PrefillJob:
    """One partially prefilled slot: the request, its remaining chunk
    schedule, and the last chunk's logits (device array — the first
    token is sampled from them when the schedule drains). ``prompt``
    is the FULL prefill stream — the submitted prompt plus any forced
    continuation prefix (token-exact migration) — computed once at
    admission."""

    req: Request
    prompt: Any                   # np.ndarray: req.full_prompt
    chunks: List[int]             # remaining chunk token counts
    off: int = 0                  # prompt tokens already streamed
    logits: Any = None


@dataclass
class _PendingTick:
    """The one-deep pipeline ring: a dispatched-but-unsynced tick and
    the slot->request map as of its dispatch (tokens are appended only
    to requests STILL in that slot at sync time — a slot retired or
    re-assigned in between discards its lagged token)."""

    handle: Any
    snapshot: Dict[int, Request] = field(default_factory=dict)


def _timeline():
    """The process's Horovod timeline, or None (spans are then no-ops):
    the handle `utils.timeline.step_bracket` reads."""
    from horovod_tpu_torch.runtime import state as _state
    return _state.global_state().timeline


def _span(method: str, request_id: int, name: str,
          trace_id: str = ""):
    """One request-span timeline verb (counterpart of
    `horovod_tpu/serving/scheduler.py:119-140`): every request is its
    own trace process ``request:<id>`` with QUEUE -> PREFILL -> DECODE
    spans; ``begin_span`` stamps the request's ``trace_id`` into the
    span's ``args``."""
    tl = _timeline()
    if tl is None:
        return
    if method == "begin_span" and trace_id:
        tl.begin_span(f"request:{request_id}", name,
                      args={"trace_id": trace_id})
    else:
        getattr(tl, method)(f"request:{request_id}", name)


def _mark(request_id: int, name: str):
    """An instant event on the request's trace process (its outcome)."""
    tl = _timeline()
    if tl is not None:
        tl.mark(f"request:{request_id}", name)


# Distinguishes stall-bracket names across scheduler generations: a
# superseded thread's finally-end() must never cancel the successor's
# identically-numbered pending tick (both count from shared metrics).
_SCHED_GEN = itertools.count()


class ContinuousBatchingScheduler:
    """The policy half of the engine: owns which request sits in which
    slot and why it leaves. Single-threaded by contract (the engine's
    dispatch thread); only the Request futures/cancel flags are shared
    with submitters.

    ``prefill_chunk_budget``: max prompt tokens streamed per step
    (<= 0 = unbounded: whole prompts at once); also caps the
    chunk sizes themselves, so a single chunk never exceeds the
    budget. ``pipeline_depth``: 0 = sync every tick immediately (the
    A/B control), 1 = the one-deep in-flight
    ring (default)."""

    def __init__(self, pool: SlotPool, queue: AdmissionQueue,
                 metrics: EngineMetrics, *,
                 eos_id: Optional[int] = None, stall=None,
                 prefill_chunk_budget: Optional[int] = None,
                 pipeline_depth: int = 1, grafts=None,
                 overload=None):
        self.pool = pool
        self.queue = queue
        self.metrics = metrics
        # Overload control plane (serving/overload.py): None keeps the
        # pre-preemption behavior (admission blocks at the pool,
        # nothing is evicted mid-stream). When set, a blocked
        # higher-priority head may PREEMPT lower-priority decode lanes
        # token-exactly — swap (KV blocks shelved host-side, re-grafted
        # on resume) or recompute (forced-prefix replay) — and the
        # brownout ladder's level-3 rung feeds `tenant_preempts`.
        self._ov = overload
        # Inbound `BlockTransfer`s (serving/transfer.py) that the
        # engine's `offer_transfer` appends from ANY thread (GIL-atomic
        # append; all device work stays here on the dispatch thread).
        # Drained at the top of every step AND just before each
        # admission peek — an offer that lands before the submit it
        # accelerates is grafted before the request's prompt is
        # matched.
        self._grafts = grafts
        self.eos_id = eos_id
        self.stall = stall           # optional utils.stall.StallMonitor
        if prefill_chunk_budget is None:
            from horovod_tpu_torch.runtime.config import config as _cfg
            prefill_chunk_budget = _cfg.prefill_chunk_budget
        self.prefill_chunk_budget = int(prefill_chunk_budget)
        self._max_chunk = (self.prefill_chunk_budget
                           if self.prefill_chunk_budget > 0 else None)
        self.pipeline_depth = max(0, min(1, int(pipeline_depth)))
        self.active: Dict[int, Request] = {}   # slot -> request
        self.prefilling: Dict[int, _PrefillJob] = {}
        self._prefill_order: List[int] = []    # FIFO over prefilling
        # Cancel fast path (admission.py): a cancelled QUEUED request
        # resolves and releases its slot immediately, and its drop
        # must count exactly like a swept one.
        queue.on_drop = self._queue_drop
        self._pending: Optional[_PendingTick] = None
        # Set (only through `abandon()`) by the engine watchdog when
        # this scheduler's dispatch thread is declared dead/stuck and
        # a replacement takes over: an abandoned scheduler must
        # neither admit nor resolve anything — its requests now belong
        # to the successor. The handoff lock makes admit-registration
        # and the watchdog's abandon+snapshot mutually exclusive, so a
        # request can never fall between the successor's snapshot and
        # the old thread's bookkeeping (a stranded future).
        self.abandoned = False
        self._handoff = lockcheck.register(
            "ContinuousBatchingScheduler._handoff", threading.Lock())
        self._gen = next(_SCHED_GEN)

    def abandon(self) -> List[Request]:
        """Watchdog entry: mark this scheduler dead and take ownership
        of its in-flight requests — decoding AND mid-prefill —
        atomically vs admit/finish registration. The pending tick's
        tokens are dropped with it: the successor replays every
        request from its prompt, token-exact."""
        with self._handoff:
            self.abandoned = True
            inflight = list(self.active.values())
            inflight += [self.prefilling[s].req
                         for s in self._prefill_order]
            self.active.clear()
            self.prefilling.clear()
            self._prefill_order.clear()
            self._pending = None
        return inflight

    def has_active(self) -> bool:
        return bool(self.active or self.prefilling)

    def fail_inflight(self, make_exc) -> int:
        """Engine containment: resolve EVERY in-flight future —
        decoding and mid-prefill — with ``make_exc(req)`` and clear
        the containers (pending tick included). One method so the
        in-flight-container invariant lives where the containers do:
        a future container (e.g. a deeper pipeline ring) added here is
        automatically covered by both engine paths that contain
        (dispatch-thread death and shutdown's dangling cleanup).
        Returns how many futures were failed."""
        with self._handoff:
            doomed = list(self.active.values()) + [
                self.prefilling[s].req for s in self._prefill_order]
            self.active.clear()
            self.prefilling.clear()
            self._prefill_order.clear()
            self._pending = None
        for req in doomed:
            for slot in ("queued", "prefill", "decode", "paused",
                         "root"):
                _spans.end_span(req.span_ids.pop(slot, ""),
                                status="failed")
            self._resolve(req.future, exc=make_exc(req))
        return len(doomed)

    # -- the tick -----------------------------------------------------

    @hot_path
    def step(self, now: Optional[float] = None) -> bool:
        """One scheduling iteration; True when any device work ran
        (the engine parks the thread on False). ``@hot_path``: this is
        the tick ring — everything reachable from here is checked by
        hvdlint HVD001 for stray host syncs (docs/analysis.md)."""
        if self.abandoned:
            return False
        now = time.time() if now is None else now
        if chaos.fires("serving_deadline_storm"):
            # Every queued deadline collapses at once — the sweep
            # below must fail them all in one tick, never hang.
            self.metrics.count("faults_injected")
            self.queue.force_expire(now)
        # Dead queued requests (cancelled / deadline-expired) resolve
        # NOW, slot or no slot — with every slot busy, admission below
        # never pops the queue, and a 100 ms deadline must not wait
        # minutes for a slot to free.
        self.queue.sweep(now, on_drop=self._queue_drop)
        # Dead MID-PREFILL requests release their reserved blocks NOW
        # too — a cancelled/hedge-lost prefill must not sit on
        # reserved-but-unfilled blocks until the chunk loop next picks
        # it (which, budget-starved, could be many steps away).
        self._sweep_dead_prefills(now)
        self._drain_tenant_preempts(now)
        self._drain_grafts()
        progressed = self._advance_prefills(now)
        # Watermark admission's collection point: reservations are
        # optimistic (BlockPool watermark), so every ticking lane's
        # chain is grown to cover the next dispatch BEFORE the write;
        # lanes the pool cannot grow are resolved by preemption, never
        # by letting a device write land in the null block.
        if self.active:
            self._resolve_stranded(now)
        if getattr(self.pool, "spec_on", False):
            # Speculative mode replaces the pipelined S=1 tick ring with
            # synchronous draft-verify ROUNDS: each round's one host
            # sync retires 1..k+1 tokens per lane (the amortization the
            # ring gave), so there is no pending tick to overlap.
            if self.active:
                self._spec_round()
                progressed = True
            return progressed
        handle = snapshot = None
        if self.active:
            # The StallMonitor brackets the dispatch (where a
            # first-time compile would hang) and, separately below,
            # the sync (where a device hang surfaces) so either warns
            # with the serving tick named.
            tick_name = (f"serving_tick_{self._gen}."
                         f"{self.metrics.ticks}")
            if self.stall is not None:
                self.stall.begin(tick_name)
            try:
                if chaos.fires("serving_tick_stall"):
                    # Cooperative hung-tick injection INSIDE the stall
                    # bracket: the heartbeat goes stale (watchdog
                    # food), the monitor sees this tick pending. Ends
                    # early once abandoned so the superseded thread
                    # can exit.
                    self.metrics.count("faults_injected")
                    t_end = time.time() + chaos.delay_of(
                        "serving_tick_stall", 1.0)
                    while time.time() < t_end and not self.abandoned:
                        time.sleep(0.005)
                handle = self.pool.tick_dispatch()
            finally:
                if self.stall is not None:
                    self.stall.end(tick_name)
            snapshot = dict(self.active)
            self.metrics.count("ticks")
            progressed = True
        # Sync the PREVIOUS tick while this one computes on device —
        # the pipeline overlap that deletes one exposed host sync per
        # token from the critical path.
        if self._pending is not None:
            self._sync_pending(overlapped=handle is not None)
            progressed = True
        if handle is not None:
            # hvd: disable=HVD004(_pending is dispatch-thread-owned; the handoff lock only orders the container handoff, and abandon() drops the ring wholesale)
            self._pending = _PendingTick(handle, snapshot)
            if self.pipeline_depth < 1:
                self._sync_pending(overlapped=False)
        return progressed

    @hot_path
    def _spec_round(self):
        """One speculative draft-verify round over the active lanes: the
        pool retires 1..k+1 tokens per lane; tokens are appended in
        order with per-token retirement checks (an eos or a budget
        boundary mid-round discards the lane's remaining emissions — the
        device already truncated at eos, the budget truncation is the
        host's). Accounting: one tick, one round, one host sync —
        amortized over every token the round retired."""
        tick_name = f"serving_spec_{self._gen}.{self.metrics.ticks}"
        t_round0 = time.time()
        if self.stall is not None:
            self.stall.begin(tick_name)
        try:
            if chaos.fires("serving_tick_stall"):
                # The tick path's cooperative hung-tick injection
                # (watchdog food; ends early once abandoned).
                self.metrics.count("faults_injected")
                t_end = time.time() + chaos.delay_of(
                    "serving_tick_stall", 1.0)
                while time.time() < t_end and not self.abandoned:
                    time.sleep(0.005)
            emitted, counts, proposed = self.pool.spec_round()
        finally:
            if self.stall is not None:
                self.stall.end(tick_name)
        round_dur = time.time() - t_round0
        self.metrics.count("ticks")
        self.metrics.count("spec_rounds")
        self.metrics.count("host_syncs")
        if self.abandoned:
            return   # the successor replays from prompts; drop the round
        accepted = prop = 0
        multi = False
        for slot, req in list(self.active.items()):
            n = int(counts[slot])
            if proposed[slot] > 0:
                prop += int(proposed[slot])
                accepted += max(0, n - 1)
                _spans.record_span(
                    "serving.spec_round", trace_id=req.trace_id,
                    parent_id=req.span_ids.get("decode", ""),
                    t0=t_round0, duration=round_dur,
                    proposed=int(proposed[slot]), accepted=max(0, n - 1))
            multi = multi or n >= 2
            t_tick = time.time()
            for j in range(n):
                if self.active.get(slot) is not req:
                    break   # retired mid-round; discard the tail
                tok = int(emitted[slot, j])
                req.tokens.append(tok)
                self.metrics.count("tokens_out")
                self._maybe_retire(slot, req, tok, t_tick)
        if prop:
            self.metrics.count("spec_proposed", prop)
        if accepted:
            self.metrics.count("spec_accepted", accepted)
        if multi:
            self.metrics.count("spec_multi_token_ticks")

    def _sync_pending(self, overlapped: bool):
        """Read one dispatched tick's tokens; append to the requests
        still occupying their dispatch-time slots and retire the
        finished. ``overlapped`` records whether newer device work was
        already queued behind the read (the metric the tentpole
        moves: exposed host syncs per token)."""
        # hvd: disable=HVD004(dispatch-thread-owned ring slot; a racing abandon() clears it too, and the snapshot re-check below tolerates that)
        pending, self._pending = self._pending, None
        sync_name = f"serving_sync_{self._gen}.{self.metrics.ticks}"
        if self.stall is not None:
            self.stall.begin(sync_name)
        try:
            toks = self.pool.tick_sync(pending.handle)
        finally:
            if self.stall is not None:
                self.stall.end(sync_name)
        self.metrics.count("ticks_overlapped" if overlapped
                           else "host_syncs")
        if self.abandoned:
            # Superseded mid-pipeline: the successor owns these
            # requests now — appending this tick's tokens would
            # corrupt their replay-from-prompt.
            return
        t_tick = time.time()
        for slot, req in pending.snapshot.items():
            if self.active.get(slot) is not req:
                continue   # retired (or slot re-assigned) since dispatch
            tok = int(toks[slot])
            req.tokens.append(tok)
            self.metrics.count("tokens_out")
            self._maybe_retire(slot, req, tok, t_tick)

    # -- admission / chunked prefill ----------------------------------

    def _advance_prefills(self, now: float) -> bool:
        """Stream up to ``prefill_chunk_budget`` prompt tokens: first
        continue the oldest mid-prefill slot, then admit new requests
        from the queue into free slots. A long prompt therefore
        spreads across many steps, each step still running a full
        decode tick for everyone else — the interleaving that keeps
        TPOT flat through a long-prompt admission."""
        progressed = False
        left = (self.prefill_chunk_budget
                if self.prefill_chunk_budget > 0 else None)
        while not self.abandoned:
            job = None
            with self._handoff:
                # Picked under the handoff lock: a watchdog abandon
                # clears these containers, and an unlocked read could
                # otherwise KeyError racing it.
                if not self.abandoned and self._prefill_order:
                    slot = self._prefill_order[0]
                    job = self.prefilling[slot]
            if job is None:
                # PEEK first: admission gates on the POOL's capacity —
                # free lanes for both pools, and block availability
                # (after prefix-cache credit) on the paged pool. A
                # request that does not fit yet stays at the queue
                # head, FIFO intact, until retirements free blocks.
                # Graft inbound KV-block transfers BEFORE the peek: an
                # offer enqueued before its request's submit is then
                # resident when the admission below hashes the prompt.
                self._drain_grafts()
                head = self.queue.peek_ready(now,
                                             on_drop=self._queue_drop)
                if head is None:
                    break
                # A swap-preempted head's shelved KV blocks are grafted
                # back BEFORE can_admit hashes the prompt, so the
                # resume's admission credits them (only the sub-block
                # tail re-prefills).
                self._maybe_restore_swap(head)
                if not self.pool.can_admit(head.full_prompt,
                                           head.remaining_new):
                    # The overload plane's make-room move: evict
                    # strictly lower-priority decode lanes until the
                    # head fits (token-exact — victims resume later,
                    # bitwise). Without it (or with no eligible
                    # victim) the head waits, FIFO intact, as before.
                    if not self._try_preempt_for(head, now):
                        break
                    continue
                req = self.queue.pop_ready(now, on_drop=self._queue_drop)
                if req is None:
                    break
                # Causal spans: the queue wait (and any preemption
                # pause) ends the moment the head is popped for
                # admission; the admit/pin/reserve work is its own
                # phase span.
                _spans.end_span(req.span_ids.pop("queued", ""),
                                status="admitted")
                _spans.end_span(req.span_ids.pop("paused", ""),
                                status="resumed")
                adm_sid = _spans.begin_span(
                    "serving.admission", trace_id=req.trace_id,
                    parent_id=req.parent_span
                    or req.span_ids.get("root", ""))
                # Registration is the handoff-critical line: between
                # pop_ready above and the prefilling registration the
                # request is in neither the queue nor a scheduler dict,
                # so a watchdog abandon landing in that window would
                # strand its future. The lock forces an order: either
                # the registration happens before the snapshot (the
                # successor requeues it) or the abandon is visible here
                # (we hand it straight back to the queue).
                blocked = None
                # The prefill stream: prompt plus any forced
                # continuation prefix (token-exact migration) — the
                # prefix matcher and the chunk schedule both see it.
                full = req.full_prompt
                with self._handoff:
                    if self.abandoned:
                        blocked = req
                    else:
                        # admit() pins matched prefix blocks and
                        # reserves the rest; None only if the popped
                        # request differs from the peeked head (a
                        # cancel raced in between) AND doesn't fit.
                        adm = self.pool.admit(full, req.remaining_new)
                        if adm is None:
                            blocked = req
                        else:
                            slot = adm.slot
                            job = _PrefillJob(
                                req=req, prompt=full,
                                chunks=prefill_schedule(
                                    int(full.shape[0])
                                    - adm.skipped, self._max_chunk),
                                off=adm.skipped)
                            self.prefilling[slot] = job
                            self._prefill_order.append(slot)
                if blocked is not None:
                    _spans.end_span(adm_sid, status="blocked")
                    blocked.span_ids["queued"] = _spans.begin_span(
                        "serving.queued",
                        trace_id=blocked.trace_id,
                        parent_id=blocked.parent_span
                        or blocked.span_ids.get("root", ""),
                        requeued=True)
                    self.queue.requeue([blocked])
                    break
                req.prefix_cached = adm.skipped
                if (self._ov is not None
                        and self._ov.swap is not None
                        and self._ov.swap.discard(req.id)):
                    # A swap-preempted stream just resumed: its shelf
                    # entry is spent. Credit the tokens the shelved
                    # blocks served vs the sub-block tail that must
                    # re-prefill anyway.
                    self.metrics.count("preempt_tokens_swapped_in",
                                       adm.skipped)
                    tail = int(full.shape[0]) - adm.skipped
                    if tail > 0:
                        self.metrics.count(
                            "preempt_tokens_recomputed", tail)
                if adm.queried_blocks:
                    self.metrics.count("prefix_hits",
                                       adm.matched_blocks)
                    self.metrics.count(
                        "prefix_misses",
                        adm.queried_blocks - adm.matched_blocks)
                if adm.skipped:
                    # The TTFT the cache just deleted: these prompt
                    # tokens never touch a prefill chunk.
                    self.metrics.count("prefill_tokens_skipped",
                                       adm.skipped)
                self.metrics.observe_peak(len(self.active)
                                          + len(self.prefilling))
                req.t_prefill = time.time()
                _spans.end_span(adm_sid, prefix_cached=adm.skipped)
                req.span_ids["prefill"] = _spans.begin_span(
                    "serving.prefill", trace_id=req.trace_id,
                    parent_id=req.parent_span
                    or req.span_ids.get("root", ""),
                    prompt_tokens=int(full.shape[0]),
                    prefix_cached=adm.skipped)
                _span("end_span", req.id, "QUEUE")
                _span("begin_span", req.id, "PREFILL",
                      trace_id=req.trace_id)
                # Registered BEFORE any device work so a fault inside
                # it (compile failure, OOM) leaves the request findable
                # by the engine's crash containment — never a future
                # in limbo.
                self.pool.begin_prefill(slot)
                progressed = True
            # Drop dead jobs before paying more device work for them.
            if job.req.cancelled or job.req.expired(now):
                self._retire_prefill(
                    slot, job,
                    "cancelled" if job.req.cancelled else "timeout")
                progressed = True
                continue
            while job.chunks and (left is None
                                  or job.chunks[0] <= left):
                c = job.chunks.pop(0)
                csid = _spans.begin_span(
                    "serving.prefill_chunk",
                    trace_id=job.req.trace_id,
                    parent_id=job.req.span_ids.get("prefill", ""),
                    tokens=c, off=job.off)
                job.logits = self.pool.prefill_chunk(
                    slot, job.prompt[job.off:job.off + c])
                job.off += c
                _spans.end_span(csid)
                self.metrics.count("prefill_chunks")
                self.metrics.count("prefill_tokens", c)
                if left is not None:
                    left -= c
                progressed = True
            if job.chunks:
                break    # budget spent mid-prompt; resume next step
            self._finish_prefill(slot, job)
            progressed = True
            if left is not None and left <= 0:
                break
        return progressed

    # -- preemption (the overload control plane) ----------------------

    def _sweep_dead_prefills(self, now: float):
        """Release reserved-but-unfilled blocks of cancelled/expired
        MID-PREFILL requests immediately. The chunk loop checks the
        head job's liveness, but a budget-starved schedule can leave a
        dead job parked for many steps — and its admission reservation
        (blocks never to be filled) parked with it, blocking admission
        of live requests the whole while."""
        with self._handoff:
            jobs = ([] if self.abandoned else
                    [(s, self.prefilling[s])
                     for s in list(self._prefill_order)])
        for slot, job in jobs:
            if job.req.cancelled or job.req.expired(now):
                self._retire_prefill(
                    slot, job,
                    "cancelled" if job.req.cancelled else "timeout")

    def _drain_tenant_preempts(self, now: float):
        """Brownout level 3: the engine's ladder callback queued tenant
        names whose lowest-priority streams should shed. One lane per
        request, and always leave the tenant at least one live stream —
        brownout degrades, it never blacks out."""
        ov = self._ov
        if ov is None or not ov.tenant_preempts:
            return
        while ov.tenant_preempts:
            try:
                tenant = ov.tenant_preempts.popleft()
            except IndexError:   # pragma: no cover — single drainer
                break
            lanes = [(s, r) for s, r in self.active.items()
                     if r.tenant == tenant]
            if len(lanes) <= 1:
                continue
            lanes.sort(key=lambda sr: (sr[1].priority,
                                       len(sr[1].tokens), sr[0]))
            slot, req = lanes[0]
            self._preempt(slot, req, now, reason="brownout")

    def _resolve_stranded(self, now: float):
        """Grow every ticking lane's block chain to cover the next
        dispatch (watermark admission reserves optimistically, so
        growth happens here, just in time). A lane the pool cannot grow
        is STRANDED — its next device write would land in the null
        block — so victims are preempted until growth succeeds.
        Guaranteed progress: the policy ranks over all active lanes and
        a stranded lane is itself active, so in the worst case the
        stranded lane is evicted and leaves the ticking set."""
        ov = self._ov
        grow = getattr(self.pool, "grow_for_tick", None)
        if grow is None:
            return
        while not self.abandoned:
            stranded = grow()
            if not stranded:
                return
            if ov is None or not ov.preempt or not self.active:
                # No preemption plane (the watermark is only ever set by
                # the engine's preemption wiring, so this is a defensive
                # arm) — evict the stranded lanes themselves.
                for slot in stranded:
                    req = self.active.get(slot)
                    if req is not None:
                        self._preempt(slot, req, now,
                                      reason="stranded")
                return
            victims = ov.policy.order_victims(None, self.active,
                                              self.pool)
            if not victims:   # pragma: no cover — stranded ⊆ active
                return
            slot, req = victims[0]
            self._preempt(slot, req, now, reason="stranded")

    def _maybe_restore_swap(self, head: Request):
        """If the queue head is a swap-preempted resume, re-graft its
        shelved KV blocks so the admission peek's prefix match credits
        them. A graft that fails verification drops the shelf entry and
        the resume degrades to recompute — the same stream either way
        (the fallback ladder)."""
        ov = self._ov
        if ov is None or ov.swap is None:
            return
        tr = ov.swap.peek(head.id)
        if tr is None:
            return
        graft = getattr(self.pool, "graft", None)
        blocks = getattr(self.pool, "blocks", None)
        if graft is None or blocks is None:
            ov.swap.discard(head.id)
            return
        if all(blocks.resident(d) for d in tr.chain_digests):
            return   # still resident from before the preempt — free
        from horovod_tpu_torch.serving.transfer import TransferError
        try:
            graft(tr)
        except TransferError as e:
            ov.swap.discard(head.id)
            self.metrics.count("preempt_swap_restore_failures")
            _events.emit("serving.swap_restore_failed",
                         request_id=head.id, trace_id=head.trace_id,
                         error=f"{type(e).__name__}: {e}")

    def _try_preempt_for(self, head: Request, now: float) -> bool:
        """Make room for a blocked higher-priority head by preempting
        strictly lower-priority active lanes, cheapest-capacity-first
        (`PreemptionPolicy`). True once `can_admit` passes; False when
        preemption is off or no eligible victim remains (the head then
        waits at the queue head, as without preemption)."""
        ov = self._ov
        if ov is None or not ov.preempt or not self.active:
            return False
        while not self.abandoned:
            victims = ov.policy.order_victims(head, self.active,
                                              self.pool)
            if not victims:
                return False
            slot, req = victims[0]
            self._preempt(slot, req, now, reason="priority")
            if self.pool.can_admit(head.full_prompt,
                                   head.remaining_new):
                return True
        return False

    def _preempt(self, slot: int, req: Request, now: float,
                 reason: str):
        """Evict one ACTIVE decode lane token-exactly and requeue its
        request to resume later, identical to the uninterrupted stream.

        Two modes, decided here per victim:

        * **swap** — the filled KV blocks of the finalized stream are
          exported (`transfer.export_blocks`: digest-chained host copy)
          into the bounded `SwapStore`; on resume they re-graft and the
          prefix match skips them, so only the sub-block tail
          re-prefills. Needs the paged pool's prefix cache and shelf
          budget; the stream is `publish`ed first so its full blocks
          are registered (decode-extended blocks aren't, until now).
        * **recompute** — no blocks survive; the resume teacher-forces
          the whole emitted prefix through prefill (the forced-prefix
          path) and re-samples with `rng_skip`, token-exact.

        Export safety: the victim has n >= 1 emitted tokens; the
        in-flight pipelined tick (if any) writes KV position P+n-1
        while sampling token n+1, so the export stream stops at
        ``tokens[:-1]`` (positions <= P+n-2) — every full block it
        covers is final, even at the ``(P+n-1) % block_size == 0``
        boundary where the write opens a NEW block. The export's read
        is stream-ordered after that tick anyway. The lagged tick's
        token for this slot is discarded by `_sync_pending`'s identity
        check once the lane is freed."""
        ov = self._ov
        mode = "recompute"
        blocks = getattr(self.pool, "blocks", None)
        if (ov is not None and ov.swap is not None
                and blocks is not None
                and getattr(blocks, "prefix_cache", False)):
            stream = np.concatenate([
                # hvd: disable=HVD001(prompt is host-side admission-queue ids, never a device array — no sync)
                np.asarray(req.prompt, dtype=np.int64),
                # hvd: disable=HVD001(tokens is the host-side emitted-int list — no sync)
                np.asarray(req.tokens[:-1], dtype=np.int64)])
            if len(stream) // self.pool.block_size >= 1:
                from horovod_tpu_torch.serving.transfer import (
                    TransferError, export_blocks)
                blocks.publish(slot, stream)
                try:
                    tr = export_blocks(self.pool, stream,
                                       trace_id=req.trace_id)
                except TransferError:
                    tr = None
                if tr is not None and ov.swap.put(req.id, tr):
                    mode = "swap"
                    self.metrics.count("preempt_swap_bytes",
                                       tr.nbytes)
        self.pool.free(slot)
        # hvd: disable=HVD004(active is dispatch-thread-owned; the handoff lock only orders the container handoff, and abandon() snapshots wholesale)
        self.active.pop(slot, None)
        _span("end_span", req.id, "DECODE")
        # Back in the queue: the readmission closes this QUEUE span, so
        # the request's timeline process stays balanced.
        _span("begin_span", req.id, "QUEUE", trace_id=req.trace_id)
        _spans.end_span(req.span_ids.pop("decode", ""),
                        status="preempted", mode=mode)
        # The pause span stays OPEN across the requeue — the resume's
        # admission pop closes it, so the anatomy charges the whole
        # evicted-to-readmitted gap to ``preempt_paused``. The
        # span_ids dict is SHARED with the `dataclasses.replace` copy
        # below, so the successor sees (and closes) this span.
        req.span_ids["paused"] = _spans.begin_span(
            "serving.preempt_paused", trace_id=req.trace_id,
            parent_id=req.parent_span
            or req.span_ids.get("root", ""),
            mode=mode, reason=reason,
            tokens_emitted=len(req.tokens))
        # The resume: everything emitted becomes forced prefix (teacher
        # forced in prefill, rng_skip re-aligns the sampled stream) and
        # stays in `tokens` so a cancel/expiry mid-queue still returns
        # the partial text. `t_submit` is preserved — the admission
        # queue's aging sees the victim's true age, so preemption never
        # starves its own victims. `dataclasses.replace` keeps the
        # same cancel Event and future (cancel races stay safe).
        resumed = dataclasses.replace(
            req,
            forced=tuple(int(t) for t in req.tokens),
            tokens=[int(t) for t in req.tokens],
            t_prefill=0.0, t_first=0.0, prefix_cached=0)
        self.queue.requeue([resumed])
        self.metrics.count("preemptions_swap" if mode == "swap"
                           else "preemptions_recompute")
        if mode == "recompute":
            # Every token of prompt+emitted re-prefills on resume
            # (minus whatever the prefix cache happens to still hold —
            # credited at the resume's admission instead for swaps).
            self.metrics.count("preempt_tokens_recomputed",
                               len(resumed.full_prompt))
        if req.tenant:
            from horovod_tpu_torch.obs import catalog as _obs_catalog
            _obs_catalog.tenant_metrics()["requests"].inc(
                tenant=req.tenant, outcome="preempted")
        _events.emit("serving.preempt", request_id=req.id,
                     trace_id=req.trace_id, mode=mode, reason=reason,
                     tenant=req.tenant, priority=req.priority,
                     tokens_emitted=len(req.tokens))

    def _drain_grafts(self):
        """Ingest every queued KV-block transfer into the pool's prefix
        cache (serving/transfer.py). A transfer that fails verification
        is dropped LOUDLY — counter + event — and the request it was
        meant to accelerate re-prefills its prompt through the normal
        path, the same stream (the fallback ladder)."""
        q = self._grafts
        if not q or getattr(self.pool, "graft", None) is None:
            return
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        from horovod_tpu_torch.serving.transfer import TransferError
        cat = _obs_catalog.disagg_metrics()
        while q:
            try:
                tr = q.popleft()
            except IndexError:   # pragma: no cover — single drainer
                break
            try:
                adopted = self.pool.graft(tr)
            except TransferError as e:
                reason = type(e).__name__
                cat["transfers"].inc(outcome="rejected")
                cat["verify_failures"].inc()
                cat["fallbacks"].inc(reason="verify_failed")
                _events.emit("disagg.transfer_rejected",
                             trace_id=tr.trace_id, error=str(e),
                             error_kind=reason)
                continue
            cat["transfers"].inc(outcome="ingested")
            cat["blocks"].inc(adopted)
            cat["bytes"].inc(tr.nbytes)
            _events.emit("disagg.transfer_ingested",
                         trace_id=tr.trace_id, blocks=adopted,
                         bytes=tr.nbytes)

    def _finish_prefill(self, slot: int, job: _PrefillJob):
        """Chunk schedule drained: sample the first token (the one
        per-request host sync), move the slot prefilling -> active
        (atomically vs a watchdog abandon), handle instant retirement
        (first token is eos, budget of 1, expired mid-prefill)."""
        req = job.req
        # A forced-prefix continuation resumes the request's sample
        # stream at ordinal len(forced): the tokens teacher-forced
        # into the cache each consumed one rng split in the original
        # stream, so the first token sampled HERE is the original's
        # token len(forced)+1, bitwise (rng_skip; docs/serving.md
        # "Fleet failover").
        first = self.pool.finish_prefill(
            slot, job.logits, req.sampling.temperature,
            req.sampling.top_p, req.sampling.seed,
            rng_skip=len(req.forced))
        self.metrics.count("host_syncs")
        with self._handoff:
            if self.abandoned:
                return   # successor replays it from the prompt
            self.prefilling.pop(slot, None)
            self._prefill_order.remove(slot)
            self.active[slot] = req
        req.t_first = time.time()
        req.tokens.append(first)
        self.metrics.count("tokens_out")
        # Sampled by the prefill forward, not a decode tick — the
        # tokens_per_tick metric excludes it.
        self.metrics.count("prefill_first_tokens")
        _span("end_span", req.id, "PREFILL")
        _span("begin_span", req.id, "DECODE", trace_id=req.trace_id)
        _spans.end_span(req.span_ids.pop("prefill", ""))
        req.span_ids["decode"] = _spans.begin_span(
            "serving.decode", trace_id=req.trace_id,
            parent_id=req.parent_span
            or req.span_ids.get("root", ""))
        self._maybe_retire(slot, req, first, req.t_first)

    def _queue_drop(self, req: Request, kind: str):
        """A queued request died before reaching a slot (cancelled or
        deadline-expired); its future already carries the exception."""
        if self._ov is not None and self._ov.swap is not None:
            self._ov.swap.discard(req.id)
        self.metrics.count("cancelled" if kind == "cancelled"
                           else "timed_out")
        _span("end_span", req.id, "QUEUE")
        _spans.end_span(req.span_ids.pop("queued", ""),
                        status=kind)
        _spans.end_span(req.span_ids.pop("paused", ""),
                        status=kind)
        _spans.end_span(req.span_ids.pop("root", ""), status=kind)
        _mark(req.id, kind.upper())
        _events.emit("serving.queue_drop", request_id=req.id,
                     trace_id=req.trace_id, reason=kind)

    def _maybe_retire(self, slot: int, req: Request, tok: int,
                      now: float):
        if req.cancelled:
            self._retire(slot, req, "cancelled", now)
        elif req.expired(now):
            self._retire(slot, req, "timeout", now)
        elif self.eos_id is not None and tok == self.eos_id:
            self._retire(slot, req, "eos", now)
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, req, "length", now)

    @staticmethod
    def _resolve(future, *, result=None, exc=None):
        """Resolve a future, tolerating the recovery race: an
        abandoned predecessor thread limping to a retire AFTER the
        watchdog already failed/requeued the request must not crash on
        the already-resolved future."""
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except InvalidStateError:
            pass

    def _retire(self, slot: int, req: Request, reason: str,
                now: float):
        """Free the slot and resolve the request's future."""
        if self.abandoned:
            # hvd: disable=HVD004(post-abandon bookkeeping on the superseded thread; the successor owns the live dict, and pop(slot, None) on the cleared one is a no-op)
            self.active.pop(slot, None)
            return
        self.pool.free(slot)
        # hvd: disable=HVD004(dispatch-thread-owned retire; abandon() clearing concurrently makes this a benign no-op, tolerated by _resolve)
        self.active.pop(slot, None)
        _span("end_span", req.id, "DECODE")
        _spans.end_span(req.span_ids.pop("decode", ""),
                        status=reason)
        self._finalize(req, reason, now)

    def _retire_prefill(self, slot: int, job: _PrefillJob,
                        reason: str):
        """A mid-prefill request died (cancelled / expired / aborted):
        free the slot before its remaining chunks waste device time.
        The pop happens under the handoff lock and only while NOT
        abandoned — popping first would open a window where a
        concurrent watchdog abandon() snapshots `prefilling` without
        this request, stranding its future in neither the successor's
        requeue list nor a _finalize here."""
        with self._handoff:
            if self.abandoned:
                return   # successor owns (and will resolve) the req
            self.prefilling.pop(slot, None)
            self._prefill_order.remove(slot)
        self.pool.free(slot)
        _span("end_span", job.req.id, "PREFILL")
        _spans.end_span(job.req.span_ids.pop("prefill", ""),
                        status=reason)
        self._finalize(job.req, reason, time.time())

    def _finalize(self, req: Request, reason: str, now: float):
        if self._ov is not None and self._ov.swap is not None:
            # A preempted-then-resumed stream that finishes (or dies)
            # with its shelf entry unclaimed — e.g. the resume's blocks
            # stayed resident so the entry was never spent — releases
            # the swap budget here.
            self._ov.swap.discard(req.id)
        _mark(req.id, reason.upper())
        _events.emit("serving.retire", request_id=req.id,
                     trace_id=req.trace_id, reason=reason,
                     tokens=len(req.tokens))
        # Close the causal root span — present only on engine-minted
        # client entries (router/disagg legs close their own roots) —
        # and, on a clean completion, decompose the finished span tree
        # into the per-phase anatomy histograms.
        root_sid = req.span_ids.pop("root", "")
        _spans.end_span(root_sid, status=reason,
                        tokens=len(req.tokens))
        if root_sid and reason in ("eos", "length"):
            _spans.observe_request(req.trace_id)
        if reason in ("eos", "length"):
            n = len(req.tokens)
            self.metrics.count("completed")
            self.metrics.observe_request(
                t_submit=req.t_submit, t_prefill=req.t_prefill,
                t_first=req.t_first, t_done=now, n_tokens=n,
                trace_id=req.trace_id, tenant=req.tenant)
            self._resolve(req.future, result=CompletedRequest(
                request_id=req.id,
                # hvd: disable=HVD001(req.prompt is the submitted numpy array, req.tokens a host list — retire-time packaging, no device read)
                prompt=np.asarray(req.prompt),
                # hvd: disable=HVD001(host list of already-synced ints)
                tokens=np.asarray(req.tokens, np.int64),
                finish_reason=reason,
                ttft_s=req.t_first - req.t_submit,
                tpot_s=((now - req.t_first) / (n - 1)
                        if n > 1 else None),
                e2e_s=now - req.t_submit,
                trace_id=req.trace_id,
                prefix_tokens_cached=req.prefix_cached))
        elif reason == "cancelled":
            self.metrics.count("cancelled")
            self._resolve(req.future, exc=CancelledError())
        elif reason == "timeout":
            self.metrics.count("timed_out")
            self._resolve(req.future, exc=DeadlineExceededError(
                f"request {req.id}: deadline passed after "
                f"{len(req.tokens)} tokens",
                partial_tokens=list(req.tokens)))
        else:   # aborted — non-draining shutdown
            self.metrics.count("aborted")
            self._resolve(req.future, exc=EngineClosedError(
                f"engine shut down while request {req.id} was "
                f"in flight ({len(req.tokens)} tokens in)"))

    def abort_active(self):
        """Non-draining shutdown: fail every in-flight request now —
        decoding and mid-prefill alike — and drop the pending tick."""
        now = time.time()
        # hvd: disable=HVD004(shutdown path on the dispatch thread — the watchdog is already joined by the time the engine aborts)
        self._pending = None
        for slot, req in list(self.active.items()):
            self._retire(slot, req, "aborted", now)
        for slot, job in list(self.prefilling.items()):
            self._retire_prefill(slot, job, "aborted")


def prefill_schedule(length: int, max_chunk: Optional[int]) -> List[int]:
    """The chunk schedule for one prompt — `prefill_chunks` with the
    scheduler's budget cap applied (kept as a named seam so the
    restart replay path and tests share the exact decomposition the
    dispatch loop uses: same prompt + same budget => same chunks =>
    same cache states => token-exact replay)."""
    from horovod_tpu_torch.models.transformer import prefill_chunks
    return prefill_chunks(length, max_chunk)
