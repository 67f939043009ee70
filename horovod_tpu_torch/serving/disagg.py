"""Disaggregated prefill/decode serving: the router as placement
brain (docs/serving.md "Disaggregated serving").

Every serving bench to date shows the same pathology: TPOT holds flat
while TTFT blows out under admission pressure, because prefill (one
compute-bound burst per request) and decode (a long bandwidth-bound
loop) share one program on one device group — a long prompt's chunks
and everyone else's ticks fight for the same dispatch thread.
`DisaggRouter` splits them MPMD-style (PAPERS.md, 2412.14374): a
PREFILL pool of engines runs prompts, a DECODE pool runs token loops,
each sized independently (``HVD_DISAGG_PREFILL`` /
``HVD_DISAGG_DECODE``), and the handoff between them moves the KV
blocks themselves (serving/transfer.py), not the tokens.

One request's life:

1. ``submit`` places it on the least-loaded healthy PREFILL replica
   with ``max_new_tokens=1`` — the prompt pass plus the first sampled
   token (the client-visible TTFT event).
2. At prefill-complete the request's full prompt blocks are EXPORTED
   from the prefill pool (chain + byte digests; host-bounce or
   device mode) and the request is re-placed on a decode replica
   with the first token as a one-token forced prefix. The transfer
   is offered to the decode engine BEFORE the submit (`_pre_place`),
   so its scheduler grafts the blocks into the destination prefix
   cache before the request's admission peek: the prompt MATCHES the
   grafted chain, prefill on the decode side covers only the
   sub-block tail, and the stream resumes mid-flight — bitwise the
   single-engine stream, because the graft composes two properties
   the suite already pins (prefix-cache hits are bitwise; forced-
   prefix continuation is bitwise).
3. Decode runs to completion on the base router's machinery —
   migration, retry budget, deadline propagation all unchanged. A
   decode replica death re-offers the transfer to the survivor and
   teacher-forces the tokens so far (forced-prefix migration), exactly
   as before.

The fallback ladder, every rung loud (``hvd_disagg_*`` counters +
events) and every rung bitwise-exact: no prefill capacity -> the
request takes the ordinary shared-program path; prefill-leg death ->
re-placed with no forced prefix (full recompute); export failure ->
forced-prefix-only handoff (decode re-prefills the prompt); digest
verification failure on ingest (the ``disagg.block_corrupt`` chaos
drill) -> the transfer is dropped by the decode scheduler and the
already-submitted request simply re-prefills. Correctness never
depends on a transfer landing — transfers only delete prefill work.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from horovod_tpu_torch.obs import catalog as _obs_catalog
from horovod_tpu_torch.obs import events as _events
from horovod_tpu_torch.obs import reqlog as _reqlog
from horovod_tpu_torch.obs import spans as _spans
from horovod_tpu_torch.obs import tracing as _tracing
from horovod_tpu_torch.resilience import detector as _detector
from horovod_tpu_torch.serving.admission import (
    DeadlineExceededError, EngineClosedError, QueueFullError,
    ServingError,
)
from horovod_tpu_torch.serving.router import (
    REPLICA_DEAD, REPLICA_UP, RouterHandle, ServingRouter, _Replica,
    _RouterRequest, _release_device_memory,
)
from horovod_tpu_torch.serving.transfer import TransferError, export_blocks

__all__ = ["DisaggRouter"]


class DisaggRouter(ServingRouter):
    """`ServingRouter` with a dedicated prefill tier (module
    docstring). Constructed directly, or by ``ServingRouter(
    disagg=...)`` / ``HVD_DISAGG=1`` through the base class's
    ``__new__``.

    ``disagg`` configures the tier: True/None reads the env knobs, an
    int is the prefill-pool width, a dict may set ``prefill``,
    ``decode``, ``transfer`` ("host" | "device") and
    ``prefill_factory`` (defaults to the decode factory — prefill
    engines are ordinarily the same build; a dedicated factory lets
    them differ, e.g. more slots, no speculative draft). The decode
    tier is the base router fleet: ``num_replicas`` (or ``decode``,
    or ``HVD_DISAGG_DECODE``) replicas with migration, hedging-
    suppression, retry budget and cold replacement unchanged.
    """

    _HANDOFF_PATIENCE_S = 30.0

    def __init__(self, factory, num_replicas=None, *, disagg=None,
                 **kwargs):
        from horovod_tpu_torch.runtime.config import config as _cfg
        n_prefill = _cfg.disagg_prefill
        n_decode = _cfg.disagg_decode
        transfer = _cfg.disagg_transfer
        prefill_factory = None
        if isinstance(disagg, bool) or disagg is None:
            pass
        elif isinstance(disagg, int):
            n_prefill = disagg
        elif isinstance(disagg, dict):
            unknown = set(disagg) - {"prefill", "decode", "transfer",
                                     "prefill_factory"}
            if unknown:
                raise ValueError(
                    f"unknown disagg keys {sorted(unknown)}; valid: "
                    f"prefill, decode, transfer, prefill_factory")
            n_prefill = int(disagg.get("prefill", n_prefill))
            if "decode" in disagg:
                n_decode = int(disagg["decode"])
                num_replicas = None   # the dict wins over the arg
            transfer = disagg.get("transfer", transfer)
            prefill_factory = disagg.get("prefill_factory")
        else:
            raise ValueError(
                f"disagg must be a bool, an int (prefill width) or a "
                f"dict, got {type(disagg).__name__}")
        if n_prefill < 1:
            raise ValueError(
                f"disagg prefill width must be >= 1, got {n_prefill}")
        if transfer not in ("host", "device"):
            raise ValueError(
                f"disagg transfer mode must be host|device "
                f"(HVD_DISAGG_TRANSFER), got {transfer!r}")
        # State the overridden _sweep/_on_replica_transition read must
        # exist BEFORE super().__init__ starts the monitor thread.
        self._prefill: Dict[int, _Replica] = {}
        self._prefill_deaths: List[int] = []
        self._pending_handoffs: List[Tuple] = []
        self._transfer_mode = transfer
        self._n_prefill = int(n_prefill)
        self._prefill_factory = prefill_factory or factory
        self._dm = _obs_catalog.disagg_metrics()
        super().__init__(factory,
                         num_replicas if num_replicas is not None
                         else n_decode, **kwargs)
        try:
            for _ in range(self._n_prefill):
                eng = self._prefill_factory()
                rep = _Replica(next(self._rep_ids), eng)
                with self._lock:
                    self._prefill[rep.id] = rep
                self._register_prefill(rep)
        except BaseException:
            # A prefill factory failing partway must not leak the
            # decode fleet (live dispatch threads) nor the prefill
            # legs already built.
            self.shutdown(drain=False)
            raise

    # -- prefill-tier plumbing ----------------------------------------

    def _prefill_key(self, rep: _Replica) -> str:
        # Namespaced UNDER the router's detector prefix (torn down by
        # the same unregister_prefix) but keyed apart from the decode
        # replicas: the base transition parser reads the LAST path
        # segment as a replica id, and prefill ids draw on the same
        # counter precisely so neither tier's events can alias the
        # other's.
        return f"{self._det_ns}/prefill/{rep.id}"

    def _register_prefill(self, rep: _Replica):
        def poll(rep=rep):
            try:
                return bool(rep.engine._health().get("healthy"))
            except (ServingError, RuntimeError, AttributeError):
                return False
        self._det.register(
            self._prefill_key(rep), poll_fn=poll,
            label=f"prefill{rep.id}",
            poll_s=self.health_poll_s,
            suspect_after=0.0,
            dead_after=max(3 * self.health_poll_s, 0.05),
            on_transition=self._on_replica_transition)

    def _on_replica_transition(self, key: str, old: str, new: str,
                               view):
        if "/prefill/" not in key:
            return super()._on_replica_transition(key, old, new, view)
        del old, view
        try:
            pid = int(key.rsplit("/", 1)[1])
        except ValueError:
            return
        with self._lock:
            rep = self._prefill.get(pid)
            if rep is None:
                return
            rep.suspect = new == _detector.SUSPECT
            if new == _detector.DEAD and rep.state == REPLICA_UP:
                rep.state = REPLICA_DEAD
                self._prefill_deaths.append(pid)
        if new != _detector.ALIVE:
            self._wake.set()

    def _pick_prefill(self) -> Optional[_Replica]:
        """Least-loaded healthy UP prefill replica, or None (the
        no-prefill-capacity rung of the fallback ladder)."""
        with self._lock:
            reps = [r for r in self._prefill.values()
                    if r.state == REPLICA_UP and not r.suspect]
        scored = []
        for r in reps:
            try:
                if not r.engine._health().get("healthy"):
                    continue
            except (ServingError, RuntimeError, AttributeError):
                continue
            scored.append((self._load_of(r), r.id, r))
        if not scored:
            return None
        scored.sort(key=lambda t: (t[0], t[1]))
        return scored[0][2]

    def kill_prefill(self, prefill_id: int):
        """Test/ops hook: abrupt prefill-replica death — its in-
        flight prompt passes fail, their requests fall back to full
        recompute on the decode pool, and the monitor cold-replaces
        the leg (the same budget as decode replacements)."""
        with self._lock:
            rep = self._prefill.get(prefill_id)
            if rep is None:
                raise KeyError(f"no prefill replica {prefill_id}")
            if rep.state == REPLICA_UP:
                rep.state = REPLICA_DEAD
                self._prefill_deaths.append(rep.id)
        try:
            rep.engine.shutdown(drain=False, timeout=60)
        except (TimeoutError, ServingError, RuntimeError) as e:
            sys.stderr.write(
                f"disagg router: kill of prefill {rep.id} did not "
                f"join cleanly ({e!r})\n")
        self._wake.set()

    def prefill_replicas(self) -> Dict[int, str]:
        with self._lock:
            return {rid: rep.state
                    for rid, rep in self._prefill.items()}

    # -- submit side ---------------------------------------------------

    def _validate_decode(self, prompt, max_new_tokens: int):
        """The decode-leg length check, SYNCHRONOUSLY: the prefill
        submit (max_new=1) cannot see that prompt + max_new - 1
        exceeds max_len, and the base contract surfaces validation
        to the caller, not to a future minutes later."""
        with self._lock:
            reps = list(self._replicas.values())
        model = next((getattr(r.engine, "model", None) for r in reps),
                     None)
        if model is None:
            return
        P = int(np.asarray(prompt).shape[0])
        unbounded = (model.pos_emb == "rope"
                     and model.window is not None)
        if not unbounded and P + max_new_tokens - 1 > model.max_len:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) "
                f"- 1 exceeds max_len={model.max_len}")

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0,
               top_p: Optional[float] = None, seed: int = 0,
               timeout_s: Optional[float] = None,
               priority: int = 0, tenant: str = "") -> RouterHandle:
        with self._lock:
            if self._closing:
                raise EngineClosedError(
                    "router is shut down; submit rejected")
        if max_new_tokens >= 1:
            self._validate_decode(prompt, max_new_tokens)
        if max_new_tokens < 2:
            # A 1-token request IS its prefill — nothing to hand off.
            return super().submit(
                prompt, max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, timeout_s=timeout_s,
                priority=priority, tenant=tenant)
        rep = self._pick_prefill()
        if rep is None:
            self._dm["fallbacks"].inc(reason="no_prefill_capacity")
            self._dcount("disagg_fallbacks")
            return super().submit(
                prompt, max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, timeout_s=timeout_s,
                priority=priority, tenant=tenant)
        now = time.time()
        rr = _RouterRequest(
            next(self._req_ids), prompt, max_new_tokens,
            temperature=temperature, top_p=top_p, seed=seed,
            deadline=None if timeout_s is None else now + timeout_s,
            trace_id=_tracing.new_trace_id(), t_submit=now,
            priority=priority, tenant=tenant)
        rr._disagg = True
        rr._transfer = None
        rr._handoff_span = ""
        # The disagg client entry mints its own causal root — the
        # prefill leg, the handoff and every decode attempt hang
        # under it. The reqlog arrival is recorded only once the
        # prefill leg actually placed (the fallback paths delegate to
        # the base submit, which records under ITS fresh trace).
        rr.root_span = _spans.begin_span(
            "router.request", trace_id=rr.trace_id,
            max_new_tokens=max_new_tokens, disagg=True,
            tenant=rr.tenant, priority=rr.priority)
        with self._lock:
            self._requests[rr.id] = rr
        t_eng = time.time()
        try:
            handle = rep.engine.submit(
                rr.prompt, 1, temperature=temperature, top_p=top_p,
                seed=seed, timeout_s=timeout_s,
                trace_id=rr.trace_id, parent_span=rr.root_span,
                priority=priority, tenant=tenant)
        except (QueueFullError, EngineClosedError):
            # The prefill tier shed — degrade to the shared-program
            # path rather than failing admission the decode tier
            # could still absorb.
            with self._lock:
                self._requests.pop(rr.id, None)
            _spans.end_span(rr.root_span, status="fallback")
            self._dm["fallbacks"].inc(reason="no_prefill_capacity")
            self._dcount("disagg_fallbacks")
            return super().submit(
                prompt, max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, timeout_s=timeout_s,
                priority=priority, tenant=tenant)
        except ValueError:
            with self._lock:
                self._requests.pop(rr.id, None)
            _spans.end_span(rr.root_span, status="invalid")
            raise
        with self._lock:
            rep.live += 1
        _reqlog.record(prompt, max_new_tokens, tenant=rr.tenant,
                       priority=rr.priority, trace_id=rr.trace_id)
        handle.future.add_done_callback(
            lambda fut, rr=rr, rep=rep, t0=t_eng:
            self._prefill_done(rr, rep, t0, fut))
        return RouterHandle(self, rr)

    # -- the handoff (prefill engine callback threads) ------------------

    def _prefill_done(self, rr: _RouterRequest, rep: _Replica,
                      t_eng: float, fut: Future):
        """The prefill leg resolved: on success, export the KV blocks
        and re-place on a decode replica with the first token forced;
        on failure, walk the fallback ladder. Runs on the prefill
        engine's dispatch thread (the lane is already retired, its
        prompt blocks LRU-resident — exactly what export reads)."""
        with self._lock:
            rep.live -= 1
            done = rr.done
            cancelled = rr.cancel_requested
        if done:
            return
        now = time.time()
        if cancelled:
            self._fail(rr, "cancelled", CancelledError())
            return
        exc = fut.exception()
        if exc is not None:
            if isinstance(exc, DeadlineExceededError):
                self._fail(rr, "timed_out", exc)
                return
            if isinstance(exc, CancelledError):
                self._fail(rr, "cancelled", exc)
                return
            # Prefill-leg death/containment: full recompute on the
            # decode pool — no forced prefix, no transfer, bitwise
            # the same stream from the prompt.
            self._dm["fallbacks"].inc(reason="prefill_failed")
            self._dcount("disagg_fallbacks")
            _events.emit("disagg.prefill_failed", request_id=rr.id,
                         trace_id=rr.trace_id, error=repr(exc))
            self._handoff_place(rr, forced=(), t0=now)
            return
        res = fut.result()
        first = int(res.tokens[-1])
        with self._lock:
            # The client-visible first token: the prefill engine's own
            # TTFT offset onto the router clock (the monitor never saw
            # this stream — it lives one callback long).
            rr.t_first_seen = t_eng + res.ttft_s
            rr.last_tokens = [first]
        eos = getattr(rep.engine, "eos_id", None)
        if eos is not None and first == eos:
            self._finish_prefill_terminal(rr, res, now)
            return
        # The handoff span brackets prefill-done to decode-ingest —
        # export is its child here, verify/ingest its children on the
        # decode replica (the BlockTransfer carries its id), so both
        # halves of the handoff sit under ONE node of the trace tree.
        rr._handoff_span = _spans.begin_span(
            "disagg.handoff", trace_id=rr.trace_id,
            parent_id=rr.root_span, prefill_replica=rep.id)
        transfer = None
        try:
            transfer = export_blocks(
                rep.engine.pool, rr.prompt, (first,),
                mode=self._transfer_mode, trace_id=rr.trace_id,
                parent_span=rr._handoff_span)
        except TransferError as e:
            self._dm["transfers"].inc(outcome="export_failed")
            self._dm["fallbacks"].inc(reason="export_failed")
            _events.emit("disagg.export_failed", request_id=rr.id,
                         trace_id=rr.trace_id, error=str(e))
        except (RuntimeError, AttributeError) as e:
            # A torn-down pool mid-shutdown must degrade, not strand
            # the stream.
            self._dm["transfers"].inc(outcome="export_failed")
            self._dm["fallbacks"].inc(reason="export_failed")
            _events.emit("disagg.export_failed", request_id=rr.id,
                         trace_id=rr.trace_id, error=repr(e))
        if transfer is not None:
            self._dm["transfers"].inc(outcome="exported")
        else:
            # Nothing to ship (export failed / nothing resident):
            # the ingest side never sees this handoff, so close its
            # span here — decode recomputes from the forced token.
            _spans.end_span(rr._handoff_span, status="no_transfer")
            rr._handoff_span = ""
        rr._transfer = transfer
        self._handoff_place(rr, forced=(first,), t0=now)

    def _handoff_place(self, rr: _RouterRequest, *, forced: tuple,
                       t0: float):
        """One free decode placement; a shed queues the handoff for
        the monitor's patience-bounded retry (mirroring `_migrate`'s
        shape — a momentarily full decode tier must not fail a stream
        whose prefill already succeeded)."""
        placed = self._place(rr, forced=tuple(forced), exclude=set(),
                             hedge=False, first_free=True,
                             max_tries=1)
        if placed is None:
            if forced:
                self._dm["handoffs"].inc()
                self._dm["handoff"].observe(time.time() - t0)
                self._dcount("disagg_handoffs")
                _events.emit("disagg.handoff", request_id=rr.id,
                             trace_id=rr.trace_id,
                             transferred=rr._transfer is not None)
            return
        if isinstance(placed, (ValueError, DeadlineExceededError)):
            self._fail(rr, "timed_out"
                       if isinstance(placed, DeadlineExceededError)
                       else "failed", placed)
            return
        with self._lock:
            if not rr.done:
                self._pending_handoffs.append((rr, tuple(forced), t0))
        self._wake.set()

    def _finish_prefill_terminal(self, rr: _RouterRequest, res,
                                 now: float):
        """The first sampled token was eos: the prefill leg's result
        IS the complete stream — resolve it on the router clock
        without ever touching the decode tier."""
        with self._lock:
            if rr.done:
                return
            rr.done = True
            first = (rr.t_first_seen if rr.t_first_seen is not None
                     else now)
            ttft = first - rr.t_submit
            self._ttft_samples.append(ttft)
            del self._ttft_samples[:-512]
            self._requests.pop(rr.id, None)
        out = dataclasses.replace(res, ttft_s=ttft,
                                  e2e_s=now - rr.t_submit)
        _spans.end_span(rr.root_span, status="completed",
                        tokens=len(res.tokens))
        if rr.root_span:
            _spans.observe_request(rr.trace_id)
        self._count("requests", outcome="completed")
        self._m["ttft"].observe(ttft,
                                exemplar={"trace_id": rr.trace_id})
        self._resolve_future(rr.future, result=out)

    def _fail(self, rr: _RouterRequest, outcome: str, exc):
        with self._lock:
            if rr.done:
                return
            rr.done = True
            self._requests.pop(rr.id, None)
        _spans.end_span(getattr(rr, "_handoff_span", ""),
                        status=outcome)
        _spans.end_span(rr.gap_span, status=outcome)
        _spans.end_span(rr.root_span, status=outcome)
        self._count("requests", outcome=outcome)
        self._resolve_future(rr.future, exc=exc)

    def _dcount(self, name: str, n: int = 1):
        # Router-local (snapshot) counter WITHOUT a shared-family
        # mirror — the hvd_disagg_* families are bumped explicitly
        # where the facts are known; base `_count` would KeyError on
        # names outside the hvd_router_* catalog.
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    # -- placement hook: the transfer rides every decode submit --------

    def _pre_place(self, rr: _RouterRequest, rep: _Replica):
        tr = getattr(rr, "_transfer", None)
        if tr is None:
            return
        try:
            # Idempotent ingest: a migration re-placement re-offers
            # the same transfer to the survivor (fresh pool, fresh
            # graft; on the original replica, already-resident digests
            # are skipped).
            rep.engine.offer_transfer(tr)
        except (ServingError, RuntimeError, AttributeError):
            pass   # the submit itself still recomputes correctly
        # First offer delivered: the handoff span closes (SpanRecorder
        # end is idempotent, so migration re-offers are no-ops). The
        # transfer.verify/ingest spans the decode scheduler emits
        # still parent onto it through the manifest's parent_span.
        _spans.end_span(getattr(rr, "_handoff_span", ""),
                        decode_replica=rep.id)

    # -- the monitor ---------------------------------------------------

    def _sweep(self):
        self._process_prefill_deaths()
        self._drain_handoffs()
        super()._sweep()

    def _drain_handoffs(self):
        with self._lock:
            pending, self._pending_handoffs = (
                self._pending_handoffs, [])
        now = time.time()
        for rr, forced, t0 in pending:
            with self._lock:
                if rr.done:
                    continue
            if rr.deadline is not None and now >= rr.deadline:
                self._fail(rr, "timed_out", DeadlineExceededError(
                    f"request {rr.id}: deadline passed awaiting "
                    f"decode-pool handoff ({len(forced)} tokens in)",
                    partial_tokens=list(forced)))
                continue
            if now - t0 > self._HANDOFF_PATIENCE_S:
                self._fail(rr, "failed", EngineClosedError(
                    f"request {rr.id}: no decode replica took the "
                    f"handoff within {self._HANDOFF_PATIENCE_S:.0f}s"))
                continue
            self._handoff_place(rr, forced=forced, t0=t0)

    def _process_prefill_deaths(self):
        with self._lock:
            deaths, self._prefill_deaths = self._prefill_deaths, []
        for pid in deaths:
            with self._lock:
                rep = self._prefill.pop(pid, None)
            if rep is None:
                continue
            self._det.unregister(f"{self._det_ns}/prefill/{pid}")
            try:
                # Idempotent for kill-path legs; a detector-declared
                # corpse gets its futures failed here (-> the
                # prefill_failed fallback in _prefill_done).
                rep.engine.shutdown(drain=False, timeout=60)
            except (TimeoutError, ServingError, RuntimeError) as e:
                sys.stderr.write(
                    f"disagg router: reap of dead prefill {pid} "
                    f"raised {e!r}\n")
            _release_device_memory(rep, "disagg router")
            self._dcount("prefill_deaths")
            _events.emit("disagg.prefill_dead", prefill=pid)
            sys.stderr.write(
                f"disagg router: prefill replica {pid} dead; "
                f"in-flight prompts fall back to decode-pool "
                f"recompute\n")
            with self._lock:
                if self._closing:
                    continue
                if self._replacements_used >= self.max_replacements:
                    _events.emit(
                        "router.replacement_budget_exhausted",
                        replica=pid)
                    sys.stderr.write(
                        f"disagg router: replacement budget "
                        f"({self.max_replacements}) spent; prefill "
                        f"tier shrinks by replica {pid}\n")
                    continue
                self._replacements_used += 1
                builder = threading.Thread(
                    target=self._build_prefill_replacement,
                    name=f"disagg-prefill-replace-{pid}", daemon=True)
                self._builders = [b for b in self._builders
                                  if b.is_alive()] + [builder]
            builder.start()

    def _build_prefill_replacement(self):
        try:
            eng = self._prefill_factory()
        # hvd: disable=HVD006(a failing factory must shrink the prefill tier loudly, not kill the builder — requests degrade to the shared-program path)
        except Exception as e:  # noqa: BLE001
            sys.stderr.write(
                f"disagg router: prefill replacement failed to build "
                f"({e!r}); tier shrinks\n")
            return
        rep = _Replica(next(self._rep_ids), eng)
        stillborn = False
        with self._lock:
            if self._closing:
                stillborn = True
            else:
                self._prefill[rep.id] = rep
        if stillborn:
            try:
                eng.shutdown(drain=False, timeout=60)
            except (TimeoutError, ServingError, RuntimeError):
                pass
            return
        self._register_prefill(rep)
        self._count("replacements")
        _events.emit("disagg.prefill_replace", new_prefill=rep.id)
        self._wake.set()

    # -- accounting -----------------------------------------------------

    def _finish_completed(self, rr: _RouterRequest, win, res,
                          now: float):
        if not getattr(rr, "_disagg", False) \
                or rr.t_first_seen is None:
            return super()._finish_completed(rr, win, res, now)
        # The client-visible first token came from the PREFILL leg:
        # the base fast path (migrations==0, not hedged) would read
        # the decode attempt's own TTFT — the time to re-emit the
        # forced token — and misreport the very latency this
        # subsystem exists to improve.
        with self._lock:
            ttft = rr.t_first_seen - rr.t_submit
            migrations = rr.migrations
            self._ttft_samples.append(ttft)
            del self._ttft_samples[:-512]
        out = dataclasses.replace(res, ttft_s=ttft,
                                  e2e_s=now - rr.t_submit)
        _spans.end_span(rr.gap_span, status="completed")
        _spans.end_span(rr.root_span, status="completed",
                        tokens=len(res.tokens))
        if rr.root_span:
            _spans.observe_request(rr.trace_id)
        self._count("requests", outcome="completed")
        self._m["ttft"].observe(ttft,
                                exemplar={"trace_id": rr.trace_id})
        if win.hedge:
            self._count("hedge_wins")
        if migrations:
            _events.emit("router.migrated_complete",
                         request_id=rr.id, trace_id=rr.trace_id,
                         migrations=migrations,
                         tokens=len(res.tokens))
        self._resolve_future(rr.future, result=out)

    def metrics_snapshot(self) -> dict:
        out = super().metrics_snapshot()
        with self._lock:
            out["prefill_replicas"] = {
                rid: rep.state
                for rid, rep in self._prefill.items()}
            c = dict(self._counts)
        out["disagg"] = {
            "handoffs": c.get("disagg_handoffs", 0),
            "fallbacks": c.get("disagg_fallbacks", 0),
            "prefill_deaths": c.get("prefill_deaths", 0),
            "transfer_mode": self._transfer_mode,
        }
        return out

    # -- lifecycle -------------------------------------------------------

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None):
        """Prefill legs close FIRST: a draining leg resolves its
        in-flight prompt futures synchronously, so every
        `_prefill_done` callback (and the decode submit it performs)
        runs before the base shutdown sweeps leftovers — no stream is
        stranded between tiers. `_closing` is NOT pre-set here: the
        base shutdown's monitor join keys off observing it flip."""
        with self._lock:
            already = self._closing
            legs = list(self._prefill.values())
            self._prefill.clear()
        if not already:
            for rep in legs:
                self._det.unregister(self._prefill_key(rep))
                try:
                    rep.engine.shutdown(
                        drain=drain and rep.state != REPLICA_DEAD,
                        timeout=timeout)
                except (TimeoutError, ServingError,
                        RuntimeError) as e:
                    sys.stderr.write(
                        f"disagg router: shutdown of prefill "
                        f"{rep.id} raised {e!r}\n")
        super().shutdown(drain=drain, timeout=timeout)
        # Defensive: a handoff queued between the legs' drain and the
        # base leftover sweep (both tiers now closed) must not dangle.
        with self._lock:
            stranded = [p[0] for p in self._pending_handoffs]
            self._pending_handoffs = []
        for rr in stranded:
            if not rr.future.done():
                _spans.end_span(getattr(rr, "_handoff_span", ""),
                                status="failed")
                _spans.end_span(rr.root_span, status="failed")
                self._count("requests", outcome="failed")
                self._resolve_future(rr.future, exc=EngineClosedError(
                    f"router shut down while request {rr.id} awaited "
                    f"handoff"))
