"""Serving fleet failover: a replica router that makes engine death
invisible to clients.

Counterpart of `horovod_tpu.serving.router` (host code, ported by
copy): the replicas are the port's `ServingEngine`s, and migration
resubmits through their ``forced_prefix`` door. Seeded streams are
threefry-keyed (`ops.threefry`), so a migrated or routed stream equals
the JAX router's for the same (prompt, seed).

Horovod's fault model is all-or-nothing — one rank dies and `mpirun`
kills the whole job (SURVEY §L2) — and a single `ServingEngine`
inherits it: a dispatch-thread death strands every attached client.
`ServingRouter` breaks that coupling the way MPMD breaks lockstep
scheduling (PAPERS.md, 2412.14374): N engine replicas fail
INDEPENDENTLY while one front door keeps every stream alive.

The router fronts N replicas built by a caller-supplied factory and
owns four robustness mechanisms (docs/serving.md "Fleet failover"):

* **Health-gated, load-aware routing** — every placement consults the
  replica's `_health()` (a dead or closing dispatch thread takes no
  new work), the shared `FailureDetector`'s graduated verdict (a
  SUSPECT replica — stale health evidence, flap-damped — is DRAINED
  from rotation rather than killed; `resilience/detector.py` owns the
  liveness question for router and training membership alike, one
  sweep thread per host), its SLO monitor (a fast-burning replica is
  drained exactly as its own ``/healthz`` 503 asks), and its load
  (queue depth + busy slots; least-loaded wins, round-robin ties).
  Per-request deadlines propagate into each engine's admission queue,
  so queue-expiry keeps working across retries and migrations. DEAD
  verdicts arrive by detector subscription — the router no longer
  runs a private health-poll sweep; its monitor thread is purely the
  REACTION layer (migrations, hedges, drains, replacements).
* **Retry budget** — a shed (`QueueFullError`) or closed first answer
  is retried on another replica under a token bucket
  (``HVD_RETRY_BUDGET`` capacity, refilling at capacity/60 per
  second) with jittered exponential backoff; an exhausted budget
  sheds to the caller instead of amplifying an overload into a retry
  storm.
* **Hedging** — a request with no first token after the fleet's
  ``HVD_HEDGE_QUANTILE`` TTFT quantile is duplicated on a second
  replica; first stream to produce a token wins and the loser is
  cancelled (`RequestHandle.cancel` releases a queued loser's
  admission slot immediately). Duplicates are harmless by
  construction: decode is deterministic per (prompt, seed), so both
  attempts compute the SAME stream.
* **Token-exact migration** — the robustness heart. When a replica
  dies mid-decode, each of its in-flight requests is resubmitted to a
  healthy replica with the tokens it had already produced as a FORCED
  prefix (`ServingEngine.submit(forced_prefix=...)`, the requeue
  machinery generalized across engines): the prefix is teacher-forced
  into the new KV cache (prefill-speed, not decode-speed), the
  per-request sample stream resumes at the right ordinal, and the
  client sees ONE uninterrupted stream bitwise-identical to an
  uninterrupted run — pinned by the migration-equivalence property
  test and the ci.sh ``--failover-check`` smoke. The original
  ``trace_id`` rides along, so the observability plane shows one
  request crossing replicas, and each failover cuts a flight-recorder
  bundle (``HVD_FLIGHT_DIR``).

Replica lifecycle: `drain(replica_id)` removes a replica from rotation,
lets its in-flight work finish, shuts it down cleanly and COLD-REPLACES
it through the factory; a dead replica is replaced the same way (both
draw on the ``HVD_ROUTER_REPLACEMENTS`` budget — once spent the fleet
just shrinks). The ``router.replica_kill`` chaos site (HVD_CHAOS)
hard-kills a busy replica from the monitor loop — the seeded fault the
equivalence tests and ``bench.py --serving --router`` drive.

All routing state lives behind one lock; engine calls (submit,
shutdown, health probes) happen OUTSIDE it because engine future
callbacks re-enter the router on arbitrary threads.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import sys
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Callable, Dict, List, Optional

import numpy as _np

from horovod_tpu_torch.analysis import lockcheck

from horovod_tpu_torch.obs import catalog as _obs_catalog
from horovod_tpu_torch.obs import events as _events
from horovod_tpu_torch.obs import flightrec as _flightrec
from horovod_tpu_torch.obs import reqlog as _reqlog
from horovod_tpu_torch.obs import spans as _spans
from horovod_tpu_torch.obs import tracing as _tracing
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience import detector as _detector
from horovod_tpu_torch.serving.admission import (
    DeadlineExceededError, EngineClosedError, QueueFullError,
    ServingError,
)
from horovod_tpu_torch.serving.scheduler import CompletedRequest

__all__ = ["ServingRouter", "RouterHandle", "RetryBudget",
           "REPLICA_UP", "REPLICA_DRAINING", "REPLICA_DEAD"]

REPLICA_UP = "up"
REPLICA_DRAINING = "draining"
REPLICA_DEAD = "dead"

# Minimum TTFT observations before the hedge delay is trusted; below
# this the router never hedges (a cold fleet has no quantile worth
# deriving a delay from).
_HEDGE_MIN_SAMPLES = 8

# Process-unique router ids for detector-peer namespacing (id(self)
# would do, except CPython reuses addresses — a stale peer from a
# collected router must never alias a new router's namespace).
_ROUTER_IDS = itertools.count()


class RetryBudget:
    """Token bucket over retries (the SRE retry-budget shape): spend
    one token per retry, refill at ``capacity / refill_window_s``
    tokens per second. An exhausted bucket answers False and the
    router sheds instead of retrying — bounded amplification under a
    fleet-wide overload."""

    def __init__(self, capacity: int, refill_window_s: float = 60.0):
        self.capacity = max(0, int(capacity))
        self._rate = (self.capacity / refill_window_s
                      if refill_window_s > 0 else 0.0)
        self._tokens = float(self.capacity)
        self._last = time.time()
        self._lock = lockcheck.register(
            "RetryBudget._lock", threading.Lock())

    def _refill(self, now: float):
        # hvd: disable=HVD004(private helper only ever called with self._lock held by try_spend and tokens)
        self._tokens = min(float(self.capacity),
                           self._tokens + (now - self._last) * self._rate)
        self._last = now

    def try_spend(self) -> bool:
        with self._lock:
            self._refill(time.time())
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill(time.time())
            return self._tokens


@dataclasses.dataclass
class _Attempt:
    """One engine-level placement of a router request: the primary, a
    hedge duplicate, or a post-migration resubmission."""

    handle: object                # engine RequestHandle
    replica_id: int
    forced: tuple                 # forced prefix this attempt carries
    t_submit: float               # engine-submit time (router clock)
    hedge: bool = False
    span_id: str = ""             # causal router.attempt/hedge span


class _RouterRequest:
    """Router-side state for one client request. All mutation happens
    under the router's lock; the future is the only field resolved
    outside it."""

    def __init__(self, rid: int, prompt, max_new_tokens: int, *,
                 temperature: float, top_p, seed: int,
                 deadline: Optional[float], trace_id: str,
                 t_submit: float, priority: int = 0,
                 tenant: str = ""):
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.deadline = deadline
        self.trace_id = trace_id
        self.t_submit = t_submit
        self.priority = int(priority)
        self.tenant = str(tenant)
        self.future: Future = Future()
        self.attempts: List[_Attempt] = []
        self.done = False
        self.cancel_requested = False
        self.hedged = False
        self.migrations = 0
        self.t_first_seen: Optional[float] = None
        # Longest stream observed from a now-dead attempt — the forced
        # prefix a migration resubmits, and the floor tokens_so_far()
        # reports while a migration is in flight.
        self.last_tokens: List[int] = []
        # Causal spans (obs/spans.py): the request's root span — every
        # attempt/hedge/migration span is its child, so one tree spans
        # replicas — and the currently-open migration_gap span (""
        # outside a death-to-replacement window).
        self.root_span = ""
        self.gap_span = ""


class RouterHandle:
    """The caller's view of one request THROUGH the router: stable
    across retries, hedges and replica deaths."""

    def __init__(self, router: "ServingRouter", rr: _RouterRequest):
        self._router = router
        self._rr = rr

    @property
    def id(self) -> int:
        return self._rr.id

    @property
    def trace_id(self) -> str:
        """One observability id for the request's whole life — carried
        into every engine attempt (migrations and hedges included), so
        the event log and Timeline show one request crossing
        replicas."""
        return self._rr.trace_id

    @property
    def future(self) -> Future:
        return self._rr.future

    def result(self, timeout: Optional[float] = None) -> CompletedRequest:
        """Block for the outcome. ``ttft_s``/``e2e_s`` are
        CLIENT-VISIBLE (router-submit based, failovers included)."""
        return self._rr.future.result(timeout)

    def done(self) -> bool:
        return self._rr.future.done()

    def cancel(self):
        self._router._cancel(self._rr)

    def tokens_so_far(self) -> list:
        """Longest generated-token prefix observed across attempts —
        every attempt computes the same deterministic stream, so the
        longest view is always a consistent prefix of the final
        answer, even mid-migration."""
        return self._router._tokens_so_far(self._rr)

    def migrations(self) -> int:
        """How many replica deaths this request has survived."""
        with self._router._lock:
            return self._rr.migrations


class ServingRouter:
    """Route requests across N `ServingEngine` replicas with
    health-gated placement, retry budgets, hedging, and token-exact
    failover (module docstring; docs/serving.md "Fleet failover").

    Parameters
    ----------
    factory : zero-arg callable building one ready `ServingEngine`;
        called ``num_replicas`` times at construction and once per
        cold replacement. Engines should NOT share mutable state.
    num_replicas : fleet width; None reads ``HVD_ROUTER_REPLICAS``.
    retry_budget : token-bucket capacity for shed/failed submit
        retries; None reads ``HVD_RETRY_BUDGET`` (0 disables).
    hedge_quantile : TTFT quantile (0, 1] deriving the hedge delay;
        None reads ``HVD_HEDGE_QUANTILE``; <= 0 disables hedging.
    health_poll_s : monitor sweep interval — the failover-detection
        latency floor; None reads ``HVD_ROUTER_POLL``.
    max_replacements : cold replacements (death or drain) the router
        may build; None reads ``HVD_ROUTER_REPLACEMENTS``.
    backoff_s : base of the jittered exponential retry backoff.
    disagg : disaggregated prefill/decode placement (docs/serving.md
        "Disaggregated serving"). Truthy — True, a prefill-pool
        width, or a dict with ``prefill``/``decode``/``transfer``/
        ``prefill_factory`` keys — constructs a `DisaggRouter`
        instead (so does ``HVD_DISAGG=1`` when the argument is left
        None). The base router accepts and ignores it.
    """

    def __new__(cls, *args, disagg=None, **kwargs):
        # `ServingRouter(disagg=...)` — or HVD_DISAGG=1 — quietly
        # builds the disaggregated subclass: type.__call__ invokes
        # type(obj).__init__ since isinstance(obj, cls) holds, so the
        # caller's arguments reach DisaggRouter.__init__ unchanged.
        if cls is ServingRouter:
            want = disagg
            if want is None:
                from horovod_tpu_torch.runtime.config import config as _cfg
                want = getattr(_cfg, "disagg", 0)
            if want:
                from horovod_tpu_torch.serving.disagg import DisaggRouter
                return super().__new__(DisaggRouter)
        return super().__new__(cls)

    def __init__(self, factory: Callable[[], object],
                 num_replicas: Optional[int] = None, *,
                 retry_budget: Optional[int] = None,
                 hedge_quantile: Optional[float] = None,
                 health_poll_s: Optional[float] = None,
                 max_replacements: Optional[int] = None,
                 backoff_s: float = 0.005, disagg=None):
        del disagg   # consumed by __new__ / DisaggRouter.__init__
        from horovod_tpu_torch.runtime.config import config as _cfg
        if num_replicas is None:
            num_replicas = _cfg.router_replicas
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}")
        if retry_budget is None:
            retry_budget = _cfg.retry_budget
        if hedge_quantile is None:
            hedge_quantile = _cfg.hedge_quantile
        if not hedge_quantile <= 1.0:
            raise ValueError(
                f"hedge_quantile must be <= 1, got {hedge_quantile}")
        if health_poll_s is None:
            health_poll_s = _cfg.router_poll_s
        if max_replacements is None:
            max_replacements = _cfg.router_replacements
        self._factory = factory
        self.hedge_quantile = float(hedge_quantile)
        self.health_poll_s = max(1e-3, float(health_poll_s))
        self.max_replacements = int(max_replacements)
        self.backoff_s = float(backoff_s)
        self.budget = RetryBudget(retry_budget)
        # Per-tenant retry-budget ISOLATION (docs/serving.md "Overload
        # control"): tenants named in HVD_TENANT_WEIGHTS spend a
        # PRIVATE bucket sized by weight share instead of the fleet
        # bucket, so one tenant's retry storm cannot drain everyone
        # else's budget. Unnamed tenants (and "") share the fleet
        # bucket as before.
        from horovod_tpu_torch.serving.overload import parse_tenant_weights
        _weights = parse_tenant_weights(_cfg.tenant_weights)
        _total = sum(_weights.values())
        self._tenant_budgets: Dict[str, RetryBudget] = (
            {t: RetryBudget(max(1, round(retry_budget * w / _total)))
             for t, w in _weights.items()}
            if _total and retry_budget > 0 else {})
        self._m = _obs_catalog.router_metrics()
        # Router-LOCAL counters behind `metrics_snapshot()` (the shared
        # hvd_router_* families are process-global — a second router in
        # the process must not pollute this one's snapshot).
        self._counts: Dict[str, int] = {}
        self._lock = lockcheck.register(
            "ServingRouter._lock", threading.Lock())
        self._rep_ids = itertools.count()
        self._req_ids = itertools.count()
        self._replicas: Dict[int, "_Replica"] = {}
        self._requests: Dict[int, _RouterRequest] = {}
        self._pending_migrations: List[tuple] = []
        self._builders: List[threading.Thread] = []
        self._ttft_samples: List[float] = []
        self._replacements_used = 0
        self._rr_tiebreak = itertools.count()
        self._closing = False
        self._rng = random.Random(0xC0FFEE)
        self._wake = threading.Event()
        # Liveness is OWNED by the shared FailureDetector
        # (resilience/detector.py): each replica's engine health is a
        # registered poll-evidence peer, and this router subscribes —
        # SUSPECT drains the replica from rotation, DEAD triggers the
        # (unchanged) declare-dead -> migrate -> cold-replace
        # reactions. No private health-poll sweep: a host running a
        # router fleet plus training membership has exactly one
        # detector thread.
        self._det = _detector.shared_detector()
        self._det_ns = f"router/{next(_ROUTER_IDS)}"
        self._detector_deaths: List[int] = []
        try:
            for _ in range(num_replicas):
                eng = factory()
                rep = _Replica(next(self._rep_ids), eng)
                with self._lock:
                    self._replicas[rep.id] = rep
                self._register_replica(rep)
        except BaseException:
            # A factory failing partway through fleet construction
            # must not leak the replicas already built (live dispatch
            # threads + device state with no router to shut them
            # down): close them before propagating.
            with self._lock:
                built = [r.engine for r in self._replicas.values()]
                self._replicas.clear()
            self._det.unregister_prefix(self._det_ns + "/")
            for eng in built:
                try:
                    eng.shutdown(drain=False, timeout=60)
                except (TimeoutError, ServingError, RuntimeError):
                    pass
            raise
        self._set_replica_gauges()
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="serving-router-monitor",
            daemon=True)
        self._monitor.start()

    def _count(self, name: str, n: int = 1, *,
               outcome: Optional[str] = None):
        """Bump the router-local counter AND its shared hvd_router_*
        mirror (``outcome`` keys `hvd_router_requests_total`; the
        local key is then the outcome itself)."""
        key = outcome or name
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
        if outcome is not None:
            self._m["requests"].inc(n, outcome=outcome)
        else:
            self._m[name].inc(n)

    # -- detector plumbing --------------------------------------------

    def _peer_key(self, rep: "_Replica") -> str:
        return f"{self._det_ns}/{rep.id}"

    def _register_replica(self, rep: "_Replica"):
        """One poll-evidence peer per replica: healthy iff the
        engine's own health surface says so. A probe that RAISES
        reads unhealthy (a torn-down engine must be able to die, not
        hide behind an evidence error)."""
        def poll(rep=rep):
            try:
                return bool(rep.engine._health().get("healthy"))
            except (ServingError, RuntimeError, AttributeError):
                return False
        self._det.register(
            self._peer_key(rep), poll_fn=poll,
            label=f"replica{rep.id}",
            poll_s=self.health_poll_s,
            suspect_after=0.0,   # any bad probe drains the replica
            dead_after=max(3 * self.health_poll_s, 0.05),
            on_transition=self._on_replica_transition)

    def _on_replica_transition(self, key: str, old: str, new: str,
                               view):
        """Detector subscription (runs on the detector thread):
        SUSPECT drains, recovery un-drains, DEAD hands the replica to
        the monitor sweep — the REACTIONS (declare dead, migrate
        token-exactly, cold-replace) are the router's own machinery."""
        del old, view
        try:
            rid = int(key.rsplit("/", 1)[1])
        except ValueError:
            return
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return
            rep.suspect = new == _detector.SUSPECT
            if new == _detector.DEAD and rep.state == REPLICA_UP:
                self._detector_deaths.append(rid)
        if new != _detector.ALIVE:
            self._wake.set()

    # -- submit side ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0,
               top_p: Optional[float] = None, seed: int = 0,
               timeout_s: Optional[float] = None,
               priority: int = 0, tenant: str = "") -> RouterHandle:
        """`ServingEngine.submit`'s surface, fleet-routed. Raises
        `QueueFullError` only once every routable replica shed AND the
        retry budget ran dry — the router's degrade-by-shedding edge —
        and `EngineClosedError` after `shutdown()`. ``priority`` /
        ``tenant`` ride through every placement (hedges, migrations,
        disagg legs) into the engine's priority bands and WFQ lanes."""
        with self._lock:
            if self._closing:
                raise EngineClosedError(
                    "router is shut down; submit rejected")
        now = time.time()
        rr = _RouterRequest(
            next(self._req_ids), prompt, max_new_tokens,
            temperature=temperature, top_p=top_p, seed=seed,
            deadline=None if timeout_s is None else now + timeout_s,
            trace_id=_tracing.new_trace_id(), t_submit=now,
            priority=priority, tenant=tenant)
        # The trace was minted HERE, so this is the client entry: mint
        # the causal root span (attempts, hedges and migration gaps
        # all hang under it) and record the arrival in the request log
        # (engine submits carry our trace_id, so they do neither).
        rr.root_span = _spans.begin_span(
            "router.request", trace_id=rr.trace_id,
            max_new_tokens=max_new_tokens,
            tenant=rr.tenant, priority=rr.priority)
        _reqlog.record(prompt, max_new_tokens, tenant=rr.tenant,
                       priority=rr.priority, trace_id=rr.trace_id)
        # Registered BEFORE placement: a fast attempt can resolve (and
        # its callback pop this entry) before _place returns —
        # registering after would leak a done request in the table
        # forever.
        with self._lock:
            self._requests[rr.id] = rr
        err = self._place(rr, forced=(), exclude=set(), hedge=False,
                          first_free=True)
        if err is not None:
            with self._lock:
                self._requests.pop(rr.id, None)
            _spans.end_span(rr.root_span, status=(
                "timed_out" if isinstance(err, DeadlineExceededError)
                else "invalid" if isinstance(err, ValueError)
                else "shed"))
            # Count the failure by what the caller actually gets: a
            # deadline that expired during placement is timed_out, an
            # engine-side ValueError is a caller bug (not counted —
            # shed rate is a CAPACITY signal and must not fire on
            # validation rejects), everything else a shed (budget
            # exhaustion is tracked by _place as the CAUSE, not as a
            # second request outcome).
            if not isinstance(err, ValueError):
                self._count("requests", outcome=(
                    "timed_out" if isinstance(err,
                                              DeadlineExceededError)
                    else "shed"))
            raise err
        return RouterHandle(self, rr)

    def _routable(self, rep: "_Replica") -> bool:
        """May `rep` take NEW work? Consumes the replica's own health
        surface: its `_health()` (dead/closing dispatch reads
        unhealthy — the same bit its /healthz 503 serves) and its SLO
        monitor (a fast-burning replica is drained from rotation, the
        consumer the SLO monitor's burn-rate 503 was built for)."""
        if rep.state != REPLICA_UP:
            return False
        if rep.suspect:
            # Graduated suspicion (the shared FailureDetector): a
            # SUSPECT replica is DRAINED — no new placements — while
            # its in-flight work keeps running; it re-enters rotation
            # on recovery instead of being killed and cold-replaced.
            return False
        try:
            if not rep.engine._health().get("healthy"):
                return False
            slo = getattr(rep.engine, "slo", None)
            if slo is not None and not slo.health().get("healthy"):
                return False
        except (ServingError, RuntimeError, AttributeError):
            return False   # a replica that can't answer takes no work
        return True

    def _load_of(self, rep: "_Replica") -> int:
        eng = rep.engine
        try:
            return int(eng.queue_depth) + int(eng.pool.busy_slots)
        except (RuntimeError, AttributeError):
            return 1 << 30

    def _candidates(self, exclude: set) -> List["_Replica"]:
        """Routable replicas, least-loaded first, ROTATING round-robin
        on ties (the rotation offset advances per call, so an idle
        fleet spreads sequential traffic instead of parking it all on
        the oldest replica). Health/load probes run OUTSIDE the router
        lock — they take engine locks."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.id not in exclude]
        offset = next(self._rr_tiebreak)
        n = max(1, len(reps))
        scored = [(self._load_of(r), (i - offset) % n, r)
                  for i, r in enumerate(reps) if self._routable(r)]
        scored.sort(key=lambda t: (t[0], t[1]))
        return [r for _, _, r in scored]

    def _place(self, rr: _RouterRequest, *, forced: tuple,
               exclude: set, hedge: bool, first_free: bool,
               max_tries: Optional[int] = None) -> Optional[Exception]:
        """Submit one attempt for ``rr`` on the best routable replica,
        spending the retry budget on every try after the free first
        one. A momentarily EMPTY fleet (every replica dead/draining —
        a cold replacement may be seconds away) counts as a failed try
        too: budgeted, backed off, re-probed. Returns None on success
        or the exception the caller should surface (never raises —
        the monitor thread calls this too); ``max_tries`` bounds the
        budget one call may burn (migrations re-queue on the monitor
        instead of camping here)."""
        tried = set(exclude)
        attempt_no = 0
        last_err: Optional[Exception] = (
            QueueFullError(f"request {rr.id}: no routable replica"))
        while True:
            now = time.time()
            if rr.deadline is not None and now >= rr.deadline:
                return DeadlineExceededError(
                    f"request {rr.id}: deadline passed during "
                    f"placement ({len(forced)} tokens in)",
                    partial_tokens=list(forced))
            if max_tries is not None and attempt_no >= max_tries:
                return last_err
            if attempt_no > 0 or not first_free:
                if not self._spend_retry(rr.tenant):
                    # A cause marker, not a request outcome — the
                    # caller's path (submit/migrate) records what the
                    # request ultimately became, so the outcomes sum
                    # to the actual request count.
                    with self._lock:
                        self._counts["budget_exhausted"] = (
                            self._counts.get("budget_exhausted", 0)
                            + 1)
                    _events.emit("router.retry_budget_exhausted",
                                 request_id=rr.id,
                                 trace_id=rr.trace_id)
                    return last_err
                self._count("retries")
                _events.emit("router.retry", request_id=rr.id,
                             trace_id=rr.trace_id, attempt=attempt_no)
                # Jittered exponential backoff BEFORE the retry: a
                # fleet-wide shed must not re-land in lockstep.
                delay = (self.backoff_s * (2 ** min(attempt_no, 6))
                         * self._rng.uniform(0.5, 1.5))
                time.sleep(delay)
            attempt_no += 1
            cands = self._candidates(tried)
            if not cands:
                # Every distinct replica answered (or is unroutable):
                # widen back to all routable replicas for the NEXT
                # budgeted retry — a shed queue may have drained, or
                # a replacement may have come up.
                tried = set(exclude)
                cands = self._candidates(tried)
            if not cands:
                last_err = QueueFullError(
                    f"request {rr.id}: no routable replica")
                continue
            rep = cands[0]
            timeout_s = (None if rr.deadline is None
                         else rr.deadline - time.time())
            if timeout_s is not None and timeout_s <= 0:
                return DeadlineExceededError(
                    f"request {rr.id}: deadline passed during "
                    f"placement ({len(forced)} tokens in)",
                    partial_tokens=list(forced))
            # Placement hook (DisaggRouter): runs BEFORE the submit so
            # anything it enqueues on the engine — a KV-block transfer
            # offer — is drained by the scheduler before this
            # request's admission peek.
            self._pre_place(rr, rep)
            # The placement's causal span: engine-side spans (queued /
            # prefill / decode) parent onto it via ``parent_span``, so
            # the tree shows WHICH replica ran which leg.
            if hedge:
                aspan = _spans.begin_span(
                    "router.hedge",
                    trace_id=rr.trace_id, parent_id=rr.root_span,
                    replica=rep.id, forced_tokens=len(forced))
            else:
                aspan = _spans.begin_span(
                    "router.attempt",
                    trace_id=rr.trace_id, parent_id=rr.root_span,
                    replica=rep.id, forced_tokens=len(forced))
            try:
                handle = rep.engine.submit(
                    rr.prompt, rr.max_new_tokens,
                    temperature=rr.temperature, top_p=rr.top_p,
                    seed=rr.seed, timeout_s=timeout_s,
                    forced_prefix=list(forced) or None,
                    trace_id=rr.trace_id, parent_span=aspan,
                    priority=rr.priority, tenant=rr.tenant)
            except (QueueFullError, EngineClosedError) as e:
                _spans.end_span(aspan, status="shed")
                last_err = e
                tried.add(rep.id)
                continue
            except ValueError as e:
                # Validation failures are deterministic — another
                # replica would reject the same request identically,
                # so retrying only burns budget. Surface immediately.
                _spans.end_span(aspan, status="invalid")
                return e
            attempt = _Attempt(handle=handle, replica_id=rep.id,
                               forced=tuple(forced),
                               t_submit=time.time(), hedge=hedge,
                               span_id=aspan)
            stillborn = False
            with self._lock:
                if rr.done or rr.cancel_requested:
                    stillborn = True   # resolved/cancelled meanwhile
                else:
                    rr.attempts.append(attempt)
                    rep.live += 1
            if stillborn:
                _spans.end_span(aspan, status="stillborn")
                handle.cancel()
                return None
            handle.future.add_done_callback(
                lambda fut, rr=rr, a=attempt: self._attempt_done(
                    rr, a, fut))
            return None

    def _spend_retry(self, tenant: str) -> bool:
        """Spend one retry token from ``tenant``'s private bucket when
        it has one (HVD_TENANT_WEIGHTS), else from the fleet bucket.
        A named tenant with a dry bucket sheds — it does NOT fall
        through to the fleet bucket, which is the isolation point."""
        b = self._tenant_budgets.get(tenant)
        return (b if b is not None else self.budget).try_spend()

    def _pre_place(self, rr: _RouterRequest, rep: "_Replica"):
        """Subclass hook, called just before each engine submit of
        ``rr`` on ``rep`` (see `DisaggRouter`: this is where a
        prefill-pool KV-block transfer is offered to the decode
        engine, and re-offered on every migration re-placement)."""

    # -- attempt resolution (engine callback threads) ------------------

    def _attempt_done(self, rr: _RouterRequest, attempt: _Attempt,
                      fut: Future):
        """One engine-level future resolved. Runs on whichever thread
        resolved it (dispatch thread, watchdog, shutdown caller) —
        bookkeeping under the lock, future resolution and cancels
        outside it, anything needing an engine submit deferred to the
        monitor."""
        exc = fut.exception()
        now = time.time()
        # Every attempt's callback fires exactly once, so the attempt
        # span closes here whatever the outcome (winner, hedge loser,
        # replica death).
        _spans.end_span(attempt.span_id,
                        status=("completed" if exc is None
                                else type(exc).__name__))
        losers: List[_Attempt] = []
        need_gap = False
        resolve: Optional[tuple] = None   # (kind, payload)

        def _clear_attempts():
            """Take the remaining (loser) attempts, keeping the
            replicas' live counts honest: the losers' own callbacks
            will find the list empty and must not double-decrement."""
            taken = list(rr.attempts)
            rr.attempts = []
            for a in taken:
                rep = self._replicas.get(a.replica_id)
                if rep is not None:
                    rep.live -= 1
            return taken

        with self._lock:
            if attempt in rr.attempts:
                rr.attempts.remove(attempt)
                rep = self._replicas.get(attempt.replica_id)
                if rep is not None:
                    rep.live -= 1
            if rr.done:
                return
            if exc is None:
                rr.done = True
                losers = _clear_attempts()
                resolve = ("completed", (attempt, fut.result()))
            elif isinstance(exc, DeadlineExceededError):
                rr.done = True
                losers = _clear_attempts()
                resolve = ("timed_out", exc)
            elif isinstance(exc, CancelledError):
                if rr.cancel_requested:
                    rr.done = True
                    losers = _clear_attempts()
                    resolve = ("cancelled", exc)
                else:
                    # A hedge loser we cancelled ourselves — normally
                    # the surviving attempt carries the request. But
                    # if the SURVIVOR's replica died while this cancel
                    # was still pending (its death callback saw this
                    # doomed attempt in rr.attempts and skipped the
                    # migration), the request would be orphaned: no
                    # attempts, no pending migration, a forever-
                    # blocked future. Hand it to the monitor exactly
                    # as a death would.
                    toks = attempt.handle.tokens_so_far()
                    if len(toks) > len(rr.last_tokens):
                        rr.last_tokens = list(toks)
                    if not rr.attempts:
                        self._pending_migrations.append(
                            (rr, list(rr.last_tokens),
                             attempt.replica_id, now, exc))
                        need_gap = True
            else:
                # Replica death (EngineClosedError / a contained
                # fault): keep the longest observed stream and, if no
                # sibling attempt survives, hand the request to the
                # monitor for token-exact migration.
                toks = attempt.handle.tokens_so_far()
                if len(toks) > len(rr.last_tokens):
                    rr.last_tokens = list(toks)
                if not rr.attempts:
                    self._pending_migrations.append(
                        (rr, list(rr.last_tokens),
                         attempt.replica_id, now, exc))
                    need_gap = True
            if need_gap and not rr.gap_span:
                # The stream is now homeless: the gap span stays open
                # until a migration re-places it (or the request
                # dies), so the anatomy charges the outage window to
                # ``migration_gap``, not to decode.
                rr.gap_span = _spans.begin_span(
                    "router.migration_gap", trace_id=rr.trace_id,
                    parent_id=rr.root_span,
                    from_replica=attempt.replica_id,
                    tokens_so_far=len(rr.last_tokens))
        if resolve is not None:
            kind, payload = resolve
            for loser in losers:
                loser.handle.cancel()
            if kind == "completed":
                win, res = payload
                self._finish_completed(rr, win, res, now)
            else:
                _spans.end_span(rr.gap_span, status=kind)
                _spans.end_span(rr.root_span, status=kind)
                self._count("requests", outcome=kind)
                self._resolve_future(rr.future, exc=payload)
            with self._lock:
                self._requests.pop(rr.id, None)
        else:
            self._wake.set()

    def _finish_completed(self, rr: _RouterRequest, win: _Attempt,
                          res: CompletedRequest, now: float):
        """Patch the winning engine's result to the CLIENT-VISIBLE
        clock (router submit time; retries/hedges/failovers included)
        and resolve the router future."""
        with self._lock:
            if rr.migrations == 0 and not rr.hedged:
                # Single-attempt fast path: the engine's own TTFT
                # (offset to the router clock) is exact — the
                # monitor's sweep-time observation is quantized to
                # HVD_ROUTER_POLL and must not inflate the headline
                # latency metric.
                ttft = (win.t_submit - rr.t_submit) + res.ttft_s
            else:
                # Migrated/hedged: the client-visible first token came
                # from an EARLIER attempt — the monitor's stream
                # watcher recorded it (poll-quantized; the winning
                # engine's TTFT is the fallback for a race that
                # completed between sweeps).
                first = (rr.t_first_seen if rr.t_first_seen is not None
                         else win.t_submit + res.ttft_s)
                ttft = first - rr.t_submit
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
        self._m["ttft"].observe(
            ttft, exemplar={"trace_id": rr.trace_id})
        if win.hedge:
            self._count("hedge_wins")
        if migrations:
            _events.emit("router.migrated_complete",
                         request_id=rr.id, trace_id=rr.trace_id,
                         migrations=migrations,
                         tokens=len(res.tokens))
        self._resolve_future(rr.future, result=out)

    @staticmethod
    def _resolve_future(future: Future, *, result=None, exc=None):
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except Exception:  # hvd: disable=HVD006(InvalidStateError race with a concurrent resolver — first resolution won and is the one the client sees)
            pass

    # -- handle plumbing ----------------------------------------------

    def _cancel(self, rr: _RouterRequest):
        with self._lock:
            rr.cancel_requested = True
            attempts = list(rr.attempts)
            orphan = not attempts and not rr.done
            if orphan:
                rr.done = True
                self._pending_migrations = [
                    p for p in self._pending_migrations
                    if p[0] is not rr]
                self._requests.pop(rr.id, None)
        for a in attempts:
            a.handle.cancel()
        if orphan:
            _spans.end_span(rr.gap_span, status="cancelled")
            _spans.end_span(rr.root_span, status="cancelled")
            self._count("requests", outcome="cancelled")
            self._resolve_future(rr.future, exc=CancelledError())

    def _tokens_so_far(self, rr: _RouterRequest) -> list:
        with self._lock:
            best = list(rr.last_tokens)
            for a in rr.attempts:
                toks = a.handle.tokens_so_far()
                if len(toks) > len(best):
                    best = list(toks)
            return best

    # -- the monitor ---------------------------------------------------

    def _monitor_loop(self):
        """The router's background sweep — the REACTION layer: chaos
        kills, detector-verdict processing, pending migrations, hedge
        scans, first-token observation, drains and cold replacements.
        (Liveness DETECTION lives in the shared FailureDetector.)
        Engine calls happen with the router lock RELEASED."""
        while not self._stop.is_set():
            self._wake.wait(self.health_poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._sweep()
            # hvd: disable=HVD006(the monitor IS the recovery path — one bad sweep, e.g. a replica torn down mid-probe, must not kill failover for the whole fleet; logged, next sweep retries)
            except Exception as e:  # noqa: BLE001
                sys.stderr.write(
                    f"serving router: monitor sweep failed with "
                    f"{e!r}; retrying next sweep\n")

    def _sweep(self):
        now = time.time()
        # 1. Chaos: the router.replica_kill site hard-kills a busy
        # replica (docs/resilience.md chaos-site table) — the seeded
        # fault behind the failover acceptance tests and bench A/B.
        if chaos.fires("router.replica_kill"):
            self._chaos_kill()
        # 2. Liveness: drain the shared FailureDetector's DEAD
        # verdicts (it polled the engines' health with graduated
        # suspicion; this sweep owns only the REACTION). The dead
        # engines already failed their futures — the engine's
        # no-dangling-futures contract — so migration rides the
        # attempt callbacks.
        with self._lock:
            verdicts, self._detector_deaths = (
                self._detector_deaths, [])
        for rid in verdicts:
            with self._lock:
                rep = self._replicas.get(rid)
            if rep is not None and rep.state == REPLICA_UP:
                self._declare_dead(rep, "failure detector: health "
                                        "evidence expired (DEAD)")
        # 3. Token-exact migrations queued by attempt callbacks —
        # BEFORE cold replacement: with healthy siblings up, orphaned
        # streams must not wait out a synchronous factory build (an
        # engine construction can take seconds on real hardware).
        # Snapshot-drained: a migration that finds NO routable replica
        # (the last replica died) re-queues itself and lands one sweep
        # after step 4's replacement instead.
        with self._lock:
            pending, self._pending_migrations = (
                self._pending_migrations, [])
        for item in pending:
            self._migrate(*item)
        # 4. Drain completion + cold replacement of dead replicas.
        self._lifecycle()
        # 5. First-token observation + hedging.
        self._observe_streams(now)
        self._m["retry_budget"].set(self.budget.tokens)
        self._set_replica_gauges()

    def _chaos_kill(self):
        """Pick the busiest UP replica (streams mid-flight make the
        kill meaningful) and kill it abruptly."""
        with self._lock:
            ups = [r for r in self._replicas.values()
                   if r.state == REPLICA_UP]
            if not ups:
                return
            target = max(ups, key=lambda r: r.live)
        self._kill_replica(target, "chaos site router.replica_kill")

    def kill_replica(self, replica_id: int):
        """Test/ops hook: abrupt replica death (no drain) — what the
        chaos site does, targeted."""
        with self._lock:
            rep = self._replicas.get(replica_id)
        if rep is None:
            raise KeyError(f"no replica {replica_id}")
        self._kill_replica(rep, "kill_replica()")

    def _kill_replica(self, rep: "_Replica", why: str):
        self._declare_dead(rep, why)
        try:
            # Abrupt stop: in-flight futures fail with
            # EngineClosedError -> attempt callbacks queue migrations.
            rep.engine.shutdown(drain=False, timeout=60)
        except (TimeoutError, ServingError, RuntimeError) as e:
            sys.stderr.write(
                f"serving router: kill of replica {rep.id} did not "
                f"join cleanly ({e!r}); its futures are failed and "
                f"the replica stays dead\n")

    def _declare_dead(self, rep: "_Replica", why: str):
        self._det.unregister(self._peer_key(rep))
        with self._lock:
            if rep.state == REPLICA_DEAD:
                return
            rep.state = REPLICA_DEAD
            inflight = [
                (r.id, r.trace_id) for r in self._requests.values()
                for a in r.attempts if a.replica_id == rep.id]
        self._count("replica_deaths")
        _events.emit("router.replica_dead", replica=rep.id,
                     reason=why,
                     inflight_trace_ids=[t for _, t in inflight])
        # The failover bundle (no-op unless HVD_FLIGHT_DIR is set):
        # the replica's in-flight trace_ids at death time, alongside
        # the full event ring and metric snapshot — the post-mortem
        # record of what the migration machinery inherited.
        _flightrec.trigger(
            "router.failover", replica=rep.id, reason=why,
            inflight_trace_ids=[t for _, t in inflight])
        sys.stderr.write(
            f"serving router: replica {rep.id} dead ({why}); "
            f"{len(inflight)} stream(s) to migrate\n")

    # How long an orphaned stream may wait for the fleet to recover
    # (cold replacement mid-build) before its migration gives up; the
    # request's own deadline still cuts this short.
    _MIGRATION_PATIENCE_S = 30.0

    def _migrate(self, rr: _RouterRequest, toks: list, dead_rid: int,
                 t_detect: float, err: Exception):
        """Token-exact failover for one request: resubmit with the
        already-generated tokens as a forced prefix, same trace_id,
        remaining deadline. With the whole fleet momentarily gone
        (the last replica died; its replacement is building), the
        migration DEFERS to the next monitor sweep instead of failing
        the stream — bounded by `_MIGRATION_PATIENCE_S` and the
        request deadline."""
        with self._lock:
            if rr.done or rr.attempts:
                return   # cancelled/resolved/re-placed meanwhile
            eos = next((getattr(rep.engine, "eos_id", None)
                        for rep in self._replicas.values()), None)
        # Terminal-stream fast path: the replica died in the window
        # AFTER generating the request's final token (budget spent, or
        # the stream ended on eos) but BEFORE resolving its future —
        # there is nothing left to decode, and resubmitting would be
        # rejected at validation ('no decode budget' / 'contains
        # eos'). The stream is complete; synthesize the result the
        # dead replica owed.
        if toks and (len(toks) >= rr.max_new_tokens
                     or (eos is not None and toks[-1] == eos)):
            self._finish_terminal(rr, list(toks), eos, dead_rid)
            return
        # max_tries=1: a migration never spends the CLIENT retry
        # budget (that bucket bounds overload amplification, and a
        # failover is a correctness path, not load) — the free probe
        # either lands or the migration re-queues for the next sweep.
        placed = self._place(rr, forced=tuple(toks),
                             exclude={dead_rid}, hedge=False,
                             first_free=True, max_tries=1)
        if placed is None:
            with self._lock:
                rr.migrations += 1
                gap, rr.gap_span = rr.gap_span, ""
            _spans.end_span(gap, status="migrated",
                            forced_tokens=len(toks))
            self._count("migrations")
            if toks:
                self._count("migrated_tokens", len(toks))
            self._m["failover"].observe(
                time.time() - t_detect,
                exemplar={"trace_id": rr.trace_id})
            _events.emit("router.migrate", request_id=rr.id,
                         trace_id=rr.trace_id, from_replica=dead_rid,
                         forced_tokens=len(toks))
            return
        with self._lock:
            recoverable = (
                any(r.state != REPLICA_DEAD
                    for r in self._replicas.values())
                or self._replacements_used < self.max_replacements)
        if (recoverable and not self._stop.is_set()
                and not isinstance(placed, DeadlineExceededError)
                and time.time() - t_detect < self._MIGRATION_PATIENCE_S):
            with self._lock:
                if not rr.done:
                    self._pending_migrations.append(
                        (rr, toks, dead_rid, t_detect, err))
            return
        # No home for the stream: surface the REPLACEMENT error if it
        # is a deadline (truthful), else the original death.
        final = (placed if isinstance(placed, DeadlineExceededError)
                 else EngineClosedError(
                     f"request {rr.id}: replica {dead_rid} died "
                     f"({err!r}) and no healthy replica could take "
                     f"the migrated stream ({placed!r})"))
        with self._lock:
            rr.done = True
            self._requests.pop(rr.id, None)
        outcome = ("timed_out"
                   if isinstance(final, DeadlineExceededError)
                   else "failed")
        _spans.end_span(rr.gap_span, status=outcome)
        _spans.end_span(rr.root_span, status=outcome)
        self._count("requests", outcome=outcome)
        _events.emit("router.migrate_failed", request_id=rr.id,
                     trace_id=rr.trace_id, error=repr(final))
        self._resolve_future(rr.future, exc=final)

    def _finish_terminal(self, rr: _RouterRequest, toks: list,
                         eos: Optional[int], dead_rid: int):
        """Resolve a migrated request whose dead replica had ALREADY
        generated its whole stream (only the future resolution was
        lost in the crash) — token-exact by construction: the tokens
        ARE the stream."""
        now = time.time()
        with self._lock:
            if rr.done:
                return
            rr.done = True
            observed = rr.t_first_seen is not None
            first = rr.t_first_seen if observed else now
            ttft = first - rr.t_submit
            if observed:
                # Only an actually-observed first token feeds the
                # hedge-delay quantile — the `now` fallback (a stream
                # that finished inside one monitor sweep) would record
                # ttft == e2e and inflate the delay after a failover
                # burst.
                self._ttft_samples.append(ttft)
                del self._ttft_samples[:-512]
            self._requests.pop(rr.id, None)
        n = len(toks)
        res = CompletedRequest(
            request_id=rr.id, prompt=_np.asarray(rr.prompt),
            tokens=_np.asarray(toks, _np.int64),
            finish_reason=("eos" if eos is not None
                           and toks[-1] == eos else "length"),
            ttft_s=ttft,
            tpot_s=((now - first) / (n - 1) if n > 1 else None),
            e2e_s=now - rr.t_submit, trace_id=rr.trace_id)
        _spans.end_span(rr.gap_span, status="terminal")
        _spans.end_span(rr.root_span, status="completed", tokens=n)
        if rr.root_span:
            _spans.observe_request(rr.trace_id)
        self._count("requests", outcome="completed")
        self._m["ttft"].observe(ttft,
                                exemplar={"trace_id": rr.trace_id})
        _events.emit("router.migrate_terminal", request_id=rr.id,
                     trace_id=rr.trace_id, from_replica=dead_rid,
                     tokens=n)
        self._resolve_future(rr.future, result=res)

    def _hedge_delay(self) -> Optional[float]:
        """The quantile-derived hedge trigger: the q-th TTFT quantile
        over the newest observations; None while hedging is off or
        the sample set is too small to trust."""
        if self.hedge_quantile <= 0:
            return None
        with self._lock:
            xs = sorted(self._ttft_samples)
        if len(xs) < _HEDGE_MIN_SAMPLES:
            return None
        rank = min(len(xs) - 1,
                   int(self.hedge_quantile * (len(xs) - 1) + 0.5))
        return xs[rank]

    def _observe_streams(self, now: float):
        """Record first-token times (the hedge scan's signal AND the
        client-visible TTFT for migrated requests) and hedge
        slow-to-first-token requests."""
        delay = self._hedge_delay()
        hedge_list: List[_RouterRequest] = []
        lose_list: List[_Attempt] = []
        with self._lock:
            for rr in self._requests.values():
                if rr.done or rr.cancel_requested:
                    continue
                first = rr.t_first_seen is not None
                producers = [a for a in rr.attempts
                             if len(a.handle.tokens_so_far())
                             > len(a.forced)]
                if not first and producers:
                    rr.t_first_seen = now
                    first = True
                if first and len(rr.attempts) > 1 and producers:
                    # First token decides the hedge race NOW: the
                    # farthest-ahead attempt keeps the request, the
                    # rest are cancelled (the documented contract —
                    # a duplicate must not decode a whole second
                    # stream on a second replica's slot).
                    winner = max(
                        producers,
                        key=lambda a: len(a.handle.tokens_so_far()))
                    lose_list.extend(a for a in rr.attempts
                                     if a is not winner)
                if (not first and not rr.hedged and delay is not None
                        and len(rr.attempts) == 1
                        and now - rr.attempts[0].t_submit > delay):
                    rr.hedged = True
                    hedge_list.append(rr)
        for loser in lose_list:
            loser.handle.cancel()
        for rr in hedge_list:
            with self._lock:
                if rr.done or not rr.attempts:
                    continue
                primary = rr.attempts[0]
                rep = self._replicas.get(primary.replica_id)
            if (rep is not None and not getattr(
                    rep.engine, "hedge_allowed", lambda t: True)(rr.tenant)):
                # Brownout rung 1+ for this tenant: a hedge would
                # DOUBLE the load the ladder is trying to shed, so the
                # duplicate is suppressed — `hedged` stays latched
                # (this request had its chance; re-probing every scan
                # would defeat the suppression).
                with self._lock:
                    self._counts["hedges_suppressed"] = (
                        self._counts.get("hedges_suppressed", 0) + 1)
                _em = getattr(rep.engine, "metrics", None)
                if _em is not None:
                    _em.count("hedges_suppressed")
                _events.emit("router.hedge_suppressed", request_id=rr.id,
                             trace_id=rr.trace_id, tenant=rr.tenant,
                             primary_replica=primary.replica_id)
                continue
            # Best-effort duplicate: ONE free probe (max_tries=1 —
            # hedges are not retries; a shedding fleet must not park
            # the monitor in the backoff loop burning client budget
            # while deaths go undetected). Both attempts compute the
            # same stream; the first token decides the race above and
            # the loser is cancelled. Counted only when a duplicate
            # actually PLACED; a failed probe un-latches `hedged` so
            # the request may hedge later (e.g. once a replacement
            # replica comes up).
            placed = self._place(rr, forced=primary.forced,
                                 exclude={primary.replica_id},
                                 hedge=True, first_free=True,
                                 max_tries=1)
            if placed is None:
                self._count("hedges")
                _events.emit("router.hedge", request_id=rr.id,
                             trace_id=rr.trace_id,
                             primary_replica=primary.replica_id,
                             delay_s=round(delay, 4))
            else:
                with self._lock:
                    rr.hedged = False

    def _lifecycle(self):
        """Complete drains and cold-replace dead/drained replicas."""
        to_finish: List["_Replica"] = []
        dead: List["_Replica"] = []
        with self._lock:
            for rep in self._replicas.values():
                if rep.state == REPLICA_DRAINING and rep.live == 0:
                    to_finish.append(rep)
                elif rep.state == REPLICA_DEAD and not rep.reaped:
                    rep.reaped = True
                    dead.append(rep)
        for rep in to_finish:
            eng = rep.engine
            if eng.queue_depth or eng.pool.busy_slots:
                continue   # still finishing admitted work
            try:
                eng.shutdown(drain=True, timeout=60)
            except (TimeoutError, ServingError, RuntimeError) as e:
                sys.stderr.write(
                    f"serving router: drain of replica {rep.id} "
                    f"failed ({e!r}); treating as dead\n")
            with self._lock:
                rep.state = REPLICA_DEAD
                rep.reaped = True
            self._det.unregister(self._peer_key(rep))
            _events.emit("router.drained", replica=rep.id)
            dead.append(rep)
        for rep in dead:
            # Probe-declared deaths never went through a shutdown:
            # close the corpse (idempotent for kill-path replicas) so
            # its /healthz provider and labeled gauge rows leave the
            # observability plane with it — a replaced replica must
            # not 503 the host forever.
            try:
                rep.engine.shutdown(drain=False, timeout=60)
            except (TimeoutError, ServingError, RuntimeError) as e:
                sys.stderr.write(
                    f"serving router: reap of dead replica {rep.id} "
                    f"raised {e!r}\n")
            _release_device_memory(rep, "serving router")
            self._replace(rep)

    def _replace(self, rep: "_Replica"):
        """Queue a cold replacement. The factory runs on a SEPARATE
        builder thread: an engine build (plus warmup compile) can take
        seconds on real hardware, and the monitor must keep detecting
        deaths, processing migrations and hedging for the REST of the
        fleet meanwhile."""
        with self._lock:
            if self._closing:
                return
            if self._replacements_used >= self.max_replacements:
                _events.emit("router.replacement_budget_exhausted",
                             replica=rep.id)
                sys.stderr.write(
                    f"serving router: replacement budget "
                    f"({self.max_replacements}) spent; fleet shrinks "
                    f"by replica {rep.id}\n")
                self._replicas.pop(rep.id, None)
                return
            self._replacements_used += 1
            builder = threading.Thread(
                target=self._build_replacement, args=(rep,),
                name=f"serving-router-replace-{rep.id}", daemon=True)
            # Prune finished builders so the list tracks live builds.
            self._builders = [b for b in self._builders
                              if b.is_alive()] + [builder]
        builder.start()

    def _build_replacement(self, rep: "_Replica"):
        try:
            eng = self._factory()
        # hvd: disable=HVD006(a failing factory must shrink the fleet loudly, not kill the builder — the remaining replicas still serve)
        except Exception as e:  # noqa: BLE001
            sys.stderr.write(
                f"serving router: cold replacement for replica "
                f"{rep.id} failed to build ({e!r}); fleet shrinks\n")
            with self._lock:
                self._replicas.pop(rep.id, None)
            return
        fresh = _Replica(next(self._rep_ids), eng)
        stillborn = False
        with self._lock:
            if self._closing:
                stillborn = True   # router shut down mid-build
            else:
                self._replicas.pop(rep.id, None)
                self._replicas[fresh.id] = fresh
        if not stillborn:
            self._register_replica(fresh)
        if stillborn:
            try:
                eng.shutdown(drain=False, timeout=60)
            except (TimeoutError, ServingError, RuntimeError):
                pass
            return
        self._count("replacements")
        _events.emit("router.replace", old_replica=rep.id,
                     new_replica=fresh.id)
        sys.stderr.write(
            f"serving router: replica {rep.id} cold-replaced by "
            f"replica {fresh.id}\n")
        self._wake.set()

    def _set_replica_gauges(self):
        with self._lock:
            counts = {REPLICA_UP: 0, REPLICA_DRAINING: 0,
                      REPLICA_DEAD: 0}
            for rep in self._replicas.values():
                counts[rep.state] += 1
        for state, n in counts.items():
            self._m["replicas"].set(n, state=state)

    # -- lifecycle API -------------------------------------------------

    def drain(self, replica_id: int):
        """Graceful replica retirement: stop routing NEW work to it
        now; the monitor shuts it down once its in-flight work
        finishes and cold-replaces it through the factory."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                raise KeyError(f"no replica {replica_id}")
            if rep.state != REPLICA_UP:
                return
            rep.state = REPLICA_DRAINING
        _events.emit("router.drain", replica=replica_id)
        self._wake.set()

    def replicas(self) -> Dict[int, str]:
        """{replica_id: state} — the fleet as the router sees it."""
        with self._lock:
            return {rid: rep.state
                    for rid, rep in self._replicas.items()}

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state != REPLICA_DEAD)

    def engine_of(self, replica_id: int):
        """The live engine behind a replica id (tests/ops)."""
        with self._lock:
            return self._replicas[replica_id].engine

    def metrics_snapshot(self) -> dict:
        """THIS router's counters for benches and tests (the shared
        ``hvd_router_*`` families are process-global mirrors;
        engine-level numbers stay on each replica's
        `metrics_snapshot()`)."""
        with self._lock:
            states = {rid: rep.state
                      for rid, rep in self._replicas.items()}
            n_requests = len(self._requests)
            c = dict(self._counts)
        out = {"replicas": states, "inflight": n_requests,
               "retry_budget_tokens": round(self.budget.tokens, 2)}
        if self._tenant_budgets:
            out["tenant_budget_tokens"] = {
                t: round(b.tokens, 2)
                for t, b in self._tenant_budgets.items()}
        for key in ("completed", "failed", "shed", "cancelled",
                    "timed_out", "budget_exhausted", "retries",
                    "hedges", "hedge_wins", "hedges_suppressed",
                    "migrations", "migrated_tokens", "replica_deaths",
                    "replacements"):
            out[key] = c.get(key, 0)
        return out

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None):
        """Stop the fleet. ``drain=True`` finishes in-flight work on
        every live replica first; pending migrations that never found
        a home fail loudly with `EngineClosedError`. Idempotent."""
        with self._lock:
            already = self._closing
            self._closing = True
        self._stop.set()
        self._wake.set()
        if not already:
            self._monitor.join()
        # In-flight replacement builds either install before _closing
        # was read (their replicas get shut down below) or go
        # stillborn (the builder closes its own engine) — joined here
        # so neither outcome races the teardown.
        with self._lock:
            builders = list(self._builders)
        for b in builders:
            b.join()
        # After the monitor and every builder joined: nobody can
        # re-register a peer, so the namespace teardown cannot leak a
        # poll closure over a shut-down engine into the shared
        # detector.
        self._det.unregister_prefix(self._det_ns + "/")
        with self._lock:
            reps = list(self._replicas.values())
            orphans = [p[0] for p in self._pending_migrations]
            self._pending_migrations = []
        for rep in reps:
            try:
                # Dead replicas get a no-drain close: usually a no-op
                # (kill/reap already shut them down — idempotent), but
                # a corpse the monitor never reaped must still leave
                # the observability plane.
                rep.engine.shutdown(
                    drain=drain and rep.state != REPLICA_DEAD,
                    timeout=timeout)
            except (TimeoutError, ServingError, RuntimeError) as e:
                sys.stderr.write(
                    f"serving router: shutdown of replica {rep.id} "
                    f"raised {e!r}\n")
        # Anything still unresolved (mid-migration requests, and the
        # no-drain case's stragglers) must not dangle.
        with self._lock:
            leftovers = [rr for rr in self._requests.values()
                         if not rr.future.done()]
            self._requests.clear()
        for rr in set(orphans) | set(leftovers):
            self._count("requests", outcome="failed")
            self._resolve_future(rr.future, exc=EngineClosedError(
                f"router shut down while request {rr.id} awaited "
                f"placement"))
        self._set_replica_gauges()

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)


def _release_device_memory(rep: "_Replica", who: str):
    """Free a reaped replica's KV before its replacement is built (the
    port's engines share one card: a kill must not hold two pools'
    worth of KV until the swap). Engines without the hook (scripted
    fakes) are left as they are."""
    release = getattr(rep.engine, "release_device_memory", None)
    if release is None:
        return
    try:
        release()
    except RuntimeError as e:
        sys.stderr.write(f"{who}: replica {rep.id} keeps its device "
                         f"memory ({e})\n")


class _Replica:
    """One engine in the fleet: identity, lifecycle state, and the
    router-side live-attempt count (kill targeting + drain
    completion)."""

    def __init__(self, rid: int, engine):
        self.id = rid
        self.engine = engine
        self.state = REPLICA_UP
        self.live = 0        # router attempts currently on this engine
        self.reaped = False  # dead replica already queued for replace
        self.suspect = False  # detector SUSPECT: drained from rotation
