"""Unified failure detection — ONE owner for the liveness question.

Counterpart of `horovod_tpu.resilience.detector` (host-only, ported by
copy). Without it a system answers "is that peer alive?" twice,
independently: a router's health-poll sweep and an elastic world's
inline heartbeat-lease arithmetic per member. Two detectors means two
clocks, two sets of thresholds, duplicated polling cost on a host
running both planes, and two different failure semantics for the same
dead process.

`FailureDetector` centralizes it (docs/resilience.md "Failure
detection"):

* **Graduated suspicion** instead of a binary cliff:
  ``ALIVE -> SUSPECT -> DEAD``. A peer whose evidence is merely stale
  (one dropped heartbeat, a slow poll, a collective-stall report) is
  SUSPECT — consumers *drain* it (route no new work, don't propose it
  out of the world); only evidence stale past the dead threshold is
  DEAD — the verdict that triggers failover/resize.
* **Hysteresis + flap damping**: leaving SUSPECT requires
  ``HVD_DETECTOR_HYSTERESIS`` consecutive good observations, and a
  peer that recovers/re-suspects more than ``HVD_DETECTOR_FLAP_MAX``
  times inside ``HVD_DETECTOR_FLAP_WINDOW_S`` is *damped* — held at
  SUSPECT (drained, not killed) until the window decays — so a
  slow-but-alive peer is never declared dead and resurrected in a
  loop. ``hvd_detector_flaps_total`` is bounded by construction.
* **Pluggable evidence sources** per peer:
  - ``age_fn`` — seconds since the last good proof of life (the KV
    heartbeat lease: `WorldMonitor` registers each member's beat age);
  - ``poll_fn`` — an active probe returning healthy/unhealthy (the
    router registers each replica's ``engine._health()``);
  - **external evidence** — `note_stall` / `ingest_stall_report`
    feed collective-stall attributions from `obs/straggler.py` (a
    rank missing from a timing-window exchange is SUSPECT evidence).
  Evidence *errors* (the KV unreachable, a probe raising) are
  recorded but cap the verdict at SUSPECT: "I cannot see the peer"
  must never read as "the peer is dead" — that asymmetry is the
  split-brain guard the `kv_partition` chaos drill pins.
* **One sweep thread per process** (`shared_detector()`): a host
  running a router fleet *plus* training membership runs exactly one
  ``hvd-failure-detector`` thread, not one liveness loop per
  consumer (pinned by test). Consumers subscribe with
  ``on_transition`` callbacks; callbacks run outside the detector
  lock.
* **Observability**: per-peer ``hvd_detector_*`` metrics,
  ``detector.suspect`` / ``detector.dead`` / ``detector.recovered``
  events, and — on every DEAD verdict — a flight-recorder bundle
  carrying the peer's full evidence timeline (last beats, poll
  results, suspicion transitions), so a postmortem can distinguish
  true death from partition.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from horovod_tpu_torch.runtime.config import env_float, env_int

from horovod_tpu_torch.analysis import lockcheck

__all__ = ["FailureDetector", "PeerView", "shared_detector",
           "install_detector", "ALIVE", "SUSPECT", "DEAD"]

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

# Evidence-timeline depth per peer (the flight-recorder bundle's
# per-peer run-up; small — entries are tiny dicts).
_TIMELINE_DEPTH = 64

# Sweep floor: registrations may ask for faster polls, but the shared
# thread never spins tighter than this.
_MIN_SWEEP_S = 0.005


class PeerView:
    """Read-only snapshot of one peer's detector state (tests/ops)."""

    __slots__ = ("key", "label", "state", "damped", "flaps",
                 "evidence_age_s")

    def __init__(self, key, label, state, damped, flaps, age):
        self.key = key
        self.label = label
        self.state = state
        self.damped = damped
        self.flaps = flaps
        self.evidence_age_s = age


class _Peer:
    """One registered peer: its evidence sources, thresholds, and the
    suspicion state machine's counters. All mutation under the
    detector lock."""

    def __init__(self, key: str, *, label: str,
                 age_fn: Optional[Callable[[], float]],
                 poll_fn: Optional[Callable[[], bool]],
                 clock: Callable[[], float],
                 suspect_after: float, dead_after: float,
                 poll_s: float, hysteresis: int,
                 flap_window_s: float, flap_max: int,
                 rank: Optional[int],
                 on_transition: Optional[Callable]):
        self.key = key
        self.label = label
        self.age_fn = age_fn
        self.poll_fn = poll_fn
        self.clock = clock
        self.suspect_after = float(suspect_after)
        self.dead_after = float(dead_after)
        self.poll_s = max(_MIN_SWEEP_S, float(poll_s))
        self.hysteresis = max(1, int(hysteresis))
        self.flap_window_s = float(flap_window_s)
        self.flap_max = max(1, int(flap_max))
        self.rank = rank
        self.on_transition = on_transition
        self.state = ALIVE
        self.good_streak = 0
        self.flap_times: collections.deque = collections.deque()
        self.flaps = 0
        self.last_age = 0.0
        # Poll-evidence bookkeeping (poll_fn peers).
        self.last_poll_mono = float("-inf")
        self.last_ok_clock = clock()
        self.last_poll_ok = True
        # External (stall-report) negative evidence holds the peer at
        # >= SUSPECT until this clock value.
        self.stall_until = float("-inf")
        self.timeline: collections.deque = collections.deque(
            maxlen=_TIMELINE_DEPTH)

    def note(self, kind: str, **fields):
        self.timeline.append(dict(fields, kind=kind,
                                  t=round(self.clock(), 4)))


# What an evidence source (an age_fn reading a possibly-partitioned
# KV, a poll_fn probing a mid-shutdown engine) may raise and have it
# read as "evidence unavailable" (capped at SUSPECT) instead of
# killing the sweep.
_EVIDENCE_ERRORS = (RuntimeError, ValueError, TypeError, OSError,
                    AttributeError, KeyError)


class FailureDetector:
    """Lease/heartbeat/poll tracking with graduated suspicion for any
    number of registered peers, swept by one background thread
    (module docstring; docs/resilience.md "Failure detection")."""

    def __init__(self, *, sweep_s: Optional[float] = None):
        if sweep_s is None:
            sweep_s = env_float("HVD_DETECTOR_SWEEP_S", 0.05)
        self.sweep_s = max(_MIN_SWEEP_S, float(sweep_s))
        self._lock = lockcheck.register(
            "FailureDetector._lock", threading.Lock())
        self._peers: Dict[str, _Peer] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0

    # -- registration --------------------------------------------------

    def register(self, key: str, *,
                 age_fn: Optional[Callable[[], float]] = None,
                 poll_fn: Optional[Callable[[], bool]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 suspect_after: float,
                 dead_after: float,
                 label: Optional[str] = None,
                 poll_s: Optional[float] = None,
                 hysteresis: Optional[int] = None,
                 flap_window_s: Optional[float] = None,
                 flap_max: Optional[int] = None,
                 rank: Optional[int] = None,
                 on_transition: Optional[Callable] = None) -> str:
        """Register (or re-register) one peer.

        Exactly one evidence source is required: ``age_fn`` returns
        seconds since the peer's last proof of life (lease evidence —
        the caller owns the clock domain, pass the matching
        ``clock``), or ``poll_fn`` actively probes and returns
        healthy. ``on_transition(key, old, new, view)`` fires outside
        the detector lock on every state change. ``rank`` tags the
        peer for `ingest_stall_report` attribution."""
        if (age_fn is None) == (poll_fn is None):
            raise ValueError(
                "register() needs exactly one evidence source "
                "(age_fn OR poll_fn)")
        peer = _Peer(
            key, label=label or key, age_fn=age_fn, poll_fn=poll_fn,
            clock=clock, suspect_after=suspect_after,
            dead_after=dead_after,
            poll_s=poll_s if poll_s is not None else self.sweep_s,
            hysteresis=(hysteresis if hysteresis is not None
                        else env_int("HVD_DETECTOR_HYSTERESIS", 2)),
            flap_window_s=(flap_window_s if flap_window_s is not None
                           else env_float("HVD_DETECTOR_FLAP_WINDOW_S",
                                          30.0)),
            flap_max=(flap_max if flap_max is not None
                      else env_int("HVD_DETECTOR_FLAP_MAX", 4)),
            rank=rank, on_transition=on_transition)
        peer.note("registered")
        with self._lock:
            self._peers[key] = peer
            start = self._thread is None
            if start:
                # Lazily (re)started: a stop()'d detector comes back
                # on the next registration (scoped-test pattern).
                self._stop.clear()
                t = threading.Thread(
                    target=self._sweep_loop,
                    name="hvd-failure-detector", daemon=True)
                self._thread = t
        if start:
            t.start()
        self._wake.set()
        return key

    def unregister(self, key: str) -> None:
        with self._lock:
            self._peers.pop(key, None)

    def unregister_prefix(self, prefix: str) -> None:
        """Drop every peer whose key starts with ``prefix`` (a
        consumer tearing down its whole namespace)."""
        with self._lock:
            for k in [k for k in self._peers if k.startswith(prefix)]:
                del self._peers[k]

    # -- queries -------------------------------------------------------

    def state_of(self, key: str, *, refresh: bool = False) -> str:
        """The peer's suspicion state; ``refresh=True`` evaluates its
        evidence NOW (synchronously, on the caller's thread) instead
        of returning the last sweep's verdict — the resize protocol's
        deterministic read."""
        if refresh:
            fired = self._evaluate_keys([key], force=True)
            self._fire(fired)
        with self._lock:
            p = self._peers.get(key)
            return p.state if p is not None else ALIVE

    def view(self, key: str) -> Optional[PeerView]:
        with self._lock:
            p = self._peers.get(key)
            if p is None:
                return None
            return PeerView(p.key, p.label, p.state,
                            self._damped(p, time.monotonic()),
                            p.flaps, p.last_age)

    def peers(self) -> Dict[str, str]:
        with self._lock:
            return {k: p.state for k, p in self._peers.items()}

    def timeline_of(self, key: str) -> List[Dict]:
        with self._lock:
            p = self._peers.get(key)
            return list(p.timeline) if p is not None else []

    # -- external evidence --------------------------------------------

    def note_stall(self, key: str, *, hold_s: float = 1.0,
                   detail: str = "collective_stall") -> None:
        """Negative external evidence: hold the peer at >= SUSPECT for
        ``hold_s`` (its own clock). Never escalates to DEAD by itself
        — a stall report is a symptom, not a death certificate."""
        with self._lock:
            p = self._peers.get(key)
            if p is None:
                return
            p.stall_until = max(p.stall_until, p.clock() + hold_s)
            p.note("stall", detail=detail, hold_s=hold_s)
        self._wake.set()

    def ingest_stall_report(self, report: Dict, *,
                            hold_s: float = 2.0) -> int:
        """Feed one `obs.straggler.merge_windows` report: every peer
        registered with a ``rank`` in the report's ``missing_ranks``
        (stopped reporting entirely — the usual prime suspect) gets
        stall evidence; a flagged straggler gets a softer note.
        Returns how many peers were marked."""
        missing = set(report.get("missing_ranks") or ())
        slowest = (report.get("slowest_rank")
                   if report.get("straggler") else None)
        marked = 0
        with self._lock:
            targets = [(p, "missing_from_exchange"
                        if p.rank in missing else "straggler")
                       for p in self._peers.values()
                       if p.rank is not None
                       and (p.rank in missing or p.rank == slowest)]
        for p, why in targets:
            self.note_stall(p.key, hold_s=hold_s, detail=why)
            marked += 1
        return marked

    # -- the state machine --------------------------------------------

    def _damped(self, p: _Peer, now_mono: float) -> bool:
        while p.flap_times and now_mono - p.flap_times[0] > p.flap_window_s:
            p.flap_times.popleft()
        return len(p.flap_times) >= p.flap_max

    def _evaluate_keys(self, keys, *, force: bool = False
                       ) -> List[tuple]:
        """Evaluate the named peers' evidence; returns the transition
        callbacks to fire (outside the lock). ``force`` probes poll
        peers even when their poll interval hasn't elapsed (the
        synchronous-refresh path)."""
        now_mono = time.monotonic()
        fired: List[tuple] = []
        # Poll evidence runs OUTSIDE the detector lock (a poll_fn
        # takes engine locks; an age_fn may do a KV round-trip).
        with self._lock:
            peers = [self._peers[k] for k in keys if k in self._peers]
        evidence: Dict[str, tuple] = {}
        due: List[_Peer] = []
        for p in peers:
            fresh = (force
                     or now_mono - p.last_poll_mono >= p.poll_s)
            if not fresh and p.age_fn is not None:
                # Age evidence not due this sweep: hold the peer's
                # state untouched. Gating BOTH evidence kinds on the
                # per-peer poll_s keeps a coexisting fast poll peer
                # (a router replica) from driving every age peer's
                # KV round-trip — and its recovery hysteresis — at
                # the global minimum sweep cadence.
                continue
            due.append(p)
            if not fresh:
                continue   # poll peer ages via ev=None below
            try:
                if p.age_fn is not None:
                    evidence[p.key] = ("age", float(p.age_fn()))
                else:
                    evidence[p.key] = ("poll", bool(p.poll_fn()))
            except _EVIDENCE_ERRORS as e:
                evidence[p.key] = ("error", repr(e))
        with self._lock:
            for p in due:
                if p.key not in self._peers:
                    continue   # unregistered mid-evaluation
                fired.extend(self._apply_evidence(
                    p, evidence.get(p.key), now_mono))
        return fired

    def _apply_evidence(self, p: _Peer, ev, now_mono: float):
        """Fold one evidence observation into the peer's state.
        Returns transition tuples to fire. Lock held."""
        clock_now = p.clock()
        unavailable = False
        if ev is None:
            # Poll not due this sweep: age since the last good poll.
            age = (0.0 if p.last_poll_ok
                   else clock_now - p.last_ok_clock)
        elif ev[0] == "age":
            p.last_poll_mono = now_mono
            age = ev[1]
            if age > p.suspect_after:
                p.note("stale", age_s=round(age, 4))
        elif ev[0] == "poll":
            p.last_poll_mono = now_mono
            p.last_poll_ok = ev[1]
            if ev[1]:
                p.last_ok_clock = clock_now
                age = 0.0
            else:
                age = clock_now - p.last_ok_clock
                p.note("poll_bad", age_s=round(age, 4))
        else:   # evidence error: cannot see the peer
            unavailable = True
            age = p.last_age
            p.note("evidence_error", error=ev[1])
        p.last_age = age
        stalled = clock_now < p.stall_until
        if unavailable:
            # "I can't see the peer" caps at SUSPECT — never DEAD on
            # missing evidence (the split-brain guard) — and never
            # DEMOTES an existing DEAD verdict either: only a real
            # proof of life resurrects a corpse (an observer whose
            # KV flakes mid-resize must not flap a dead member back
            # into the world, re-cutting a flight bundle per flip).
            target = DEAD if p.state == DEAD else SUSPECT
        elif age > p.dead_after:
            target = DEAD
        elif age > p.suspect_after or stalled:
            target = SUSPECT
        else:
            target = ALIVE
        out = []
        if target == ALIVE and p.state != ALIVE:
            # Recovery is hysteresis- and damping-gated; death and
            # suspicion never are (evidence drives them immediately).
            # Only FRESH evidence counts toward the good streak — a
            # cached (ev=None) evaluation re-reading one lucky poll
            # must not satisfy "consecutive good observations".
            if ev is None:
                return out
            p.good_streak += 1
            if (p.good_streak < p.hysteresis
                    or self._damped(p, now_mono)):
                return out
            p.flap_times.append(now_mono)
            p.flaps += 1
            out.append(self._transition(p, ALIVE, age))
            return out
        if target != ALIVE:
            p.good_streak = 0
        if target != p.state:
            out.append(self._transition(p, target, age))
        return out

    def _transition(self, p: _Peer, new: str, age: float) -> tuple:
        old, p.state = p.state, new
        p.note("transition", frm=old, to=new, age_s=round(age, 4))
        return (p, old, new, age)

    # -- the sweep -----------------------------------------------------

    def sweep_once(self) -> None:
        """One evaluation pass over every peer (the background
        thread's body; callable directly from tests)."""
        with self._lock:
            keys = list(self._peers)
            self.sweeps += 1
        self._fire(self._evaluate_keys(keys))
        self._publish_gauges()

    def _fire(self, fired: List[tuple]) -> None:
        """Emit metrics/events/flight bundles and run subscriber
        callbacks for a batch of transitions — all outside the lock
        (callbacks take consumer locks; a DEAD bundle does I/O)."""
        if not fired:
            return
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        from horovod_tpu_torch.obs import events as _events
        from horovod_tpu_torch.obs import flightrec as _flightrec
        m = _obs_catalog.detector_metrics()
        for p, old, new, age in fired:
            m["transitions"].inc(peer=p.label, to=new)
            if new == ALIVE:
                m["flaps"].inc(peer=p.label)
                _events.emit("detector.recovered", peer=p.label,
                             frm=old, flaps=p.flaps)
            elif new == SUSPECT:
                _events.emit("detector.suspect", peer=p.label,
                             frm=old, evidence_age_s=round(age, 4))
            else:
                _events.emit("detector.dead", peer=p.label, frm=old,
                             evidence_age_s=round(age, 4))
                # The postmortem bundle: this peer's full evidence
                # timeline (beats, polls, stalls, transitions), so
                # 03:12-you can tell true death from partition.
                _flightrec.trigger(
                    "detector.dead", peer=p.label, key=p.key,
                    evidence_age_s=round(age, 4),
                    timeline=list(p.timeline))
            cb = p.on_transition
            if cb is not None:
                try:
                    cb(p.key, old, new, self.view(p.key))
                except _EVIDENCE_ERRORS:
                    pass   # a consumer's bug must not kill the sweep

    def _publish_gauges(self) -> None:
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        m = _obs_catalog.detector_metrics()
        with self._lock:
            counts = {ALIVE: 0, SUSPECT: 0, DEAD: 0}
            for p in self._peers.values():
                counts[p.state] += 1
        for state, n in counts.items():
            m["peers"].set(n, state=state)
        m["sweeps"].inc()

    def _interval(self) -> float:
        with self._lock:
            polls = [p.poll_s for p in self._peers.values()]
        return max(_MIN_SWEEP_S,
                   min(polls) if polls else max(0.25, self.sweep_s))

    def _sweep_loop(self):
        while not self._stop.is_set():
            self._wake.wait(self._interval())
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep_once()
            except _EVIDENCE_ERRORS:
                continue   # the detector IS the recovery path

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# The process-shared instance: one sweep thread per host, however many
# routers/monitors consume it.
# ---------------------------------------------------------------------------

_SHARED: Optional[FailureDetector] = None
_SHARED_LOCK = lockcheck.register(
    "detector._SHARED_LOCK", threading.Lock())


def shared_detector() -> FailureDetector:
    """The process-global detector every consumer registers into —
    a host running a router fleet plus training membership gets
    exactly ONE sweep thread."""
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None:
            _SHARED = FailureDetector()
        return _SHARED


def install_detector(d: Optional[FailureDetector]
                     ) -> Optional[FailureDetector]:
    """Swap the shared detector, returning the previous one (the
    scoped test pattern — same contract as `membership.install_kv`)."""
    global _SHARED
    with _SHARED_LOCK:
        prev, _SHARED = _SHARED, d
        return prev
