"""Collective straggler attribution — who is slowing the fleet down.

The reference's stall check answers "a collective is STUCK"; at pod
scale the operationally expensive question is the softer one — "which
rank is consistently SLOW" (arXiv:1909.09756:
scaling efficiency dies by stragglers long before it dies by
deadlocks). This module answers it from the host side:

* Every eager collective dispatch (`ops/eager.py::_run_collective`)
  and every fusion-buffer cycle (the train step hosting the bucketed
  allreduce — `models/train.py::_obs_step`) records its host-side
  enter→exit time into the process tracker. Under CUDA's async
  launches that is DISPATCH latency, not device completion — but a
  rank parked on a dead peer's rendezvous, a chaos ``collective_slow``
  delay, or host-side input stalls all land exactly here, which is
  the skew that matters.
* Every ``HVD_STRAGGLER_CYCLES`` records (default 64; 0 disables) the
  tracker closes its timing WINDOW and exchanges it: in-process
  consumers (`obs.aggregate`'s fleet collector, tests) merge windows
  from simulated ranks directly via `merge_windows`; a
  multi-controller deployment can install a real allgather with
  `install_exchange` (the payload is one tiny dict per rank — cheap
  by construction, the reason windows exist instead of per-dispatch
  traffic).
* The merged `report` names the slowest rank, the cross-rank skew of
  mean dispatch time (observed into ``hvd_collective_skew_seconds``),
  and whether the spread looks like a STRAGGLER (slowest ≥ 2x the
  fastest mean). The newest report is kept for the `StallMonitor`,
  which links it into its stall events — a stall warning now arrives
  with the prime suspect attached.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.analysis import lockcheck

__all__ = ["StragglerTracker", "tracker", "merge_windows",
           "install_exchange", "last_report", "STRAGGLER_FACTOR"]

# A rank reads as THE straggler (not just the max of a tight spread)
# when its mean dispatch time is at least this multiple of the
# fastest rank's mean.
STRAGGLER_FACTOR = 2.0


def _local_rank() -> int:
    """This process's rank, 0 when the runtime is uninitialized (the
    single-process default)."""
    try:
        from horovod_tpu_torch.runtime import state as _state
        st = _state.global_state()
        return int(st.rank) if st.initialized else 0
    except (ImportError, AttributeError, RuntimeError):
        return 0


def _expected_ranks() -> Optional[int]:
    """The world size an exchange should hear from (None when the
    runtime is uninitialized or single-process) — lets the merged
    report flag ranks that stopped reporting entirely."""
    try:
        from horovod_tpu_torch.runtime import state as _state
        st = _state.global_state()
        if st.initialized and int(st.size) > 1:
            return int(st.size)
    except (ImportError, AttributeError, RuntimeError, ValueError):
        pass
    return None


def merge_windows(windows: List[Dict],
                  expected_ranks: Optional[int] = None
                  ) -> Optional[Dict]:
    """Fold per-rank timing windows into one straggler report.

    Each window is a `StragglerTracker.window_snapshot()` dict
    (``rank``, ``n``, ``total_s``, ``max_s``, ``ops``). Returns None
    when no window carries a single timed dispatch; otherwise::

        {"ranks": K, "slowest_rank": r, "fastest_rank": r2,
         "skew_s": max_mean - min_mean, "straggler": bool,
         "per_rank": {rank: {"n", "total_s", "mean_s", "max_s"}}}

    Churn-tolerant by contract: a rank that died mid-window costs its
    contribution, never the merge — ``None``/empty/partial entries in
    ``windows`` (an allgather slot a dead peer never filled, a
    snapshot missing ``total_s``) degrade to the surviving ranks'
    report rather than raising. Pass ``expected_ranks`` (the world
    size) to have the report additionally FLAG who is absent:
    ``missing_ranks`` lists every rank 0..expected-1 that contributed
    nothing — a stall warning naming the straggler should also name
    the rank that stopped reporting entirely (it is usually the real
    suspect).

    Pure function — the in-process leg `dryrun`-style tests and the
    fleet aggregator both call it on simulated rank windows.
    """
    per_rank: Dict[int, Dict] = {}
    for w in windows:
        if not w or not w.get("n"):
            continue
        try:
            r = int(w.get("rank", 0))
            n = int(w["n"])
            total = float(w.get("total_s", 0.0))
            mx = float(w.get("max_s", 0.0))
        except (TypeError, ValueError):
            continue   # malformed (truncated mid-death) window
        cur = per_rank.setdefault(
            r, {"n": 0, "total_s": 0.0, "max_s": 0.0})
        cur["n"] += n
        cur["total_s"] += total
        cur["max_s"] = max(cur["max_s"], mx)
    if not per_rank:
        return None
    for stats in per_rank.values():
        stats["mean_s"] = stats["total_s"] / stats["n"]
    slowest = max(per_rank, key=lambda r: per_rank[r]["mean_s"])
    fastest = min(per_rank, key=lambda r: per_rank[r]["mean_s"])
    lo = per_rank[fastest]["mean_s"]
    hi = per_rank[slowest]["mean_s"]
    out = {
        "ranks": len(per_rank),
        "slowest_rank": slowest,
        "fastest_rank": fastest,
        "skew_s": hi - lo,
        # A one-rank window has no cross-rank spread to accuse.
        "straggler": (len(per_rank) > 1
                      and hi >= STRAGGLER_FACTOR * max(lo, 1e-12)),
        "per_rank": {r: {k: (round(v, 6) if isinstance(v, float)
                             else v)
                         for k, v in stats.items()}
                     for r, stats in sorted(per_rank.items())},
    }
    if expected_ranks is not None:
        out["expected_ranks"] = int(expected_ranks)
        out["missing_ranks"] = sorted(
            set(range(int(expected_ranks))) - set(per_rank))
    return out


class StragglerTracker:
    """Per-process collective timing accumulator.

    ``record(op, dt_s)`` is the hot-path hook — one lock, two adds;
    every ``window`` records it closes the window and runs an
    exchange (outside the lock, reentrancy-guarded: an exchange
    implemented over an eager allgather re-enters `record` for its
    own dispatch and must neither deadlock nor recurse).
    """

    def __init__(self, rank: Optional[int] = None, *,
                 window: Optional[int] = None,
                 exchange_fn: Optional[
                     Callable[[Dict], List[Dict]]] = None):
        if window is None:
            from horovod_tpu_torch.runtime.config import env_int
            window = env_int("HVD_STRAGGLER_CYCLES", 64)
        self._rank = rank
        self.window = int(window)
        # exchange_fn(local_window) -> [window, ...] across ranks;
        # None = local-only (the single-process default — the fleet
        # aggregator then merges windows it pulled itself).
        self.exchange_fn = exchange_fn
        self._lock = lockcheck.register(
            "StragglerTracker._lock", threading.Lock())
        self._ops: Dict[str, List[float]] = {}  # op -> [n, total, max]
        self._n = 0
        self._t0 = time.time()
        # Thread id of the thread currently running an exchange, or
        # None. Thread-SCOPED, not a global flag: only the exchange's
        # own recursive dispatch (an allgather-based exchange_fn
        # re-entering record) must be skipped — other threads'
        # collectives during a slow exchange are real samples and
        # dropping them would bias the very skew being measured.
        self._exchanging_in: Optional[int] = None
        self._last_report: Optional[Dict] = None

    @property
    def rank(self) -> int:
        return self._rank if self._rank is not None else _local_rank()

    def record(self, op: str, dt_s: float):
        """One collective dispatch's host-side enter→exit duration."""
        dt_s = float(dt_s)
        me = threading.get_ident()
        exchange_due = False
        with self._lock:
            if self._exchanging_in == me:
                # THIS thread's in-flight exchange dispatching its
                # own allgather: timing it would recurse the window
                # forever. Other threads keep recording.
                return
            cur = self._ops.setdefault(op, [0, 0.0, 0.0])
            cur[0] += 1
            cur[1] += dt_s
            cur[2] = max(cur[2], dt_s)
            self._n += 1
            if (self.window > 0 and self._n >= self.window
                    and self._exchanging_in is None):
                exchange_due = True
                self._exchanging_in = me
        if exchange_due:
            try:
                self.exchange()
            finally:
                with self._lock:
                    self._exchanging_in = None

    def window_snapshot(self, *, reset: bool = False) -> Dict:
        """The current window as a mergeable dict (what `rank_snapshot`
        embeds and `merge_windows` consumes)."""
        with self._lock:
            ops = {op: {"n": c[0], "total_s": round(c[1], 6),
                        "max_s": round(c[2], 6)}
                   for op, c in sorted(self._ops.items())}
            out = {
                "rank": self.rank,
                "t0": round(self._t0, 3),
                "t1": round(time.time(), 3),
                "n": self._n,
                "total_s": round(sum(c[1]
                                     for c in self._ops.values()), 6),
                "max_s": max([c[2] for c in self._ops.values()],
                             default=0.0),
                "ops": ops,
            }
            if reset:
                self._ops = {}
                self._n = 0
                self._t0 = time.time()
        return out

    def exchange(self, windows: Optional[List[Dict]] = None
                 ) -> Optional[Dict]:
        """Close the current window, merge it with the other ranks'
        (via ``windows`` when the caller already gathered them, else
        ``exchange_fn``, else local-only), publish the skew metrics,
        and keep the report for the StallMonitor link."""
        local = self.window_snapshot(reset=True)
        if windows is None:
            fn = self.exchange_fn
            if fn is not None:
                try:
                    windows = list(fn(local))
                except _EXCHANGE_ERRORS:
                    windows = [local]   # degraded: local-only report
            else:
                windows = [local]
        report = merge_windows(windows,
                               expected_ranks=_expected_ranks())
        if report is None:
            return None
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        m = _obs_catalog.collective_metrics()
        m["exchanges"].inc()
        m["skew"].observe(report["skew_s"])
        m["straggler_rank"].set(report["slowest_rank"])
        if report["straggler"]:
            from horovod_tpu_torch.obs import events as _events
            _events.emit(
                "collective.straggler",
                slowest_rank=report["slowest_rank"],
                skew_s=round(report["skew_s"], 6),
                ranks=report["ranks"])
        if report["straggler"] or report.get("missing_ranks"):
            # Collective-stall attribution is failure EVIDENCE: feed
            # the unified detector (resilience/detector.py) so a rank
            # that stopped reporting (or is consistently slow) reads
            # SUSPECT to every consumer — soft evidence only, never a
            # death verdict (the heartbeat lease owns that).
            try:
                from horovod_tpu_torch.resilience import detector as _det
                _det.shared_detector().ingest_stall_report(report)
            except _EXCHANGE_ERRORS:
                pass   # evidence is best-effort; the report stands
        with self._lock:
            self._last_report = report
        return report

    def last_report(self) -> Optional[Dict]:
        with self._lock:
            return dict(self._last_report) if self._last_report else None


# What a pluggable exchange may raise and still only cost THIS
# window's cross-rank view (degrade to a local report, never fail the
# collective that triggered the exchange).
_EXCHANGE_ERRORS = (RuntimeError, ValueError, TypeError, OSError,
                    AttributeError, KeyError)


_TRACKER: Optional[StragglerTracker] = None
_TRACKER_LOCK = lockcheck.register(
    "straggler._TRACKER_LOCK", threading.Lock())


def tracker() -> StragglerTracker:
    """The process-global tracker `_run_collective` and the train-step
    bracket record into."""
    global _TRACKER
    with _TRACKER_LOCK:
        if _TRACKER is None:
            _TRACKER = StragglerTracker()
        return _TRACKER


def install(t: Optional[StragglerTracker]
            ) -> Optional[StragglerTracker]:
    """Swap the global tracker, returning the previous one (the scoped
    pattern tests use — same contract as `events.install`)."""
    global _TRACKER
    with _TRACKER_LOCK:
        prev, _TRACKER = _TRACKER, t
        return prev


def install_exchange(fn: Optional[Callable[[Dict], List[Dict]]]):
    """Attach a cross-rank window exchange to the global tracker —
    e.g. an eager-allgather of the tiny window dict under a
    multi-controller launch. The in-process default (None) keeps
    windows local; `obs.aggregate` then merges what it pulls."""
    tracker().exchange_fn = fn


def last_report() -> Optional[Dict]:
    """The newest merged straggler report (None before any exchange)
    — what the StallMonitor attaches to its stall events."""
    t = _TRACKER
    return t.last_report() if t is not None else None
