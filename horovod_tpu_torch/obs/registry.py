"""Process-wide metric registry: Counter / Gauge / Histogram.

The observability plane's core (docs/observability.md). Horovod's
original pitch was making distributed training *inspectable* (the
Timeline is a headline feature of arXiv:1802.05799 §6), and operating
MLPerf-scale pods demands continuous monitoring of step time,
throughput and stragglers (arXiv:1909.09756) — but before this layer
every subsystem kept its own private counters (`EngineMetrics`,
resilience dicts, `StallMonitor` stderr lines). The registry is the
one place they all land, so ONE scrape answers "how is the process
behaving" across serving, resilience and training.

Design rules:

* **Thread-safe, lock-per-metric.** Writers are submit threads, the
  serving dispatch thread, watchdogs and training loops; a scrape
  must never see a torn histogram (bucket counts vs ``_count``).
* **Fixed log-scale histogram buckets.** Every rank/process uses the
  same bucket edges (`DEFAULT_BUCKETS`, powers of two from 0.1 ms to
  ~3.5 min), so histograms MERGE by adding counts — percentiles
  aggregate across ranks without shipping samples, unlike a
  reservoir, and estimation is O(buckets), not O(n log n) per read.
* **Get-or-create.** `registry().counter(name, ...)` returns the
  existing metric when the declaration matches (kind + label names);
  subsystems and the pre-declared catalog can both "declare" the same
  family without coordination. Kind/label conflicts raise.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "DEFAULT_BUCKETS", "registry", "quantile_from_buckets",
]

# Fixed log-scale (base-2) bucket upper bounds, in the metric's native
# unit (seconds for every latency family): 0.1 ms .. ~209 s. Fixed
# and shared so per-rank histograms merge by adding counts.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * 2 ** i for i in range(22))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# What a pull-time callback (Gauge.set_fn, health providers) may
# raise and still cost only its own value, never the scrape: the
# exporter renders NaN / flags the provider degraded instead of
# tearing the HTTP response down. Deliberately wide — a metrics
# callback reading live engine state can plausibly hit any of these.
_CALLBACK_ERRORS = (RuntimeError, ValueError, TypeError,
                    AttributeError, KeyError, IndexError,
                    ArithmeticError, OSError)


def _label_key(labelnames: Tuple[str, ...],
               labels: Dict[str, str]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label "
            f"names {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Shared child bookkeeping; `kind` distinguishes render/typing."""

    kind = "untyped"

    def __init__(self, name: str, doc: str,
                 labelnames: Tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # Unlabeled metrics expose their zero value immediately —
            # a scrape shows the family even before the first event.
            self._child(())

    def _new_child(self):
        return 0.0

    def _child(self, key: Tuple[str, ...]):
        """Get-or-create one labeled child. LOCK-HELD helper: every
        caller (observe/merge_counts, and __init__ pre-sharing)
        acquires ``self._lock`` first — the lock is not reentrant, so
        this must not re-take it."""
        child = self._children.get(key)
        if child is None:
            # hvd: disable=HVD004(lock-held helper by contract — all callers own self._lock; __init__ runs pre-sharing)
            child = self._children[key] = self._new_child()
        return child

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels, child-state)] snapshot, stable order."""
        with self._lock:
            items = sorted(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]

    def remove(self, **labels):
        """Drop one labeled child (e.g. a shut-down engine's gauge
        row) so the scrape's cardinality tracks LIVE label values
        instead of growing per dead instance. No-op when absent."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._children.pop(key, None)


class Counter(_Metric):
    """Monotonic counter (`*_total` by convention)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._children.get(key, 0.0)


class Gauge(_Metric):
    """Point-in-time value; `set_fn` registers a pull-time callback
    (evaluated at collect) for values cheaper to read than to push."""

    kind = "gauge"

    def __init__(self, name, doc, labelnames=()):
        super().__init__(name, doc, labelnames)
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._children[key] = float(v)

    def inc(self, n: float = 1, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def set_fn(self, fn: Optional[Callable[[], float]]):
        if self.labelnames:
            raise ValueError(
                f"set_fn requires an unlabeled gauge ({self.name})")
        with self._lock:
            self._fn = fn

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        # The callback runs OUTSIDE the (non-reentrant) lock, like
        # samples(): a set_fn that touches its own gauge must not
        # deadlock, and a slow callback must not block writers.
        with self._lock:
            fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except _CALLBACK_ERRORS:
                return float("nan")
        with self._lock:
            return self._children.get(key, 0.0)

    def samples(self):
        with self._lock:
            fn = self._fn
        if fn is not None:
            try:
                v = float(fn())
            except _CALLBACK_ERRORS:
                v = float("nan")
            return [({}, v)]
        return super().samples()


class _HistChild:
    __slots__ = ("counts", "sum", "count", "exemplar")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.exemplar: Optional[Dict] = None


def quantile_from_buckets(buckets: Iterable[float],
                          counts: Iterable[int],
                          q: float) -> Optional[float]:
    """Estimate the q-quantile (q in [0, 1]) from cumulative-free
    per-bucket counts (last entry = the +Inf bucket). Log-linear
    interpolation inside the winning bucket — the merge-friendly
    percentile that replaces sorting a reservoir. None when empty."""
    buckets = list(buckets)
    counts = list(counts)
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(buckets):         # +Inf bucket: clamp to edge
                return buckets[-1]
            hi = buckets[i]
            lo = buckets[i - 1] if i > 0 else hi / 2.0
            frac = (rank - (cum - c)) / c
            if lo <= 0:
                return hi * frac
            # interpolate in log space (buckets are log-scaled)
            return math.exp(math.log(lo)
                            + frac * (math.log(hi) - math.log(lo)))
    return buckets[-1]


class Histogram(_Metric):
    """Fixed-bucket histogram with optional per-child exemplar (the
    last observation's trace context, the metrics leg of request
    tracing — docs/observability.md)."""

    kind = "histogram"

    def __init__(self, name, doc, labelnames=(),
                 buckets: Optional[Tuple[float, ...]] = None):
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(
                f"histogram {name} buckets must be strictly "
                f"increasing")
        super().__init__(name, doc, labelnames)

    def _new_child(self):
        return _HistChild(len(self.buckets))

    def observe(self, v: float, exemplar: Optional[Dict] = None,
                **labels):
        v = float(v)
        key = _label_key(self.labelnames, labels)
        # bisect without importing: buckets are tiny (<= 22)
        i = 0
        while i < len(self.buckets) and v > self.buckets[i]:
            i += 1
        with self._lock:
            child = self._child(key)
            child.counts[i] += 1
            child.sum += v
            child.count += 1
            if exemplar is not None:
                child.exemplar = dict(exemplar, value=v,
                                      ts=time.time())

    def samples(self):
        """Histogram children are MUTABLE (observe updates counts/
        sum/count in place), so unlike the scalar metrics the base
        dict copy is not enough — snapshot each child under the lock
        or a concurrent observe could tear the +Inf-==-count
        invariant a scrape is asserting."""
        with self._lock:
            items = []
            for key, child in sorted(self._children.items()):
                snap = _HistChild(len(self.buckets))
                snap.counts = list(child.counts)
                snap.sum = child.sum
                snap.count = child.count
                snap.exemplar = (dict(child.exemplar)
                                 if child.exemplar else None)
                items.append((key, snap))
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]

    def quantile(self, q: float, **labels) -> Optional[float]:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            counts = list(child.counts) if child else None
        if not counts:
            return None
        return quantile_from_buckets(self.buckets, counts, q)

    def summary(self, scale: float = 1.0, nd: int = 2,
                **labels) -> Dict:
        """{p50, p95, p99, mean, n} estimated from the buckets —
        the same shape `serving.metrics.Series.summary` reports."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None or child.count == 0:
                return {"p50": None, "p95": None, "p99": None,
                        "mean": None, "n": 0}
            counts, total, s = list(child.counts), child.count, child.sum
        out = {f"p{int(q * 100)}": round(
                   quantile_from_buckets(self.buckets, counts, q)
                   * scale, nd)
               for q in (0.50, 0.95, 0.99)}
        out.update({"mean": round(s / total * scale, nd), "n": total})
        return out

    def merge_counts(self, counts: List[int], total_sum: float,
                     **labels):
        """Fold another rank's bucket counts into this child — the
        cross-rank aggregation fixed buckets exist for."""
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"histogram {self.name}: merge expects "
                f"{len(self.buckets) + 1} buckets, got {len(counts)}")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._child(key)
            for i, c in enumerate(counts):
                child.counts[i] += c
            child.count += sum(counts)
            child.sum += total_sum


class MetricRegistry:
    """Named metrics + liveness ("health") providers.

    `registry()` returns the process singleton every subsystem and the
    exporters share; tests may build private instances.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._health: Dict[str, Callable[[], Dict]] = {}
        self._t0 = time.time()

    # -- declaration (get-or-create) ----------------------------------

    def _get_or_create(self, cls, name, doc, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {cls.kind}")
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} label names "
                        f"{m.labelnames} != {tuple(labelnames)}")
                want = kw.get("buckets")
                if want is not None and tuple(want) != m.buckets:
                    # Silently handing back the existing edges would
                    # corrupt a later merge_counts sized for the
                    # requested ones — conflict, like kind/labels.
                    raise ValueError(
                        f"histogram {name!r} already registered "
                        f"with buckets {m.buckets}, not "
                        f"{tuple(want)}")
                return m
            m = cls(name, doc, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, doc: str,
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, doc, labelnames)

    def gauge(self, name: str, doc: str,
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, doc, labelnames)

    def histogram(self, name: str, doc: str,
                  labelnames: Tuple[str, ...] = (),
                  buckets: Optional[Tuple[float, ...]] = None
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, doc, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- health providers ---------------------------------------------

    def register_health(self, key: str, fn: Callable[[], Dict]):
        """Attach a liveness provider (e.g. a serving engine reporting
        its dispatch generation) surfaced at ``/healthz``."""
        with self._lock:
            self._health[key] = fn

    def unregister_health(self, key: str):
        with self._lock:
            self._health.pop(key, None)

    def health(self) -> Dict:
        with self._lock:
            providers = dict(self._health)
        out = {"status": "ok",
               "uptime_s": round(time.time() - self._t0, 3)}
        detail = {}
        for key, fn in sorted(providers.items()):
            try:
                detail[key] = fn()
                # A provider may self-report unhealthiness (e.g. a
                # dead dispatch thread) via a `healthy: false` field
                # — that degrades the plane just like an exception,
                # so /healthz turns probe-visible (503).
                if detail[key].get("healthy") is False:
                    out["status"] = "degraded"
            except _CALLBACK_ERRORS as e:
                detail[key] = {"error": repr(e)}
                out["status"] = "degraded"
        if detail:
            out["components"] = detail
        return out

    # -- JSON snapshot (the /metrics.json exporter body) --------------

    def to_json(self) -> Dict:
        out = {}
        for m in self.collect():
            fam = {"type": m.kind, "doc": m.doc,
                   "labelnames": list(m.labelnames), "samples": []}
            for labels, child in m.samples():
                if m.kind == "histogram":
                    sample = {
                        "labels": labels,
                        "count": child.count,
                        "sum": round(child.sum, 6),
                        "buckets": {
                            ("+Inf" if i == len(m.buckets)
                             else repr(m.buckets[i])): c
                            for i, c in enumerate(child.counts)},
                        "quantiles": {
                            f"p{int(q * 100)}": quantile_from_buckets(
                                m.buckets, child.counts, q)
                            for q in (0.5, 0.95, 0.99)},
                    }
                    if child.exemplar is not None:
                        sample["exemplar"] = dict(child.exemplar)
                    fam["samples"].append(sample)
                else:
                    fam["samples"].append(
                        {"labels": labels, "value": child})
            out[m.name] = fam
        return out


_REGISTRY = MetricRegistry()


def registry() -> MetricRegistry:
    """The process-global registry (serving, resilience, training and
    the exporters all share it)."""
    return _REGISTRY
