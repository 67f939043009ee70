"""Fleet-level cross-rank metric aggregation.

The metric registry was built to merge — fixed log-scale histogram
buckets, ``merge_counts`` — but every rank still exported in
isolation. This module is the consumer: a rank-0 (or sidecar)
collector that pulls each rank's metric snapshot, folds the
histograms together bucket-by-bucket, and answers the two questions a
per-rank scrape cannot:

* **fleet percentiles** — "what is TTFT p95 across the POD", from
  summed bucket counts (``hvd_fleet_*`` families; exact with respect
  to the shared bucket resolution, no sample shipping);
* **cross-rank skew** — "which rank is off the pack", as
  ``hvd_rank_skew_*`` gauges (max - min across ranks per metric; for
  histograms the spread of per-rank MEANS) plus the merged collective
  straggler report (`obs.straggler`) naming the slowest rank.

Sources are pluggable: in-process registries (``add_registry`` — the
`dryrun_multichip` / test mode), snapshot callables, or the existing
exporter HTTP endpoints (``add_endpoint`` pulls ``/metrics.json`` —
multi-process mode; list the per-rank exporters in
``HVD_FLEET_RANKS``). The exporter serves the collected view at
``/fleet`` (Prometheus text) and ``/fleet.json``.

A collect is CHURN-TOLERANT by contract: ranks may be mid-engine-
shutdown (gauge rows vanishing between passes), unreachable, or
running an older schema — each failure costs that rank's contribution
(counted in ``hvd_fleet_ranks_failed``), never the scrape.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch.obs import catalog as _catalog
from horovod_tpu_torch.obs import straggler as _straggler
from horovod_tpu_torch.obs.registry import MetricRegistry, registry

from horovod_tpu_torch.analysis import lockcheck

__all__ = ["rank_snapshot", "FleetAggregator", "FleetSnapshot",
           "install", "default_aggregator", "SNAPSHOT_SCHEMA"]

SNAPSHOT_SCHEMA = 1

# What pulling one rank's snapshot may raise and cost only that rank:
# network faults (URLError IS-A OSError), JSON decode errors, schema
# surprises while a rank restarts mid-scrape.
_FETCH_ERRORS = (OSError, ValueError, TypeError, KeyError)


def rank_snapshot(reg: Optional[MetricRegistry] = None, *,
                  rank: Optional[int] = None,
                  collectives: Optional[Dict] = None) -> Dict:
    """One rank's mergeable snapshot — the unit the fleet collector
    pulls (in-process directly; over HTTP it is the ``/metrics.json``
    body, which carries the same keys)."""
    reg = reg or registry()
    tr = _straggler.tracker()
    return {
        "schema": SNAPSHOT_SCHEMA,
        "rank": tr.rank if rank is None else int(rank),
        "ts": round(time.time(), 6),
        "metrics": reg.to_json(),
        "collectives": (tr.window_snapshot() if collectives is None
                        else collectives),
    }


def _parse_hist_sample(sample: Dict
                       ) -> Optional[Tuple[Tuple[float, ...],
                                           List[int], float]]:
    """Reconstruct (edges, counts incl. +Inf, sum) from a to_json
    histogram sample's bucket map. None when the map is malformed —
    the merge then skips this child rather than corrupting the fleet
    family."""
    buckets = sample.get("buckets")
    if not isinstance(buckets, dict) or "+Inf" not in buckets:
        return None
    try:
        edges = sorted(float(k) for k in buckets if k != "+Inf")
        counts = [int(buckets[k]) for k in
                  sorted((k for k in buckets if k != "+Inf"),
                         key=float)]
        counts.append(int(buckets["+Inf"]))
    except (ValueError, TypeError):
        return None
    return tuple(edges), counts, float(sample.get("sum", 0.0))


def _fleet_name(name: str, prefix: str) -> str:
    """hvd_serving_ttft_seconds -> hvd_<prefix>_serving_ttft_seconds
    (non-hvd names are prefixed wholesale)."""
    if name.startswith("hvd_"):
        return f"hvd_{prefix}_{name[len('hvd_'):]}"
    return f"hvd_{prefix}_{name}"


def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f and abs(f) != float("inf") else None


@dataclass
class FleetSnapshot:
    """One collected fleet view: a private registry holding the
    ``hvd_fleet_*`` / ``hvd_rank_skew_*`` families, plus the merged
    straggler report."""

    registry: MetricRegistry
    ranks: List[int]
    failed: List[str]
    straggler: Optional[Dict]
    ts: float
    notes: List[str] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {
            "schema": SNAPSHOT_SCHEMA,
            "ts": round(self.ts, 6),
            "ranks": self.ranks,
            "ranks_failed": self.failed,
            "straggler": self.straggler,
            "notes": self.notes,
            "metrics": self.registry.to_json(),
        }

    def render_prometheus(self) -> str:
        from horovod_tpu_torch.obs.exporter import render_prometheus
        return render_prometheus(self.registry)


class FleetAggregator:
    """Pulls per-rank snapshots and merges them into a `FleetSnapshot`.

    Thread-safe for the exporter's concurrent scrapes (collect builds
    a fresh output registry each time; source registration is
    locked)."""

    def __init__(self):
        self._lock = lockcheck.register(
            "FleetAggregator._lock", threading.Lock())
        self._sources: List[Tuple[str, Callable[[], Dict]]] = []

    # -- sources ------------------------------------------------------

    def add_registry(self, reg: MetricRegistry,
                     rank: Optional[int] = None) -> "FleetAggregator":
        """In-process source (the `dryrun_multichip` / test mode):
        snapshot `reg` at collect time under rank `rank`."""
        n = len(self._sources) if rank is None else rank
        with self._lock:
            self._sources.append(
                (f"registry:{n}",
                 lambda reg=reg, n=n: rank_snapshot(reg, rank=n)))
        return self

    def add_snapshot_fn(self, fn: Callable[[], Dict],
                        name: Optional[str] = None
                        ) -> "FleetAggregator":
        """Arbitrary snapshot callable returning a `rank_snapshot`-
        shaped dict (simulated ranks, custom transports)."""
        with self._lock:
            self._sources.append(
                (name or f"fn:{len(self._sources)}", fn))
        return self

    def add_endpoint(self, url: str, *,
                     timeout_s: float = 5.0) -> "FleetAggregator":
        """HTTP source: one rank's exporter base URL; collect pulls
        ``<url>/metrics.json`` (the existing endpoint — it carries
        ``rank`` and the straggler window since the fleet PR)."""
        base = url if "//" in url else f"http://{url}"
        base = base.rstrip("/")

        def fetch(base=base, timeout_s=timeout_s):
            import json
            import urllib.request
            with urllib.request.urlopen(base + "/metrics.json",
                                        timeout=timeout_s) as r:
                return json.loads(r.read())

        with self._lock:
            self._sources.append((base, fetch))
        return self

    @property
    def sources(self) -> List[str]:
        with self._lock:
            return [name for name, _ in self._sources]

    # -- the merge ----------------------------------------------------

    def collect(self) -> FleetSnapshot:
        """Pull every source once and merge. Never raises for a
        source fault — a dead rank costs its contribution, counted in
        ``hvd_fleet_ranks_failed``."""
        with self._lock:
            sources = list(self._sources)
        snaps: List[Dict] = []
        failed: List[str] = []
        for idx, (name, fn) in enumerate(sources):
            try:
                snap = fn()
                metrics = snap.get("metrics")
                if not isinstance(metrics, dict):
                    raise ValueError("snapshot has no metrics dict")
                snap.setdefault("rank", idx)
                snaps.append(snap)
            except _FETCH_ERRORS as e:
                failed.append(f"{name}: {e!r}")
        fleet = MetricRegistry()
        notes: List[str] = []
        ranks = [int(s.get("rank", i)) for i, s in enumerate(snaps)]
        own = _catalog.fleet_metrics(fleet)
        own["ranks"].set(len(snaps))
        own["ranks_failed"].set(len(failed))
        self._merge_metrics(fleet, snaps, notes)
        report = _straggler.merge_windows(
            [s.get("collectives") or {} for s in snaps])
        if report is not None:
            # NOT named hvd_fleet_collective_skew_seconds: that name
            # is taken by the MERGE of the per-rank
            # hvd_collective_skew_seconds histograms above.
            strag = _catalog.fleet_straggler_metrics(fleet)
            strag["straggler_rank"].set(report["slowest_rank"])
            strag["straggler_skew"].set(report["skew_s"])
        return FleetSnapshot(registry=fleet, ranks=ranks,
                             failed=failed, straggler=report,
                             ts=time.time(), notes=notes)

    def _merge_metrics(self, fleet: MetricRegistry,
                       snaps: List[Dict], notes: List[str]):
        # family name -> list of (rank, family dict)
        families: Dict[str, List[Tuple[int, Dict]]] = {}
        for snap in snaps:
            r = int(snap.get("rank", 0))
            for name, fam in snap["metrics"].items():
                if isinstance(fam, dict):
                    families.setdefault(name, []).append((r, fam))
        for name in sorted(families):
            per_rank = families[name]
            kinds = {fam.get("type") for _, fam in per_rank}
            if len(kinds) != 1:
                notes.append(f"{name}: mixed types {sorted(kinds)}; "
                             f"skipped")
                continue
            kind = kinds.pop()
            try:
                if kind == "histogram":
                    self._merge_histogram(fleet, name, per_rank,
                                          notes)
                elif kind in ("counter", "gauge"):
                    self._merge_scalar(fleet, name, kind, per_rank)
            except _FETCH_ERRORS as e:
                # One malformed family (a rank mid-restart handing
                # back garbage) must not cost the whole fleet scrape.
                notes.append(f"{name}: merge failed ({e!r}); skipped")

    @staticmethod
    def _labels_key(labels: Dict) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v))
                            for k, v in (labels or {}).items()))

    def _merge_histogram(self, fleet, name, per_rank, notes):
        doc = per_rank[0][1].get("doc", "")
        labelnames = tuple(per_rank[0][1].get("labelnames") or ())
        merged = None
        edges0 = None
        # label key -> rank -> mean (the skew input)
        means: Dict[Tuple, Dict[int, float]] = {}
        for rank, fam in per_rank:
            for sample in fam.get("samples", []):
                parsed = _parse_hist_sample(sample)
                if parsed is None:
                    continue
                edges, counts, total_sum = parsed
                if edges0 is None:
                    edges0 = edges
                    merged = fleet.histogram(
                        _fleet_name(name, "fleet"),
                        f"Fleet-merged (summed buckets): {doc}",
                        labelnames, buckets=edges)
                elif edges != edges0:
                    notes.append(
                        f"{name}: rank {rank} uses different bucket "
                        f"edges; its sample skipped")
                    continue
                labels = {k: str(v) for k, v in
                          (sample.get("labels") or {}).items()}
                if set(labels) != set(labelnames):
                    continue
                merged.merge_counts(counts, total_sum, **labels)
                n = sum(counts)
                if n:
                    means.setdefault(
                        self._labels_key(labels), {})[rank] = (
                        total_sum / n)
        if means:
            skew = fleet.gauge(
                _fleet_name(name, "rank_skew"),
                f"Cross-rank spread of per-rank MEANS (max - min): "
                f"{doc}", labelnames)
            for key, by_rank in means.items():
                if len(by_rank) < 1:
                    continue
                vs = list(by_rank.values())
                skew.set(max(vs) - min(vs), **dict(key))

    def _merge_scalar(self, fleet, name, kind, per_rank):
        doc = per_rank[0][1].get("doc", "")
        labelnames = tuple(per_rank[0][1].get("labelnames") or ())
        # label key -> rank -> value
        values: Dict[Tuple, Dict[int, float]] = {}
        for rank, fam in per_rank:
            for sample in fam.get("samples", []):
                v = _finite(sample.get("value"))
                if v is None:
                    continue   # NaN gauge callbacks, junk
                labels = {k: str(v2) for k, v2 in
                          (sample.get("labels") or {}).items()}
                if set(labels) != set(labelnames):
                    continue
                values.setdefault(
                    self._labels_key(labels), {})[rank] = v
        if not values:
            return
        if kind == "counter":
            fam_out = fleet.counter(
                _fleet_name(name, "fleet"),
                f"Fleet-summed: {doc}", labelnames)
        else:
            fam_out = fleet.gauge(
                _fleet_name(name, "fleet"),
                f"Fleet mean across ranks: {doc}", labelnames)
        skew = fleet.gauge(
            _fleet_name(name, "rank_skew"),
            f"Cross-rank spread (max - min): {doc}", labelnames)
        for key, by_rank in values.items():
            vs = list(by_rank.values())
            labels = dict(key)
            if kind == "counter":
                total = sum(vs)
                if total:
                    fam_out.inc(total, **labels)
            else:
                fam_out.set(sum(vs) / len(vs), **labels)
            skew.set(max(vs) - min(vs), **labels)


# ---------------------------------------------------------------------------
# The process-default aggregator (what the exporter's /fleet serves)
# ---------------------------------------------------------------------------

_FLEET: Optional[FleetAggregator] = None
_FLEET_LOCK = lockcheck.register(
    "aggregate._FLEET_LOCK", threading.Lock())


def install(agg: Optional[FleetAggregator]
            ) -> Optional[FleetAggregator]:
    """Install the aggregator `/fleet` serves (None = back to the
    lazily-built default). Returns the previous one."""
    global _FLEET
    with _FLEET_LOCK:
        prev, _FLEET = _FLEET, agg
        return prev


def default_aggregator() -> FleetAggregator:
    """The `/fleet` endpoint's aggregator: the installed one, else a
    default built once from ``HVD_FLEET_RANKS`` (comma-separated
    per-rank exporter base URLs / host:ports — the rank-0-collector
    deployment), else the local registry alone (a one-host fleet:
    `/fleet` then shows the merged view of every engine in this
    process)."""
    global _FLEET
    with _FLEET_LOCK:
        if _FLEET is None:
            from horovod_tpu_torch.runtime.config import env_str
            agg = FleetAggregator()
            spec = env_str("HVD_FLEET_RANKS").strip()
            if spec:
                for part in spec.split(","):
                    part = part.strip()
                    if part:
                        agg.add_endpoint(part)
            else:
                agg.add_registry(registry())
            _FLEET = agg
        return _FLEET
