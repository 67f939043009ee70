"""horovod_tpu_torch.obs — the observability plane (host-side copy of
the JAX package's):

* `registry` (counters, gauges, histograms), `catalog` (the metric
  families), `events` (structured event log), `spans`/`tracing`
  (request trace ids and causal spans), `flightrec` (the crash flight
  recorder), `reqlog` (request record/replay) and `slo` (burn-rate
  objectives);
* `exporter` — stdlib HTTP daemon: Prometheus text at ``/metrics``,
  liveness at ``/healthz``, full JSON at ``/metrics.json``, the fleet
  view at ``/fleet``. Enable with ``HVD_METRICS_PORT``.
* `aggregate` — the fleet layer: a rank-0 collector merging every
  rank's histograms bucket by bucket (``HVD_FLEET_RANKS``).
* `straggler` — collective straggler attribution from the eager ops'
  dispatch timing windows (``HVD_STRAGGLER_CYCLES``).
* `profiling` — `profile_step` brackets + the opt-in `torch.profiler`
  session (``HVD_PROFILE_DIR``), analyzed by
  `utils.profile_analysis`.
"""

# NOTE: `flightrec` is deliberately NOT imported here — it is also a
# `python -m horovod_tpu_torch.obs.flightrec` CLI, and importing it
# from the package __init__ would make runpy warn about the double
# import. `from horovod_tpu_torch.obs import flightrec` still works.
from horovod_tpu_torch.obs import (aggregate, catalog, events, slo,
                                   straggler, tracing)
from horovod_tpu_torch.obs.aggregate import FleetAggregator, rank_snapshot
from horovod_tpu_torch.obs.exporter import (MetricsServer,
                                            render_prometheus,
                                            start_exporter, stop_exporter)
from horovod_tpu_torch.obs.profiling import (StepProfiler, profile_step,
                                             profiler_session)
from horovod_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                            MetricRegistry, registry)
from horovod_tpu_torch.obs.slo import Objective, SLOMonitor

__all__ = [
    "registry", "MetricRegistry", "Counter", "Gauge", "Histogram",
    "catalog", "events", "tracing",
    "aggregate", "straggler", "slo",
    "FleetAggregator", "rank_snapshot", "SLOMonitor", "Objective",
    "MetricsServer", "render_prometheus", "start_exporter",
    "stop_exporter",
    "StepProfiler", "profile_step", "profiler_session",
]
