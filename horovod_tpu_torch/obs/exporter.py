"""Metric exporters: Prometheus text format + JSON over HTTP.

A stdlib-``http.server`` daemon thread (no dependencies — the same
rule as the rest of the repo) serving three endpoints:

* ``/metrics`` — Prometheus text exposition format 0.0.4: HELP/TYPE
  per family, escaped label values, cumulative histogram ``_bucket``
  series with ``_sum``/``_count``. What a Prometheus scraper or
  ``curl`` reads.
* ``/metrics.json`` — the registry's full JSON snapshot (histogram
  quantile estimates + exemplars included) plus the newest structured
  events, this process's rank and its collective timing window; what
  `bench.py`, the fleet aggregator and humans read.
* ``/healthz`` — liveness + the registered health providers (the
  serving engine reports its dispatch generation here, so a prober
  can tell an in-place watchdog restart from a process restart; an
  SLO monitor in fast burn reads ``healthy: false`` and degrades it).
* ``/fleet`` / ``/fleet.json`` — the cross-rank aggregated view
  (`obs.aggregate`): fleet-merged histograms (``hvd_fleet_*``),
  per-metric cross-rank skew gauges (``hvd_rank_skew_*``) and the
  collective straggler report.

``/metrics`` additionally speaks OpenMetrics when the scraper asks
(``Accept: application/openmetrics-text`` or ``?exemplars=1``):
histogram ``_bucket`` lines then carry their exemplar (the last
observation's ``trace_id``) in the ``# {...} value ts`` syntax, and
the exposition ends with ``# EOF``. The classic 0.0.4 text format —
what an un-negotiated scrape gets — is byte-identical to before.

Enable with ``HVD_METRICS_PORT`` (0 = ephemeral, the CI smoke's
choice) or programmatically via `start_exporter(port=...)`.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.obs import catalog
from horovod_tpu_torch.obs.registry import MetricRegistry, registry

__all__ = ["render_prometheus", "MetricsServer", "start_exporter",
           "stop_exporter"]

CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    f = float(v)
    # The format's spellings for non-finite values — a gauge whose
    # set_fn callback failed reads NaN, and that must render, not
    # abort the whole scrape.
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) else repr(f)


def _labels_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = list(labels.items()) + list((extra or {}).items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"'
                    for k, v in items)
    return "{" + body + "}"


def _exemplar_suffix(exemplar: Optional[dict]) -> str:
    """The OpenMetrics exemplar tail for one bucket line:
    `` # {trace_id="..."} value ts``. Empty for no exemplar."""
    if not exemplar or "value" not in exemplar:
        return ""
    labels = {k: v for k, v in exemplar.items()
              if k not in ("value", "ts")}
    body = ",".join(f'{k}="{_escape_label(str(v))}"'
                    for k, v in sorted(labels.items()))
    out = f" # {{{body}}} {_fmt(exemplar['value'])}"
    if "ts" in exemplar:
        out += f" {_fmt(exemplar['ts'])}"
    return out


def render_prometheus(reg: Optional[MetricRegistry] = None, *,
                      exemplars: bool = False) -> str:
    """The registry in Prometheus text exposition format 0.0.4.

    ``exemplars=True`` is the OpenMetrics flavor: each histogram
    child's stored exemplar (the last observation's trace context —
    the metrics leg of request tracing) rides the ``_bucket`` line
    whose range contains it, and the exposition closes with
    ``# EOF``. Off by default — classic 0.0.4 scrapers reject the
    exemplar syntax."""
    reg = reg or registry()
    lines = []
    for m in reg.collect():
        # OpenMetrics names a counter FAMILY without the _total
        # suffix (samples keep it): '# TYPE x counter' + 'x_total 5'.
        # Emitting the 0.0.4 shape ('# TYPE x_total counter') under
        # the OpenMetrics content type makes a stock Prometheus —
        # which negotiates OpenMetrics by default — reject the whole
        # scrape on the family/sample name mismatch.
        fam = m.name
        if (exemplars and m.kind == "counter"
                and fam.endswith("_total")):
            fam = fam[:-len("_total")]
        lines.append(f"# HELP {fam} {_escape_help(m.doc)}")
        lines.append(f"# TYPE {fam} {m.kind}")
        for labels, child in m.samples():
            if m.kind == "histogram":
                ex = child.exemplar if exemplars else None
                ex_i = None
                if ex is not None and "value" in ex:
                    # The bucket the exemplar's value falls in — the
                    # only line OpenMetrics allows it on.
                    v = float(ex["value"])
                    ex_i = len(m.buckets)
                    for i, edge in enumerate(m.buckets):
                        if v <= edge:
                            ex_i = i
                            break
                cum = 0
                for i, edge in enumerate(m.buckets):
                    cum += child.counts[i]
                    suffix = (_exemplar_suffix(ex)
                              if ex_i == i else "")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_labels_str(labels, {'le': _fmt(edge)})} "
                        f"{cum}{suffix}")
                cum += child.counts[len(m.buckets)]
                suffix = (_exemplar_suffix(ex)
                          if ex_i == len(m.buckets) else "")
                lines.append(
                    f"{m.name}_bucket"
                    f"{_labels_str(labels, {'le': '+Inf'})} "
                    f"{cum}{suffix}")
                lines.append(f"{m.name}_sum{_labels_str(labels)} "
                             f"{_fmt(child.sum)}")
                lines.append(f"{m.name}_count{_labels_str(labels)} "
                             f"{cum}")
            else:
                lines.append(
                    f"{m.name}{_labels_str(labels)} {_fmt(child)}")
    if exemplars:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """The exporter daemon thread. ``port=0`` binds an ephemeral port
    (read it back from ``.port``)."""

    def __init__(self, reg: Optional[MetricRegistry] = None, *,
                 port: int = 0, host: str = "127.0.0.1"):
        # Loopback by DEFAULT: /metrics.json carries the event tail
        # (restart reasons, request token counts, file paths) — wider
        # exposure is an explicit ``host=`` opt-in, never an accident
        # on a public-IP host.
        self.registry = reg or registry()
        # Pre-declare the full catalog: a scrape of an idle process
        # still shows every family, so dashboards can be built before
        # traffic arrives.
        catalog.declare_standard_metrics(self.registry)
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by design
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    # OpenMetrics (exemplars on _bucket lines, # EOF
                    # terminator) only when the scraper negotiates it
                    # — classic 0.0.4 consumers reject the syntax.
                    om = ("application/openmetrics-text"
                          in (self.headers.get("Accept") or "")
                          or "exemplars=1" in query)
                    body = render_prometheus(
                        server_ref.registry, exemplars=om).encode()
                    self._send(200, body,
                               CONTENT_TYPE_OPENMETRICS if om
                               else CONTENT_TYPE_PROM)
                elif path == "/metrics.json":
                    from horovod_tpu_torch.obs import events
                    from horovod_tpu_torch.obs import straggler
                    tr = straggler.tracker()
                    body = json.dumps({
                        # The fleet aggregator's pull shape
                        # (obs/aggregate.rank_snapshot over HTTP).
                        "rank": tr.rank,
                        "metrics": server_ref.registry.to_json(),
                        "collectives": tr.window_snapshot(),
                        "events": events.tail(100),
                    }, default=repr).encode()
                    self._send(200, body, "application/json")
                elif path in ("/fleet", "/fleet.json"):
                    from horovod_tpu_torch.obs import aggregate
                    snap = aggregate.default_aggregator().collect()
                    if path == "/fleet":
                        self._send(200,
                                   snap.render_prometheus().encode(),
                                   CONTENT_TYPE_PROM)
                    else:
                        self._send(200,
                                   json.dumps(snap.to_json(),
                                              default=repr).encode(),
                                   "application/json")
                elif path.startswith("/trace/"):
                    from horovod_tpu_torch.obs import spans as _spans
                    tid = path[len("/trace/"):]
                    tree = _spans.trace(tid)
                    if tree is None:
                        # Unknown OR evicted from the bounded ring —
                        # the recorder cannot tell the two apart.
                        self._send(404, json.dumps(
                            {"error": "unknown or evicted trace",
                             "trace_id": tid}).encode(),
                            "application/json")
                    else:
                        self._send(200, json.dumps(
                            {"trace_id": tid, "spans": tree},
                            default=repr).encode(),
                            "application/json")
                elif path in ("/healthz", "/health"):
                    health = server_ref.registry.health()
                    body = json.dumps(health, default=repr).encode()
                    # Probe-usable: a degraded plane (a provider
                    # errored, or a component self-reported
                    # healthy=false — e.g. a dead dispatch thread)
                    # answers 503 so status-code-only checks see it.
                    code = 200 if health.get("status") == "ok" else 503
                    self._send(code, body, "application/json")
                else:
                    self._send(404, b'{"error": "not found"}',
                               "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="hvd-metrics-exporter", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


_SERVER: Optional[MetricsServer] = None
_SERVER_LOCK = threading.Lock()


def start_exporter(port: Optional[int] = None,
                   reg: Optional[MetricRegistry] = None,
                   host: str = "127.0.0.1"
                   ) -> Optional[MetricsServer]:
    """Start (or return) the process-global exporter. ``port=None``
    reads ``HVD_METRICS_PORT``; with the knob also unset the exporter
    stays off and None is returned (observability is opt-in). Called
    env-gated from `hvd.init()` and `ServingEngine` construction, so
    setting the knob is sufficient — no code change needed. Binds
    loopback unless a wider ``host`` is explicitly requested."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            return _SERVER
        if port is None:
            from horovod_tpu_torch.runtime.config import env_raw
            raw = env_raw("HVD_METRICS_PORT")
            if raw is None or raw == "":
                return None
            try:
                port = int(raw)
            except ValueError:
                import sys
                sys.stderr.write(
                    f"WARNING: HVD_METRICS_PORT={raw!r} is not an "
                    f"integer; exporter disabled\n")
                return None
        try:
            _SERVER = MetricsServer(reg, port=port, host=host)
        except OSError as e:
            # Warn-and-disable, never fail the workload: a fixed
            # port under a multi-process-per-host launch (hvdrun
            # propagates the env to every local rank) binds on one
            # rank and EADDRINUSEs on the rest — those ranks train
            # on without an exporter instead of dying in init().
            import sys
            sys.stderr.write(
                f"WARNING: metrics exporter could not bind "
                f"{host}:{port} ({e}); exporter disabled for this "
                f"process (on multi-rank hosts only one rank can "
                f"own a fixed HVD_METRICS_PORT — use 0 for "
                f"per-rank ephemeral ports)\n")
            return None
        return _SERVER


def stop_exporter():
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None
