"""PyTorch port: the fleet's metrics plane — the HTTP exporter
(`obs.exporter`), fleet aggregation (`obs.aggregate`), straggler
attribution (`obs.straggler`) with the eager ops' hook, and the fleet
knobs — against the JAX package's.

These modules are host code ported by copy, so the oracle is exact: for
the same registry contents the port renders the same Prometheus text
(classic and OpenMetrics) as the reference; the aggregator's merge and
the straggler report come out equal for the same inputs. Every server
binds port 0 and is shut down by its ``with`` block or fixture.
"""

import json
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu.obs.aggregate as j_aggregate
import horovod_tpu.obs.straggler as j_straggler
import horovod_tpu.runtime.config as j_config
import horovod_tpu_torch as hvd_port
from horovod_tpu.obs.exporter import render_prometheus as j_render
from horovod_tpu.obs.registry import MetricRegistry as JRegistry
from horovod_tpu_torch.obs import aggregate, events, straggler
from horovod_tpu_torch.obs.exporter import MetricsServer, render_prometheus
from horovod_tpu_torch.obs.registry import MetricRegistry, registry
from horovod_tpu_torch.runtime import config as t_config
from horovod_tpu_torch.resilience.detector import install_detector

FLEET_KNOBS = [
    "HVD_ROUTER_REPLICAS", "HVD_ROUTER_POLL", "HVD_ROUTER_REPLACEMENTS",
    "HVD_HEDGE_QUANTILE", "HVD_RETRY_BUDGET", "HVD_DISAGG",
    "HVD_DISAGG_PREFILL", "HVD_DISAGG_DECODE", "HVD_DISAGG_TRANSFER",
    "HVD_METRICS_PORT", "HVD_FLEET_RANKS", "HVD_STRAGGLER_CYCLES",
    "HVD_DETECTOR_SWEEP_S", "HVD_DETECTOR_HYSTERESIS",
    "HVD_DETECTOR_FLAP_WINDOW_S", "HVD_DETECTOR_FLAP_MAX",
    "HVD_IO_RETRIES",
]


@pytest.fixture(scope="module", autouse=True)
def _stop_port_detector():
    """Stop the port's shared failure detector after the module: its
    sweep thread carries the JAX package's thread name, and a later
    module of this worker process (`tests/test_detector.py`) counts the
    live threads of that name."""
    yield
    old = install_detector(None)
    if old is not None:
        old.stop()


def _fill(reg):
    """The same metric contents in either package's registry: labeled
    counters with escapes, gauges incl. non-finite values, histograms
    with samples past the last edge and exemplars."""
    c = reg.counter("hvd_t_requests_total", "requests", ("kind",))
    c.inc(3, kind="a")
    c.inc(2, kind='quo"te\\back\nline')
    g = reg.gauge("hvd_t_level", "a level", ("shard",))
    g.set(1.5, shard="0")
    g.set(float("inf"), shard="1")
    g.set(float("nan"), shard="2")
    h = reg.histogram("hvd_t_latency_seconds", "latency")
    rs = np.random.RandomState(4)
    for i, v in enumerate(rs.lognormal(-3, 1.5, size=50)):
        h.observe(float(v), exemplar={"trace_id": f"t{i}"})
    h.observe(1e4, exemplar={"trace_id": "far"})
    reg.gauge("hvd_t_plain", "no labels").set(-2)
    return reg


_EXEMPLAR_TS = re.compile(r"(# \{[^}]*\} \S+) \S+$", re.M)


@pytest.mark.parametrize("exemplars", [False, True],
                         ids=["prometheus", "openmetrics"])
def test_exporter_renders_reference_text(exemplars):
    """Byte-equal text for the same contents; under OpenMetrics the
    exemplars' timestamps (the wall clock of each observation) are the
    only field allowed to differ."""
    ours = render_prometheus(_fill(MetricRegistry()), exemplars=exemplars)
    ref = j_render(_fill(JRegistry()), exemplars=exemplars)
    assert _EXEMPLAR_TS.sub(r"\1", ours) == _EXEMPLAR_TS.sub(r"\1", ref)
    assert 'le="+Inf"' in ours
    assert ("trace_id=" in ours) == exemplars


def _scrape(url, path, accept=None):
    req = urllib.request.Request(url + path)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (NaN|[+-]Inf|[-+0-9.eE]+)$')


def test_http_endpoints_parse_and_carry_the_router():
    """A live exporter on an ephemeral port, scraped after a port
    `ServingRouter` over two toy engines served requests:
    /metrics parses as Prometheus text and carries the router's
    counters; /healthz and /metrics.json answer."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.serving import ServingEngine, ServingRouter
    tm = TransformerLM(64, 1, 2, 8, max_len=32, device="cpu").init_weights(0)
    with MetricsServer(port=0) as srv, ServingRouter(
            lambda: ServingEngine(tm, num_slots=2, max_queue=8),
            num_replicas=2, health_poll_s=0.01) as router:
        hs = [router.submit(np.arange(1, 4 + i), 6) for i in range(4)]
        for h in hs:
            h.result(timeout=60)
        status, ctype, text = _scrape(srv.url, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        for line in text.splitlines():
            assert line.startswith("#") or _SAMPLE.match(line), line
        m = re.search(r"^hvd_router_requests_total\{[^}]*"
                      r'outcome="completed"[^}]*\} (\d+)', text, re.M)
        assert m and int(m.group(1)) >= 4
        assert "hvd_router_replicas" in text
        status, _, body = _scrape(srv.url, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        mj = json.loads(_scrape(srv.url, "/metrics.json")[2])
        assert "rank" in mj and "collectives" in mj
        _, ctype, om = _scrape(srv.url, "/metrics",
                               accept="application/openmetrics-text")
        assert "openmetrics" in ctype and om.rstrip().endswith("# EOF")


def test_fleet_endpoint_and_default_aggregator():
    h = registry().histogram("hvd_fleet_http_port_seconds", "fleet family")
    h.observe(0.01)
    h.observe(0.2)
    prev = aggregate.install(aggregate.FleetAggregator().add_registry(
        registry()))
    try:
        with MetricsServer(port=0) as srv:
            text = _scrape(srv.url, "/fleet")[2]
            assert re.search(r'hvd_fleet_fleet_http_port_seconds_bucket'
                             r'\{le="\+Inf"\} 2', text)
            assert "hvd_fleet_ranks 1" in text
            full = json.loads(_scrape(srv.url, "/fleet.json")[2])
            assert full["ranks_failed"] == []
    finally:
        aggregate.install(prev)


def _window(mod, rank, mean_s, n=6):
    tr = mod.StragglerTracker(rank=rank, window=0)
    for i in range(n):
        tr.record("allreduce", mean_s * (1.0 + 0.01 * i))
    return tr.window_snapshot()


def test_aggregator_merge_equals_reference():
    """Eight simulated ranks (histograms, counters, gauges, one slow
    rank's collective window): the port's merged fleet registry renders
    the JAX aggregator's text, its quantiles equal the pooled stream's,
    and both name the slow rank."""
    def build(mod, reg_cls):
        rs = np.random.RandomState(3)
        agg = mod.FleetAggregator()
        pooled = reg_cls().histogram("hvd_step_seconds", "o")
        for rank in range(8):
            reg = reg_cls()
            h = reg.histogram("hvd_step_seconds", "step")
            for v in rs.lognormal(-2 + 0.1 * rank, 0.5, size=16):
                h.observe(float(v))
                pooled.observe(float(v))
            reg.counter("hvd_x_total", "doc").inc(rank + 1)
            reg.gauge("hvd_g", "doc").set(float(rank))
            strag = j_straggler if mod is j_aggregate else straggler
            window = _window(strag, rank, 0.05 if rank == 5 else 0.01)
            agg.add_snapshot_fn(
                lambda reg=reg, rank=rank, window=window:
                mod.rank_snapshot(reg, rank=rank, collectives=window),
                name=f"rank:{rank}")
        return agg.collect(), pooled

    snap, pooled = build(aggregate, MetricRegistry)
    jsnap, _ = build(j_aggregate, JRegistry)
    merged = snap.registry.get("hvd_fleet_step_seconds")
    assert merged.samples()[0][1].count == 8 * 16
    assert merged.quantile(0.5) == pytest.approx(pooled.quantile(0.5))
    assert snap.registry.get("hvd_fleet_x_total").value() == 36
    assert snap.registry.get("hvd_rank_skew_g").value() == 7.0
    assert render_prometheus(snap.registry) == j_render(jsnap.registry)
    assert snap.straggler["slowest_rank"] == 5
    assert snap.straggler["straggler"] is True
    assert snap.straggler == jsnap.straggler


def test_dead_source_costs_only_its_rank():
    reg = MetricRegistry()
    reg.counter("hvd_x_total", "doc").inc(4)
    agg = aggregate.FleetAggregator().add_registry(reg, rank=0)
    agg.add_endpoint("http://127.0.0.1:9", timeout_s=0.5)
    snap = agg.collect()
    assert len(snap.failed) == 1
    assert snap.registry.get("hvd_fleet_ranks_failed").value() == 1
    assert snap.registry.get("hvd_fleet_x_total").value() == 4


def test_straggler_report_equals_reference():
    windows = [_window(straggler, r, 0.03 if r == 2 else 0.01)
               for r in range(4)]
    jwindows = [_window(j_straggler, r, 0.03 if r == 2 else 0.01)
                for r in range(4)]
    report = straggler.merge_windows(windows)
    assert report == j_straggler.merge_windows(jwindows)
    assert report["slowest_rank"] == 2 and report["straggler"] is True
    assert straggler.merge_windows([]) is None


@pytest.fixture
def event_log(tmp_path):
    log = events.EventLog(str(tmp_path / "events.jsonl"))
    prev = events.install(log)
    yield log
    events.install(prev)


def test_eager_collective_records_into_tracker():
    """The instrumentation seam: each eager op of the port lands its
    host-side enter -> exit time in the process tracker's window."""
    prev = straggler.install(straggler.StragglerTracker(rank=0, window=0))
    hvd_port.init(device="cpu")
    try:
        hvd_port.allreduce(torch.ones(4), name="straggler_t")
        hvd_port.allgather(torch.ones(2, 3), name="straggler_g")
        hvd_port.broadcast(torch.ones(3), 0, name="straggler_b")
        snap = straggler.tracker().window_snapshot()
        assert snap["n"] == 3
        assert set(snap["ops"]) == {"allreduce", "allgather", "broadcast"}
    finally:
        hvd_port.shutdown()
        straggler.install(prev)


def test_stall_event_carries_straggler_report(event_log):
    from horovod_tpu_torch.utils.stall import StallMonitor
    tr = straggler.StragglerTracker(rank=0, window=0)
    tr.exchange(windows=[_window(straggler, r, 0.04 if r == 1 else 0.01)
                         for r in range(2)])
    prev = straggler.install(tr)
    mon = StallMonitor(60.0, check_every_s=3600.0)
    try:
        mon.begin("fleet_stall_op")
        stalled = mon.check_once(now=time.time() + 120.0)
    finally:
        mon.stop()
        straggler.install(prev)
    assert stalled == ["fleet_stall_op"]
    recs = [e for e in events.tail(50)
            if e["kind"] == "stall" and e["op"] == "fleet_stall_op"]
    assert recs and recs[-1]["straggler"]["slowest_rank"] == 1


@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_fleet_knob_declared_with_reference_default(name):
    ours = t_config.KNOBS[name]
    ref = j_config.KNOBS[name]
    assert (ours.kind, ours.default) == (ref.kind, ref.default)
    assert ours.consumer == ref.consumer
