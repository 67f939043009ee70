"""PyTorch port: the serving fleet router (`serving.router`) against the
JAX package's.

Two surfaces, as in `tests/test_router.py`:

* **Real engines.** The port's `ServingRouter` over port
  `ServingEngine` replicas serves seeded requests, and every stream must
  be token-exact against the JAX `ServingRouter`'s stream for the same
  (prompt, seed) — with no fault, across replica kills at several
  points, through the ``router.replica_kill`` chaos site, and across
  the death of the only replica. Each kill is made deterministic: the
  replicas' dispatch threads are held mid-stream (`_Gate`) until the
  kill lands, so no stream can finish first on a loaded host.
* **Scripted fake replicas.** The policy half (health gating, load
  awareness, SLO drain, retry budget, hedging, migration bookkeeping)
  runs the same script against both routers, each with its own
  package's exceptions and result type, and must give the same
  outcome.

The model is the JAX router tests' toy (vocab 64, 2 layers, 4 heads of
8, max_len 64, float32), loaded into the port with `params_from_jax`.
"""

import threading
import time
from concurrent.futures import CancelledError, Future

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import horovod_tpu.serving as jserving
import horovod_tpu_torch.serving as tserving
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving import (
    DeadlineExceededError, EngineClosedError, ServingEngine, ServingRouter,
)
from horovod_tpu_torch.serving.router import REPLICA_DRAINING, REPLICA_UP
from horovod_tpu_torch.resilience.detector import install_detector

VOCAB, MAX_LEN = 64, 64


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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(n, seed=0, lo=2, hi=8):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(rs.randint(lo, hi)),))
            for _ in range(n)]


def _wait(cond, timeout=120.0, dt=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(dt)


# The seeded request sets of the real-engine tests: name ->
# (prompts, seeds, steps, temperature), as in tests/test_router.py.
SETS = {
    "fleet": (_prompts(8, seed=0), list(range(8)), 10, 0.7),
    "kill": (_prompts(6, seed=3), list(range(6)), 30, 0.7),
    "chaos": (_prompts(6, seed=9), list(range(6)), 24, 0.6),
    "last": (_prompts(1, seed=31), [1], 20, 0.5),
}
for _k in (1, 4, 9):
    SETS[f"mig{_k}"] = (_prompts(3, seed=40 + _k), [7, 11, 13], 24, 0.9)


@pytest.fixture(scope="module")
def lm():
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=2, num_heads=4,
                          head_dim=8, max_len=MAX_LEN, dtype=jnp.float32)
    params = unbox(jm.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))["params"])
    tm = tt.TransformerLM(VOCAB, 2, 4, 8, max_len=MAX_LEN,
                          dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def jax_router_streams(lm):
    """Every request of `SETS` served once by the JAX `ServingRouter`
    (two replicas, no fault): name -> list of token streams."""
    jm, params, _ = lm
    with jserving.ServingRouter(
            lambda: jserving.ServingEngine(jm, params, num_slots=4,
                                           max_queue=64),
            num_replicas=2, health_poll_s=0.01) as router:
        handles = {
            name: [router.submit(p, steps, temperature=temp, seed=s)
                   for p, s in zip(prompts, seeds)]
            for name, (prompts, seeds, steps, temp) in SETS.items()}
        return {name: [list(map(int, h.result(timeout=300).tokens))
                       for h in hs] for name, hs in handles.items()}


def _factory(tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    return lambda: ServingEngine(tm, **kw)


class _Gate:
    """Holds every engine built by `factory` after ``after`` decode
    ticks, until `release` or the engine's own shutdown, so a kill
    lands while streams are demonstrably mid-flight."""

    def __init__(self, after: int):
        self.after = after
        self.released = threading.Event()
        self.built = []
        self.freed_at_build = []   # per build: earlier engines' KV freed?

    def release(self):
        self.released.set()

    def factory(self, tm):
        def make():
            self.freed_at_build.append([e.pool._cache is None
                                        for e in self.built])
            eng = ServingEngine(tm, num_slots=2, max_queue=16)
            inner, ticks = eng.pool.tick_dispatch, [0]

            def held_tick():
                ticks[0] += 1
                if ticks[0] > self.after:
                    _wait(lambda: self.released.is_set() or eng._closing,
                          timeout=60, dt=0.002)
                return inner()
            eng.pool.tick_dispatch = held_tick
            self.built.append(eng)
            return eng
        return make


def _submit_set(router, name):
    prompts, seeds, steps, temp = SETS[name]
    return [router.submit(p, steps, temperature=temp, seed=s)
            for p, s in zip(prompts, seeds)]


def _streams(results):
    return [list(map(int, r.tokens)) for r in results]


class TestRouterOracle:
    def test_fleet_token_exact_and_load_spread(self, lm,
                                               jax_router_streams):
        _, _, tm = lm
        with ServingRouter(_factory(tm), num_replicas=2,
                           health_poll_s=0.01) as router:
            hs = _submit_set(router, "fleet")
            results = [h.result(timeout=300) for h in hs]
            spread = [router.engine_of(rid).metrics_snapshot()
                      ["submitted"] for rid in router.replicas()]
        assert _streams(results) == jax_router_streams["fleet"]
        snap = router.metrics_snapshot()
        assert snap["completed"] == 8
        assert snap["migrations"] == 0
        assert all(n > 0 for n in spread), spread

    def test_kill_mid_decode_migrates_token_exact(self, lm,
                                                  jax_router_streams):
        _, _, tm = lm
        gate = _Gate(after=6)
        with ServingRouter(gate.factory(tm), num_replicas=2,
                           health_poll_s=0.01) as router:
            hs = _submit_set(router, "kill")
            _wait(lambda: any(len(h.tokens_so_far()) >= 3 for h in hs))
            victim = max(
                router.replicas(),
                key=lambda rid: router.engine_of(rid).pool.busy_slots)
            dead = gate.built.index(router.engine_of(victim))
            router.kill_replica(victim)
            gate.release()
            results = [h.result(timeout=300) for h in hs]
            _wait(lambda: router.metrics_snapshot()["replacements"] == 1)
            snap = router.metrics_snapshot()
        assert _streams(results) == jax_router_streams["kill"]
        # The dead replica's KV was freed before its replacement was
        # built (one card never holds both pools).
        assert gate.freed_at_build[2][dead] is True
        assert all(r.trace_id == h.trace_id for h, r in zip(hs, results))
        assert snap["completed"] == 6
        assert snap["replica_deaths"] == 1
        assert snap["migrations"] >= 1
        assert snap["replacements"] == 1
        assert any(h.migrations() > 0 for h in hs)

    @pytest.mark.parametrize("kill_at", [1, 4, 9])
    def test_migration_equivalence_property(self, lm, jax_router_streams,
                                            kill_at):
        """Kill the replica of the first stream once it reaches
        ``kill_at`` tokens: every final stream is the JAX router's, so
        the continuation resumes each request's threefry key mid-stream."""
        _, _, tm = lm
        gate = _Gate(after=kill_at + 3)
        with ServingRouter(gate.factory(tm), num_replicas=2,
                           health_poll_s=0.01) as router:
            hs = _submit_set(router, f"mig{kill_at}")
            victim = hs[0]
            _wait(lambda: len(victim.tokens_so_far()) >= kill_at,
                  dt=0.0005)
            with router._lock:
                rid = router._requests[victim.id].attempts[0].replica_id
            router.kill_replica(rid)
            gate.release()
            results = [h.result(timeout=300) for h in hs]
            snap = router.metrics_snapshot()
        assert _streams(results) == jax_router_streams[f"mig{kill_at}"]
        assert snap["completed"] == 3
        assert snap["migrations"] >= 1

    def test_chaos_site_kills_and_streams_survive(self, lm,
                                                  jax_router_streams):
        _, _, tm = lm
        gate = _Gate(after=5)
        with ServingRouter(gate.factory(tm), num_replicas=2,
                           health_poll_s=0.01) as router:
            hs = _submit_set(router, "chaos")
            _wait(lambda: any(len(h.tokens_so_far()) >= 2 for h in hs))
            with chaos.armed("router.replica_kill:1") as monkey:
                _wait(lambda: monkey.fired("router.replica_kill") == 1)
                gate.release()
                results = [h.result(timeout=300) for h in hs]
            snap = router.metrics_snapshot()
        assert _streams(results) == jax_router_streams["chaos"]
        assert snap["replica_deaths"] == 1
        assert snap["completed"] == 6

    def test_last_replica_death_recovers_via_replacement(
            self, lm, jax_router_streams):
        """Killing the ONLY replica mid-stream: the migration waits for
        the cold replacement and the stream stays token-exact. The
        replica is held after its sixth tick until the kill, so the
        20-token stream cannot finish before the kill lands."""
        _, _, tm = lm
        gate = _Gate(after=6)
        with ServingRouter(gate.factory(tm), num_replicas=1,
                           health_poll_s=0.01) as router:
            (h,) = _submit_set(router, "last")
            _wait(lambda: len(h.tokens_so_far()) >= 4)
            router.kill_replica(list(router.replicas())[0])
            gate.release()
            res = h.result(timeout=300)
            snap = router.metrics_snapshot()
            router.submit(_prompts(1, seed=32)[0], 4).result(timeout=300)
        assert _streams([res]) == jax_router_streams["last"]
        assert snap["migrations"] == 1
        assert snap["migrated_tokens"] >= 4
        assert snap["replacements"] == 1
        assert len(gate.built) == 2

    def test_drain_cold_replaces_and_takes_no_new_work(self, lm):
        _, _, tm = lm
        with ServingRouter(_factory(tm), num_replicas=2,
                           health_poll_s=0.01) as router:
            ids0 = set(router.replicas())
            h0 = router.submit(_prompts(1, seed=1)[0], 20)
            _wait(lambda: len(h0.tokens_so_far()) >= 1)
            with router._lock:
                drain_rid = router._requests[h0.id].attempts[0].replica_id
            router.drain(drain_rid)
            assert router.replicas()[drain_rid] == REPLICA_DRAINING
            other = next(r for r in ids0 if r != drain_rid)
            for h in [router.submit(p, 4) for p in _prompts(3, seed=2)]:
                h.result(timeout=300)
            assert router.engine_of(other).metrics_snapshot()[
                "submitted"] >= 3
            assert h0.result(timeout=300).finish_reason in ("eos",
                                                             "length")
            _wait(lambda: drain_rid not in router.replicas())
            snap = router.metrics_snapshot()
            assert snap["replacements"] == 1
            assert snap["replica_deaths"] == 0
            states = router.replicas()
            assert len(states) == 2
            assert all(s == REPLICA_UP for s in states.values())

    def test_deadline_propagates_through_router(self, lm):
        _, _, tm = lm
        with ServingRouter(_factory(tm, num_slots=1), num_replicas=1,
                           health_poll_s=0.01) as router:
            blocker = router.submit(_prompts(1, seed=5)[0], 40)
            h = router.submit(_prompts(1, seed=6)[0], 40, timeout_s=0.05)
            with pytest.raises(DeadlineExceededError):
                h.result(timeout=120)
            blocker.result(timeout=300)

    def test_cancel_through_router(self, lm):
        _, _, tm = lm
        with ServingRouter(_factory(tm, num_slots=1), num_replicas=1,
                           health_poll_s=0.01) as router:
            blocker = router.submit(_prompts(1, seed=5)[0], 30)
            queued = router.submit(_prompts(1, seed=6)[0], 30)
            queued.cancel()
            with pytest.raises(CancelledError):
                queued.result(timeout=120)
            blocker.result(timeout=300)
            assert router.metrics_snapshot()["cancelled"] == 1

    def test_submit_after_shutdown_rejected(self, lm):
        _, _, tm = lm
        router = ServingRouter(_factory(tm), num_replicas=1,
                               health_poll_s=0.01)
        router.shutdown()
        with pytest.raises(EngineClosedError):
            router.submit(_prompts(1)[0], 4)


# ---------------------------------------------------------------------------
# Scripted fake replicas: the policy half, one script on both routers.
# ---------------------------------------------------------------------------

@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    """The serving package under test: the JAX package's or the port's
    (the fakes raise and return that package's types)."""
    return jserving if request.param == "jax" else tserving


def _fake_stream(prompt, seed, n):
    base = int(np.asarray(prompt).sum()) + 31 * seed
    return [(base + i) % 97 for i in range(n)]


class _FakeHandle:
    def __init__(self, req):
        self._req = req

    @property
    def future(self):
        return self._req["future"]

    @property
    def trace_id(self):
        return self._req["trace_id"]

    def tokens_so_far(self):
        return list(self._req["tokens"])

    def cancel(self):
        self._req["cancelled"] = True
        self._req["engine"].cancels += 1
        fut = self._req["future"]
        if not fut.done():
            fut.set_exception(CancelledError())


class _FakePool:
    busy_slots = 0


class FakeEngine:
    """Exactly the engine surface the router consumes, scripted (as in
    tests/test_router.py): ``ttft_s`` delays the first token,
    ``shed_next`` sheds that many submits, ``healthy``/``die()`` drive
    the health probe, a worker thread feeds tokens at ``tpot_s``."""

    def __init__(self, pkg, *, ttft_s=0.0, tpot_s=0.001, shed_next=0,
                 healthy=True):
        self.pkg = pkg
        self.ttft_s = ttft_s
        self.tpot_s = tpot_s
        self.shed_next = shed_next
        self.healthy = healthy
        self.slo = None
        self.pool = _FakePool()
        self.submitted = 0
        self.cancels = 0
        self._reqs = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def queue_depth(self):
        with self._lock:
            return len([r for r in self._reqs if not r["future"].done()])

    def _health(self):
        return {"healthy": self.healthy and not self._stop.is_set()}

    def submit(self, prompt, max_new_tokens, *, temperature=0.0,
               top_p=None, seed=0, timeout_s=None, forced_prefix=None,
               trace_id=None, parent_span="", priority=0, tenant=""):
        with self._lock:
            if self._stop.is_set():
                raise self.pkg.EngineClosedError("fake closed")
            if self.shed_next > 0:
                self.shed_next -= 1
                raise self.pkg.QueueFullError("fake shed")
            self.submitted += 1
            forced = list(forced_prefix or [])
            req = {"prompt": np.asarray(prompt), "max_new": max_new_tokens,
                   "seed": seed, "tokens": list(forced),
                   "forced": len(forced), "future": Future(),
                   "trace_id": trace_id or "fake", "t0": time.time(),
                   "cancelled": False, "engine": self}
            self._reqs.append(req)
        return _FakeHandle(req)

    def _run(self):
        while not self._stop.wait(0.0005):
            now = time.time()
            with self._lock:
                reqs = list(self._reqs)
            for r in reqs:
                if r["future"].done() or r["cancelled"]:
                    continue
                age = now - r["t0"]
                if age < self.ttft_s:
                    continue
                want = min(r["max_new"], r["forced"] + 1
                           + int((age - self.ttft_s) / self.tpot_s))
                stream = _fake_stream(r["prompt"], r["seed"], r["max_new"])
                r["tokens"] = stream[:want]
                if want >= r["max_new"]:
                    r["future"].set_result(self.pkg.CompletedRequest(
                        request_id=0, prompt=r["prompt"],
                        tokens=np.asarray(stream, np.int64),
                        finish_reason="length", ttft_s=self.ttft_s,
                        tpot_s=self.tpot_s, e2e_s=now - r["t0"],
                        trace_id=r["trace_id"]))

    def shutdown(self, *, drain=True, timeout=None):
        del drain, timeout
        self._stop.set()
        self._worker.join()
        with self._lock:
            for r in self._reqs:
                if not r["future"].done():
                    r["future"].set_exception(
                        self.pkg.EngineClosedError("fake killed"))

    def die(self):
        self.healthy = False
        self.shutdown()


def _fakes(pkg, n=2, **kw):
    return [FakeEngine(pkg, **kw) for _ in range(n)]


def _fake_router(pkg, fakes, **kw):
    it = iter(fakes)
    kw.setdefault("health_poll_s", 0.005)
    kw.setdefault("hedge_quantile", 0.0)
    return pkg.ServingRouter(lambda: next(it), num_replicas=len(fakes),
                             max_replacements=0, **kw)


def _hedged_request(router, fakes):
    """Eight fast requests seed the TTFT quantile, then the ninth lands
    on a wedged replica (30 s to first token); only the OTHER replica is
    un-wedged, so the hedge must win there. Returns (handle, primary
    replica id, replica id -> fake)."""
    for i in range(8):
        router.submit(np.array([i + 1]), 2).result(timeout=60)
    for f in fakes:
        f.ttft_s = 30.0
    h = router.submit(np.array([50]), 3)
    with router._lock:
        prid = router._requests[h.id].attempts[0].replica_id
        by_rid = {rep.id: rep.engine for rep in router._replicas.values()}
    for rid, eng in by_rid.items():
        if rid != prid:
            eng.ttft_s = 0.005
    return h, prid, by_rid


class TestRoutingPolicy:
    def test_unhealthy_replica_takes_no_new_work(self, pkg):
        a, b = FakeEngine(pkg, healthy=False), FakeEngine(pkg)
        with _fake_router(pkg, [a, b]) as router:
            for i in range(4):
                router.submit(np.array([i + 1]), 3).result(timeout=60)
        assert (a.submitted, b.submitted) == (0, 4)

    def test_least_loaded_wins(self, pkg):
        a, b = FakeEngine(pkg, tpot_s=0.2), FakeEngine(pkg, tpot_s=0.001)
        with _fake_router(pkg, [a, b]) as router:
            slow = router.submit(np.array([1]), 4)
            _wait(lambda: a.submitted + b.submitted == 1)
            other = b if a.submitted else a
            for i in range(3):
                router.submit(np.array([i + 2]), 3).result(timeout=60)
            assert other.submitted == 3
            slow.result(timeout=60)

    def test_slo_breaching_replica_drained_from_rotation(self, pkg):
        class _BurningSLO:
            def health(self):
                return {"healthy": False, "breaching": ["ttft"]}

        a, b = _fakes(pkg)
        a.slo = _BurningSLO()
        with _fake_router(pkg, [a, b]) as router:
            for i in range(3):
                router.submit(np.array([i + 1]), 3).result(timeout=60)
        assert (a.submitted, b.submitted) == (0, 3)

    def test_retry_budget_spends_then_sheds(self, pkg):
        fakes = _fakes(pkg, shed_next=10 ** 6)
        with _fake_router(pkg, fakes, retry_budget=3,
                          backoff_s=0.001) as router:
            with pytest.raises(pkg.QueueFullError):
                router.submit(np.array([1]), 3)
            snap = router.metrics_snapshot()
        assert (snap["retries"], snap["shed"],
                snap["budget_exhausted"]) == (3, 1, 1)

    def test_retry_recovers_on_second_replica(self, pkg):
        a, b = FakeEngine(pkg, shed_next=10 ** 6), FakeEngine(pkg)
        with _fake_router(pkg, [a, b], retry_budget=4,
                          backoff_s=0.001) as router:
            out = [router.submit(np.array([i + 1]), 3).result(timeout=60)
                   for i in range(3)]
        assert len(out) == 3 and b.submitted == 3

    def test_zero_budget_disables_retries(self, pkg):
        fakes = _fakes(pkg, shed_next=10 ** 6)
        with _fake_router(pkg, fakes, retry_budget=0,
                          backoff_s=0.001) as router:
            with pytest.raises(pkg.QueueFullError):
                router.submit(np.array([1]), 3)
            assert router.metrics_snapshot()["retries"] == 0

    def test_hedge_slow_first_token_and_cancel_loser(self, pkg):
        fakes = _fakes(pkg, ttft_s=0.005)
        with _fake_router(pkg, fakes, hedge_quantile=0.95) as router:
            h, prid, by_rid = _hedged_request(router, fakes)
            res = h.result(timeout=60)
            snap = router.metrics_snapshot()
        assert list(res.tokens) == _fake_stream(np.array([50]), 0, 3)
        assert (snap["hedges"], snap["hedge_wins"]) == (1, 1)
        _wait(lambda: by_rid[prid].cancels >= 1, timeout=10)

    def test_terminal_stream_migration_synthesizes_completion(self, pkg):
        """A replica dying after its request's last token but before
        resolving the future: migration synthesizes the completion."""
        fakes = _fakes(pkg, ttft_s=30.0)
        with _fake_router(pkg, fakes) as router:
            h = router.submit(np.array([5]), 6, seed=2)
            _wait(lambda: sum(f.submitted for f in fakes) == 1)
            holder = next(f for f in fakes if f.submitted)
            stream = _fake_stream(np.array([5]), 2, 6)
            with holder._lock:
                holder._reqs[0]["tokens"] = list(stream)
            holder.die()
            res = h.result(timeout=60)
            snap = router.metrics_snapshot()
        assert list(res.tokens) == stream
        assert res.finish_reason == "length"
        assert res.trace_id == h.trace_id
        assert (snap["completed"], snap["failed"]) == (1, 0)

    def test_hedge_loser_does_not_wedge_drain(self, pkg):
        fakes = _fakes(pkg, ttft_s=0.005)
        with _fake_router(pkg, fakes, hedge_quantile=0.95) as router:
            h, prid, _ = _hedged_request(router, fakes)
            h.result(timeout=60)
            assert router.metrics_snapshot()["hedges"] == 1
            router.drain(prid)
            _wait(lambda: prid not in router.replicas(), timeout=30)

    def test_migration_off_dead_fake_carries_forced_prefix(self, pkg):
        a, b = FakeEngine(pkg, tpot_s=0.02), FakeEngine(pkg, tpot_s=0.001)
        with _fake_router(pkg, [a, b]) as router:
            h = router.submit(np.array([9]), 12, seed=4)
            _wait(lambda: a.submitted + b.submitted == 1)
            holder = a if a.submitted else b
            _wait(lambda: len(h.tokens_so_far()) >= 3)
            mid = len(h.tokens_so_far())
            holder.die()
            res = h.result(timeout=60)
            snap = router.metrics_snapshot()
        assert list(res.tokens) == _fake_stream(np.array([9]), 4, 12)
        assert snap["migrations"] == 1
        assert snap["migrated_tokens"] >= mid
        other = b if holder is a else a
        with other._lock:
            mig = [r for r in other._reqs if r["forced"] > 0]
        assert mig and mig[0]["forced"] >= 3


class TestRetryBudget:
    def test_spend_and_refill(self, pkg):
        budget = pkg.RetryBudget(2, refill_window_s=0.2)
        assert budget.try_spend() and budget.try_spend()
        assert not budget.try_spend()
        _wait(lambda: budget.try_spend(), timeout=5)

    def test_zero_capacity_never_spends(self, pkg):
        assert not pkg.RetryBudget(0).try_spend()
