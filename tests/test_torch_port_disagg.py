"""PyTorch port: disaggregated prefill/decode serving (`serving.disagg`
over `serving.transfer`) against the JAX package's.

The contract is the JAX suite's (`tests/test_disagg.py`): moving a
stream's KV blocks from a prefill pool into a decode pool changes WHERE
the tokens are computed, never WHAT they are. Every stream here is held
token-exact against the JAX package's `DisaggRouter` serving the same
(prompt, seed) — fp32 and int8 weights, greedy and seeded, host and
device transfer mode — and against every way the handoff can go wrong
(prefill death, decode death mid-stream, a corrupted transfer). The
transfer layer's unit surface (export/ingest round trip, idempotent
re-ingest, tamper / chain / geometry rejection) is tested at pool level
first. Pools on different meshes are the multi-GPU slice of the port
(ROADMAP Queue A 8): their counterpart asserts the refusal.

The model is the JAX disagg tests' toy (vocab 64, 2 layers, 4 heads of
8, max_len 64, float32, blocks of 8), loaded with `params_from_jax`.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import horovod_tpu.serving as jserving
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving import (
    DisaggRouter, ServingEngine, ServingRouter, TransferCompatError,
    TransferVerifyError, export_blocks, ingest_blocks,
)
from horovod_tpu_torch.resilience.detector import install_detector

VOCAB, MAX_LEN, BS = 64, 64, 8


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


def _prompts(n, seed=0, length=2 * BS + 2):
    # Two FULL blocks plus a sub-block tail: the manifest covers tokens
    # [0, 16) and the decode side re-prefills the tail.
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (length,)) for _ in range(n)]


def _wait(cond, timeout=120.0, dt=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(dt)


# The request sets whose streams the JAX DisaggRouter serves once:
# name -> (prompts, steps, temperature, seeds).
MATRIX = (_prompts(3, seed=20), 6)
SETS = {
    "roundtrip": (_prompts(1, seed=5), 6, 0.0, [0]),
    "device": (_prompts(1, seed=11), 5, 0.0, [0]),
    "one_token": (_prompts(1, seed=22), 1, 0.0, [0]),
    "corrupt": (_prompts(1, seed=40), 6, 0.0, [0]),
    "mid_kill": (_prompts(3, seed=41), 20, 0.8, [7, 8, 9]),
    "prefill_kill": (_prompts(4, seed=42), 6, 0.0, [0] * 4),
    "no_prefill": (_prompts(1, seed=43), 6, 0.0, [0]),
    "followup": (_prompts(1, seed=50), 6, 0.0, [0]),
    "greedy": (MATRIX[0], MATRIX[1], 0.0, [0] * 3),
    "seeded": (MATRIX[0], MATRIX[1], 0.9, [100, 101, 102]),
}


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
def jax_streams(lm):
    """The JAX `DisaggRouter`'s streams (one prefill, one decode
    replica): ``(quant, name) -> streams`` for every set under fp32 and
    for the matrix sets under int8 weights."""
    jm, params, _ = lm
    out = {}
    for quant, names in ((None, list(SETS)), ("int8", ["greedy",
                                                       "seeded"])):
        router = jserving.ServingRouter(
            lambda: jserving.ServingEngine(
                jm, params, num_slots=4, max_queue=64, paged=True,
                kv_block_size=BS, weight_quant=quant),
            disagg={"prefill": 1, "decode": 1})
        try:
            hs = {n: [router.submit(p, SETS[n][1], temperature=SETS[n][2],
                                    seed=s)
                      for p, s in zip(SETS[n][0], SETS[n][3])]
                  for n in names}
            for n in names:
                out[quant, n] = [list(map(int, h.result(timeout=300).tokens))
                                 for h in hs[n]]
        finally:
            router.shutdown()
    return out


def _factory(tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    kw.setdefault("paged", True)
    kw.setdefault("kv_block_size", BS)
    return lambda: ServingEngine(tm, **kw)


def _router(tm, **kw):
    disagg = kw.pop("disagg", {"prefill": 1, "decode": 1})
    return ServingRouter(_factory(tm, **kw.pop("engine_kw", {})),
                         disagg=disagg, **kw)


def _submit(router, name):
    prompts, steps, temp, seeds = SETS[name]
    return [router.submit(p, steps, temperature=temp, seed=s)
            for p, s in zip(prompts, seeds)]


def _tokens(res):
    return list(map(int, res.tokens))


# ---------------------------------------------------------------------------
# Transfer layer: pool-level unit surface
# ---------------------------------------------------------------------------


class TestTransferUnit:
    def _exported(self, tm, prompt, **kw):
        """Serve ``prompt`` for one token on a throwaway engine and
        export its (now LRU-resident) full prompt blocks."""
        mode = kw.pop("mode", "host")
        with ServingEngine(tm, num_slots=2, paged=True, kv_block_size=BS,
                           **kw) as eng:
            res = eng.submit(prompt, 1).result(timeout=120)
            tr = export_blocks(eng.pool, prompt, (int(res.tokens[0]),),
                               mode=mode)
        return tr

    def test_export_ingest_roundtrip_bitwise(self, lm, jax_streams):
        _, _, tm = lm
        (prompt,) = SETS["roundtrip"][0]
        tr = self._exported(tm, prompt)
        assert tr is not None and tr.num_blocks == 2 and tr.nbytes > 0
        assert tr.mode == "host" and len(tr.emitted) == 1
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=BS) as eng:
            assert ingest_blocks(eng.pool, tr) == 2
            eng.pool.blocks.check_invariants()
            res = eng.submit(prompt, 6).result(timeout=120)
        assert [_tokens(res)] == jax_streams[None, "roundtrip"]
        assert res.prefix_tokens_cached == 2 * BS

    def test_reingest_is_idempotent(self, lm):
        _, _, tm = lm
        (prompt,) = _prompts(1, seed=6)
        tr = self._exported(tm, prompt)
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=BS) as eng:
            assert ingest_blocks(eng.pool, tr) == 2
            assert ingest_blocks(eng.pool, tr) == 0
            eng.pool.blocks.check_invariants()

    def test_tampered_bytes_rejected(self, lm):
        _, _, tm = lm
        (prompt,) = _prompts(1, seed=7)
        tr = self._exported(tm, prompt)
        rows = [r.clone() for r in tr.rows]
        rows[0].view(torch.uint8).view(-1)[3] ^= 0xFF
        bad = dataclasses.replace(tr, rows=rows)
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=BS) as eng:
            before = eng.pool.blocks.free_blocks
            with pytest.raises(TransferVerifyError):
                ingest_blocks(eng.pool, bad)
            assert eng.pool.blocks.free_blocks == before
            eng.pool.blocks.check_invariants()

    def test_wrong_prompt_chain_rejected(self, lm):
        _, _, tm = lm
        p1, p2 = _prompts(2, seed=8)
        tr = self._exported(tm, p1)
        bad = dataclasses.replace(tr, prompt=np.asarray(p2, np.int64))
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=BS) as eng:
            with pytest.raises(TransferVerifyError):
                ingest_blocks(eng.pool, bad)

    def test_block_size_mismatch_rejected(self, lm):
        _, _, tm = lm
        (prompt,) = _prompts(1, seed=9)
        tr = self._exported(tm, prompt)
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=4) as eng:
            with pytest.raises(TransferCompatError):
                ingest_blocks(eng.pool, tr)

    def test_export_none_without_full_blocks(self, lm):
        _, _, tm = lm
        (short,) = _prompts(1, seed=10, length=BS - 2)
        assert self._exported(tm, short) is None
        with ServingEngine(tm, num_slots=2) as eng:
            res = eng.submit(short, 1).result(timeout=120)
            assert export_blocks(eng.pool, short,
                                 (int(res.tokens[0]),)) is None

    def test_device_mode_roundtrip(self, lm, jax_streams):
        """``mode="device"``: the rows stay on the pool's device (the
        CPU here; CUDA tensors on the card) and the digests and graft
        behave as in host mode."""
        _, _, tm = lm
        (prompt,) = SETS["device"][0]
        tr = self._exported(tm, prompt, mode="device")
        assert tr is not None and tr.mode == "device"
        assert all(r.device == tm.device for r in tr.rows)
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=BS) as eng:
            assert ingest_blocks(eng.pool, tr) == 2
            res = eng.submit(prompt, 5).result(timeout=120)
        assert [_tokens(res)] == jax_streams[None, "device"]
        assert res.prefix_tokens_cached == 2 * BS
        with pytest.raises(ValueError, match="host|device"):
            export_blocks(None, prompt, mode="pinned")


# ---------------------------------------------------------------------------
# The acceptance matrix: disaggregated streams equal the JAX router's
# ---------------------------------------------------------------------------


class TestDisaggBitwise:
    @pytest.mark.parametrize("transfer", ["host", "device"])
    @pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
    @pytest.mark.parametrize("seeded", [False, True],
                             ids=["greedy", "seeded"])
    def test_disagg_matches_jax_disagg(self, lm, jax_streams, quant,
                                       seeded, transfer):
        _, _, tm = lm
        name = "seeded" if seeded else "greedy"
        router = _router(tm, engine_kw={"weight_quant": quant},
                         disagg={"prefill": 1, "decode": 1,
                                 "transfer": transfer})
        assert isinstance(router, DisaggRouter)
        try:
            got = [_tokens(h.result(timeout=120))
                   for h in _submit(router, name)]
            snap = router.metrics_snapshot()
        finally:
            router.shutdown()
        assert got == jax_streams[quant, name]
        assert snap["completed"] == 3
        assert snap["disagg"]["handoffs"] == 3
        assert snap["disagg"]["fallbacks"] == 0
        assert snap["disagg"]["transfer_mode"] == transfer

    def test_handoff_grafts_full_prompt_blocks(self, lm):
        _, _, tm = lm
        (prompt,) = _prompts(1, seed=21)
        router = _router(tm)
        try:
            res = router.submit(prompt, 5).result(timeout=120)
        finally:
            router.shutdown()
        assert res.prefix_tokens_cached == 2 * BS

    def test_one_token_requests_skip_the_handoff(self, lm, jax_streams):
        _, _, tm = lm
        router = _router(tm)
        try:
            (h,) = _submit(router, "one_token")
            res = h.result(timeout=120)
            snap = router.metrics_snapshot()
        finally:
            router.shutdown()
        assert [_tokens(res)] == jax_streams[None, "one_token"]
        assert snap["disagg"]["handoffs"] == 0

    def test_decode_length_validated_synchronously(self, lm):
        _, _, tm = lm
        (prompt,) = _prompts(1, seed=23, length=MAX_LEN - 4)
        router = _router(tm)
        try:
            with pytest.raises(ValueError):
                router.submit(prompt, 16)
        finally:
            router.shutdown()


class TestCrossLayout:
    @pytest.mark.parametrize("src,dst", [(2, 4), (2, None), (None, 2)],
                             ids=["mesh2-to-mesh4", "sharded-to-unsharded",
                                  "unsharded-to-sharded"])
    def test_cross_mesh_handoff_bitwise(self, lm, src, dst):
        """Pools on different meshes are the multi-GPU slice: the
        sharded engine and a graft into a pool laid out on a mesh both
        raise `NotImplementedError` naming ROADMAP Queue A 8."""
        _, _, tm = lm
        with pytest.raises(NotImplementedError, match="Queue A 8"):
            ServingRouter(
                _factory(tm, mesh=None if dst is None else dst),
                disagg={"prefill": 1, "decode": 1,
                        "prefill_factory": _factory(
                            tm, mesh=None if src is None else src)})
        (prompt,) = _prompts(1, seed=30)
        tr = TestTransferUnit()._exported(tm, prompt)
        with ServingEngine(tm, num_slots=2, paged=True,
                           kv_block_size=BS) as eng:
            eng.pool.mesh = dst or src
            with pytest.raises(NotImplementedError, match="Queue A 8"):
                ingest_blocks(eng.pool, tr)
            eng.pool.blocks.check_invariants()


# ---------------------------------------------------------------------------
# Kill points and the fallback ladder
# ---------------------------------------------------------------------------


class TestKillPointsAndFallbacks:
    def test_corrupted_transfer_falls_back_bitwise(self, lm, jax_streams):
        _, _, tm = lm
        router = _router(tm)
        try:
            with chaos.armed("disagg.block_corrupt:1") as monkey:
                (h,) = _submit(router, "corrupt")
                res = h.result(timeout=120)
            assert monkey.fired("disagg.block_corrupt") == 1
            snap = router.metrics_snapshot()
        finally:
            router.shutdown()
        assert [_tokens(res)] == jax_streams[None, "corrupt"]
        assert res.prefix_tokens_cached == 0
        assert snap["completed"] == 1

    def test_mid_decode_kill_migrates_bitwise(self, lm, jax_streams):
        """Decode-replica death mid-stream: migration re-places the
        stream on the surviving decode replica, re-offering the
        transfer. The decode engines are held after their fourth tick
        until the kill, so it lands mid-stream on any host."""
        _, _, tm = lm
        released = threading.Event()

        def factory():
            eng = ServingEngine(tm, num_slots=2, max_queue=16, paged=True,
                                kv_block_size=BS)
            inner, ticks = eng.pool.tick_dispatch, [0]

            def held_tick():
                ticks[0] += 1
                if ticks[0] > 4:
                    _wait(lambda: released.is_set() or eng._closing,
                          timeout=60, dt=0.002)
                return inner()
            eng.pool.tick_dispatch = held_tick
            return eng

        router = ServingRouter(factory, disagg={"prefill": 1, "decode": 2},
                               health_poll_s=0.01)
        try:
            hs = _submit(router, "mid_kill")
            _wait(lambda: any(len(h.tokens_so_far()) >= 3 for h in hs))
            victim = max(
                router.replicas(),
                key=lambda rid: router.engine_of(rid).pool.busy_slots)
            router.kill_replica(victim)
            released.set()
            got = [_tokens(h.result(timeout=120)) for h in hs]
            snap = router.metrics_snapshot()
        finally:
            released.set()
            router.shutdown()
        assert got == jax_streams[None, "mid_kill"]
        assert snap["completed"] == 3
        assert snap["replica_deaths"] == 1
        assert snap["migrations"] >= 1

    def test_prefill_kill_degrades_and_replaces(self, lm, jax_streams):
        _, _, tm = lm
        router = _router(tm, health_poll_s=0.01)
        try:
            (pid,) = router.prefill_replicas()
            hs = _submit(router, "prefill_kill")
            router.kill_prefill(pid)
            got = [_tokens(h.result(timeout=120)) for h in hs]
            _wait(lambda: any(state == "up" for state
                              in router.prefill_replicas().values()))
            snap = router.metrics_snapshot()
        finally:
            router.shutdown()
        assert got == jax_streams[None, "prefill_kill"]
        assert snap["completed"] == 4
        assert snap["disagg"]["prefill_deaths"] == 1

    def test_no_prefill_capacity_falls_back_to_shared_path(self, lm,
                                                           jax_streams):
        _, _, tm = lm
        router = _router(tm, health_poll_s=0.01, max_replacements=0)
        try:
            (pid,) = router.prefill_replicas()
            router.kill_prefill(pid)
            _wait(lambda: not any(state == "up" for state
                                  in router.prefill_replicas().values()))
            (h,) = _submit(router, "no_prefill")
            res = h.result(timeout=120)
            snap = router.metrics_snapshot()
        finally:
            router.shutdown()
        assert [_tokens(res)] == jax_streams[None, "no_prefill"]
        assert snap["disagg"]["fallbacks"] >= 1
        assert snap["disagg"]["handoffs"] == 0


class TestPrefixInteraction:
    def test_transferred_prefix_serves_followup_requests(self, lm,
                                                         jax_streams):
        _, _, tm = lm
        router = _router(tm)
        try:
            (h1,) = _submit(router, "followup")
            r1 = h1.result(timeout=120)
            (h2,) = _submit(router, "followup")
            r2 = h2.result(timeout=120)
        finally:
            router.shutdown()
        assert [_tokens(r1)] == jax_streams[None, "followup"]
        assert [_tokens(r2)] == jax_streams[None, "followup"]
        assert r1.prefix_tokens_cached == 2 * BS
        assert r2.prefix_tokens_cached >= 2 * BS
