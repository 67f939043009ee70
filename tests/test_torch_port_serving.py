"""PyTorch port: `ServingEngine` against the JAX package's `generate`,
the engine's fault paths, and the port's import boundary.

The model is the JAX serving tests' toy (vocab 64, 2 layers, 4 heads
of 8, max_len 32, float32); its flax weights load into the port with
`params_from_jax`, and every greedy engine stream must be token-exact
against the JAX `generate` of the same prompt.
"""

import ast
import pathlib
import subprocess
import sys
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.tensor import unbox
from horovod_tpu_torch.compat.from_jax import params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.serving import (
    DeadlineExceededError, EngineClosedError, QueueFullError,
    ServingEngine, SlotPool,
)

VOCAB, MAX_LEN = 64, 32
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Toy shapes gain nothing from intra-op threads, and idle OpenMP
    threads spinning here would slow the JAX tests running beside this
    module in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    jm = jt.TransformerLM(vocab_size=VOCAB, num_layers=2, num_heads=4,
                          head_dim=8, max_len=MAX_LEN, dtype=jnp.float32)
    params = unbox(jm.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))["params"])

    def port(**kw):
        tm = tt.TransformerLM(VOCAB, 2, 4, 8, max_len=MAX_LEN,
                              dtype=torch.float32, device="cpu", **kw)
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
        return tm
    return jm, params, port


def _prompts(n, seed=0, lo=1, hi=8):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(rs.randint(lo, hi)),))
            for _ in range(n)]


def _wait(cond, timeout=60.0, dt=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(dt)


@pytest.mark.parametrize("kw", [
    {}, dict(attn_impl="flash", decode_prefix_impl="pallas",
             decode_prefix_block=8)], ids=["lax", "flash_pallas"])
def test_engine_token_exact_vs_jax_generate(lm, kw):
    """>= 8 mixed-length greedy requests through 3 slots (slots
    recycle, chunked prefill interleaves with ticks) == the JAX
    `generate` of each prompt, token for token."""
    jm, params, port = lm
    prompts = _prompts(8, seed=0)
    steps = 8
    with ServingEngine(port(**kw), num_slots=3, max_queue=16,
                       prefill_chunk_budget=4) as eng:
        handles = [eng.submit(p, steps) for p in prompts]
        results = [h.result(timeout=120) for h in handles]
    snap = eng.metrics_snapshot()
    assert snap["completed"] == 8
    assert snap["ttft_ms"]["n"] == 8 and snap["tpot_ms"]["p50"] is not None
    for p, r in zip(prompts, results):
        ref = np.asarray(jt.generate(jm, params, jnp.asarray(p)[None],
                                     steps=steps))[0, len(p):]
        assert list(map(int, r.tokens)) == ref.tolist()
        assert r.finish_reason == "length"


def test_queue_full_sheds(lm):
    _, _, port = lm
    eng = ServingEngine(port(), num_slots=1, max_queue=1)
    try:
        first = eng.submit(np.arange(1, 6), 20)
        _wait(lambda: eng.pool.busy_slots == 1)
        eng.submit(np.arange(1, 4), 4)
        with pytest.raises(QueueFullError):
            eng.submit(np.arange(1, 4), 4)
        assert first.result(timeout=60).finish_reason == "length"
    finally:
        eng.shutdown(drain=True)


def test_cancel_mid_decode_frees_slot(lm):
    _, _, port = lm
    with ServingEngine(port(), num_slots=1, max_queue=4) as eng:
        h = eng.submit(np.arange(1, 4), 28)
        _wait(lambda: len(h.tokens_so_far()) >= 2)
        h.cancel()
        with pytest.raises(CancelledError):
            h.result(timeout=60)
        nxt = eng.submit(np.arange(2, 5), 3)
        assert len(nxt.result(timeout=60).tokens) == 3
    assert eng.metrics_snapshot()["cancelled"] == 1


def test_deadline_exceeded(lm):
    _, _, port = lm
    with ServingEngine(port(), num_slots=1, max_queue=4) as eng:
        blocker = eng.submit(np.arange(1, 4), 28)
        late = eng.submit(np.arange(1, 4), 4, timeout_s=1e-3)
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=60)
        assert blocker.result(timeout=60).finish_reason == "length"


def test_shutdown_drain_resolves_everything(lm):
    _, _, port = lm
    eng = ServingEngine(port(), num_slots=2, max_queue=8)
    handles = [eng.submit(p, 5) for p in _prompts(5, seed=4)]
    eng.shutdown(drain=True)
    assert all(h.done() for h in handles)
    assert all(len(h.result().tokens) == 5 for h in handles)
    with pytest.raises(EngineClosedError):
        eng.submit(np.arange(1, 3), 2)


def test_seeded_sampling_reproducible_and_resumable(lm):
    """Per-request generators: the same seed gives the same stream in
    any slot/batch mix, and a forced-prefix resume continues it."""
    _, _, port = lm
    p = np.arange(3, 9)
    with ServingEngine(port(), num_slots=2, max_queue=8) as eng:
        a = eng.submit(p, 10, temperature=0.9, top_p=0.95, seed=7)
        eng.submit(np.arange(1, 5), 6)   # company in the batch
        b = eng.submit(p, 10, temperature=0.9, top_p=0.95, seed=7)
        ta = list(map(int, a.result(timeout=60).tokens))
        tb = list(map(int, b.result(timeout=60).tokens))
        c = eng.submit(p, 10, temperature=0.9, top_p=0.95, seed=7,
                       forced_prefix=ta[:4])
        tc = list(map(int, c.result(timeout=60).tokens))
    assert ta == tb == tc


def test_slot_pool_lanes_freeze_and_eos_sticks(lm):
    _, _, port = lm
    pool = SlotPool(port(), 3, eos_id=None)
    slot = pool.alloc()
    first = pool.prefill(slot, np.arange(1, 6), 0.0, None, 0)
    assert isinstance(first, int)
    for _ in range(3):
        pool.tick()
    want = np.zeros(3, np.int32)
    want[slot] = 8          # 5 prompt rows + 3 ticks; idle lanes frozen
    np.testing.assert_array_equal(pool.fill_indices(), want)
    pool.free(slot)
    np.testing.assert_array_equal(pool.fill_indices(), [0, 0, 0])
    pool2 = SlotPool(port(), 2, eos_id=int(first))
    slot = pool2.alloc()
    assert pool2.prefill(slot, np.arange(1, 6), 0.0, None, 0) == first
    for _ in range(3):
        assert int(pool2.tick()[slot]) == first
    assert pool2.fill_indices()[slot] == 5


def test_dispatch_crash_restarts_token_exact(lm):
    """auto_restart: an injected dispatch-thread crash mid-flight
    restarts the engine on a fresh pool (`clone_fresh`) and every
    stream replays from its prompt, token-exact."""
    from horovod_tpu_torch.resilience import chaos
    jm, params, port = lm
    prompts = _prompts(4, seed=5)
    with ServingEngine(port(), num_slots=2, max_queue=8,
                       auto_restart=True, max_restarts=2) as eng:
        handles = [eng.submit(p, 10) for p in prompts]
        _wait(lambda: len(handles[0].tokens_so_far()) >= 2)
        with chaos.armed("serving_dispatch_crash:1"):
            _wait(lambda: eng.metrics_snapshot()["restarts"] >= 1)
        results = [h.result(timeout=120) for h in handles]
        snap = eng.metrics_snapshot()
    assert snap["restarts"] == 1
    for p, r in zip(prompts, results):
        ref = np.asarray(jt.generate(jm, params, jnp.asarray(p)[None],
                                     steps=10))[0, len(p):]
        assert list(map(int, r.tokens)) == ref.tolist()


def test_priority_preemption_recompute_token_exact(lm):
    """preempt=True on the fixed pool: a priority-5 arrival evicts the
    running priority-0 stream (recompute mode), and the victim resumes
    through its forced prefix — both streams token-exact. Every tick
    is stretched to >= 20 ms (chaos tick stall) so the priority-0
    stream is surely still decoding when the priority-5 one arrives."""
    from horovod_tpu_torch.resilience import chaos
    jm, params, port = lm
    lo, hi = np.arange(1, 5), np.arange(7, 12)
    with chaos.armed("serving_tick_stall:-1:delay=0.02"), \
            ServingEngine(port(), num_slots=1, max_queue=4,
                          preempt=True) as eng:
        h_lo = eng.submit(lo, 28)
        _wait(lambda: len(h_lo.tokens_so_far()) >= 3)
        h_hi = eng.submit(hi, 6, priority=5)
        r_hi, r_lo = h_hi.result(timeout=120), h_lo.result(timeout=120)
        snap = eng.metrics_snapshot()
    assert snap["preemptions_recompute"] >= 1
    for p, r, n in ((lo, r_lo, 28), (hi, r_hi, 6)):
        ref = np.asarray(jt.generate(jm, params, jnp.asarray(p)[None],
                                     steps=n))[0, len(p):]
        assert list(map(int, r.tokens)) == ref.tolist()


def test_later_slices_raise(lm):
    _, _, port = lm
    m = port()
    for kw in (dict(paged=True), dict(mesh=2), dict(weight_quant="int8"),
               dict(spec_draft=(m, None))):
        with pytest.raises(NotImplementedError, match="later slice"):
            ServingEngine(m, **kw)


# -- the import boundary ----------------------------------------------------

def test_import_leaves_jax_out():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.serving, "
            "horovod_tpu_torch.compat.from_jax, "
            "horovod_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax')) or m == 'horovod_tpu' "
            "or m.startswith('horovod_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_jax_package_imports_in_port():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (f, mod)
            assert top != "horovod_tpu", (f, mod)
