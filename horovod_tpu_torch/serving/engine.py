"""`ServingEngine` — the thin API over a background dispatch loop.

Horovod's core architectural lesson (Sergeev & Del Balso,
arXiv:1802.05799; SURVEY §L2) is that adoption comes from a minimal
user-facing API (`hvd.init` + `DistributedOptimizer`) layered over a
carefully engineered background coordinator thread that turns
asynchronous per-tensor readiness into ordered batched device work.
This engine is that architecture pointed at serving: callers get TWO
calls — ``submit(prompt, ...) -> handle`` and ``shutdown()`` — and a
single background dispatch thread turns asynchronously arriving
requests into full decode batches (`ContinuousBatchingScheduler` over
a `SlotPool`, or the paged `PagedSlotPool` with ``paged=True``), with
admission control in front (`AdmissionQueue`) and request-level
metrics behind (`EngineMetrics`).

Threading model (mirrors the reference's one-background-thread rule,
`operations.cc` there): ALL device work happens on the dispatch thread.
Submitter threads touch only the queue, the metrics counters, and
their own request's future/cancel-flag — so arbitrary caller threads
compose with single-threaded device dispatch.

Usage::

    from horovod_tpu_torch.serving import ServingEngine

    with ServingEngine(model, num_slots=8, eos_id=2) as eng:
        h = eng.submit(prompt_tokens, 64)
        out = h.result(timeout=30)        # CompletedRequest
        print(out.tokens, out.finish_reason, out.ttft_s)

Every request is traced as a causal span tree (`obs.spans`): queue
wait, admission, prefill and decode under one root per request.

Sharded serving (``mesh=``, ``HVD_SERVE_MESH``): the engine serves a
tensor-parallel model over the mesh's ``model`` axis, one process a
rank. Every rank builds the same engine; model rank 0 (the leader)
runs it, and every other rank calls `ServingEngine.follow`, which
replays the leader's pool calls in lockstep (`serving.lockstep`).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import sys
import threading
import time
import traceback
from concurrent.futures import CancelledError, Future
from typing import Optional

import numpy as np

from horovod_tpu_torch.obs import catalog as _obs_catalog
from horovod_tpu_torch.obs import events as _events
from horovod_tpu_torch.obs import flightrec as _flightrec
from horovod_tpu_torch.obs import reqlog as _reqlog
from horovod_tpu_torch.obs import spans as _spans
from horovod_tpu_torch.obs import tracing as _tracing
from horovod_tpu_torch.obs.registry import registry as _obs_registry
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.serving.admission import (
    AdmissionQueue, DeadlineExceededError, EngineClosedError,
    QueueFullError, Request, SamplingParams,
)
from horovod_tpu_torch.serving.metrics import EngineMetrics
from horovod_tpu_torch.serving.scheduler import (
    CompletedRequest, ContinuousBatchingScheduler, _span,
)
from horovod_tpu_torch.serving.slots import SlotPool
from horovod_tpu_torch.utils.stall import StallMonitor

from horovod_tpu_torch.analysis import lockcheck

__all__ = ["ServingEngine", "RequestHandle", "CompletedRequest",
           "SamplingParams", "QueueFullError", "EngineClosedError"]

# How long the idle dispatcher parks between queue checks. Wake-ups on
# submit are event-driven (AdmissionQueue.wait returns early); this
# only bounds how stale a shutdown/cancel notice can go unnoticed.
_IDLE_WAIT_S = 0.05

# Process-unique engine numbers for /healthz provider keys (several
# engines can coexist; each reports its own dispatch generation).
_ENGINE_IDS = itertools.count()

# What stays single-device on a serving mesh, and where ROADMAP lists it.
_MESH_LATER = "a later slice of the PyTorch port (ROADMAP Queue A 5)"


def _resolve_serving_mesh(mesh, device_type: str = "cuda"):
    """Normalize `ServingEngine`'s ``mesh`` argument to a built mesh (or
    None = unsharded), with the JAX package's forms and errors:

    * None — read ``HVD_SERVE_MESH`` (unset keeps the engine unsharded);
    * a built mesh (`parallel.mesh.make_mesh`) — used as it is;
    * a ``MeshSpec`` — resolved over the world's ranks;
    * an int N — a mesh of N ranks on the serving axis
      (``HVD_SERVE_MESH_AXIS``, ``model``);
    * a str — a rank count ("2") or comma-separated "axis=N" sizes
      ("model=2").

    Each rank of the world is one device here, so the mesh needs a
    world of exactly that many ranks (`horovod_tpu_torch.init`); a
    trivial one-rank mesh in a process with no world is no mesh."""
    if mesh is None:
        from horovod_tpu_torch.runtime.config import config as _cfg
        mesh = _cfg.serve_mesh.strip() or None
    if mesh is None:
        return None
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.models.transformer import _serve_kv_axis
    from horovod_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    if hasattr(mesh, "mesh_dim_names"):
        return mesh
    if isinstance(mesh, MeshSpec):
        return make_mesh(spec=mesh, device_type=device_type)
    if isinstance(mesh, str):
        s = mesh.strip()
        if "=" in s:
            sizes = {}
            for part in s.split(","):
                k, _, v = part.partition("=")
                sizes[k.strip()] = int(v)
        else:
            sizes = None
            mesh = int(s)
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(
                f"serving mesh device count must be >= 1, got {mesh}")
        sizes = {_serve_kv_axis(): mesh}
    elif not isinstance(mesh, str):
        raise TypeError(
            f"mesh must be None, an int device count, a 'axis=N' str, a "
            f"MeshSpec, or a built mesh; got {type(mesh).__name__}")
    need = int(np.prod(list(sizes.values())))
    world = optim.world_size()
    if need > world:
        raise ValueError(
            f"serving mesh {sizes} needs {need} devices, only {world} "
            f"visible (HVD_SERVE_MESH; each rank of the world is one)")
    if need == 1 and world == 1:
        return None
    sizes.setdefault("data", 1)
    return make_mesh(device_type=device_type, **sizes)


class RequestHandle:
    """The caller's view of one in-flight request."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def id(self) -> int:
        return self._req.id

    @property
    def trace_id(self) -> str:
        """The request's observability id — the key into the event
        log, the span recorder, and the histogram exemplars
        (docs/observability.md); survives watchdog-restart requeues."""
        return self._req.trace_id

    @property
    def future(self) -> Future:
        return self._req.future

    def result(self, timeout: Optional[float] = None) -> CompletedRequest:
        """Block for the outcome. Raises `DeadlineExceededError` /
        `CancelledError` / `EngineClosedError` for the non-completion
        exits, or `concurrent.futures.TimeoutError` if ``timeout``
        passes first (the request itself keeps running)."""
        return self._req.future.result(timeout)

    def done(self) -> bool:
        return self._req.future.done()

    def cancel(self):
        """Best-effort cancel: queued requests are dropped before
        prefill, running requests retire (freeing their slot) at the
        next decode tick. No-op once done."""
        self._req.cancel()

    def tokens_so_far(self) -> list:
        """Snapshot of the generated tokens (grows per tick) — the
        polling flavor of streaming."""
        return list(self._req.tokens)


class ServingEngine:
    """In-process continuous-batching serving engine over one model.

    Parameters
    ----------
    model : the port's `TransformerLM`, holding its weights (pre-cast
        with `serving_params` as usual); the engine runs on its device.
        A sliding-window model is served on the fixed pool (each lane a
        rolling cache of ``window`` slots; with RoPE a request may run
        past max_len); the paged pool refuses it.
    num_slots : decode-batch width S.
    max_queue : admission bound; submits beyond it shed immediately.
    eos_id : stop token (None = budget-only stops), as in `generate`;
        results end at the first eos.
    default_timeout_s : per-request deadline applied when `submit`
        gets no explicit ``timeout_s`` (None = no deadline).
    auto_restart : self-healing: a watchdog thread detects a dead or
        stuck dispatch thread and restarts the engine IN PLACE — fresh
        slot pool, fresh dispatch thread, same admission queue; the
        in-flight requests replay from their prompts (token-exact).
    tick_deadline_s : stuck-dispatch threshold for the watchdog (None
        disables stuck detection; crashes are still healed).
    stall_warning_s : threshold for the engine's `StallMonitor` around
        every decode tick. Default: ``HOROVOD_STALL_CHECK_TIME``.
    warmup : run every kind of device call once at construction
        (`SlotPool.warmup`), which builds the CUDA kernels before the
        first request.
    prefill_chunk_budget : max prompt tokens streamed per scheduler
        step (interleaved chunked prefill). None reads
        HVD_PREFILL_CHUNK_BUDGET (default 128); <= 0 = unbounded.
    pipeline_depth : 1 (default) keeps the one-deep in-flight tick
        ring; 0 syncs every tick immediately.
    paged : use the paged KV cache (`serving.paging.PagedSlotPool`):
        device KV is a shared block pool instead of a private max_len
        region per slot, admission gates on BLOCK availability (more
        concurrent sequences fit the same KV bytes whenever requests
        run short of max_len), and shared prompt prefixes are served
        from the resident block cache instead of re-prefilling.
        Greedy streams stay token-exact vs the fixed pool.
    kv_block_size : paged block size in tokens (must divide max_len);
        None reads HVD_KV_BLOCK_SIZE (default 16).
    kv_blocks : paged device block count — the KV-bytes knob; None
        reads HVD_KV_BLOCKS, and <= 0 means auto: num_slots x max_len /
        block_size (+1 null), byte-parity with the fixed pool.
    prefix_cache : shared-prefix caching over the paged pool; None
        reads HVD_PREFIX_CACHE (default on). Ignored unless paged.
    paged_kernel : paged-attention dispatch: "auto"/"lax" walk only
        the FILLED blocks of each lane's table, "pallas" runs every
        S=1 tick on the hand-written CUDA paged-decode kernel
        (``csrc/paged_decode.cu``; its plain version on the CPU),
        "off" gathers each lane's whole table into a linear view (the
        oracle). None reads HVD_PAGED_KERNEL. Ignored unless paged.
    spec_draft : the draft arming SPECULATIVE decoding — a
        `TransformerLM` (it holds its weights) or the JAX package's
        ``(draft_model, draft_params)`` pair (`slots.resolve_spec_draft`):
        the tick becomes a batched draft-verify round retiring
        1..spec_k+1 tokens per lane, greedy-only (submit refuses
        temperature > 0), the streams exactly the plain engine's for any
        draft. Disables the tick ring (pipeline_depth 0 — multi-token
        retirement is the amortization) and, on the paged pool, the
        prefix cache (one chunk schedule drives both caches).
    spec_k : draft proposals per round; None reads HVD_SPEC_K (default
        4). Only meaningful with spec_draft.
    weight_quant : "int8" quantizes the block matmul kernels at the
        door (`ops.quantization.quantize_lm`: int8 codes plus one f32
        scale per output channel); None reads HVD_WEIGHT_QUANT. A model
        already int8 passes through as it is; anything but "int8" or
        None raises `ValueError`.
    mesh : shard the model over a tensor-parallel serving mesh (None
        reads HVD_SERVE_MESH; the forms of `_resolve_serving_mesh`).
        Every rank of its ``model`` axis builds the engine with the same
        arguments and a model of the same weights; the weights are
        sharded at the door (after the int8 clone), the pools hold each
        rank's kv heads, and model rank 0 leads while the others run
        `follow`. Only ``model`` may exceed 1; speculative decoding
        and ``auto_restart`` under a mesh raise.
    slo : an `obs.slo.SLOMonitor`; None reads ``HVD_SLO``.
    preempt, tenant_weights, brownout : the overload control plane.
        On the paged pool preemption swaps the victim's KV blocks to a
        host shelf when it can (recompute otherwise) and admission
        turns optimistic (watermark reservations grown just in time);
        on the fixed pool it recomputes.
    swap_bytes : host-RAM byte budget of the preemption swap shelf;
        None reads HVD_SWAP_BYTES (256 MiB); 0 makes every preemption
        recompute.
    """

    def __init__(self, model: TransformerLM, *,
                 num_slots: int = 4, max_queue: int = 16,
                 eos_id: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 mesh=None, auto_restart: bool = False,
                 max_restarts: int = 2,
                 tick_deadline_s: Optional[float] = None,
                 stall_warning_s: Optional[float] = None,
                 warmup: bool = False,
                 prefill_chunk_budget: Optional[int] = None,
                 pipeline_depth: int = 1,
                 paged: bool = False,
                 kv_block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 paged_kernel: Optional[str] = None,
                 spec_draft=None, spec_k: Optional[int] = None,
                 weight_quant: Optional[str] = None,
                 slo=None,
                 preempt: Optional[bool] = None,
                 tenant_weights=None,
                 brownout: Optional[bool] = None,
                 swap_bytes: Optional[int] = None):
        if eos_id is not None and not 0 <= eos_id < model.vocab_size:
            raise ValueError(
                f"eos_id must be in [0, vocab_size={model.vocab_size}"
                f"), got {eos_id}")
        from horovod_tpu_torch.runtime.config import config as _cfg
        if spec_draft is not None and (mesh is not None
                                       or _cfg.serve_mesh.strip()):
            raise NotImplementedError(
                f"speculative decoding on a serving mesh: {_MESH_LATER}")
        mesh = _resolve_serving_mesh(mesh, model.device.type)
        if mesh is not None and auto_restart:
            # A restart swaps the pool while a follower may sit inside a
            # model-axis all-reduce the leader will never issue.
            raise NotImplementedError(
                f"auto_restart on a serving mesh: {_MESH_LATER}")
        # Weight-only int8 at the engine door: the block kernels become
        # int8 codes plus per-channel scales.
        if weight_quant is None:
            weight_quant = _cfg.weight_quant or None
        if weight_quant:
            if weight_quant != "int8":
                raise ValueError(
                    f"weight_quant must be 'int8' (or None), got "
                    f"{weight_quant!r}")
            from horovod_tpu_torch.ops.quantization import quantize_lm
            model = quantize_lm(model)
        self.weight_quant = model.weight_quant
        self.mesh = mesh
        self._channel = None
        self._follower = False
        if mesh is not None:
            model = self._shard_at_the_door(model, mesh)
        # Speculative decoding: rounds are synchronous, so the tick ring
        # is off (the multi-token retire is the amortization).
        self.spec_k = 0
        spec_kw = {}
        if spec_draft is not None:
            self.spec_k = int(_cfg.spec_k if spec_k is None else spec_k)
            spec_kw = dict(spec_draft=spec_draft, spec_k=self.spec_k)
            pipeline_depth = 0
        self.model = model
        self.eos_id = eos_id
        self.default_timeout_s = default_timeout_s
        # Process-unique engine number: the /healthz provider key and
        # the `engine` label on the shared engine-scoped gauges.
        self._engine_id = next(_ENGINE_IDS)
        if slo is None:
            from horovod_tpu_torch.obs.slo import SLOMonitor
            slo = SLOMonitor.from_env()
        self.slo = slo
        self.metrics = EngineMetrics(
            engine_label=str(self._engine_id), slo=slo)
        self.metrics.observe_mesh(self.mesh_devices, self._mesh_shape())
        self.auto_restart = auto_restart
        self.max_restarts = max_restarts
        self.tick_deadline_s = tick_deadline_s
        if prefill_chunk_budget is None:
            prefill_chunk_budget = _cfg.prefill_chunk_budget
        self.prefill_chunk_budget = int(prefill_chunk_budget)
        self.pipeline_depth = max(0, min(1, int(pipeline_depth)))
        if stall_warning_s is None:
            stall_warning_s = _cfg.stall_warning_time
        self.stall = StallMonitor(warning_time_s=stall_warning_s,
                                  check_every_s=max(
                                      1.0, stall_warning_s / 4))
        self.paged = bool(paged)
        if self.paged:
            from horovod_tpu_torch.serving.paging import PagedSlotPool
            if kv_blocks is None:
                kv_blocks = _cfg.kv_blocks
            self.pool = PagedSlotPool(
                model, num_slots,
                num_blocks=(int(kv_blocks) if kv_blocks
                            and int(kv_blocks) > 0 else None),
                block_size=kv_block_size, eos_id=eos_id,
                prefix_cache=prefix_cache, kernel=paged_kernel,
                # Evictions are operator-visible cache pressure: the
                # allocator reports each one straight into this
                # engine's metrics.
                on_evict=lambda: self.metrics.count("prefix_evictions"),
                **spec_kw)
        else:
            self.pool = SlotPool(model, num_slots, eos_id=eos_id, **spec_kw)
        if self.mesh is not None:
            from horovod_tpu_torch.serving.lockstep import (LeaderPool,
                                                            SideChannel)
            self._channel = SideChannel(self.mesh)
            self._follower = model.tp_rank != 0
            if not self._follower:
                self.pool = LeaderPool(self.pool, self._channel)
        # Warmup runs on the constructor thread BEFORE the dispatch
        # thread exists, so the single-device-thread contract holds. A
        # follower warms up when the leader's descriptor arrives.
        self.warmup_info = None
        if warmup and not self._follower:
            self.warmup_info = self.pool.warmup(
                max_chunk=(self.prefill_chunk_budget
                           if self.prefill_chunk_budget > 0 else None))
            self.metrics.observe_warmup(self.warmup_info["seconds"])
        # First-time calls past this baseline (0 on a warmed engine).
        self._compile_baseline = self.pool.compiles
        self.metrics.observe_pipeline(self.pipeline_depth)
        # Overload control plane: priority + weighted-fair admission is
        # always on (an unconfigured queue is plain FIFO); preemption
        # (HVD_PREEMPT) and the brownout ladder (HVD_BROWNOUT) are
        # knobs.
        from horovod_tpu_torch.serving.overload import (
            BrownoutController, OverloadControl, SwapStore,
            parse_tenant_weights)
        if tenant_weights is None:
            weights = parse_tenant_weights(_cfg.tenant_weights)
        elif isinstance(tenant_weights, str):
            weights = parse_tenant_weights(tenant_weights)
        else:
            weights = dict(tenant_weights)
        self._tenant_weights = weights
        self.queue = AdmissionQueue(max_queue, tenant_weights=weights)
        self.preempt = bool(_cfg.preempt if preempt is None
                            else preempt)
        self._overload = None
        if self.preempt:
            swap = None
            # On a serving mesh every preemption recomputes: the swap
            # shelf's export and re-graft are not mirrored to the
            # followers (a later slice, with device-mode transfer).
            if (self.paged and self.pool.blocks.prefix_cache
                    and self.mesh is None):
                sb = int(_cfg.swap_bytes if swap_bytes is None
                         else swap_bytes)
                if sb > 0:
                    swap = SwapStore(sb)
            if self.paged:
                # Optimistic (watermark) admission: reserve one block
                # of decode headroom instead of the worst case — safe
                # ONLY because overflow now preempts (the scheduler
                # grows chains just in time and resolves stranded
                # lanes) instead of deadlocking.
                self.pool.blocks.watermark = self.pool.block_size
            self._overload = OverloadControl(preempt=True, swap=swap)
        self.brownout = None
        if bool(_cfg.brownout if brownout is None else brownout):
            self.brownout = BrownoutController(
                slo=self.slo, metrics=self.metrics,
                on_level=self._apply_brownout)
        self._obs_tenant = _obs_catalog.tenant_metrics()
        # Inbound KV-block transfers (serving/transfer.py), appended by
        # `offer_transfer` from any thread, drained on the dispatch
        # thread. Survives watchdog restarts — the replacement
        # scheduler inherits the deque.
        self._grafts: "collections.deque" = collections.deque()
        self.scheduler = ContinuousBatchingScheduler(
            self.pool, self.queue, self.metrics, eos_id=eos_id,
            stall=self.stall,
            prefill_chunk_budget=self.prefill_chunk_budget,
            pipeline_depth=self.pipeline_depth, grafts=self._grafts,
            overload=self._overload)
        self._ids = itertools.count()
        self._lock = lockcheck.register(
            "ServingEngine._lock", threading.Lock())
        self._closing = False
        self._drain = True
        # Restart machinery: `_epoch` names the CURRENT dispatch
        # generation; a dispatch thread that observes a newer epoch
        # knows it was superseded and exits without touching anything.
        self._epoch = 0
        self._restart_count = 0
        self._heartbeat = time.time()
        self._thread = threading.Thread(
            target=self._dispatch_loop,
            args=(0, self.scheduler, self.queue),
            name="serving-dispatch", daemon=True)
        if not self._follower:
            self._thread.start()
        # Observability plane (docs/observability.md): the engine
        # reports its dispatch generation + liveness at /healthz (so a
        # prober can tell an in-place watchdog restart from a process
        # restart) and mirrors the generation into the shared gauge
        # (labeled per engine). Registered BEFORE the watchdog exists:
        # a restart touching `_obs_gen` must never race construction.
        self._obs_gen = _obs_catalog.serving_metrics()[
            "engine_generation"]
        self._obs_gen.set(0, engine=str(self._engine_id))
        _obs_registry().register_health(
            f"serving_engine_{self._engine_id}", self._health)
        # The SLO monitor is its own /healthz component: a fast-burn
        # breach reads healthy=false there, flipping the endpoint to
        # 503 while the dispatch thread is still perfectly alive —
        # "up but missing its objectives" is a drainable state.
        if self.slo is not None:
            _obs_registry().register_health(
                f"serving_slo_{self._engine_id}", self.slo.health)
        # Flight-recorder in-flight provider (obs/flightrec.py): at
        # dump time the bundle lists this engine's decoding /
        # mid-prefill / queued requests with their trace_ids.
        _flightrec.register_inflight(
            f"serving_engine_{self._engine_id}", self._inflight_states)
        # Env-gated exporter bring-up (no-op unless HVD_METRICS_PORT
        # is set): a serving process that never calls init() still
        # honors the knob.
        from horovod_tpu_torch.obs.exporter import start_exporter
        start_exporter()
        self._watchdog: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()
        if auto_restart:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serving-watchdog",
                daemon=True)
            self._watchdog.start()

    def _shard_at_the_door(self, model: TransformerLM, mesh):
        """This rank's tensor-parallel shard of ``model`` over ``mesh``:
        checks that only the serving axis is > 1, and shards a whole
        model (`models.transformer.shard_model`); a model already built
        over ``mesh`` passes through."""
        from horovod_tpu_torch.models.transformer import _serve_kv_axis
        from horovod_tpu_torch.parallel.mesh import mesh_shape
        axis = _serve_kv_axis()
        others = {k: v for k, v in mesh_shape(mesh).items()
                  if k != axis and v > 1}
        if others:
            raise ValueError(
                f"serving mesh axes {others}: the port shards serving "
                f"over {axis!r} only (each other axis must be 1)")
        if model.mesh is mesh:
            return model
        if model.tp > 1:
            raise ValueError("the model is sharded over another mesh "
                             "than the serving mesh")
        from horovod_tpu_torch.models.transformer import shard_model
        return shard_model(model, mesh)

    @property
    def mesh_devices(self) -> int:
        """Devices (ranks) in the serving mesh (1 = unsharded)."""
        return 1 if self.mesh is None else int(self.mesh.size())

    def _mesh_shape(self):
        """Non-trivial mesh axes as {axis: size} (None = unsharded): the
        stamp /healthz, the metrics snapshot and flight-recorder bundles
        carry; size-1 axes are dropped."""
        if self.mesh is None:
            return None
        from horovod_tpu_torch.parallel.mesh import mesh_shape
        return {k: int(v) for k, v in mesh_shape(self.mesh).items()
                if v > 1}

    @property
    def is_follower(self) -> bool:
        """True on a model rank > 0 of a serving mesh: the engine takes
        no submits and runs `follow`."""
        return self._follower

    def follow(self, *, drop: Optional[str] = None):
        """A follower's whole job: replay the leader's pool calls in
        lockstep until the leader's engine stops (`serving.lockstep.
        follow`), then return. Raises `ShardDivergence` when this rank's
        tokens or host state leave the leader's. ``drop`` is a planted
        fault for tests (skip the first descriptor of that name)."""
        if not self._follower:
            raise RuntimeError("follow() runs on a follower rank (model "
                               "rank > 0 of a serving mesh)")
        from horovod_tpu_torch.serving import lockstep
        self.pool = lockstep.follow(self.pool, self._channel, drop=drop)

    def _inflight_states(self) -> list:
        """Flight-recorder provider: every request this engine
        currently owes an answer for, with its trace_id — decoding,
        mid-prefill, and queued. Read WITHOUT the scheduler's locks
        (dump time may be mid-crash; the recorder contains any racing
        mutation error, and a slightly torn list beats a deadlocked
        post-mortem)."""
        sched = self.scheduler
        out = []

        def rec(req, phase, slot=None):
            out.append({
                "phase": phase, "slot": slot,
                "request_id": req.id, "trace_id": req.trace_id,
                "tokens": len(req.tokens),
                "prompt_tokens": int(req.prompt.shape[0]),
                "max_new_tokens": req.max_new_tokens,
                "deadline": req.deadline,
                "t_submit": req.t_submit,
            })

        for slot, req in list(sched.active.items()):
            rec(req, "decode", slot)
        for slot, job in list(sched.prefilling.items()):
            rec(job.req, "prefill", slot)
        for req in self.queue.snapshot():
            rec(req, "queued")
        return out

    def _health(self) -> dict:
        with self._lock:
            alive = self._thread.is_alive()
            return {
                "engine_generation": self._epoch,
                "dispatch_alive": alive,
                "closing": self._closing,
                "restarts": self._restart_count,
                "queue_depth": len(self.queue),
                # Mesh stamp: /healthz (and the flight-recorder
                # bundle's health snapshot) names the layout a
                # replica is serving from — a sharded and an
                # unsharded replica are otherwise indistinguishable.
                "mesh_devices": self.mesh_devices,
                "mesh": self._mesh_shape(),
                # Drives /healthz's HTTP code: a dead (or draining)
                # dispatch thread must read 503 to a status-code
                # probe, not 200-with-fine-print.
                "healthy": alive and not self._closing,
            }

    # -- overload control ---------------------------------------------

    def _apply_brownout(self, tenant: str, old: int, new: int):
        """The brownout ladder's teeth (`BrownoutController.on_level`,
        dispatch thread). Level 1 is enforced at the router via
        `hedge_allowed`; level 2 caps speculative k engine-wide at
        max(1, spec_k // 2) (greedy speculative decoding is token-exact
        for any k, so the cap sheds draft compute without changing a
        token); level 3 queues the tenant for a lowest-priority
        preemption at the next scheduler step."""
        if self.spec_k:
            self.pool.spec_cap = (max(1, self.spec_k // 2)
                                  if self.brownout.max_level() >= 2
                                  else None)
        if new >= 3 and self._overload is not None:
            self._overload.tenant_preempts.append(tenant)

    def hedge_allowed(self, tenant: str = "") -> bool:
        """Router hook: False while ``tenant`` sits at brownout level
        >= 1 — hedging a burning tenant amplifies exactly the load
        that is burning it."""
        return self.brownout is None or self.brownout.level(tenant) < 1

    # -- submit side --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0,
               top_p: Optional[float] = None, seed: int = 0,
               timeout_s: Optional[float] = None,
               forced_prefix=None,
               trace_id: Optional[str] = None,
               parent_span: str = "",
               priority: int = 0,
               tenant: str = "") -> RequestHandle:
        """Enqueue one generation request; returns immediately.

        Raises `QueueFullError` when the admission queue is at
        capacity (load shedding — never blocks the caller) and
        `EngineClosedError` after shutdown. Validation errors raise
        before the request is queued.

        ``priority`` (higher = more important, default 0) orders
        admission in strict bands and decides preemption eligibility
        (a blocked higher-priority head may evict strictly
        lower-priority streams when HVD_PREEMPT is on). ``tenant``
        names the submitter's WFQ lane / SLO bucket; "" is the
        untenanted default lane.

        ``forced_prefix`` is the token-exact continuation hook
        (docs/serving.md "Fleet failover"): tokens a previous engine
        already generated for this request. They are teacher-forced
        into the KV cache after the prompt (never re-sampled), count
        against ``max_new_tokens``, pre-seed the handle's
        ``tokens_so_far()``/result stream, and the sample stream
        resumes at ordinal len(forced_prefix) — so the completed
        stream is bitwise what an uninterrupted run would have
        produced. ``trace_id`` overrides the minted observability id
        so a migrated/hedged request keeps its original identity
        across engines; ``parent_span`` hangs this engine leg's spans
        under the caller's span (a router attempt, a disagg handoff).
        With both unset this is a CLIENT entry: the engine mints the
        trace, opens the ``serving.request`` root span, and records
        the arrival in the ``HVD_REQLOG`` request log.
        """
        if self._follower:
            raise RuntimeError(
                "submit on a follower rank of a serving mesh: requests go "
                "to the leader (model rank 0); this rank runs follow()")
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array, got "
                f"shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"prompt must hold integer token ids, got dtype "
                f"{prompt.dtype}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        forced = ()
        if forced_prefix is not None and len(forced_prefix):
            fp = np.asarray(forced_prefix)
            if fp.ndim != 1 or not np.issubdtype(fp.dtype, np.integer):
                raise ValueError(
                    f"forced_prefix must be a 1-D integer token "
                    f"array, got shape {fp.shape} dtype {fp.dtype}")
            if fp.shape[0] >= max_new_tokens:
                raise ValueError(
                    f"forced_prefix ({fp.shape[0]} tokens) leaves no "
                    f"decode budget (max_new_tokens={max_new_tokens})")
            if self.eos_id is not None and self.eos_id in fp:
                raise ValueError(
                    f"forced_prefix contains eos_id={self.eos_id} — "
                    f"the original stream already finished")
            forced = tuple(int(t) for t in fp)
        P = int(prompt.shape[0])
        if (not self.model.unbounded
                and P + max_new_tokens - 1 > self.model.max_len):
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) - 1 "
                f"exceeds max_len={self.model.max_len}")
        if self.spec_k:
            if temperature > 0:
                raise ValueError(
                    "speculative serving is greedy-only (the greedy "
                    "acceptance rule is the token-exactness proof); "
                    "submit with temperature=0 or build the engine "
                    "without spec_draft")
            if P + max_new_tokens + self.spec_k - 1 > self.model.max_len:
                # The verify writes up to spec_k rows past the last
                # budgeted token before the rewind; they must stay in
                # the cache (a clamped linear-cache write would corrupt
                # the tail rows).
                raise ValueError(
                    f"prompt ({P}) + max_new_tokens ({max_new_tokens}) + "
                    f"spec_k ({self.spec_k}) - 1 exceeds max_len="
                    f"{self.model.max_len} (speculative verify needs k "
                    f"tokens of cache headroom)")
        if self.paged and not self.pool.fits(
                P + len(forced), max_new_tokens - len(forced)):
            # A request whose WORST-CASE block need exceeds the whole
            # pool could never admit — it would park at the queue head
            # starving everything behind it. Shed at the front door
            # instead. The need is NET of the forced prefix: a resume
            # can only generate max_new - len(forced) more tokens.
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) "
                f"needs more KV blocks than the paged pool holds "
                f"({self.pool.num_blocks - 1} x "
                f"{self.pool.block_size} tokens); raise kv_blocks "
                f"(HVD_KV_BLOCKS) or lower the request size")
        sampling = SamplingParams(temperature=temperature, top_p=top_p,
                                  seed=seed)
        sampling.validate()
        timeout_s = (self.default_timeout_s if timeout_s is None
                     else timeout_s)
        now = time.time()
        minted = trace_id is None
        req = Request(
            id=next(self._ids), prompt=prompt,
            max_new_tokens=max_new_tokens, sampling=sampling,
            deadline=None if timeout_s is None else now + timeout_s,
            future=Future(),
            trace_id=trace_id or _tracing.new_trace_id(),
            t_submit=now, forced=forced, tokens=list(forced),
            parent_span=parent_span,
            priority=int(priority), tenant=str(tenant))
        if minted:
            # Client entry: this engine owns the trace ROOT (closed in
            # the scheduler's finalize, where the anatomy is observed)
            # and the arrival belongs in the HVD_REQLOG request log.
            # Routed/internal legs (trace_id given) do neither — the
            # router owns their root and already recorded them.
            req.span_ids["root"] = _spans.begin_span(
                "serving.request", trace_id=req.trace_id,
                prompt_tokens=P, max_new_tokens=max_new_tokens,
                tenant=req.tenant, priority=req.priority)
            _reqlog.record(prompt, max_new_tokens, tenant=req.tenant,
                           priority=req.priority,
                           trace_id=req.trace_id)
        self.metrics.count("submitted")
        if req.tenant:
            if self.brownout is not None:
                self.brownout.touch(req.tenant)
            self._obs_tenant["requests"].inc(tenant=req.tenant,
                                             outcome="submitted")
        _span("begin_span", req.id, "QUEUE", trace_id=req.trace_id)
        req.span_ids["queued"] = _spans.begin_span(
            "serving.queued", trace_id=req.trace_id,
            parent_id=req.parent_span or req.span_ids.get("root", ""),
            tenant=req.tenant, priority=req.priority)
        try:
            self.queue.offer(req)
        except QueueFullError:
            self.metrics.count("rejected")
            self.metrics.observe_admission(False, tenant=req.tenant)
            if req.tenant:
                self._obs_tenant["requests"].inc(tenant=req.tenant,
                                                 outcome="shed")
            _span("end_span", req.id, "QUEUE")
            _spans.end_span(req.span_ids.pop("queued", ""),
                            status="shed")
            _spans.end_span(req.span_ids.pop("root", ""),
                            status="shed")
            _events.emit("serving.shed", request_id=req.id,
                         trace_id=req.trace_id, tenant=req.tenant,
                         queue_depth=len(self.queue))
            raise
        except EngineClosedError:
            _span("end_span", req.id, "QUEUE")
            _spans.end_span(req.span_ids.pop("queued", ""),
                            status="closed")
            _spans.end_span(req.span_ids.pop("root", ""),
                            status="closed")
            raise
        self.metrics.observe_admission(True, tenant=req.tenant)
        _events.emit("serving.submit", request_id=req.id,
                     trace_id=req.trace_id,
                     prompt_tokens=P, max_new_tokens=max_new_tokens)
        return RequestHandle(req)

    def release_device_memory(self):
        """Free the KV of a shut-down engine's pool: a router calls it
        for a dead replica before building the replacement, so one card
        never holds both replicas' pools. Raises `RuntimeError` while
        the dispatch thread still runs."""
        if self._thread.is_alive():
            raise RuntimeError("release_device_memory on an engine whose "
                               "dispatch thread still runs")
        self.pool.release()

    def offer_transfer(self, transfer) -> bool:
        """Enqueue an inbound KV-block transfer (serving/transfer.py)
        for ingest on the dispatch thread. Callable from any thread
        (deque append is atomic); the scheduler drains the inbox before
        every admission peek, so an offer made BEFORE the submit it
        accelerates is grafted before that request's prompt is
        matched. False when this engine cannot ingest (non-paged pool,
        or closing) — the caller's submit still works, it just
        re-prefills."""
        if (transfer is None or not self.paged or self._closing
                or self.mesh is not None):
            return False
        self._grafts.append(transfer)
        return True

    # -- dispatch side ------------------------------------------------

    def _dispatch_loop(self, epoch: int,
                       scheduler: ContinuousBatchingScheduler,
                       queue: AdmissionQueue):
        # `scheduler`/`queue` are BOUND at thread start: after a
        # watchdog restart `self.scheduler` points at the successor's
        # state, and a superseded thread limping out of a hung device
        # call must keep driving its own (abandoned) scheduler, never
        # the replacement's.
        try:
            while True:
                if chaos.fires("serving_dispatch_crash"):
                    self.metrics.count("faults_injected")
                    raise chaos.ChaosError(
                        "injected serving dispatch-thread crash "
                        "(site serving_dispatch_crash)")
                progressed = scheduler.step()
                with self._lock:
                    if self._epoch != epoch:
                        return   # superseded by a watchdog restart
                    closing, drain = self._closing, self._drain
                    # Heartbeat only AFTER the epoch check (a
                    # superseded thread limping out of a hung call
                    # must not refresh the live generation's stuck
                    # timer), and under the lock — the watchdog reads
                    # it against tick_deadline_s (hvdlint HVD004).
                    self._heartbeat = time.time()
                self.metrics.observe_gauges(
                    len(queue), scheduler.pool.busy_slots,
                    scheduler.pool.num_slots)
                if self.paged:
                    self.metrics.observe_kv(scheduler.pool.kv_stats())
                if (self._overload is not None
                        and self._overload.swap is not None):
                    self.metrics.observe_swap_store(
                        self._overload.swap.stats())
                # Brownout control loop: evaluated here on the
                # dispatch thread (internally rate-limited) so the
                # ladder's teeth — the tenant preemption mailbox —
                # touch pool state only where device work happens.
                if self.brownout is not None:
                    self.brownout.step()
                if closing:
                    if not drain:
                        scheduler.abort_active()
                        return
                    if (not scheduler.has_active()
                            and len(queue) == 0):
                        return
                    continue
                if not progressed and not scheduler.has_active():
                    queue.wait(_IDLE_WAIT_S)
        # hvd: disable=HVD006(THE containment boundary: any dispatch-thread fault must fail the in-flight futures, never leave callers hanging)
        except BaseException as e:  # noqa: BLE001 — fail futures, not hang
            # A dispatch-thread fault (a poison request, a compile
            # failure, device OOM, an injected crash). With the
            # watchdog on and restart budget left, just exit: the
            # watchdog sees the dead thread and restarts the engine in
            # place, re-queuing this thread's in-flight requests.
            with self._lock:
                superseded = self._epoch != epoch
                healable = (self.auto_restart and not self._closing
                            and not superseded
                            and self._restart_count < self.max_restarts)
            if superseded:
                # A watchdog restart already took this generation's
                # requests; the queue and futures belong to the
                # successor now — containment here would close the
                # LIVE engine. Exit quietly.
                sys.stderr.write(
                    f"superseded serving dispatch thread exited with "
                    f"{e!r} (already recovered)\n")
                return
            if healable:
                sys.stderr.write(
                    f"serving dispatch thread crashed ({e!r}); "
                    f"watchdog restarting the engine\n")
                return
            # Containment (no watchdog / budget exhausted): a dead
            # dispatch thread must not leave callers blocked in
            # result() forever. Fail every in-flight and queued future
            # with the error, mark the engine closed so later submits
            # are rejected, and log the traceback (no re-raise: the
            # futures carry the failure to callers).
            with self._lock:
                self._closing = True
            # Flight-recorder dump BEFORE the futures are failed: the
            # unhandled dispatch exception is precisely the incident
            # whose in-flight trace_ids the post-mortem bundle exists
            # to preserve (no-op unless HVD_FLIGHT_DIR is set).
            _flightrec.trigger(
                "serving.dispatch_crash", engine=self._engine_id,
                error=repr(e))
            scheduler.fail_inflight(lambda req: EngineClosedError(
                f"serving dispatch thread died: {e!r}"))
            queue.close(drain=False)  # fails queued futures too
            sys.stderr.write("serving dispatch thread died:\n")
            traceback.print_exc(file=sys.stderr)

    # -- self-healing (docs/resilience.md) ----------------------------

    def _watchdog_loop(self):
        """Detect a dead or stuck dispatch thread and heal in place."""
        poll = 0.02
        if self.tick_deadline_s is not None:
            poll = min(poll, self.tick_deadline_s / 4)
        while not self._wd_stop.wait(poll):
            with self._lock:
                if self._closing:
                    return
                thread = self._thread
                # Snapshot under the same lock the dispatch thread
                # writes it under (hvdlint HVD008) — the bare read
                # raced the writer it was timing.
                heartbeat = self._heartbeat
            dead = not thread.is_alive()
            # Stuck = stale heartbeat with work pending, EXCEPT while
            # the pool may be inside a first-time-shape XLA compile
            # (arbitrarily long, and progress, not a hang). No
            # first-step grace beyond that: a poison request re-queued
            # to the front must trip detection again in the successor
            # generation, not hang it forever.
            stuck = (self.tick_deadline_s is not None
                     and not self.pool.maybe_compiling
                     and (self.scheduler.has_active()
                          or len(self.queue) > 0)
                     and (time.time() - heartbeat
                          > self.tick_deadline_s))
            if not (dead or stuck):
                continue
            if self._restart_count >= self.max_restarts:
                self._contain(
                    f"dispatch {'died' if dead else 'stuck'} with the "
                    f"restart budget ({self.max_restarts}) exhausted")
                return
            self._restart("died" if dead else
                          f"no heartbeat for {self.tick_deadline_s}s")

    def _restart(self, reason: str):
        """Restart the engine in place: abandon the old dispatch
        generation, re-queue its recoverable requests, stand up a
        fresh slot pool + scheduler + dispatch thread."""
        with self._lock:
            if self._closing:
                return
            t_fault = self._heartbeat   # last sign of life
            self._epoch += 1
            epoch = self._epoch
            self._restart_count += 1
        old = self.scheduler
        # abandon() marks the old generation dead and takes its
        # in-flight requests atomically vs the old thread's admit
        # registration (scheduler handoff lock) — no request can fall
        # between the snapshot and the old thread's bookkeeping.
        inflight = old.abandon()
        now = time.time()
        requeued = []
        for req in inflight:
            if req.cancelled:
                self.metrics.count("cancelled")
                old._resolve(req.future, exc=CancelledError())
            elif req.expired(now):
                self.metrics.count("timed_out")
                old._resolve(req.future, exc=DeadlineExceededError(
                    f"request {req.id}: deadline passed during engine "
                    f"restart ({len(req.tokens)} tokens in)",
                    partial_tokens=list(req.tokens)))
            else:
                # Fresh Request sharing the future/cancel-flag/id:
                # replay from the prompt is token-exact (greedy and
                # seeded sampling are deterministic), and a fresh
                # tokens list means the old thread limping out of a
                # hung tick cannot corrupt the replay. prefix_cached
                # resets too: the successor pool's cache starts COLD
                # (untrusted device state), so the replay's own
                # re-admission decides what it skips. A forced-prefix
                # continuation re-seeds its tokens with the forced
                # span — those were generated by an earlier engine
                # and are part of the stream contract, not replayed.
                resumed = dataclasses.replace(
                    req, tokens=list(req.forced), t_prefill=0.0,
                    t_first=0.0, prefix_cached=0)
                # Span continuity across the restart: the abandoned
                # generation's open leg spans close here (span_ids is
                # the SHARED dict dataclasses.replace carried over),
                # an instant serving.restart_requeue marker records
                # the seam, and the replay re-enters the queue under
                # a fresh serving.queued span — one tree, one trace.
                parent = (resumed.parent_span
                          or resumed.span_ids.get("root", ""))
                for slot in ("queued", "prefill", "decode", "paused"):
                    _spans.end_span(resumed.span_ids.pop(slot, ""),
                                    status="restart_abandoned")
                _spans.record_span(
                    "serving.restart_requeue",
                    trace_id=resumed.trace_id, parent_id=parent,
                    generation=epoch, tokens=len(resumed.tokens))
                resumed.span_ids["queued"] = _spans.begin_span(
                    "serving.queued", trace_id=resumed.trace_id,
                    parent_id=parent, requeued=True,
                    tenant=resumed.tenant, priority=resumed.priority)
                requeued.append(resumed)
        n = self.queue.requeue(requeued)
        self.metrics.count("restarts")
        if n:
            self.metrics.count("requeued", n)
        self._obs_gen.set(epoch, engine=str(self._engine_id))
        # Requeue continuity: the replayed requests keep their
        # ORIGINAL trace_ids (dataclasses.replace preserves the
        # field), so the event log shows one id crossing the restart.
        _events.emit(
            "serving.restart", engine=self._engine_id, reason=reason,
            generation=epoch, requeued=n,
            failed=len(inflight) - len(requeued),
            requeued_trace_ids=[r.trace_id for r in requeued])
        # Post-mortem bundle (obs/flightrec.py, no-op unless
        # HVD_FLIGHT_DIR is set), cut AFTER the requeue and the
        # restart event: the ring's newest event is the restart
        # itself, and the re-queued requests — the crash's survivors,
        # original trace_ids — are captured by the in-flight provider
        # as "queued".
        _flightrec.trigger(
            "serving.restart", engine=self._engine_id, reason=reason,
            generation=epoch,
            requeued_trace_ids=[r.trace_id for r in requeued])
        # Fresh device state: the old pool's cache is mid-unknown-
        # tick; the kernels are already built, so this is cheap. The
        # overload plane survives the restart: the swap shelf's entries
        # are HOST bytes, so a stream preempted-to-swap before the
        # crash still restores into the successor pool (clone_fresh
        # carries the watermark).
        self.pool = self.pool.clone_fresh()
        self.scheduler = ContinuousBatchingScheduler(
            self.pool, self.queue, self.metrics, eos_id=self.eos_id,
            stall=self.stall,
            prefill_chunk_budget=self.prefill_chunk_budget,
            pipeline_depth=self.pipeline_depth, grafts=self._grafts,
            overload=self._overload)
        with self._lock:
            self._heartbeat = time.time()
            self._thread = threading.Thread(
                target=self._dispatch_loop,
                args=(epoch, self.scheduler, self.queue),
                name=f"serving-dispatch-{epoch}", daemon=True)
            self._thread.start()
        self.metrics.observe_recovery(time.time() - t_fault)
        sys.stderr.write(
            f"serving watchdog: dispatch {reason}; engine restarted "
            f"in place (restart {self._restart_count}/"
            f"{self.max_restarts}, {n} request(s) re-queued, "
            f"{len(inflight) - len(requeued)} failed)\n")

    def _contain(self, why: str):
        """Terminal failure: close and fail everything (the
        degrade-by-shedding contract)."""
        with self._lock:
            self._closing = True
        # Dump BEFORE the futures fail: containment is the terminal
        # incident, and the bundle is the only record of what was in
        # flight when the engine gave up.
        _flightrec.trigger("serving.contain",
                           engine=self._engine_id, reason=why)
        sched = self.scheduler
        for req in sched.abandon():
            sched._resolve(req.future, exc=EngineClosedError(
                f"serving engine gave up: {why}"))
        doomed = self.queue.close(drain=False)
        self.metrics.count("aborted", len(doomed))
        _events.emit("serving.contain", engine=self._engine_id,
                     reason=why, failed=len(doomed))
        sys.stderr.write(f"serving watchdog: {why}; engine closed\n")

    # -- lifecycle ----------------------------------------------------

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None):
        """Stop the engine. ``drain=True`` (default) finishes every
        queued and in-flight request first — the clean-exit contract;
        ``drain=False`` fails queued requests with `EngineClosedError`
        and aborts in-flight ones at the next tick. Idempotent."""
        # The watchdog goes down FIRST (joined, not just signalled): a
        # restart racing the close below could stand up a new dispatch
        # thread after this join picked the old one.
        self._wd_stop.set()
        if self._watchdog is not None:
            self._watchdog.join()
        with self._lock:
            self._closing = True
            self._drain = self._drain and drain
            effective_drain = self._drain
        if self._follower:
            # No dispatch thread: follow() returned when the leader
            # stopped.
            self.queue.close(drain=False)
            self.stall.stop()
            self._unregister()
            return
        # close() is idempotent; re-closing after a drain→no-drain
        # downgrade (force-stop following a timed-out graceful
        # shutdown) fails whatever is STILL queued instead of leaving
        # those futures pending forever.
        doomed = self.queue.close(effective_drain)
        self.metrics.count("aborted", len(doomed))
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"serving dispatch thread still draining after "
                f"{timeout}s (queue={len(self.queue)}, "
                f"active={self.pool.busy_slots})")
        if self.mesh is not None:
            # The followers leave follow() once the dispatch thread is
            # gone (the stop descriptor carries the final digest).
            self.pool.stop()
        self.stall.stop()
        # The dispatcher is gone. A submit racing the close above (its
        # offer landed after the dispatcher saw `closing` and exited,
        # but before queue.close flipped the rejected flag) would
        # leave a future nobody will ever resolve — fail any such
        # straggler now (idempotent re-close with drain=False).
        stragglers = self.queue.close(drain=False)
        self.metrics.count("aborted", len(stragglers))
        # And if the dispatcher died (crash between watchdog stop and
        # here, or healable crash whose restart never happened), its
        # in-flight futures — decoding AND mid-prefill — must not
        # dangle.
        n = self.scheduler.fail_inflight(
            lambda req: EngineClosedError(
                f"engine shut down while request {req.id} was in "
                f"flight"))
        self.metrics.count("aborted", n)
        self._unregister()

    def _unregister(self):
        # The engine is gone from /healthz AND its labeled gauge rows
        # leave the registry (idempotent: double shutdown removes
        # missing keys harmlessly) — scrape cardinality tracks live
        # engines only. Same for the SLO component and the
        # flight-recorder provider.
        _obs_registry().unregister_health(
            f"serving_engine_{self._engine_id}")
        _obs_registry().unregister_health(
            f"serving_slo_{self._engine_id}")
        _flightrec.unregister_inflight(
            f"serving_engine_{self._engine_id}")
        self.metrics.close()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)

    # -- introspection ------------------------------------------------

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        # Hot-path first-time-shape compiles (0 on a warmed engine —
        # the "no compile inside the timed window" guarantee ci.sh
        # asserts) and what warmup paid up front.
        snap["compiles"] = self.pool.compiles - self._compile_baseline
        snap["warmup_compiles"] = ((self.warmup_info or {})
                                   .get("compiles", 0))
        if self.brownout is not None:
            snap["brownout"] = self.brownout.summary()
        if self._overload is not None and self._overload.swap is not None:
            snap["swap_store"] = self._overload.swap.stats()
        return snap

    @property
    def num_slots(self) -> int:
        return self.pool.num_slots

    @property
    def queue_depth(self) -> int:
        return len(self.queue)
