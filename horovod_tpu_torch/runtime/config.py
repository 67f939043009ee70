"""Environment-variable configuration surface.

The single source of truth for every ``HVD_*`` / ``HOROVOD_*``
environment knob the port reads: each knob is declared in the `KNOBS`
registry below, and other modules read the environment only through
the `env_str` / `env_int` / `env_float` accessors, which refuse
unregistered names. `env_table_md` renders the registry as a markdown
table.

Only knobs that a ported module reads are registered. A knob of the
JAX package whose consumer is not ported yet (the router and fleet,
the metrics exporter, profiling, elastic membership, checkpoints,
...) is registered by the slice that ports
its consumer; ROADMAP.md lists them until then. ``HOROVOD_COORDINATOR``
(the ``jax.distributed`` address) has no reader over
`torch.distributed` and stays unregistered.
``HVD_SERVE_MESH`` and ``HVD_WEIGHT_QUANT`` are read so that a setting
raises `NotImplementedError` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes (Horovod's default)
DEFAULT_STALL_WARNING_TIME = 60.0            # seconds
# Serving: max prompt tokens the dispatch loop streams per scheduling
# step (interleaved chunked prefill); <= 0 disables interleaving (whole
# prompt at once).
DEFAULT_PREFILL_CHUNK_BUDGET = 128
# Serving: paged KV cache geometry. Block size in tokens (must divide
# max_len); block count 0 = auto (num_slots x max_len / block_size,
# byte-parity with the fixed slot pool); prefix cache on by default.
DEFAULT_KV_BLOCK_SIZE = 16
# Serving: speculative-decode proposals per draft-verify round.
DEFAULT_SPEC_K = 4
# Overload control: the preemption swap shelf's host-RAM byte budget.
DEFAULT_SWAP_BYTES = 256 << 20
# Serving fleet (serving/router.py): replica count, monitor sweep
# interval, cold-replacement budget, hedge-delay TTFT quantile, and the
# retry budget's token-bucket capacity.
DEFAULT_ROUTER_REPLICAS = 2
DEFAULT_ROUTER_POLL_S = 0.02
DEFAULT_ROUTER_REPLACEMENTS = 4
DEFAULT_HEDGE_QUANTILE = 0.95
DEFAULT_RETRY_BUDGET = 16
# Disaggregated serving (serving/disagg.py): pool sizes and the
# KV-block transfer mode.
DEFAULT_DISAGG_PREFILL = 1
DEFAULT_DISAGG_DECODE = 1
DEFAULT_DISAGG_TRANSFER = "host"


# ---------------------------------------------------------------------------
# The knob registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment variable: its type, default, the
    module that consumes it, and a one-line doc (the table row)."""

    name: str
    kind: str          # "int" | "float" | "str" | "flag"
    default: str       # rendered default (documentation, not parsing)
    consumer: str      # module that reads it
    doc: str


KNOBS: Dict[str, Knob] = {}


def register_knob(name: str, kind: str, default: str, consumer: str,
                  doc: str) -> Knob:
    """Declare one environment knob. Every ``HVD_*``/``HOROVOD_*``
    variable the port reads must be declared here; re-registration
    with identical fields is a no-op."""
    knob = Knob(name, kind, default, consumer, doc)
    prev = KNOBS.get(name)
    if prev is not None and prev != knob:
        raise ValueError(
            f"environment knob {name!r} registered twice with "
            f"conflicting declarations:\n  {prev}\n  {knob}")
    KNOBS[name] = knob
    return knob


def _require_registered(name: str):
    if name not in KNOBS:
        raise KeyError(
            f"environment variable {name!r} is not in the "
            f"horovod_tpu_torch.runtime.config knob registry; declare it "
            f"with register_knob()")


def env_str(name: str, default: str = "") -> str:
    """Read a REGISTERED env knob as a string (raises KeyError for
    undeclared names — the registry is the single source of truth)."""
    _require_registered(name)
    return os.environ.get(name, default)


def env_raw(name: str) -> Optional[str]:
    """Like `env_str` but preserves unset-vs-empty (returns None when
    the variable is absent)."""
    _require_registered(name)
    return os.environ.get(name)


def env_int(name: str, default: int) -> int:
    _require_registered(name)
    v = os.environ.get(name, "")
    try:
        return int(v) if v else default
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    _require_registered(name)
    v = os.environ.get(name, "")
    try:
        return float(v) if v else default
    except ValueError:
        return default


def env_table_md() -> str:
    """The environment-knob table, rendered as GitHub markdown."""
    rows = ["| Variable | Type | Default | Read by | Meaning |",
            "| --- | --- | --- | --- | --- |"]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        rows.append(f"| `{k.name}` | {k.kind} | {k.default} | "
                    f"`{k.consumer}` | {k.doc} |")
    return "\n".join(rows) + "\n"


# -- the declarations -------------------------------------------------------
# (kept in one block so the table reads as documentation; consumers
# outside this file fetch values via the env_* accessors above)

register_knob(
    "HOROVOD_FUSION_THRESHOLD", "int", str(DEFAULT_FUSION_THRESHOLD),
    "ops/fusion.py",
    "Tensor-fusion bucket size in bytes for the gradient allreduce (0 "
    "disables fusion: one collective per tensor)")
register_knob(
    "HVD_FUSION_MB", "float", "64", "ops/fusion.py",
    "Megabyte alias of the fusion threshold (accepts fractions); "
    "HOROVOD_FUSION_THRESHOLD wins when both are set")
register_knob(
    "HOROVOD_ALLREDUCE_DTYPE", "str", "(unset)", "optim.py",
    "Reduce gradients in this torch dtype (e.g. bfloat16) before "
    "casting back")
register_knob(
    "HOROVOD_FLASH_BWD", "str", "pallas", "ops/flash_attention.py",
    "Flash-attention backward override of bwd_impl='auto': 'pallas' "
    "(the fused dQ and dK/dV kernels) or 'recompute' (autograd "
    "through the blockwise attention); any other value raises")
register_knob(
    "HVD_PREFILL_CHUNK_BUDGET", "int", str(DEFAULT_PREFILL_CHUNK_BUDGET),
    "serving/engine.py",
    "Serving: max prompt tokens streamed per dispatch step "
    "(interleaved chunked prefill; <= 0 streams whole prompts)")
register_knob(
    "HVD_KV_BLOCK_SIZE", "int", str(DEFAULT_KV_BLOCK_SIZE),
    "serving/paging.py",
    "Serving: paged-KV block size in tokens (must divide the model's "
    "max_len; ServingEngine(paged=True))")
register_knob(
    "HVD_KV_BLOCKS", "int", "0", "serving/engine.py",
    "Serving: paged-KV device block count (0 = auto: num_slots x "
    "max_len / block_size, byte-parity with the fixed slot pool)")
register_knob(
    "HVD_PREFIX_CACHE", "int", "1", "serving/paging.py",
    "Serving: shared-prefix caching over the paged KV pool (0 "
    "disables matching/publishing; blocks then free eagerly)")
register_knob(
    "HVD_PAGED_KERNEL", "str", "auto", "serving/paging.py",
    "Serving: paged-attention dispatch — 'auto'/'lax' walk only the "
    "FILLED blocks of each lane's table, 'pallas' adds the "
    "hand-written CUDA paged-decode kernel (csrc/paged_decode.cu) "
    "for S=1 ticks, 'off' gathers each lane's whole table into a "
    "linear view (the oracle)")
register_knob(
    "HVD_SPEC_K", "int", str(DEFAULT_SPEC_K), "serving/engine.py",
    "Serving: speculative-decode proposals per round when "
    "ServingEngine(spec_draft=...) does not pass spec_k (1..k+1 "
    "tokens retired per lane and round)")
register_knob(
    "HVD_SWAP_BYTES", "int", str(DEFAULT_SWAP_BYTES),
    "serving/engine.py",
    "Overload control: host-RAM byte budget for the preemption swap "
    "shelf (preempted streams' KV blocks awaiting resume); 0 "
    "degrades every preemption to recompute")
register_knob(
    "HVD_WEIGHT_QUANT", "str", "(unset)", "serving/engine.py",
    "Serving: weight-only quantization at ServingEngine construction "
    "when weight_quant= isn't passed ('int8' stores the block matmul "
    "kernels as int8 codes plus one f32 scale per output channel; "
    "anything else raises ValueError)")
register_knob(
    "HVD_SERVE_MESH", "str", "(unset)", "serving/engine.py",
    "Serving: the engine's model-parallel mesh; any setting raises "
    "NotImplementedError until the sharded-serving slice of the port "
    "lands")
register_knob(
    "HOROVOD_STALL_CHECK_TIME", "float", str(DEFAULT_STALL_WARNING_TIME),
    "serving/engine.py",
    "Seconds before a pending serving tick or eager collective warns "
    "as stalled (utils/stall.py)")
register_knob(
    "HOROVOD_TIMELINE", "str", "(unset)", "runtime/bootstrap.py",
    "Write the Horovod Timeline (Chrome trace of eager collectives, "
    "train-step brackets and serving requests) to this path from "
    "init() on")
register_knob(
    "HOROVOD_RANK", "int", "(unset)", "runtime/bootstrap.py",
    "This worker's global rank, set by the hvdrun launcher (wins over "
    "torchrun's RANK; explicit init(rank=) wins over both)")
register_knob(
    "HOROVOD_SIZE", "int", "(unset)", "runtime/bootstrap.py",
    "World size, set by the hvdrun launcher")
register_knob(
    "HOROVOD_LOCAL_RANK", "int", "(unset)", "runtime/bootstrap.py",
    "This worker's rank on its host, set by the hvdrun launcher; a "
    "CUDA rank drives card local_rank")
register_knob(
    "HOROVOD_LOCAL_SIZE", "int", "(unset)", "runtime/bootstrap.py",
    "Workers on this host, set by the hvdrun launcher")
register_knob(
    "HOROVOD_KV", "str", "(unset)", "runtime/bootstrap.py",
    "host:port of the launcher's rendezvous store (a "
    "torch.distributed.TCPStore); init() joins it as a client")
register_knob(
    "HOROVOD_PLATFORM", "str", "(unset)", "runtime/bootstrap.py",
    "Default device of init(): 'gpu' (NCCL, card local_rank) or 'cpu' "
    "(gloo); set by hvdrun --platform; an explicit device= wins")
register_knob(
    "HVD_CHAOS", "str", "(unset)", "resilience/chaos.py",
    "Arm chaos-injection sites: 'site:count[:p=..][:delay=..],...'")
register_knob(
    "HVD_CHAOS_SEED", "int", "0", "resilience/chaos.py",
    "Seed for the deterministic per-site chaos fault schedule")
register_knob(
    "HVD_EVENTS_LOG", "str", "(unset)", "obs/events.py",
    "Append the structured JSONL event log (restarts, requeues, "
    "sheds, chaos fires, stalls, compiles) to this path "
    "(size-rotated)")
register_knob(
    "HVD_EVENTS_RING", "int", "2048", "obs/events.py",
    "In-memory structured-event ring capacity (the flight-recorder "
    "bundle's run-up depth)")
register_knob(
    "HVD_TRACE_LOG", "str", "(unset)", "obs/spans.py",
    "Mirror every completed causal request span to this JSONL path "
    "(size-rotated); render waterfalls / Chrome traces with "
    "python -m horovod_tpu_torch.obs.spans")
register_knob(
    "HVD_TRACE_SAMPLE", "float", "1.0", "obs/spans.py",
    "Head-sampling rate for causal span recording (0..1, "
    "deterministic on the trace id; 1.0 records everything)")
register_knob(
    "HVD_REQLOG", "str", "(unset)", "obs/reqlog.py",
    "Record every client-entry submit (arrival time, prompt/output "
    "budgets, tenant/priority, prefix-group chain digests) to this "
    "JSONL request log")
register_knob(
    "HVD_LOCK_CHECK", "int", "0", "analysis/lockcheck.py",
    "1 = wrap every lockcheck.register()-ed lock in the runtime "
    "order witness (records acquisition edges, flags inversions); "
    "0 = hand back the raw lock, zero overhead")
register_knob(
    "HVD_LOCK_CHECK_OUT", "str", "(unset)", "analysis/lockcheck.py",
    "With HVD_LOCK_CHECK=1: write the observed lock-order graph and "
    "any inversions as JSON to this path at process exit")
register_knob(
    "HVD_PROFILE_DIR", "str", "(unset)", "obs/profiling.py",
    "Opt-in torch.profiler trace session directory "
    "(obs.profiling.profiler_session); analyze captures with "
    "utils/profile_analysis.py")
register_knob(
    "HVD_FLIGHT_DIR", "str", "(unset)", "obs/flightrec.py",
    "Crash flight recorder: dump a post-mortem bundle (event ring + "
    "metric snapshot + in-flight trace_ids + config) here on watchdog "
    "restarts, chaos fires, stall trips and dispatch crashes; unset "
    "disables")
register_knob(
    "HVD_FLIGHT_KEEP", "int", "8", "obs/flightrec.py",
    "Flight-recorder retention: newest N bundles kept, oldest pruned "
    "(0 = keep all)")
register_knob(
    "HVD_SLO", "str", "(unset)", "obs/slo.py",
    "SLO objectives as burn-rate spec, e.g. 'ttft=0.5,tpot=0.1,"
    "shed=0.02,target=0.99,fast=60,slow=600'; a fast-burn breach "
    "marks the engine's SLO health component unhealthy")
register_knob(
    "HVD_PREEMPT", "flag", "0", "serving/engine.py",
    "Overload control: 1 lets a blocked higher-priority request "
    "preempt strictly lower-priority decode streams token-exactly "
    "(swap or recompute on the paged pool, recompute on the fixed "
    "slot pool), and switches paged admission to optimistic "
    "watermark reservations")
register_knob(
    "HVD_TENANT_WEIGHTS", "str", "", "serving/engine.py",
    "Overload control: per-tenant WFQ weights, "
    "'name=<w>,name=<w>,...' — admission serves tenant lanes in "
    "weight proportion and caps each named tenant's queue share at "
    "weight/total; empty = every tenant weighs 1, no caps")
register_knob(
    "HVD_BROWNOUT", "flag", "1", "serving/engine.py",
    "Overload control: per-tenant graduated degradation ladder "
    "(1 no hedging -> 2 spec-k capped -> 3 lowest-priority streams "
    "preempted), driven by per-tenant SLO fast burn and the "
    "serving.overload_storm chaos site; 0 disables")
register_knob(
    "HVD_IO_RETRIES", "int", "3", "resilience/retry.py",
    "Checkpoint/data I/O retry attempts under the shared RetryPolicy "
    "(0 disables retries)")
register_knob(
    "HVD_METRICS_PORT", "int", "(unset)", "obs/exporter.py",
    "Serve Prometheus /metrics + /healthz + /metrics.json on this "
    "port (0 = ephemeral; binds 127.0.0.1 — wider exposure is a "
    "programmatic host= opt-in); honored by init() and "
    "ServingEngine construction, unset disables the exporter, "
    "docs/observability.md")
register_knob(
    "HVD_FLEET_RANKS", "str", "(unset)", "obs/aggregate.py",
    "Comma-separated per-rank exporter base URLs (host:port) the "
    "/fleet endpoint aggregates; unset = this process's registry "
    "alone, docs/observability.md")
register_knob(
    "HVD_STRAGGLER_CYCLES", "int", "64", "obs/straggler.py",
    "Collective dispatches per straggler timing-window exchange "
    "(0 disables the periodic exchange; windows still accumulate "
    "for the fleet collector)")
register_knob(
    "HVD_ROUTER_REPLICAS", "int", str(DEFAULT_ROUTER_REPLICAS),
    "runtime/config.py",
    "Serving fleet: ServingRouter replica count when the caller "
    "doesn't pass num_replicas, docs/serving.md 'Fleet failover'")
register_knob(
    "HVD_ROUTER_POLL", "float", str(DEFAULT_ROUTER_POLL_S),
    "runtime/config.py",
    "Serving fleet: router monitor sweep interval in seconds "
    "(health checks, hedge scans, migration processing, chaos "
    "kills) — the failover-detection latency floor")
register_knob(
    "HVD_ROUTER_REPLACEMENTS", "int", str(DEFAULT_ROUTER_REPLACEMENTS),
    "runtime/config.py",
    "Serving fleet: cold replacements the router may build for "
    "dead/drained replicas over its lifetime (the factory-call "
    "budget; the fleet shrinks once spent)")
register_knob(
    "HVD_HEDGE_QUANTILE", "float", str(DEFAULT_HEDGE_QUANTILE),
    "runtime/config.py",
    "Serving fleet: TTFT quantile (0, 1] deriving the hedge delay — "
    "a request with no first token after the fleet's q-th TTFT "
    "quantile is duplicated on a second replica and the loser "
    "cancelled; <= 0 disables hedging")
register_knob(
    "HVD_DETECTOR_SWEEP_S", "float", "0.05",
    "resilience/detector.py",
    "Failure detector: shared sweep-thread cadence in seconds (per-"
    "peer poll intervals may ask for faster; floor 0.005), "
    "docs/resilience.md 'Failure detection'")
register_knob(
    "HVD_DETECTOR_HYSTERESIS", "int", "2",
    "resilience/detector.py",
    "Failure detector: consecutive good observations required to "
    "leave SUSPECT (recovery hysteresis; death is never gated)")
register_knob(
    "HVD_DETECTOR_FLAP_WINDOW_S", "float", "30",
    "resilience/detector.py",
    "Failure detector: flap-damping window — recoveries inside it "
    "count against HVD_DETECTOR_FLAP_MAX")
register_knob(
    "HVD_DETECTOR_FLAP_MAX", "int", "4",
    "resilience/detector.py",
    "Failure detector: recoveries allowed per flap window before the "
    "peer is damped (held at SUSPECT — drained, not resurrected — "
    "until the window decays)")
register_knob(
    "HVD_RETRY_BUDGET", "int", str(DEFAULT_RETRY_BUDGET),
    "runtime/config.py",
    "Serving fleet: router retry-budget token-bucket capacity for "
    "shed/failed submits (refills at capacity/60 per second; 0 "
    "disables retries — first answer wins)")
register_knob(
    "HVD_DISAGG", "flag", "0",
    "serving/disagg.py",
    "Disaggregated serving: 1 makes ServingRouter construct a "
    "DisaggRouter — requests prefill on a dedicated pool, migrate "
    "their KV blocks to a decode pool at prefill-complete "
    "(docs/serving.md \"Disaggregated serving\")")
register_knob(
    "HVD_DISAGG_PREFILL", "int", str(DEFAULT_DISAGG_PREFILL),
    "serving/disagg.py",
    "Disaggregated serving: prefill-pool replica count (sized "
    "independently of the decode pool — the MPMD split's point)")
register_knob(
    "HVD_DISAGG_DECODE", "int", str(DEFAULT_DISAGG_DECODE),
    "serving/disagg.py",
    "Disaggregated serving: decode-pool replica count (the base "
    "router fleet; HVD_ROUTER_REPLICAS is ignored when disagg is "
    "on)")
register_knob(
    "HVD_DISAGG_TRANSFER", "str", DEFAULT_DISAGG_TRANSFER,
    "serving/transfer.py",
    "KV-block transfer mode between pools: 'host' bounces rows "
    "through host memory, 'device' keeps them on the card for the "
    "graft (one card; a cross-mesh re-commit is ROADMAP Queue A 8)")

register_knob(
    "HVD_CKPT_KEEP", "int", "0", "utils/checkpoint.py",
    "Default step-checkpoint retention for save_step callers that "
    "don't pass keep= (GC prunes oldest beyond N; 0 = keep all)")
register_knob(
    "HVD_PREEMPT_GRACE_S", "float", "30", "resilience/elastic.py",
    "Preemption grace window in seconds: how long after a preemption "
    "notice (SIGUSR1/SIGTERM) the host is expected to survive — "
    "PreemptionHandler.grace_remaining() budgets the emergency "
    "checkpoint against it")
register_knob(
    "HOROVOD_NO_NATIVE", "flag", "(unset)", "data/__init__.py",
    "Non-empty makes ShardedDataset use the Python shard reader instead "
    "of the native prefetching loader (csrc/data_loader.cc)")


# ---------------------------------------------------------------------------
# The resolved runtime config.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Config:
    """Runtime configuration, resolved from the environment;
    `refresh()` re-reads it (tests call it after setting a variable).
    """

    stall_warning_time: float = DEFAULT_STALL_WARNING_TIME
    # Horovod Timeline path ("" = off) and init()'s default platform.
    timeline_path: str = ""
    platform: str = ""
    # Training: gradient-allreduce fusion bucket bytes and the optional
    # reduce dtype (a torch dtype name, "" = the gradients' own).
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD
    allreduce_dtype: str = ""
    prefill_chunk_budget: int = DEFAULT_PREFILL_CHUNK_BUDGET
    # Paged KV cache: block geometry, prefix caching, the paged-
    # attention dispatch mode, and the swap shelf's byte budget.
    kv_block_size: int = DEFAULT_KV_BLOCK_SIZE
    kv_blocks: int = 0
    prefix_cache: bool = True
    paged_kernel: str = "auto"
    swap_bytes: int = DEFAULT_SWAP_BYTES
    # Speculative decoding: draft proposals per round.
    spec_k: int = DEFAULT_SPEC_K
    # Later slices: read only so that a setting raises.
    weight_quant: str = ""
    serve_mesh: str = ""
    # Overload control plane: token-exact preemption switch,
    # per-tenant WFQ weights, and the brownout ladder switch.
    preempt: bool = False
    tenant_weights: str = ""
    brownout: bool = True
    # The data pipeline: the native prefetching loader (False: the
    # Python shard reader, HOROVOD_NO_NATIVE).
    use_native: bool = True

    def refresh(self) -> "Config":
        # HOROVOD_FUSION_THRESHOLD (exact bytes, Horovod's knob) wins;
        # HVD_FUSION_MB (megabytes, accepts fractions) is the alias.
        if env_str("HOROVOD_FUSION_THRESHOLD"):
            self.fusion_threshold = env_int("HOROVOD_FUSION_THRESHOLD",
                                            DEFAULT_FUSION_THRESHOLD)
        elif env_str("HVD_FUSION_MB"):
            self.fusion_threshold = int(
                env_float("HVD_FUSION_MB",
                          DEFAULT_FUSION_THRESHOLD / (1 << 20)) * (1 << 20))
        else:
            self.fusion_threshold = DEFAULT_FUSION_THRESHOLD
        self.allreduce_dtype = env_str("HOROVOD_ALLREDUCE_DTYPE")
        self.prefill_chunk_budget = env_int(
            "HVD_PREFILL_CHUNK_BUDGET", DEFAULT_PREFILL_CHUNK_BUDGET)
        self.kv_block_size = env_int("HVD_KV_BLOCK_SIZE",
                                     DEFAULT_KV_BLOCK_SIZE)
        self.kv_blocks = env_int("HVD_KV_BLOCKS", 0)
        self.prefix_cache = env_int("HVD_PREFIX_CACHE", 1) != 0
        self.paged_kernel = env_str("HVD_PAGED_KERNEL", "auto")
        self.swap_bytes = env_int("HVD_SWAP_BYTES", DEFAULT_SWAP_BYTES)
        self.spec_k = env_int("HVD_SPEC_K", DEFAULT_SPEC_K)
        self.weight_quant = env_str("HVD_WEIGHT_QUANT")
        self.serve_mesh = env_str("HVD_SERVE_MESH")
        self.router_replicas = env_int("HVD_ROUTER_REPLICAS",
                                       DEFAULT_ROUTER_REPLICAS)
        self.router_poll_s = env_float("HVD_ROUTER_POLL",
                                       DEFAULT_ROUTER_POLL_S)
        self.router_replacements = env_int(
            "HVD_ROUTER_REPLACEMENTS", DEFAULT_ROUTER_REPLACEMENTS)
        self.hedge_quantile = env_float("HVD_HEDGE_QUANTILE",
                                        DEFAULT_HEDGE_QUANTILE)
        self.retry_budget = env_int("HVD_RETRY_BUDGET",
                                    DEFAULT_RETRY_BUDGET)
        self.disagg = env_int("HVD_DISAGG", 0)
        self.disagg_prefill = env_int("HVD_DISAGG_PREFILL",
                                      DEFAULT_DISAGG_PREFILL)
        self.disagg_decode = env_int("HVD_DISAGG_DECODE",
                                     DEFAULT_DISAGG_DECODE)
        self.disagg_transfer = env_str("HVD_DISAGG_TRANSFER",
                                       DEFAULT_DISAGG_TRANSFER)
        self.preempt = env_int("HVD_PREEMPT", 0) != 0
        self.tenant_weights = env_str("HVD_TENANT_WEIGHTS")
        self.brownout = env_int("HVD_BROWNOUT", 1) != 0
        self.stall_warning_time = env_float(
            "HOROVOD_STALL_CHECK_TIME", DEFAULT_STALL_WARNING_TIME)
        self.timeline_path = env_str("HOROVOD_TIMELINE")
        self.platform = env_str("HOROVOD_PLATFORM")
        self.use_native = env_str("HOROVOD_NO_NATIVE") == ""
        return self


config = Config()
config.refresh()
