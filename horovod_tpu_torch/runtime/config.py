"""Environment-variable configuration surface.

The single source of truth for every ``HVD_*`` / ``HOROVOD_*``
environment knob the port reads: each knob is declared in the `KNOBS`
registry below, and other modules read the environment only through
the `env_str` / `env_int` / `env_float` accessors, which refuse
unregistered names. `env_table_md` renders the registry as a markdown
table.

Only knobs that a ported module reads are registered. A knob of the
JAX package whose consumer is not ported yet (fusion, paged KV,
speculative decoding, the router and fleet, the metrics exporter,
profiling, elastic membership, checkpoints, ...) is registered by the
slice that ports its consumer; ROADMAP.md lists them until then.
``HVD_SERVE_MESH`` and ``HVD_WEIGHT_QUANT`` are read so that a setting
raises `NotImplementedError` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

DEFAULT_STALL_WARNING_TIME = 60.0            # seconds
# Serving: max prompt tokens the dispatch loop streams per scheduling
# step (interleaved chunked prefill); <= 0 disables interleaving (whole
# prompt at once).
DEFAULT_PREFILL_CHUNK_BUDGET = 128


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
    "HVD_PREFILL_CHUNK_BUDGET", "int", str(DEFAULT_PREFILL_CHUNK_BUDGET),
    "serving/engine.py",
    "Serving: max prompt tokens streamed per dispatch step "
    "(interleaved chunked prefill; <= 0 streams whole prompts)")
register_knob(
    "HVD_WEIGHT_QUANT", "str", "(unset)", "serving/engine.py",
    "Serving: weight-only quantization at ServingEngine construction; "
    "any setting raises NotImplementedError until the int8 slice of "
    "the port lands")
register_knob(
    "HVD_SERVE_MESH", "str", "(unset)", "serving/engine.py",
    "Serving: the engine's model-parallel mesh; any setting raises "
    "NotImplementedError until the sharded-serving slice of the port "
    "lands")
register_knob(
    "HOROVOD_STALL_CHECK_TIME", "float", str(DEFAULT_STALL_WARNING_TIME),
    "serving/engine.py",
    "Seconds before a pending serving tick warns as stalled "
    "(utils/stall.py)")
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
    "(recompute on the fixed slot pool)")
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


# ---------------------------------------------------------------------------
# The resolved runtime config.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Config:
    """Runtime configuration, resolved from the environment;
    `refresh()` re-reads it (tests call it after setting a variable).
    """

    stall_warning_time: float = DEFAULT_STALL_WARNING_TIME
    prefill_chunk_budget: int = DEFAULT_PREFILL_CHUNK_BUDGET
    # Later slices: read only so that a setting raises.
    weight_quant: str = ""
    serve_mesh: str = ""
    # Overload control plane: token-exact preemption switch,
    # per-tenant WFQ weights, and the brownout ladder switch.
    preempt: bool = False
    tenant_weights: str = ""
    brownout: bool = True

    def refresh(self) -> "Config":
        self.prefill_chunk_budget = env_int(
            "HVD_PREFILL_CHUNK_BUDGET", DEFAULT_PREFILL_CHUNK_BUDGET)
        self.weight_quant = env_str("HVD_WEIGHT_QUANT")
        self.serve_mesh = env_str("HVD_SERVE_MESH")
        self.preempt = env_int("HVD_PREEMPT", 0) != 0
        self.tenant_weights = env_str("HVD_TENANT_WEIGHTS")
        self.brownout = env_int("HVD_BROWNOUT", 1) != 0
        self.stall_warning_time = env_float(
            "HOROVOD_STALL_CHECK_TIME", DEFAULT_STALL_WARNING_TIME)
        return self


config = Config()
config.refresh()
