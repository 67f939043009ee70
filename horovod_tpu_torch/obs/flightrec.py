"""Crash flight recorder — the post-mortem bundle.

Metrics answer "how is it behaving", events answer "what happened";
the flight recorder answers the 03:12 question: "why did the engine
restart, and what was in flight when it did". On every incident
trigger — a watchdog restart, a chaos fire, a stall trip, a NaN
rollback, an unhandled dispatch exception — one self-contained JSON
bundle is ATOMICALLY dumped to ``HVD_FLIGHT_DIR`` (unset = the whole
module is a no-op; observability must never cost the workload):

* the newest events from the in-memory ring (the full
  ``HVD_EVENTS_RING`` window — the restart/chaos/stall event that
  triggered the dump is the ring's tail),
* a full metric snapshot (`registry().to_json()` — every counter,
  gauge and histogram with quantile estimates),
* the in-flight request states with their ``trace_id``s, pulled from
  the registered providers (each live `ServingEngine` registers one
  covering its decoding / mid-prefill / queued requests),
* the active configuration: every registered env knob's live value
  plus the resolved `runtime.config.Config`.

Retention keeps the newest ``HVD_FLIGHT_KEEP`` bundles (oldest
pruned), so an incident storm can never fill a disk. Read a bundle
with the pretty-printer::

    python -m horovod_tpu_torch.obs.flightrec /path/flight_*.json

which renders the trigger, the in-flight table (trace_ids first —
the grep key into the event log), the newest events and the headline
latency metrics.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["dump", "trigger", "register_inflight",
           "unregister_inflight", "describe", "load", "list_bundles",
           "main", "SCHEMA"]

SCHEMA = 1

# What an in-flight provider (reading live engine containers without
# locks) or a bundle write may raise and cost only its own section /
# bundle — same contract as the registry's _CALLBACK_ERRORS.
_PROVIDER_ERRORS = (RuntimeError, ValueError, TypeError,
                    AttributeError, KeyError, IndexError, OSError)

_PROVIDERS: Dict[str, Callable[[], List[Dict]]] = {}
_LOCK = threading.Lock()
_SEQ = 0


def register_inflight(key: str, fn: Callable[[], List[Dict]]):
    """Attach an in-flight-state provider (e.g. a serving engine
    reporting its decoding/prefilling/queued requests with trace_ids).
    Cheap: providers are only ever called at dump time."""
    with _LOCK:
        _PROVIDERS[key] = fn


def unregister_inflight(key: str):
    with _LOCK:
        _PROVIDERS.pop(key, None)


def _flight_dir() -> Optional[str]:
    from horovod_tpu_torch.runtime.config import env_str
    return env_str("HVD_FLIGHT_DIR") or None


def trigger(reason: str, /, **context) -> Optional[str]:
    """The subsystems' incident hook: dump a bundle when
    ``HVD_FLIGHT_DIR`` is set, no-op otherwise. Returns the bundle
    path (or None). Never raises — a broken post-mortem path must not
    break the recovery it is documenting. (``reason`` is positional-
    only so a caller's ``reason=...`` context field — the restart
    path's — lands in the bundle's context, not a TypeError.)"""
    d = _flight_dir()
    if d is None:
        return None
    return dump(reason, dirpath=d, **context)


def _inflight_states() -> Dict[str, object]:
    with _LOCK:
        providers = dict(_PROVIDERS)
    out: Dict[str, object] = {}
    for key, fn in sorted(providers.items()):
        try:
            out[key] = fn()
        except _PROVIDER_ERRORS as e:
            # A provider reading a mid-shutdown engine may race its
            # containers; the bundle records that instead of dying.
            out[key] = {"error": repr(e)}
    return out


def _spans_section() -> Dict:
    """The causal span ring + the slowest completed request's
    waterfall (obs/spans.py `flight_section`) — the SLO-breach
    bundle's 'what was the time spent on' page. Errors degrade to a
    marker, never cost the bundle."""
    try:
        from horovod_tpu_torch.obs import spans as _spans
        return _spans.flight_section()
    # hvd: disable=HVD006(a broken span recorder must cost the spans section, never the bundle the restart depends on)
    except Exception as e:  # noqa: BLE001
        return {"error": repr(e)}


def _config_snapshot() -> Dict:
    import dataclasses

    from horovod_tpu_torch.runtime.config import KNOBS, config, env_raw
    return {
        "knobs": {name: env_raw(name) for name in sorted(KNOBS)},
        "resolved": dataclasses.asdict(config),
    }


def dump(reason: str, /, *, dirpath: Optional[str] = None,
         keep: Optional[int] = None, **context) -> Optional[str]:
    """Write one bundle now. ``dirpath`` defaults to
    ``HVD_FLIGHT_DIR`` (None with it unset — the disabled no-op);
    ``keep`` defaults to ``HVD_FLIGHT_KEEP``. Atomic (tmp + rename):
    a reader never sees a half-written bundle, and a crash mid-dump
    leaves no discoverable garbage."""
    global _SEQ
    dirpath = dirpath or _flight_dir()
    if dirpath is None:
        return None
    from horovod_tpu_torch.obs import events as _events
    from horovod_tpu_torch.obs.registry import registry as _registry
    from horovod_tpu_torch.runtime.config import env_int
    if keep is None:
        keep = env_int("HVD_FLIGHT_KEEP", 8)
    with _LOCK:
        _SEQ += 1
        seq = _SEQ
    now = time.time()
    bundle = {
        "schema": SCHEMA,
        "reason": reason,
        "ts": round(now, 6),
        "pid": os.getpid(),
        "context": context,
        # The WHOLE ring, not tail(100): the post-mortem wants the
        # run-up, and the ring is already bounded by HVD_EVENTS_RING.
        "events": _events.tail(1 << 30),
        "metrics": _registry().to_json(),
        "inflight": _inflight_states(),
        "config": _config_snapshot(),
        "spans": _spans_section(),
    }
    slug = "".join(c if c.isalnum() else "-" for c in reason)[:48]
    name = (f"flight_{time.strftime('%Y%m%dT%H%M%S', time.gmtime(now))}"
            f"_{os.getpid()}_{seq:04d}_{slug}.json")
    path = os.path.join(dirpath, name)
    try:
        os.makedirs(dirpath, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=repr)
        os.replace(tmp, path)
        _prune(dirpath, keep)
    except OSError as e:
        # Warn-and-skip (the event log's unwritable-file contract): a
        # full disk costs the bundle, never the restart in progress.
        sys.stderr.write(
            f"WARNING: flight recorder could not write {path!r}: "
            f"{e}\n")
        return None
    from horovod_tpu_torch.obs import catalog as _obs_catalog
    _obs_catalog.flight_metrics()["bundles"].inc(reason=reason)
    _events.emit("flightrec.dump", reason=reason, path=path)
    return path


def _prune(dirpath: str, keep: int):
    """Drop the oldest bundles beyond ``keep`` (0 = keep all)."""
    if keep <= 0:
        return
    for stale in sorted(list_bundles(dirpath))[:-keep]:
        try:
            os.remove(stale)
        except OSError:
            pass   # already gone / permissions — retention is advisory


def list_bundles(dirpath: str) -> List[str]:
    """All bundle paths in ``dirpath`` (name-sorted = time-sorted:
    the filename leads with a UTC stamp)."""
    try:
        return sorted(
            os.path.join(dirpath, n) for n in os.listdir(dirpath)
            if n.startswith("flight_") and n.endswith(".json"))
    except OSError:
        return []


def load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The pretty-printer (python -m horovod_tpu_torch.obs.flightrec <bundle>)
# ---------------------------------------------------------------------------

def _fmt_ts(ts) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S",
                             time.gmtime(float(ts)))
    except (TypeError, ValueError):
        return str(ts)


def _metric_headlines(metrics: Dict) -> List[str]:
    out = []
    for name in ("hvd_serving_ttft_seconds", "hvd_serving_tpot_seconds",
                 "hvd_serving_e2e_seconds",
                 "hvd_resilience_recovery_seconds",
                 "hvd_collective_skew_seconds",
                 "hvd_training_step_seconds"):
        fam = metrics.get(name)
        if not fam:
            continue
        for sample in fam.get("samples", []):
            if not sample.get("count"):
                continue
            q = sample.get("quantiles", {})
            out.append(
                f"  {name}: n={sample['count']} "
                f"p50={_fmt_q(q.get('p50'))} "
                f"p95={_fmt_q(q.get('p95'))} "
                f"p99={_fmt_q(q.get('p99'))}")
    for name in ("hvd_resilience_restarts_total",
                 "hvd_resilience_requeued_total",
                 "hvd_resilience_stalls_total",
                 "hvd_resilience_rollbacks_total"):
        fam = metrics.get(name)
        if not fam:
            continue
        for sample in fam.get("samples", []):
            v = sample.get("value", 0)
            if v:
                out.append(f"  {name}: {v:g}")
    return out


def _fmt_q(v) -> str:
    return "-" if v is None else f"{float(v) * 1e3:.1f}ms"


def describe(bundle: Dict, *, events_shown: int = 30) -> str:
    """Human rendering of one bundle — the incident page. Trace_ids
    lead every in-flight line (the grep key into the event log)."""
    lines = []
    lines.append(f"flight-recorder bundle (schema "
                 f"{bundle.get('schema')})")
    lines.append(f"reason:  {bundle.get('reason')}")
    lines.append(f"when:    {_fmt_ts(bundle.get('ts'))} UTC  "
                 f"(pid {bundle.get('pid')})")
    ctx = bundle.get("context") or {}
    if ctx:
        lines.append("context: " + json.dumps(ctx, default=repr))
    inflight = bundle.get("inflight") or {}
    total = sum(len(v) for v in inflight.values()
                if isinstance(v, list))
    lines.append("")
    lines.append(f"in-flight requests ({total}):")
    for key in sorted(inflight):
        states = inflight[key]
        if not isinstance(states, list):
            lines.append(f"  [{key}] provider error: {states}")
            continue
        for st in states:
            lines.append(
                f"  trace_id={st.get('trace_id')} "
                f"phase={st.get('phase')} "
                f"request_id={st.get('request_id')} "
                f"tokens={st.get('tokens')} "
                f"prompt={st.get('prompt_tokens')} [{key}]")
    evs = bundle.get("events") or []
    lines.append("")
    lines.append(f"newest events ({min(events_shown, len(evs))} of "
                 f"{len(evs)} in the ring):")
    for rec in evs[-events_shown:]:
        extras = {k: v for k, v in rec.items()
                  if k not in ("ts", "seq", "kind")}
        lines.append(
            f"  [{_fmt_ts(rec.get('ts'))}] #{rec.get('seq')} "
            f"{rec.get('kind')} "
            + json.dumps(extras, default=repr))
    spans_sec = bundle.get("spans") or {}
    ring = spans_sec.get("ring") or []
    if ring or spans_sec.get("slowest_trace_id"):
        lines.append("")
        lines.append(f"causal spans ({len(ring)} newest in bundle):")
        slow = spans_sec.get("slowest_trace_id")
        if slow:
            anat = spans_sec.get("slowest_anatomy") or {}
            phases = " ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in anat.items()
                if v)
            lines.append(f"  slowest completed request: "
                         f"trace_id={slow}  {phases}")
            wf = spans_sec.get("slowest_waterfall")
            if wf:
                lines.extend("  " + ln for ln in wf.splitlines())
    lines.append("")
    lines.append("metric headlines:")
    lines.extend(_metric_headlines(bundle.get("metrics") or {})
                 or ["  (no samples)"])
    cfg = (bundle.get("config") or {}).get("knobs") or {}
    set_knobs = {k: v for k, v in cfg.items() if v is not None}
    lines.append("")
    lines.append(f"env knobs set ({len(set_knobs)}/{len(cfg)}):")
    for k in sorted(set_knobs):
        lines.append(f"  {k}={set_knobs[k]}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.obs.flightrec",
        description="Pretty-print a crash flight-recorder bundle "
                    "(or list a bundle directory).")
    ap.add_argument("path", help="bundle file, or a directory of "
                                 "bundles to list")
    ap.add_argument("--events", type=int, default=30,
                    help="newest events to render (default 30)")
    ap.add_argument("--json", action="store_true",
                    help="re-emit the raw bundle JSON (pretty)")
    args = ap.parse_args(argv)
    if os.path.isdir(args.path):
        bundles = list_bundles(args.path)
        if not bundles:
            print(f"no flight bundles under {args.path}")
            return 1
        for p in bundles:
            try:
                b = load(p)
                print(f"{p}  reason={b.get('reason')} "
                      f"ts={_fmt_ts(b.get('ts'))}")
            except (OSError, ValueError) as e:
                print(f"{p}  UNREADABLE: {e}")
        return 0
    try:
        bundle = load(args.path)
    except (OSError, ValueError) as e:
        sys.stderr.write(f"cannot read bundle {args.path!r}: {e}\n")
        return 1
    if args.json:
        print(json.dumps(bundle, indent=1, default=repr))
    else:
        sys.stdout.write(describe(bundle, events_shown=args.events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
