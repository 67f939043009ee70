"""Request tracing identifiers — compat shim over `obs.spans`.

Trace identity moved into the causal span module (obs/spans.py) when
flat trace_id stamping grew into span trees; this module keeps the
older import surface alive so no call site breaks. One ``trace_id`` is
still minted per serving request at ``submit()`` and carried
everywhere that request's life leaves a mark — the span tree, the
admission queue, the Timeline args, the event log, watchdog-restart
requeues, and the histogram exemplars.
"""

from __future__ import annotations

from horovod_tpu_torch.obs.spans import (   # noqa: F401 — re-exports
    mint_trace_id, new_span_id, new_trace_id, span_args,
)

__all__ = ["mint_trace_id", "new_trace_id", "new_span_id",
           "span_args"]
