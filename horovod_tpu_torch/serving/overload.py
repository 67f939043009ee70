"""The overload control plane (docs/serving.md "Overload control").

Under pressure the serving stack used to have exactly two moves: park
requests FIFO and shed at the full queue. This module adds the third —
**make room**: when a higher-priority request cannot be admitted, the
scheduler preempts lower-priority decode streams (token-exactly, via
swap or recompute — see `ContinuousBatchingScheduler._preempt`), the
queue serves tenants weighted-fair, and a tenant burning its SLO
budget is degraded GRADUALLY (brownout) instead of tripping a
fleet-wide 503. The pieces here are the policy objects the scheduler
and engine wire together:

* `SwapStore` — a bounded host-RAM shelf for preempted streams' KV
  blocks, keyed by request id, holding `BlockTransfer`
  manifests (digest-verified on re-graft, so a swap resume inherits
  the transfer path's integrity contract for free).
* `PreemptionPolicy` — victim ordering: lowest priority first, then
  most blocks reserved (frees the most capacity per eviction), then
  fewest tokens generated (cheapest to redo).
* `BrownoutController` — the per-tenant degradation ladder
  (0 normal → 1 no hedging → 2 speculative-k capped → 3 preempt the
  tenant's lowest-priority streams), driven by per-tenant SLO burn
  and the ``serving.overload_storm`` chaos site.
* `OverloadControl` — the wiring bundle the engine hands its
  scheduler (flags + store + policy + the brownout→scheduler
  preemption mailbox).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.analysis import lockcheck

__all__ = ["parse_tenant_weights", "SwapStore", "PreemptionPolicy",
           "BrownoutController", "OverloadControl",
           "BROWNOUT_MAX_LEVEL"]

# The ladder's top rung; see BrownoutController.
BROWNOUT_MAX_LEVEL = 3


def parse_tenant_weights(spec: Optional[str]) -> Dict[str, float]:
    """Parse an ``HVD_TENANT_WEIGHTS`` spec (``"paid=4,free=1"``) into
    {tenant: weight}. Empty/None means no explicit weights (every
    tenant weighs 1.0 in the WFQ and no per-tenant shed caps apply).
    Malformed fields raise `ValueError` naming the offending part —
    the chaos-spec contract: a typo'd weight must fail loudly, not
    silently serve unfairly."""
    if not spec:
        return {}
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad tenant-weight field {part!r} (grammar: "
                f"name=<weight>,name=<weight>,...)")
        name, _, raw = part.partition("=")
        name = name.strip()
        if not name:
            raise ValueError(
                f"bad tenant-weight field {part!r}: empty tenant name")
        try:
            w = float(raw)
        except ValueError:
            raise ValueError(
                f"bad tenant weight {raw!r} for {name!r} "
                f"(must be a number)") from None
        if not w > 0:
            raise ValueError(
                f"tenant weight must be > 0, got {name!r}={w!r}")
        out[name] = w
    return out


class SwapStore:
    """Bounded host-RAM store of preempted streams' KV blocks.

    Entries are `BlockTransfer` manifests keyed by request id. The
    byte budget (``HVD_SWAP_BYTES``) is a hard cap: a `put` that would
    exceed it returns False and the scheduler degrades that victim to
    recompute-preemption — swapping is an optimization, never a
    correctness dependency. Thread-safe (the scheduler writes from
    the dispatch thread; stats are read by scrapes)."""

    def __init__(self, max_bytes: int = 256 << 20):
        if max_bytes < 1:
            raise ValueError(
                f"swap budget must be >= 1 byte, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._lock = lockcheck.register(
            "SwapStore._lock", threading.Lock())
        self._entries: Dict[int, object] = {}
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def put(self, key: int, transfer) -> bool:
        """Shelve one preempted stream's blocks; False when the byte
        budget cannot hold it (caller falls back to recompute)."""
        nb = int(transfer.nbytes)
        with self._lock:
            cur = self._entries.get(key)
            base = self._bytes - (int(cur.nbytes)
                                  if cur is not None else 0)
            if nb > self.max_bytes - base:
                return False
            self._entries[key] = transfer
            self._bytes = base + nb
            return True

    def peek(self, key: int):
        with self._lock:
            return self._entries.get(key)

    def pop(self, key: int):
        with self._lock:
            tr = self._entries.pop(key, None)
            if tr is not None:
                self._bytes -= int(tr.nbytes)
            return tr

    def discard(self, key: int) -> bool:
        """Drop a shelved entry (request finished/cancelled some other
        way); True when something was actually held."""
        return self.pop(key) is not None

    def stats(self) -> Dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes_used": self._bytes,
                    "max_bytes": self.max_bytes}


class PreemptionPolicy:
    """Victim ordering for token-exact preemption.

    ``order_victims(head, active, pool)`` ranks the ACTIVE decode
    lanes that may be evicted to admit ``head``: only strictly
    LOWER-priority lanes are eligible (equal priority never thrashes
    equal priority), ordered lowest priority first, then most blocks
    reserved (one eviction should free the most capacity), then
    fewest tokens generated (the cheapest stream to redo). With
    ``head=None`` every active lane is eligible — the stranded-lane /
    brownout paths, which must always be able to shed load."""

    def order_victims(self, head, active: Dict[int, object],
                      pool) -> List[Tuple[int, object]]:
        floor = None if head is None else head.priority
        blocks = getattr(pool, "blocks", None)
        ranked = []
        for slot, req in active.items():
            if floor is not None and req.priority >= floor:
                continue
            held = (len(blocks.blocks_of(slot))
                    if blocks is not None else 0)
            ranked.append((req.priority, -held, len(req.tokens), slot))
        ranked.sort()
        return [(slot, active[slot]) for _, _, _, slot in ranked]


class BrownoutController:
    """Per-tenant graduated degradation instead of a fleet-wide 503.

    Each tenant sits on a ladder level:

    ====== ==============================================================
    level  effect (applied by the engine via ``on_level``)
    ====== ==============================================================
    0      normal service
    1      hedging disabled for the tenant (stop amplifying its load)
    2      ...and speculative-decode k capped engine-wide (shed compute)
    3      ...and the tenant's lowest-priority active streams preempted
    ====== ==============================================================

    Escalation fires when the tenant's per-tenant SLO monitor reports
    a fast burn (`SLOMonitor.tenant_breaching`) or when the
    ``serving.overload_storm`` chaos site fires (which escalates EVERY
    known tenant one rung — the test/drill hammer). De-escalation is
    one rung per ``cooldown_s`` of clean burn, so recovery is as
    graduated as degradation. Every transition emits a
    ``serving.brownout`` event, bumps the transition counter and
    updates the ``hvd_tenant_brownout_level`` gauge."""

    def __init__(self, slo=None, *, on_level=None, metrics=None,
                 hold_s: float = 1.0, cooldown_s: float = 5.0,
                 interval_s: float = 0.25):
        self._slo = slo
        self._on_level = on_level
        self._metrics = metrics
        self.hold_s = float(hold_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self._lock = lockcheck.register(
            "BrownoutController._lock", threading.Lock())
        self._levels: Dict[str, int] = {}
        self._changed: Dict[str, float] = {}
        self._tenants: Dict[str, bool] = {}   # insertion-ordered set
        self._last_eval = 0.0
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        self._m = _obs_catalog.tenant_metrics()

    def touch(self, tenant: str):
        """Register a tenant as known (engine submit path) so a storm
        or burn can find it."""
        if tenant not in self._tenants:
            with self._lock:
                self._tenants[tenant] = True

    def level(self, tenant: str) -> int:
        return self._levels.get(tenant, 0)

    def levels(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._levels)

    def max_level(self) -> int:
        """The highest rung any tenant currently sits on (drives the
        engine-wide spec-k cap)."""
        lv = self._levels
        return max(lv.values()) if lv else 0

    def step(self, now: Optional[float] = None
             ) -> List[Tuple[str, int, int]]:
        """One control-loop tick (dispatch-thread cadence, internally
        rate-limited to ``interval_s``). Returns the transitions
        applied as (tenant, old_level, new_level)."""
        now = time.time() if now is None else now
        from horovod_tpu_torch.resilience import chaos
        storm = chaos.fires("serving.overload_storm")
        if not storm and now - self._last_eval < self.interval_s:
            return []
        self._last_eval = now
        burning: Dict[str, bool] = {}
        if self._slo is not None:
            tb = getattr(self._slo, "tenant_breaching", None)
            if tb is not None:
                burning = {t: bool(objs) for t, objs in tb().items()}
        transitions: List[Tuple[str, int, int]] = []
        with self._lock:
            tenants = set(self._tenants) | set(burning) \
                | set(self._levels)
            if storm and not tenants:
                tenants = {""}
            for tenant in sorted(tenants):
                old = self._levels.get(tenant, 0)
                changed = self._changed.get(tenant, 0.0)
                new = old
                if storm or burning.get(tenant):
                    if old < BROWNOUT_MAX_LEVEL and (
                            storm or now - changed >= self.hold_s):
                        new = old + 1
                elif old > 0 and now - changed >= self.cooldown_s:
                    new = old - 1
                if new == old:
                    continue
                if new > 0:
                    self._levels[tenant] = new
                else:
                    self._levels.pop(tenant, None)
                self._changed[tenant] = now
                transitions.append((tenant, old, new))
        for tenant, old, new in transitions:
            self._publish(tenant, old, new)
        return transitions

    def _publish(self, tenant: str, old: int, new: int):
        self._m["brownout_level"].set(float(new), tenant=tenant)
        self._m["brownout_transitions"].inc(
            tenant=tenant,
            direction="escalate" if new > old else "recover")
        if self._metrics is not None:
            self._metrics.count("brownout_transitions")
        from horovod_tpu_torch.obs import events as _events
        _events.emit("serving.brownout", tenant=tenant,
                     level=new, previous=old,
                     direction="escalate" if new > old else "recover")
        if self._on_level is not None:
            self._on_level(tenant, old, new)

    def summary(self) -> Dict:
        with self._lock:
            return {"levels": dict(self._levels),
                    "max_level": self.max_level()}


@dataclass
class OverloadControl:
    """The engine→scheduler wiring bundle for preemption: the enable
    flag, the swap shelf (None ⇒ recompute-only preemption), the
    victim policy, and the brownout→scheduler mailbox (tenant names
    whose lowest-priority streams should be recompute-preempted at
    the next step — appended by the engine's brownout callback,
    drained by the dispatch thread)."""

    preempt: bool = False
    swap: Optional[SwapStore] = None
    policy: PreemptionPolicy = field(default_factory=PreemptionPolicy)
    tenant_preempts: collections.deque = field(
        default_factory=collections.deque)
