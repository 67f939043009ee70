"""Elastic training membership: who is in the world, and what happens
when that changes.

Counterpart of `horovod_tpu.resilience.membership`, ported by copy
with its imports re-pointed. Two parts differ: `BootstrapKV` wraps the
launcher's `torch.distributed.TCPStore` (the JAX package wraps its
native rendezvous client), and `SimulatedWorld` averages gradients that
may be torch tensors on a card as well as numpy arrays (`average`).

Horovod's launch contract is a fixed ``mpirun -np N`` world — one rank
dying kills the job (the reference's only answer is the 60 s stall
warning). On preemptible fleets that is exactly backwards: rank
death is scheduled, and MLPerf-scale runs treat restart/resume as
first-class (arXiv:1909.09756). This module gives training the
membership story serving got from the router:

* `WorldMonitor` — a heartbeat **lease** per member over a small KV
  transport (`InProcessKV` for the CPU-simulated worlds tests run;
  `install_kv` plugs a real rendezvous backend the same way
  `obs.straggler.install_exchange` plugs a real allgather; the
  launcher's store through `BootstrapKV` is the deployment target).
  A member whose newest heartbeat is older than ``HVD_LEASE_S`` is
  dead; a ``join/<member>`` announcement is a prospective member.
* The **resize protocol** — a barrier'd agreement: any member that
  detects a death/join proposes the next *generation* (monotonic,
  `hvd_elastic_generation`) with the deterministic survivor list;
  every proposed member acks; the fully-acked proposal commits the
  new ``(world, rank)`` assignment (survivors ordered by old rank,
  joiners appended). Every member then rolls back to the last
  committed `TrainSnapshot`, re-keys the runtime
  (`bootstrap.apply_resize` — generation bump + membership fields +
  op-cache drop), and rebalances its shard stream
  (`ShardedDataset.restore(migrate=True)` via the `ElasticTrainer`
  resize path).
* `SimulatedWorld` — the in-process N-thread elastic training world
  CPU tests, the equivalence harness and the card smoke drive
  end-to-end: real heartbeats, real lease expiry, a gradient-averaging
  lockstep loop, and the chaos sites that make the drills honest —
  ``rank_death`` (a member stops heartbeating mid-epoch), ``rank_join``
  (a new member announces itself after a shrink), ``heartbeat_drop``
  (a beat is lost in transit; the lease must tolerate it).

The determinism contract the whole stack leans on: given the KV's
committed history, every member computes the SAME assignment, the
same generation, and (through `data.remainder_after`) the same record
partition — so the union of all ranks' post-resize batches is exactly
the untrained remainder of the interrupted epoch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience import detector as _detector
from horovod_tpu_torch.resilience.retry import RetryError, RetryPolicy
from horovod_tpu_torch.runtime.config import env_float, env_int

from horovod_tpu_torch.analysis import lockcheck


class MembershipError(RuntimeError):
    """This member cannot continue in the world — typically it was
    declared dead by the others (its lease lapsed while it was
    paused/partitioned) and a newer generation excludes it. The only
    safe answer is to stop and re-join as a fresh member."""


class KVTransportError(MembershipError):
    """A rendezvous-KV round-trip failed even after the shared
    `RetryPolicy` ran dry — the typed answer to what used to surface
    as a raw socket error out of the heartbeat thread. Consumers
    degrade: a heartbeat counts a missed beat, the watch loop skips a
    tick, the resize protocol times out into `MembershipError`."""


class _KVFault(OSError):
    """One failed KV attempt (transport down, chaos ``kv_drop`` /
    ``kv_partition``) — an `OSError` so the shared `RetryPolicy`
    retries it as transient; `KVTransportError` is what escapes once
    the policy gives up."""


def _kv_policy() -> RetryPolicy:
    """The KV transport's retry schedule: `HVD_IO_RETRIES` attempts
    (the same knob checkpoint/data I/O honor) with a tighter base
    delay — membership traffic is latency-sensitive (heartbeats race
    leases)."""
    return RetryPolicy(max_attempts=max(1, env_int("HVD_IO_RETRIES", 3)),
                       base_delay_s=0.02, max_delay_s=0.25)


def _kv_chaos(op: str) -> None:
    """The KV transport-fault chaos sites, applied to every hardened
    round-trip (the chaos-site table of `resilience.chaos`):

    * ``kv_drop`` — this round-trip is lost in transit (both
      directions); the retry policy must absorb isolated drops.
    * ``kv_partition`` — ASYMMETRIC partition: writes from this
      process stop landing while reads still work, the nastiest
      split-brain shape — the minority member keeps seeing a live
      world it can no longer prove itself alive to, and must exit
      `MembershipError` once a commit excludes it.
    * ``kv_delay`` — a slow round-trip (congested rendezvous);
      leases must tolerate it.
    """
    if chaos.fires("kv_drop"):
        raise _KVFault(f"chaos kv_drop: {op} round-trip lost")
    if op == "put" and chaos.fires("kv_partition"):
        raise _KVFault(f"chaos kv_partition: {op} did not land "
                       f"(asymmetric write partition)")
    chaos.slow_site("kv_delay", 0.05)


def _hardened_call(policy: RetryPolicy, op: str, attempt: Callable, *,
                   on_retry: Optional[Callable] = None,
                   what: str = "KV"):
    """The BootstrapKV/ChaosKV common core — one hardened round-trip:
    the ``kv_*`` chaos sites + the shared `RetryPolicy` + typed
    `KVTransportError` exhaustion. ``on_retry`` is the transport's
    between-attempts hook (BootstrapKV reconnects + logs there)."""
    def one():
        _kv_chaos(op)
        return attempt()

    try:
        return policy.call(
            one, on_retry=on_retry if on_retry is not None
            else (lambda *_: None))
    except RetryError as e:
        raise KVTransportError(
            f"{what} {op} failed after {e.attempts} attempt(s): "
            f"{e.__cause__!r}") from e


# ---------------------------------------------------------------------------
# KV transport.
# ---------------------------------------------------------------------------

class InProcessKV:
    """Dict-backed KV with the 4 primitives the protocol needs —
    the CPU test double for the rendezvous server. Thread-safe;
    values are plain JSON-able objects (stored by reference, so
    writers must not mutate after put)."""

    def __init__(self):
        self._lock = lockcheck.register(
            "InProcessKV._lock", threading.Lock())
        self._d: Dict[str, Any] = {}

    def put(self, key: str, value) -> None:
        with self._lock:
            self._d[key] = value

    def put_if_absent(self, key: str, value):
        """Atomic first-write-wins; returns the winning value."""
        with self._lock:
            return self._d.setdefault(key, value)

    def get(self, key: str):
        with self._lock:
            return self._d.get(key)

    def scan(self, prefix: str) -> Dict[str, Any]:
        with self._lock:
            return {k: v for k, v in self._d.items()
                    if k.startswith(prefix)}

    def delete(self, key: str) -> None:
        with self._lock:
            self._d.pop(key, None)


def _connect_store(addr: str):
    from horovod_tpu_torch.runtime import bootstrap as _bootstrap
    return _bootstrap.connect_kv(addr, timeout_s=2.0)


class BootstrapKV:
    """Adapter over the launcher's rendezvous store (a
    `torch.distributed.TCPStore` client, `bootstrap.connect_kv`) — the
    deployment transport for multi-process worlds; JSON values.

    Every round-trip is HARDENED: the `kv_drop`/`kv_delay`/
    `kv_partition` chaos sites model transport faults, each attempt
    runs under the shared `RetryPolicy` (``HVD_IO_RETRIES``), a failed
    round-trip tries a rendezvous RECONNECT between attempts (a new
    client of ``HOROVOD_KV``: the server restarting, a flapped link),
    and exhaustion raises the typed `KVTransportError` — never a raw
    socket error out of the heartbeat thread.

    Capability notes, honest by design: the store offers no scan, and
    the protocol does not use its compare-and-set. Neither breaks the
    protocol — `put_if_absent` is read-then-write, as over the JAX
    package's native plane, which is benign because proposal and
    commit CONTENTS are deterministic functions of the committed
    history (two racing writers write identical bytes, and the store's
    single server serializes them); join discovery, the one genuinely
    scan-shaped read, rides the well-known ``join_queue`` key instead
    (`scan` raises, and `WorldMonitor.joiners()` falls back).
    Heartbeats, death detection, and the whole shrink path are
    targeted gets.

    Absent versus unreachable: the store's ``get`` of an absent key
    blocks until its timeout, so every read probes with ``check`` first
    (absent: None at once). A dead server raises from any call, and
    that raise is a transport fault like any other: retried, then
    `KVTransportError`. `delete` writes the JSON ``null`` tombstone the
    JAX package writes, so every protocol read sees what it sees there.

    ``connect`` builds a fresh client from an address (reconnects);
    default `bootstrap.connect_kv` with a 2 s timeout."""

    def __init__(self, store=None, *,
                 policy: Optional[RetryPolicy] = None,
                 connect: Optional[Callable[[str], Any]] = None):
        if store is None:
            from horovod_tpu_torch.runtime import state as _rt_state
            store = _rt_state.global_state().store
        if store is None:
            raise MembershipError(
                "BootstrapKV needs the launcher's rendezvous store; "
                "init under hvdrun-torch with HOROVOD_KV set, pass "
                "bootstrap.connect_kv(), or install an InProcessKV/"
                "custom transport via membership.install_kv")
        self._store = store
        self._policy = policy if policy is not None else _kv_policy()
        self._connect = connect if connect is not None else _connect_store
        self._lock = lockcheck.register(
            "BootstrapKV._lock", threading.Lock())
        self.reconnects = 0

    # -- transport plumbing -------------------------------------------

    def _client(self):
        with self._lock:
            return self._store

    def _reconnect(self):
        """Best-effort rendezvous reconnect between retry attempts
        (HOROVOD_KV names the server): a new client replaces the old
        one when the server answers."""
        from horovod_tpu_torch.runtime.config import env_str
        addr = env_str("HOROVOD_KV")
        if not addr or ":" not in addr:
            return
        with self._lock:
            self.reconnects += 1
        try:
            store = self._connect(addr)
        except (OSError, ValueError, RuntimeError):
            return   # next attempt will fault again and re-enter here
        with self._lock:
            self._store = store

    def _call(self, op: str, attempt: Callable):
        """One hardened round-trip: chaos sites + retry policy +
        reconnect between attempts; typed exhaustion. A store error
        (`torch.distributed.DistError` is a `RuntimeError`) is one
        failed attempt."""
        def guarded():
            try:
                return attempt(self._client())
            except RuntimeError as e:
                raise _KVFault(f"rendezvous store {op}: {e}") from e

        def on_retry(exc, n, delay):
            import sys
            self._reconnect()
            sys.stderr.write(
                f"horovod_tpu_torch membership: transient KV fault "
                f"({str(exc).splitlines()[0]!r}); retry {n} in "
                f"{delay:.2f}s\n")

        return _hardened_call(self._policy, op, guarded,
                              on_retry=on_retry, what="rendezvous KV")

    # -- the KV surface -----------------------------------------------

    def put(self, key: str, value) -> None:
        import json
        payload = json.dumps(value).encode()
        self._call("put", lambda store: store.set(key, payload))

    def get(self, key: str):
        import json

        def attempt(store):
            if not store.check([key]):
                return None   # the server answered: absent
            raw = store.get(key)
            try:
                return json.loads(bytes(raw).decode())
            except (ValueError, UnicodeDecodeError):
                return None

        return self._call("get", attempt)

    def put_if_absent(self, key: str, value):
        cur = self.get(key)
        if cur is not None:
            return cur
        self.put(key, value)
        return self.get(key)

    def scan(self, prefix: str) -> Dict[str, Any]:
        raise NotImplementedError(
            "the rendezvous store has no scan; join discovery uses the "
            "join_queue key")

    def delete(self, key: str) -> None:
        # A JSON null tombstone (as over the JAX package's native
        # plane, which has no delete) reads as absent to every
        # protocol read.
        self.put(key, None)


class ChaosKV:
    """The same transport hardening `BootstrapKV` applies to the
    rendezvous store, composable around ANY membership KV (typically
    `InProcessKV`): every round-trip passes the `kv_drop`/`kv_delay`/
    `kv_partition` chaos sites under the shared `RetryPolicy`, with
    typed `KVTransportError` exhaustion — how in-process worlds drill
    transport faults (a partitioned member wraps only ITS handle;
    the survivors' handles stay clean)."""

    def __init__(self, inner, *, policy: Optional[RetryPolicy] = None):
        self._inner = inner
        self._policy = policy if policy is not None else _kv_policy()

    def _call(self, op: str, fn: Callable, *args):
        return _hardened_call(self._policy, op, lambda: fn(*args))

    def put(self, key: str, value) -> None:
        self._call("put", self._inner.put, key, value)

    def get(self, key: str):
        return self._call("get", self._inner.get, key)

    def put_if_absent(self, key: str, value):
        return self._call("put", self._inner.put_if_absent, key,
                          value)

    def scan(self, prefix: str) -> Dict[str, Any]:
        return self._call("get", self._inner.scan, prefix)

    def delete(self, key: str) -> None:
        self._call("put", self._inner.delete, key)


# The pluggable transport, `straggler.install_exchange`-style: None
# means each WorldMonitor constructed without an explicit `kv` gets
# the process-local InProcessKV below (single-process worlds); a
# multi-controller launch installs an adapter over its rendezvous
# service once, before monitors are built.
_KV: Optional[Any] = None
_KV_LOCK = lockcheck.register(
    "membership._KV_LOCK", threading.Lock())


def install_kv(kv: Optional[Any]) -> Optional[Any]:
    """Install (or with None, remove) the process-global membership
    transport; returns the previous one (scoped-swap test pattern)."""
    global _KV
    with _KV_LOCK:
        prev, _KV = _KV, kv
        return prev


def default_kv():
    """The installed transport, or a lazily-created process-local
    `InProcessKV`."""
    global _KV
    with _KV_LOCK:
        if _KV is None:
            _KV = InProcessKV()
        return _KV


# A member whose beat age crosses this fraction of the lease is
# SUSPECT (drained by consumers that can drain; the resize protocol
# ignores suspicion — only DEAD, age past the full lease, resizes).
SUSPECT_LEASE_FRACTION = 0.5

# Process-unique monitor ids for detector-peer namespacing (observer-
# scoped: each member judges its peers through its own clock and KV
# handle; id(self) would alias after garbage collection).
_MONITOR_IDS = itertools.count()


# ---------------------------------------------------------------------------
# The resize decision.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResizeDecision:
    """One committed generation: the agreed world and this member's
    place in it."""

    generation: int
    world: int
    rank: int                    # THIS member's new rank
    members: List[str]           # rank order (index == rank)
    died: List[str]
    joined: List[str]

    @property
    def kind(self) -> str:
        if self.died and not self.joined:
            return "shrink"
        if self.joined and not self.died:
            return "grow"
        return "shrink" if len(self.died) > len(self.joined) else (
            "grow" if len(self.joined) > len(self.died) else "steady")


def _default_members(world: int) -> List[str]:
    return [f"rank{i}" for i in range(world)]


class WorldMonitor:
    """Heartbeat lease + rank-death/join detection + the barrier'd
    resize protocol, for one member.

    Key space (per shared KV): ``hb/<member>`` heartbeat stamps,
    ``join/<member>`` join announcements, ``prop/<gen>`` the first
    detector's deterministic membership proposal, ``ack/<gen>/<m>``
    the barrier, ``commit/<gen>`` the agreed assignment. Generations
    are monotonic; ``commit/0`` is the launch world (written
    first-wins by whichever founding member gets there first).
    """

    def __init__(self, member_id: Optional[str] = None, *,
                 rank: Optional[int] = None,
                 world: Optional[int] = None,
                 kv: Optional[Any] = None,
                 initial_members: Optional[Sequence[str]] = None,
                 lease_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_change: Optional[Callable[[], None]] = None,
                 joining: bool = False,
                 apply_runtime: bool = True):
        if lease_s is None:
            lease_s = env_float("HVD_LEASE_S", 2.0)
        if heartbeat_s is None:
            heartbeat_s = env_float("HVD_HEARTBEAT_S", lease_s / 4.0)
        if not joining and (rank is None or world is None):
            raise ValueError(
                "a founding member needs rank= and world= "
                "(pass joining=True to announce a new member instead)")
        self.member_id = member_id if member_id is not None else (
            f"rank{rank}" if not joining else "joiner")
        self.kv = kv if kv is not None else default_kv()
        self.lease_s = float(lease_s)
        self.heartbeat_s = float(heartbeat_s)
        self.clock = clock
        self.on_change = on_change
        self._lock = lockcheck.register(
            "WorldMonitor._lock", threading.Lock())
        self._members: List[str] = (
            list(initial_members) if initial_members is not None
            else (_default_members(world) if world is not None else []))
        self.generation = 0
        self.rank = rank if rank is not None else -1
        self.world = world if world is not None else 0
        self.joining = joining
        # False in simulated worlds: many fake ranks share one
        # process — the REAL runtime's rank/size must not be
        # rewritten; the world generation is still recorded.
        self.apply_runtime = bool(apply_runtime)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0
        self.beats_missed = 0
        # The shared failure detector owns the liveness question
        # (resilience/detector.py): this monitor registers its peers'
        # KV-lease beat ages as evidence, observer-scoped (each
        # member judges peers through its own clock/KV handle), and
        # reads graduated verdicts back — the inline lease arithmetic
        # this class used to do. One sweep thread per process,
        # however many monitors (and routers) are live.
        self._det = _detector.shared_detector()
        self._det_ns = f"wm/{next(_MONITOR_IDS)}"
        self._det_peers: set = set()
        # The never-beaten startup-grace reference (_beat_age);
        # re-anchored by start().
        self._start_t = self.clock()

    # -- heartbeats ----------------------------------------------------

    def heartbeat(self) -> bool:
        """One beat; False when the write was dropped (chaos
        ``heartbeat_drop`` or a transport fault) — the lease is sized
        to survive isolated misses (default cadence = lease/4), and a
        KV transport failure is a typed, COUNTED miss, not a raw
        socket error out of the heartbeat thread."""
        if chaos.fires("heartbeat_drop"):
            return self._miss_beat()
        try:
            self.kv.put(f"hb/{self.member_id}", {"t": self.clock()})
        except KVTransportError:
            return self._miss_beat()
        with self._lock:
            self.beats += 1
        return True

    def _miss_beat(self) -> bool:
        from horovod_tpu_torch.obs import catalog as _obs_catalog
        _obs_catalog.elastic_metrics()["heartbeats_missed"].inc()
        with self._lock:
            self.beats_missed += 1
        return False

    def announce_join(self) -> None:
        """Publish this (non-member) process's intent to join; the
        incumbent members' watchers pick it up and propose a grow.
        Written both as a ``join/<member>`` key (scan-capable
        transports) and onto the well-known ``join_queue`` list (the
        scan-less bootstrap KV plane)."""
        self.kv.put(f"join/{self.member_id}", {"t": self.clock()})
        queue = self.kv.get("join_queue") or []
        if self.member_id not in queue:
            self.kv.put("join_queue", list(queue) + [self.member_id])
        self.heartbeat()

    def _beat_age(self, member: str, now: float) -> float:
        hb = self.kv.get(f"hb/{member}")
        if not hb:
            # Startup grace: a member that has never beaten is aged
            # from when THIS observer started watching, not from -inf
            # — real multi-process worlds stagger their starts
            # (import time, scheduler jitter), and an observer that
            # came up first must not resize a still-booting peer out
            # instantly. A peer that never comes up still expires on
            # the ordinary lease schedule.
            return now - self._start_t
        return now - float(hb.get("t", float("-inf")))

    def members(self) -> List[str]:
        with self._lock:
            return list(self._members)

    # -- detector plumbing --------------------------------------------

    def _peer_key(self, member: str) -> str:
        return f"{self._det_ns}/{member}"

    def _sync_detector_peers(self) -> None:
        """Register every current peer (members minus self) with the
        shared detector, KV-lease beat age as evidence; drop peers no
        longer in the world. Idempotent — called at start() and after
        every adopted commit."""
        members = self.members()
        want = {m for m in members if m != self.member_id}
        with self._lock:
            have = set(self._det_peers)
            self._det_peers = set(want)
        for m in have - want:
            self._det.unregister(self._peer_key(m))
        for m in want:
            # Re-registering refreshes rank attribution after a
            # resize (ranks are slots; stall reports name ranks).
            self._det.register(
                self._peer_key(m),
                age_fn=(lambda m=m: self._beat_age(m, self.clock())),
                clock=self.clock,
                suspect_after=self.lease_s * SUSPECT_LEASE_FRACTION,
                dead_after=self.lease_s,
                label=m, poll_s=self.heartbeat_s,
                rank=members.index(m))

    def _peer_state(self, member: str) -> str:
        """This peer's graduated verdict, evidence evaluated NOW (the
        protocol's deterministic read). Falls back to direct lease
        arithmetic for a peer not (or no longer) registered — e.g. a
        stopped monitor probing one last time."""
        key = self._peer_key(member)
        with self._lock:
            registered = member in self._det_peers
        if registered:
            return self._det.state_of(key, refresh=True)
        age = self._beat_age(member, self.clock())
        if age > self.lease_s:
            return _detector.DEAD
        if age > self.lease_s * SUSPECT_LEASE_FRACTION:
            return _detector.SUSPECT
        return _detector.ALIVE

    def alive_members(self, now: Optional[float] = None) -> List[str]:
        """Current members the detector does not call DEAD (self
        always — a member never declares itself dead; SUSPECT peers
        are still alive: drained, not removed). An explicit ``now``
        keeps the pre-detector point-in-time semantics: raw lease
        arithmetic evaluated at that timestamp (``self.clock``
        domain), bypassing the detector's graduated state."""
        dead = set(self.dead_members(now))
        return [m for m in self.members() if m not in dead]

    def dead_members(self, now: Optional[float] = None) -> List[str]:
        if now is not None:
            return [m for m in self.members()
                    if m != self.member_id
                    and self._beat_age(m, now) > self.lease_s]
        return [m for m in self.members()
                if m != self.member_id
                and self._peer_state(m) == _detector.DEAD]

    def suspect_members(self) -> List[str]:
        """Peers under graduated suspicion (stale-but-not-dead
        evidence, stall reports, flap damping) — drain candidates,
        never resize triggers."""
        return [m for m in self.members()
                if m != self.member_id
                and self._peer_state(m) == _detector.SUSPECT]

    def joiners(self) -> List[str]:
        cur = set(self.members())
        try:
            announced = [m.split("/", 1)[1]
                         for m, v in self.kv.scan("join/").items()
                         if v is not None]
        except NotImplementedError:
            # Scan-less transport (BootstrapKV): the join_queue list
            # is the announcement channel.
            announced = list(self.kv.get("join_queue") or [])
        # A joiner must also be ALIVE: a candidate that announced and
        # died before admission would stall every ack barrier it is
        # proposed into for a full lease.
        now = self.clock()
        return sorted(m for m in set(announced)
                      if m not in cur
                      and self._beat_age(m, now) <= self.lease_s)

    def pending_change(self) -> Optional[Dict]:
        """{'dead': [...], 'joiners': [...]} when the committed world
        no longer matches reality, else None. Also flags a NEWER
        COMMIT this member has not adopted (``'commit': gen``) — how
        a write-partitioned member finds out the world moved on
        without it: its own beats stopped landing, the survivors
        resized, and the only honest next step is `resize()`, which
        adopts the commit and raises `MembershipError` if it excludes
        this member (never split-brain at the old generation)."""
        dead, joiners = self.dead_members(), self.joiners()
        # Snapshot under the lock `_adopt` writes it under (hvdlint
        # HVD008): this runs on the watcher thread while a caller
        # thread may be mid-resize.
        with self._lock:
            gen = self.generation
        newer = self.kv.get(f"commit/{gen + 1}")
        if not dead and not joiners and newer is None:
            return None
        out: Dict[str, Any] = {"dead": dead, "joiners": joiners}
        if newer is not None:
            out["commit"] = gen + 1
        return out

    # -- the watcher thread --------------------------------------------

    def start(self) -> "WorldMonitor":
        """Start heartbeating + watching. Founding members also race
        to write the genesis commit (first wins; content identical)."""
        if not self.joining:
            members = self.members()
            self.kv.put_if_absent("commit/0", {
                "generation": 0, "members": list(members),
                "died": [], "joined": []})
        # hvd: disable=HVD008(written before Thread.start() below — start() publishes it to the watcher thread, happens-before, not a race)
        self._start_t = self.clock()
        self.heartbeat()
        self._sync_detector_peers()
        self._stop.clear()
        t = threading.Thread(target=self._watch_loop,
                             name=f"hvd-member-{self.member_id}",
                             daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def _watch_loop(self):
        """Heartbeat writer + change watcher. NOT a liveness sweep —
        detection belongs to the shared `FailureDetector`; this
        thread only writes this member's own beats and reacts to what
        the detector (and the commit log) already concluded. A KV
        transport fault costs the tick, never the thread."""
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.heartbeat()
                if (self.on_change is not None
                        and self.pending_change()):
                    self.on_change()
            except KVTransportError:
                continue   # typed + already counted; next tick retries

    def stop(self) -> None:
        """Stop beating and watching (clean shutdown: the lease will
        lapse and the survivors will resize us out — that is the
        protocol's ONLY removal path, so a crash and a clean exit
        look identical to the world)."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            self._det_peers = set()
        self._det.unregister_prefix(self._det_ns + "/")

    def die(self) -> None:
        """Abrupt death for drills: stop heartbeating NOW, no
        goodbyes (what `rank_death` simulates)."""
        self.stop()

    # -- the resize protocol -------------------------------------------

    def _adopt(self, commit: Dict) -> ResizeDecision:
        members = list(commit["members"])
        if self.member_id not in members:
            raise MembershipError(
                f"{self.member_id}: generation "
                f"{commit['generation']} excludes this member "
                f"(declared dead at {commit.get('died')}) — stop and "
                f"re-join as a new member")
        with self._lock:
            prev = list(self._members)
            self.generation = int(commit["generation"])
            self._members = members
            self.rank = members.index(self.member_id)
            self.world = len(members)
            self.joining = False
        dec = ResizeDecision(
            generation=int(commit["generation"]), world=len(members),
            rank=members.index(self.member_id), members=members,
            died=[m for m in prev if m not in members],
            joined=[m for m in members if m not in prev])
        self._sync_detector_peers()
        self.kv.delete(f"join/{self.member_id}")
        queue = self.kv.get("join_queue") or []
        if self.member_id in queue:
            self.kv.put("join_queue",
                        [m for m in queue if m != self.member_id])
        # Generation hint for scan-less joiners: where to start
        # probing prop/commit keys.
        self.kv.put("gen", int(commit["generation"]))
        from horovod_tpu_torch.runtime import bootstrap as _bootstrap
        _bootstrap.apply_resize(dec.rank, dec.world, dec.generation,
                                rekey_runtime=self.apply_runtime)
        if dec.rank == 0:
            # One emitter per generation (the new leader): events,
            # counters, and the flight-recorder bundle that preserves
            # the run-up to the membership change.
            from horovod_tpu_torch.obs import catalog as _obs_catalog
            from horovod_tpu_torch.obs import events as _events
            from horovod_tpu_torch.obs import flightrec as _flightrec
            m = _obs_catalog.elastic_metrics()
            m["world_size"].set(float(dec.world))
            if dec.generation > 0:
                m["resizes"].inc(kind=dec.kind)
                if dec.died:
                    m["rank_deaths"].inc(len(dec.died))
                if dec.joined:
                    m["rank_joins"].inc(len(dec.joined))
                for dm in dec.died:
                    _events.emit("membership.rank_death", member=dm,
                                 generation=dec.generation)
                for jm in dec.joined:
                    _events.emit("membership.rank_join", member=jm,
                                 generation=dec.generation)
                _events.emit(
                    "membership.resize", generation=dec.generation,
                    world=dec.world, resize_kind=dec.kind,
                    died=dec.died, joined=dec.joined)
                _flightrec.trigger(
                    "membership.resize", generation=dec.generation,
                    world=dec.world, died=dec.died, joined=dec.joined)
        return dec

    def current_decision(self) -> ResizeDecision:
        """The already-committed view (no protocol round)."""
        members = self.members()
        with self._lock:
            return ResizeDecision(
                generation=self.generation, world=self.world,
                rank=self.rank, members=members, died=[], joined=[])

    def resize(self, timeout_s: float = 30.0) -> ResizeDecision:
        """Run the agreement until the pending membership change is
        committed; every affected member calls this (survivors from
        their barrier interrupt, joiners via `wait_for_membership`).

        Deterministic: the proposal is survivors-in-old-rank-order
        with joiners appended (sorted by member id), first proposal
        per generation wins, commit requires every proposed member's
        ack. A proposed member dying mid-barrier stalls acks for one
        lease, after which the detectors re-propose at the next
        generation without it."""
        deadline = self.clock() + timeout_s
        attempt = self.generation + 1
        while True:
            if self.clock() > deadline:
                raise MembershipError(
                    f"{self.member_id}: resize did not commit within "
                    f"{timeout_s}s (generation {self.generation}, "
                    f"pending {self.pending_change()})")
            self.heartbeat()
            # Adopt the newest commit first — another member may have
            # finished the round while we were detecting. Targeted
            # probes (generation+1 .. attempt+1), not a scan, so the
            # scan-less bootstrap transport works identically.
            newest_commit = None
            for g in range(self.generation + 1, attempt + 2):
                c = self.kv.get(f"commit/{g}")
                if c is not None:
                    newest_commit = c
            if newest_commit is not None:
                dec = self._adopt(newest_commit)
                if self.pending_change() is None:
                    return dec
                attempt = self.generation + 1
                continue
            if self.pending_change() is None and not self.joining:
                return self.current_decision()   # spurious wake
            attempt = max(attempt, self.generation + 1)
            prop = self.kv.get(f"prop/{attempt}")
            if prop is None:
                pend = self.pending_change() or {"dead": [],
                                                 "joiners": []}
                alive = [m for m in self.members()
                         if m not in pend["dead"]]
                proposed = alive + sorted(pend["joiners"])
                prop = self.kv.put_if_absent(
                    f"prop/{attempt}",
                    {"members": proposed, "by": self.member_id,
                     "t": self.clock()})
            members = list(prop["members"])
            if self.member_id not in members:
                # Proposed out (our lease lapsed under someone else's
                # clock): wait for the commit to confirm, then stop.
                t0 = self.clock()
                while self.clock() - t0 < self.lease_s * 2:
                    c = self.kv.get(f"commit/{attempt}")
                    if c is not None:
                        self._adopt(c)   # raises MembershipError
                    time.sleep(self.heartbeat_s / 4)
                raise MembershipError(
                    f"{self.member_id}: proposed out of generation "
                    f"{attempt} by {prop.get('by')}")
            self.kv.put(f"ack/{attempt}/{self.member_id}", 1)
            t0 = self.clock()
            while self.clock() - t0 < self.lease_s:
                acked = {m for m in members
                         if self.kv.get(f"ack/{attempt}/{m}")
                         is not None}
                if set(members) <= acked:
                    commit = {
                        "generation": attempt, "members": members,
                        "died": [m for m in self.members()
                                 if m not in members],
                        "joined": [m for m in members
                                   if m not in self.members()]}
                    won = self.kv.put_if_absent(f"commit/{attempt}",
                                                commit)
                    dec = self._adopt(won)
                    if self.pending_change() is None:
                        return dec
                    attempt = self.generation + 1
                    break
                if self.kv.get(f"commit/{attempt}") is not None:
                    break   # someone else committed; adopt at loop top
                time.sleep(self.heartbeat_s / 4)
            else:
                # Barrier stalled a full lease: a proposed member died
                # mid-round. Supersede at the next generation with a
                # fresh alive set.
                attempt += 1

    def wait_for_membership(self, timeout_s: float = 30.0
                            ) -> ResizeDecision:
        """Joiner side: ack any proposal that includes us, adopt the
        commit that admits us. Probes generations from the committed
        ``gen`` hint (scan-free, so the bootstrap transport works)."""
        deadline = self.clock() + timeout_s
        while self.clock() < deadline:
            self.heartbeat()
            base = int(self.kv.get("gen") or 0)
            best = None
            for g in range(base, base + 16):
                prop = self.kv.get(f"prop/{g + 1}")
                if (prop is not None
                        and self.member_id in prop.get("members", ())):
                    self.kv.put(f"ack/{g + 1}/{self.member_id}", 1)
                commit = self.kv.get(f"commit/{g}")
                if (commit is not None
                        and self.member_id
                        in commit.get("members", ())):
                    best = commit
            if best is not None:
                return self._adopt(best)
            time.sleep(self.heartbeat_s / 4)
        raise MembershipError(
            f"{self.member_id}: no generation admitted this joiner "
            f"within {timeout_s}s")


# ---------------------------------------------------------------------------
# The resize-aware step barrier (in-process worlds).
# ---------------------------------------------------------------------------

class ElasticBarrier:
    """A cyclic barrier whose membership can change and whose waiters
    can be interrupted — the in-process stand-in for "the collective
    failed because a peer is gone".

    `wait` returns ``"ok"`` when every current member arrived,
    ``"resize"`` when the cycle was interrupted (a monitor detected a
    membership change — the step in flight must be discarded), or
    ``"timeout"``. `reconfigure(gen, members)` installs the new
    membership after a committed resize (idempotent per generation;
    an equal-generation call only clears a stale interrupt)."""

    def __init__(self, members: Sequence[str]):
        self._cond = threading.Condition()
        self._members = set(members)
        self._arrived: set = set()
        self._phase = 0
        self._interrupted = False
        self._config_gen = 0

    def interrupt(self) -> None:
        with self._cond:
            self._interrupted = True
            # Abort the in-flight cycle cleanly: every waiter returns
            # "resize" and NOBODY stays arrived — a stale arrival
            # surviving into the post-resize cycle would let one
            # member complete a barrier the others never re-entered.
            self._arrived = set()
            self._cond.notify_all()

    def reconfigure(self, gen: int, members: Sequence[str]) -> None:
        with self._cond:
            if gen < self._config_gen:
                return
            if gen > self._config_gen:
                self._config_gen = gen
                self._members = set(members)
                self._arrived = set()
                self._phase += 1
            self._interrupted = False
            self._cond.notify_all()

    def members(self) -> List[str]:
        with self._cond:
            return sorted(self._members)

    def wait(self, member: str, timeout: float = 30.0) -> str:
        deadline = time.monotonic() + timeout
        with self._cond:
            if self._interrupted:
                return "resize"
            if member not in self._members:
                return "resize"   # reconfigured out while computing
            self._arrived.add(member)
            if self._members <= self._arrived:
                self._arrived = set()
                self._phase += 1
                self._cond.notify_all()
                return "ok"
            phase = self._phase
            while self._phase == phase and not self._interrupted:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._arrived.discard(member)
                    return "timeout"
                self._cond.wait(min(remaining, 0.05))
            if self._phase != phase:
                return "ok"
            return "resize"


# ---------------------------------------------------------------------------
# The simulated elastic training world.
# ---------------------------------------------------------------------------

def record_keys(batch: Dict[str, np.ndarray]) -> List[str]:
    """Per-record content hashes of one batch — the union-stream
    currency (field names, dtypes, and raw bytes participate, so
    "bitwise identical" means exactly that; batch GROUPING does not,
    which is the point: a resize regroups records, never alters
    them)."""
    names = sorted(batch)
    n = len(batch[names[0]])
    out = []
    for i in range(n):
        h = hashlib.sha256()
        for name in names:
            a = np.ascontiguousarray(batch[name][i])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        out.append(h.hexdigest())
    return out


def _float64(x):
    """``x`` in float64 where it lies: a torch tensor on its own device,
    anything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64)
    return np.asarray(x, dtype=np.float64)


def average(grads: Sequence[Dict]) -> Dict:
    """The lockstep loop's gradient average over the contributing
    members' gradient dicts, given in rank order: per key, the float64
    sum in that order divided by the count. Numpy leaves take exactly
    the JAX package's arithmetic (Python ``sum`` from 0, then ``/ n``),
    so their average is bitwise its; torch leaves are summed the same
    way in float64 on their own device (a card's gradients never leave
    it)."""
    return {k: sum(_float64(g[k]) for g in grads) / len(grads)
            for k in grads[0]}


@dataclasses.dataclass
class WorldRunReport:
    """What one simulated elastic run did (the union proof's chaos
    leg, the CI smoke's assertion surface, bench's artifact)."""

    completed: bool
    final_world: int
    final_generation: int
    steps: int
    epochs: int
    deaths: List[str]
    joins: List[str]
    resizes: List[Dict]          # per commit: gen/world/kind/timings
    logs: Dict[str, List]        # member -> [(step, [record keys])]
    final_state: Optional[Dict] = None
    error: Optional[str] = None

    def union_keys(self) -> List[str]:
        """Every record key whose training survived into the final
        state (each log already trimmed to its member's last committed
        step at every resize) — sorted, as a multiset."""
        out: List[str] = []
        for entries in self.logs.values():
            for _step, keys in entries:
                out.extend(keys)
        return sorted(out)

    def summary(self) -> Dict:
        detect = sorted(r["detect_s"] for r in self.resizes
                        if r.get("detect_s") is not None)
        resume = sorted(r["resume_s"] for r in self.resizes
                        if r.get("resume_s") is not None)
        return {
            "completed": self.completed,
            "final_world": self.final_world,
            "final_generation": self.final_generation,
            "steps": self.steps,
            "deaths": len(self.deaths),
            "joins": len(self.joins),
            "resizes": len(self.resizes),
            "records_reassigned": sum(
                r.get("records_reassigned", 0) for r in self.resizes),
            "detect_s": {
                "p50": round(detect[len(detect) // 2], 3)
                if detect else None,
                "max": round(detect[-1], 3) if detect else None},
            "time_to_resume_s": {
                "p50": round(resume[len(resume) // 2], 3)
                if resume else None,
                "max": round(resume[-1], 3) if resume else None},
            "error": self.error,
        }


class SimulatedWorld:
    """An N-member in-process elastic training world (CPU test double
    for a multi-host fleet): each member is a thread with its own
    `WorldMonitor`, `ShardedDataset` shard view, and `ElasticTrainer`
    over ONE shared checkpoint directory; steps run in lockstep
    through an `ElasticBarrier` with gradients averaged across the
    contributing members (`average`: a deterministic rank-order float64
    sum, on the gradients' own device).

    Chaos opportunities (all leader-offered at step boundaries so a
    one-shot ``HVD_CHAOS=rank_death:1`` arming is deterministic):
    ``rank_death`` — once a checkpoint is committed, the
    highest-ranked member stops heartbeating and its thread dies;
    ``rank_join`` — while the world is below its launch size, a new
    member announces itself and is admitted by a grow resize at that
    step boundary (`_await_joiner`).

    The loop only checkpoints on FULL lockstep steps (every live
    member contributed a batch), so the snapshot's single cursor
    describes every rank — the invariant `data.remainder_after`'s
    consumed-set math stands on.
    """

    def __init__(self, *, world: int, make_dataset: Callable,
                 state0: Dict, grad_fn: Callable, apply_fn: Callable,
                 ckpt_dir: str, epochs: int, save_every: int = 2,
                 lease_s: float = 0.4,
                 heartbeat_s: Optional[float] = None,
                 join_member_prefix: str = "joiner",
                 max_joins: int = 1,
                 kv: Optional[Any] = None):
        self.world0 = int(world)
        self.make_dataset = make_dataset
        self.state0 = state0
        self.grad_fn = grad_fn
        self.apply_fn = apply_fn
        self.ckpt_dir = ckpt_dir
        self.epochs = int(epochs)
        self.save_every = int(save_every)
        self.lease_s = float(lease_s)
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s
                            else self.lease_s / 4.0)
        self.join_member_prefix = join_member_prefix
        self.max_joins = int(max_joins)
        self.kv = kv if kv is not None else InProcessKV()
        self.members0 = _default_members(world)
        self.barrier = ElasticBarrier(self.members0)
        self._lock = lockcheck.register(
            "SimulatedWorld._lock", threading.Lock())
        self._ctl: Dict[str, Any] = {
            "victim": None, "stop": False, "joins_spawned": 0,
            "contrib": {}, "death_t": {}, "logs": {}, "resizes": [],
            "deaths": [], "joins": [], "final": {}, "errors": [],
        }
        self._threads: List[threading.Thread] = []

    # -- shared-control helpers (all under self._lock) -----------------

    def _log_keys(self, member: str, step: int, keys: List[str]):
        with self._lock:
            self._ctl["logs"].setdefault(member, []).append(
                (int(step), list(keys)))

    def _trim_log(self, member: str, step: int):
        """Drop a member's record log past `step` — those batches'
        effects died with the rollback."""
        with self._lock:
            log = self._ctl["logs"].get(member, [])
            self._ctl["logs"][member] = [
                ent for ent in log if ent[0] <= step]

    # -- member threads ------------------------------------------------

    def _spawn(self, member: str, rank: Optional[int],
               joining: bool):
        t = threading.Thread(
            target=self._member_main, args=(member, rank, joining),
            name=f"hvd-sim-{member}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()
        if joining:
            self._await_joiner(member)

    def _await_joiner(self, member: str) -> None:
        """Hold the leader's step until the new member has announced
        itself (its first beat lands last), then interrupt the barrier:
        every member resizes at this step boundary. The JAX package
        leaves the interrupt to the next watcher tick instead, which
        makes the grow's rollback step a matter of timing; the port's
        steps are quick enough that a small world could even finish its
        epochs before that tick saw the joiner."""
        deadline = time.monotonic() + max(10.0, self.lease_s * 40)
        while (self.kv.get(f"hb/{member}") is None
               and time.monotonic() < deadline):
            time.sleep(self.heartbeat_s / 4)
        self.barrier.interrupt()

    def _member_main(self, member: str, rank: Optional[int],
                     joining: bool):
        try:
            self._member_loop(member, rank, joining)
        except MembershipError:
            return   # declared dead mid-protocol: the drill's point
        # hvd: disable=HVD006(simulated-world member: any unexpected fault must surface in the report, not hang the join)
        except Exception as e:
            with self._lock:
                self._ctl["errors"].append(f"{member}: {e!r}")
            self.barrier.interrupt()

    def _build_trainer(self, dec_rank: int, dec_world: int):
        from horovod_tpu_torch.resilience.elastic import ElasticTrainer
        ds = self.make_dataset(dec_rank, dec_world)
        trainer = ElasticTrainer(
            self.ckpt_dir,
            save_every=self.save_every if dec_rank == 0 else 0,
            keep=0, block=True, install_signals=False,
            dataset=ds, migrate_world=True)
        state, step = trainer.resume(like=self.state0)
        return ds, trainer, state, step

    def _offer_chaos(self, monitor: WorldMonitor, trainer) -> None:
        """Leader-only, step-boundary chaos opportunities (see class
        docstring for why they are leader-offered)."""
        if monitor.rank != 0:
            return
        committed = getattr(trainer, "_last_good_step", None)
        if committed and committed >= self.save_every:
            if chaos.fires("rank_death"):
                victims = [m for m in monitor.members()
                           if m != monitor.member_id]
                if victims:
                    victim = victims[-1]   # highest current rank
                    with self._lock:
                        self._ctl["victim"] = victim
                        self._ctl["deaths"].append(victim)
        if monitor.world < self.world0:
            with self._lock:
                spawned = self._ctl["joins_spawned"]
            if spawned < self.max_joins and chaos.fires("rank_join"):
                with self._lock:
                    self._ctl["joins_spawned"] = spawned + 1
                    jid = f"{self.join_member_prefix}{spawned}"
                    self._ctl["joins"].append(jid)
                self._spawn(jid, None, True)

    def _resize(self, member: str, monitor: WorldMonitor):
        """Survivor side of a detected change: agree, reconfigure the
        barrier, roll back to the committed snapshot, rebalance.

        Returns ``None`` for a spurious wake (a stale interrupt after
        the generation already committed, or a barrier timeout with
        nothing actually pending): the caller keeps its state and its
        in-flight contribution — rolling back on a phantom resize
        would discard legitimately-trained steps and inflate the
        resize accounting."""
        gen_before = monitor.generation
        t_detect = time.monotonic()
        dec = monitor.resize(timeout_s=max(10.0, self.lease_s * 40))
        self.barrier.reconfigure(dec.generation, dec.members)
        if dec.generation == gen_before:
            return None
        ds, trainer, state, step = self._build_trainer(
            dec.rank, dec.world)
        self._trim_log(member, step)
        t_done = time.monotonic()
        if dec.rank == 0:
            with self._lock:
                recorded = {r["generation"]
                            for r in self._ctl["resizes"]}
                if dec.generation not in recorded:
                    for dm in dec.died:
                        # The dead member's post-commit batches died
                        # with it — trim its log to the step we
                        # rolled back to.
                        log = self._ctl["logs"].get(dm, [])
                        self._ctl["logs"][dm] = [
                            ent for ent in log if ent[0] <= step]
                    death_t = [self._ctl["death_t"].get(dm)
                               for dm in dec.died]
                    death_t = [t for t in death_t if t is not None]
                    self._ctl["resizes"].append({
                        "generation": dec.generation,
                        "world": dec.world,
                        "kind": dec.kind, "died": dec.died,
                        "joined": dec.joined, "committed_step": step,
                        "detect_s": round(
                            t_done - max(death_t), 3)
                        if death_t else None,
                        "resume_s": round(t_done - t_detect, 3),
                        "records_reassigned": int(
                            (ds.last_rebalance or {}).get(
                                "records_reassigned", 0)),
                    })
        return dec, ds, trainer, state, step

    def _member_loop(self, member: str, rank: Optional[int],
                     joining: bool):
        monitor = WorldMonitor(
            member, rank=rank, world=None if joining else self.world0,
            kv=self.kv, initial_members=None if joining
            else self.members0, lease_s=self.lease_s,
            heartbeat_s=self.heartbeat_s,
            on_change=self.barrier.interrupt, joining=joining,
            apply_runtime=False)
        ds = trainer = None
        try:
            if joining:
                monitor.announce_join()
                monitor.start()
                dec = monitor.wait_for_membership(
                    timeout_s=max(10.0, self.lease_s * 40))
                self.barrier.reconfigure(dec.generation, dec.members)
            else:
                monitor.start()
            ds, trainer, state, step = self._build_trainer(
                monitor.rank, monitor.world)
            self._trim_log(member, step)
            e0, b0 = trainer.data_start
            epoch = e0
            it = iter(ds.epoch(epoch, start_batch=b0))
            # The contribution drawn for the CURRENT step. Kept across
            # spurious barrier interrupts (the iterator cannot un-draw
            # a batch — on a phantom resize the same contribution is
            # simply re-posted; a REAL resize rebuilds the iterator
            # from the rolled-back cursor and discards it).
            pending = None
            while True:
                with self._lock:
                    if self._ctl["stop"]:
                        return
                status = self.barrier.wait(member)
                if status != "ok":
                    out = self._resize(member, monitor)
                    if out is not None:
                        dec, ds2, trainer, state, step = out
                        if ds is not None and ds is not ds2:
                            ds.close()
                        ds = ds2
                        e0, b0 = trainer.data_start
                        epoch = e0
                        it = iter(ds.epoch(epoch, start_batch=b0))
                        pending = None
                    continue
                self._offer_chaos(monitor, trainer)
                with self._lock:
                    victim = self._ctl["victim"]
                if victim == member:
                    with self._lock:
                        self._ctl["death_t"][member] = time.monotonic()
                        self._ctl["victim"] = None
                    monitor.die()
                    return
                if pending is None:
                    batch = next(it, None)
                    if batch is not None:
                        grads, loss = self.grad_fn(state, batch)
                        pending = {"grads": grads, "loss": loss,
                                   "keys": record_keys(batch)}
                    else:
                        pending = {"grads": None, "loss": None,
                                   "keys": []}
                with self._lock:
                    self._ctl["contrib"][member] = dict(
                        pending, epoch=epoch, step=step)
                status = self.barrier.wait(member)
                if status != "ok":
                    # Step in flight when the membership changed: no
                    # one applied it — resize (a REAL one discards
                    # it; a phantom one re-posts `pending`).
                    out = self._resize(member, monitor)
                    if out is not None:
                        dec, ds2, trainer, state, step = out
                        if ds is not None and ds is not ds2:
                            ds.close()
                        ds = ds2
                        e0, b0 = trainer.data_start
                        epoch = e0
                        it = iter(ds.epoch(epoch, start_batch=b0))
                        pending = None
                    continue
                live = set(monitor.members())
                with self._lock:
                    contribs = {
                        m: c for m, c in self._ctl["contrib"].items()
                        if m in live and c["epoch"] == epoch
                        and c["step"] == step}
                order = [m for m in monitor.members()
                         if m in contribs
                         and contribs[m]["grads"] is not None]
                if not order:
                    # Every live member exhausted the epoch.
                    epoch += 1
                    pending = None
                    if epoch >= self.epochs:
                        with self._lock:
                            self._ctl["final"][member] = {
                                "state": state, "step": step,
                                "world": monitor.world,
                                "generation": monitor.generation}
                        return
                    it = iter(ds.epoch(epoch))
                    continue
                avg = average([contribs[m]["grads"] for m in order])
                loss_mean = float(
                    sum(float(contribs[m]["loss"]) for m in order)
                    / len(order))
                state = self.apply_fn(state, avg)
                step += 1
                if pending["keys"]:
                    self._log_keys(member, step, pending["keys"])
                pending = None
                full = len(order) == len(live)
                if monitor.rank == 0 and full:
                    state = trainer.after_step(step, state, loss_mean)
        finally:
            monitor.stop()
            if ds is not None:
                ds.close()

    # -- running the world ---------------------------------------------

    def run(self, timeout_s: float = 120.0) -> WorldRunReport:
        for i, member in enumerate(self.members0):
            self._spawn(member, i, False)
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                threads = list(self._threads)
            if all(not t.is_alive() for t in threads):
                break
            if time.monotonic() > deadline:
                with self._lock:
                    self._ctl["stop"] = True
                    self._ctl["errors"].append(
                        f"run did not finish within {timeout_s}s")
                self.barrier.interrupt()
                for t in threads:
                    t.join(timeout=5.0)
                break
            time.sleep(0.02)
        with self._lock:
            ctl = self._ctl
            finals = dict(ctl["final"])
            errors = list(ctl["errors"])
            completed = (not errors and len(finals) > 0)
            worlds = {f["world"] for f in finals.values()}
            gens = {f["generation"] for f in finals.values()}
            steps = {f["step"] for f in finals.values()}
            if completed and (len(worlds) != 1 or len(gens) != 1
                              or len(steps) != 1):
                errors.append(
                    f"finishers disagree: worlds={worlds} gens={gens} "
                    f"steps={steps}")
                completed = False
            any_final = next(iter(finals.values()), None)
            return WorldRunReport(
                completed=completed,
                final_world=any_final["world"] if any_final else 0,
                final_generation=(any_final["generation"]
                                  if any_final else 0),
                steps=any_final["step"] if any_final else 0,
                epochs=self.epochs,
                deaths=list(ctl["deaths"]),
                joins=list(ctl["joins"]),
                resizes=list(ctl["resizes"]),
                logs={m: list(v) for m, v in ctl["logs"].items()},
                final_state=(any_final or {}).get("state"),
                error="; ".join(errors) if errors else None,
            )
