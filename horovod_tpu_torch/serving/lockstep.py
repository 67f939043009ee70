"""The lockstep engine: one scheduler driving the pools of every rank of
a tensor-parallel serving mesh.

The JAX package's sharded engine is one controller that drives every
device of its mesh. The port has one process a rank, so the engine is
split at the pool boundary:

* **The leader** (model rank 0) runs the whole engine: admission, the
  scheduler, overload control, metrics, handles and the dispatch
  thread. Its pool is wrapped in a `LeaderPool`: before each call that
  touches the device or the host allocator, the wrapper broadcasts a
  descriptor (the method and its host arguments) and only then makes
  its own call, so the row-parallel all-reduces inside each model call
  pair up rank for rank.
* **A follower** (every other model rank) builds the same engine and
  runs `follow`: a loop with no scheduler and no queue that replays
  each descriptor on its own pool. Its host allocator receives the same
  calls as the leader's and so makes the same decisions.

Descriptors travel over a CPU gloo group of the mesh's ranks
(`SideChannel`), so control never passes through the card. Each tick
descriptor carries the leader's tokens of its last synced tick and a
digest of its host state (free lanes, fills, block chains, sampling
keys); a follower whose own tokens or digest differ, or that receives a
descriptor it does not know, raises `ShardDivergence`. Nothing carries
on silently. Every rank samples from the same gathered logits with the
same threefry keys, so the streams agree.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Optional

import numpy as np

__all__ = ["ShardDivergence", "SideChannel", "LeaderPool", "follow",
           "pool_digest"]


class ShardDivergence(RuntimeError):
    """A follower's state left the leader's: its tokens, its host
    digest, or a descriptor it does not know."""


class _NotOnMesh(NotImplementedError, AttributeError):
    """A pool call the lockstep engine does not mirror: raises as a
    later slice, and reads as absent to ``getattr(pool, name, None)``
    (the scheduler's probe for optional pool features)."""


class SideChannel:
    """Descriptor broadcast from the mesh's model rank 0 to the others,
    over a gloo group of the ``model`` axis's ranks (created here, by
    those ranks only)."""

    def __init__(self, mesh):
        import torch.distributed as dist
        from horovod_tpu_torch.parallel.mesh import AXIS_MODEL, axis_ranks
        self.mesh = mesh
        self.ranks = axis_ranks(AXIS_MODEL, mesh)
        self.leader = self.ranks[0]
        self.group = dist.new_group(self.ranks, backend="gloo",
                                    use_local_synchronization=True)
        self.sent = 0

    def send(self, desc: tuple) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([desc], src=self.leader,
                                   group=self.group)
        self.sent += 1

    def recv(self) -> tuple:
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]


def pool_digest(pool) -> str:
    """A digest of a pool's host state, the same on every rank of a
    lockstep mesh: its free lanes, host fills, sampled lanes' keys and,
    on the paged pool, every lane's block chain and the allocator's
    counts. Reads nothing from the device."""
    parts = []
    if hasattr(pool, "blocks"):
        parts += [list(pool._free_lanes), pool._est_fill.tolist(),
                  sorted(pool._ticking), pool.blocks.stats(),
                  [pool.blocks.blocks_of(s) for s in range(pool.num_slots)]]
    else:
        parts += [list(pool._free), list(pool._fill)]
    keys = pool._keys
    parts += [sorted(keys.sampled), keys.keys[sorted(keys.sampled)].tolist()]
    return hashlib.blake2b(repr(parts).encode(), digest_size=16).hexdigest()


class LeaderPool:
    """The leader's pool: each call that touches the device or the host
    allocator is broadcast as a descriptor first, then made; everything
    else reads through to the wrapped pool."""

    def __init__(self, pool, channel: SideChannel):
        self._pool = pool
        self._channel = channel
        self._seq = 0
        self._inflight: collections.deque = collections.deque()
        self._last: Optional[tuple] = None   # (seq, tokens) last synced
        self._stopped = False
        self.mesh = channel.mesh

    def __getattr__(self, name):
        if name in ("prefill", "spec_round", "graft", "fork",
                    "clone_fresh"):
            raise _NotOnMesh(
                f"{name} on a lockstep (sharded) pool: a later slice of "
                f"the PyTorch port (ROADMAP Queue A 5)")
        attr = getattr(self._pool, name)
        if name == "grow_for_tick":
            # The paged pool's watermark growth (the scheduler looks it
            # up with getattr, so the fixed pool has none).
            def grow():
                self._send("grow_for_tick")
                return attr()
            return grow
        return attr

    @property
    def pool(self):
        return self._pool

    def _send(self, name: str, *args, **kw):
        self._channel.send((name, args, kw))

    def admit(self, prompt, max_new: int):
        # hvd: disable=HVD001(prompt is host-side admission-queue tokens — no sync)
        prompt = np.asarray(prompt)
        self._send("admit", prompt, int(max_new))
        return self._pool.admit(prompt, max_new)

    def begin_prefill(self, slot: int):
        self._send("begin_prefill", int(slot))
        return self._pool.begin_prefill(slot)

    def prefill_chunk(self, slot: int, chunk):
        # hvd: disable=HVD001(chunk is host-side prompt tokens — no sync)
        chunk = np.asarray(chunk)
        self._send("prefill_chunk", int(slot), chunk)
        return self._pool.prefill_chunk(slot, chunk)

    def finish_prefill(self, slot: int, logits, temperature: float,
                       top_p, seed: int, *, rng_skip: int = 0) -> int:
        # The follower samples from its own copy of the (gathered)
        # logits of the slot's last chunk.
        self._send("finish_prefill", int(slot), float(temperature),
                   top_p, int(seed), rng_skip=int(rng_skip))
        return self._pool.finish_prefill(slot, logits, temperature, top_p,
                                         seed, rng_skip=rng_skip)

    def tick_dispatch(self):
        self._seq += 1
        self._send("tick", self._seq, self._last, pool_digest(self._pool))
        handle = self._pool.tick_dispatch()
        self._inflight.append((handle, self._seq))
        return handle

    def tick_sync(self, handle):
        toks = self._pool.tick_sync(handle)
        while self._inflight:
            h, seq = self._inflight.popleft()
            if h is handle:
                self._last = (seq, toks.copy())
                break
        return toks

    def tick(self):
        return self.tick_sync(self.tick_dispatch())

    def free(self, slot: int):
        self._send("free", int(slot))
        return self._pool.free(slot)

    def warmup(self, max_chunk: Optional[int] = None) -> dict:
        self._send("warmup", max_chunk)
        return self._pool.warmup(max_chunk)

    def stop(self):
        """Tell the followers the engine has stopped (idempotent); the
        descriptor carries the last synced tick and the final digest."""
        if not self._stopped:
            self._stopped = True
            self._send("stop", self._last, pool_digest(self._pool))

    def release(self):
        self.stop()
        self._pool.release()


def _check(pool, handles: dict, last, digest, where: str):
    """Sync this rank's ticks up to the leader's last synced one and
    hold its tokens and host digest to the leader's."""
    if last is not None:
        seq, toks = last
        for s in sorted(k for k in handles if k <= seq):
            mine = pool.tick_sync(handles.pop(s))
            if s == seq and not np.array_equal(mine, toks):
                raise ShardDivergence(
                    f"tick {seq}: this rank emitted {mine.tolist()}, the "
                    f"leader {np.asarray(toks).tolist()}")
    mine = pool_digest(pool)
    if digest != mine:
        raise ShardDivergence(f"{where}: host state digest {mine} differs "
                              f"from the leader's {digest}")


def follow(pool, channel: SideChannel, *, drop: Optional[str] = None):
    """Replay the leader's descriptors on ``pool`` until it stops;
    returns ``pool``. Raises `ShardDivergence` as the module says. ``drop`` skips the
    first descriptor of that name (a planted fault: the digest check
    must catch it)."""
    logits = {}
    handles: dict = {}
    while True:
        name, args, kw = channel.recv()
        if name == drop:
            drop = None
            continue
        if name == "admit":
            pool.admit(*args)
        elif name == "begin_prefill":
            pool.begin_prefill(*args)
        elif name == "prefill_chunk":
            logits[args[0]] = pool.prefill_chunk(*args)
        elif name == "finish_prefill":
            slot = args[0]
            pool.finish_prefill(slot, logits.pop(slot), *args[1:], **kw)
        elif name == "grow_for_tick":
            pool.grow_for_tick()
        elif name == "tick":
            seq, last, digest = args
            _check(pool, handles, last, digest, f"tick {seq}")
            handles[seq] = pool.tick_dispatch()
        elif name == "free":
            pool.free(*args)
        elif name == "warmup":
            pool.warmup(*args)
        elif name == "stop":
            last, digest = args
            _check(pool, handles, last, digest, "stop")
            pool.release()
            return pool
        else:
            raise ShardDivergence(f"unknown descriptor {name!r}")
