"""Sharded input pipeline over the native prefetching loader.

Counterpart of `horovod_tpu.data`, ported by copy (numpy throughout:
batches stay numpy, the train loop moves them to the device). The
reference leaves IO to user code and prescribes only the sharding
arithmetic (`examples/keras_mnist_advanced.py:113-119`: divide the work
by `hvd.size()`). The host must hide IO behind device steps, so this
subsystem makes the recipe a component:

* `write_shards` — pack numpy arrays into fixed-record binary shards.
* `ShardedDataset` — per-rank round-robin shard ownership, C++ reader
  threads prefetching batches into a bounded queue
  (``horovod_tpu_torch/csrc/data_loader.cc``, built with the host's
  ``c++`` at first use into ``build/host/`` and bound with ctypes),
  deterministic per-epoch shuffling; a pure-Python fallback keeps the
  same semantics when the native build is unavailable (it warns) or
  ``HOROVOD_NO_NATIVE=1``.

Records are structured rows: a `spec` of (name, dtype, shape) fields,
e.g. ``[("image", "float32", (28, 28, 1)), ("label", "int32", ())]``;
batches come back as dicts of numpy arrays with a leading batch dim.

Exact resume: both loader
implementations shuffle with the SAME splitmix64-keyed stable sort, so
native and fallback yield bitwise-identical batch streams for a given
(seed, epoch, rank, world) — and the stream is addressable by a
cursor. `state()` snapshots the cursor (epoch index, next batch,
shuffle seed — everything needed to re-derive the permutation),
`restore(state)` validates and re-installs it in a fresh process, and
`epoch(epoch_idx, start_batch=k)` restarts mid-epoch: the native
loader skips to the record offset inside the producer
(`hvd_dl_start_epoch_at`), the fallback slices the shuffled order —
batches ``k..end`` are bitwise identical to the uninterrupted epoch's.

Elastic resize: the cursor
is additionally *world-portable*. When the fleet shrinks or grows
mid-epoch, `restore(state, migrate=True)` / `rebalance(new_rank,
new_world)` remap the splitmix64-keyed stream instead of raising
`DataStateError`: the untrained remainder of the interrupted epoch —
every old rank's unconsumed suffix, the dead rank's included — is
computed from the snapshot's ``(world, next_batch)`` and repartitioned
round-robin across the new world (`remainder_after` is the pure
oracle). The union of all new ranks' post-resize batches is exactly
that remainder: no record trained twice, none silently dropped.
Resizes chain (a grow right after a shrink, both mid-epoch) through
the migration ``history`` the cursor carries. The rebalanced remainder
is read host-side by an explicit-order reader under both loader
implementations; from the next epoch boundary the stream returns to
normal file sharding (native prefetch included) under the new world.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience.retry import default_io_policy

Spec = Sequence[Tuple[str, str, Tuple[int, ...]]]

# Version stamp of the `ShardedDataset.state()` dict; bump on any
# incompatible change so a stale cursor fails restore() loudly instead
# of silently mis-seeking.
DATA_STATE_SCHEMA = 1

_GOLDEN = 0x9E3779B97F4A7C15  # splitmix64 stream constant


class DataStateError(ValueError):
    """A data-pipeline cursor cannot be restored onto this dataset —
    wrong schema version or the dataset's identity fields (seed,
    batch size, sharding, ...) disagree with the snapshot's. Resume
    logic catches this and falls back to the epoch boundary
    (`resilience/elastic.py`), loudly."""


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array — the shared shuffle
    key (`csrc/data_loader.cc::Mix64` is the same arithmetic; the
    two must never diverge or native/fallback parity breaks)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def shuffle_perm(n: int, seed: int, epoch: int) -> np.ndarray:
    """The deterministic epoch permutation BOTH loader implementations
    apply: stable argsort of splitmix64 keys Mix64(seed*GOLDEN+epoch+i).
    Stable, so key ties break toward the lower index — matching the
    native `std::stable_sort`. Exposed so tests (and any external
    tooling) can compute the oracle order without a loader."""
    base = (int(seed) * _GOLDEN + int(epoch)) % (1 << 64)
    keys = _mix64(np.uint64(base) + np.arange(n, dtype=np.uint64))
    return np.argsort(keys, kind="stable")


def _rank_epoch_order(counts: Sequence[int], world: int, rank: int,
                      seed: int, epoch: int,
                      shuffle: bool) -> List[Tuple[int, int]]:
    """The (global_file_idx, record_idx) walk order rank ``rank`` of
    ``world`` produces in ``epoch`` — owned files ascending, records
    ascending, then the splitmix64 stable-sort permutation. This is
    the SAME order both loader implementations yield (pinned by the
    parity tests), which is what makes the remainder of a resized
    epoch computable without replaying it."""
    order = [(fi, r) for fi in range(len(counts))
             if fi % world == rank for r in range(counts[fi])]
    if shuffle:
        order = [order[i] for i in shuffle_perm(len(order), seed,
                                                epoch)]
    return order


def remainder_after(counts: Sequence[int], history, *,
                    batch_size: int, seed: int, epoch: int,
                    shuffle: bool,
                    drop_remainder: bool) -> List[Tuple[int, int]]:
    """The canonical untrained remainder of ``epoch`` after a resize
    ``history`` — the pure oracle behind elastic rebalancing.

    ``history`` is ``[(world_0, batches_0), (world_1, batches_1),
    ...]``: segment 0 is the normal file-sharded stream under
    ``world_0`` with ``batches_0`` lockstep batches consumed per rank;
    each later segment is the round-robin repartition of the previous
    remainder under ``world_i`` with ``batches_i`` batches consumed
    per rank. New rank ``k`` of ``new_world`` owns
    ``remainder[k::new_world]`` — so the union over ranks is exactly
    this list, each record once (no record trained twice, none
    silently dropped). With ``drop_remainder`` the per-rank tail the
    uninterrupted epoch would never have trained is excluded from
    segment 0 (it was never owed to anyone)."""
    w0, b0 = history[0]
    rem: List[Tuple[int, int]] = []
    for r in range(int(w0)):
        order = _rank_epoch_order(counts, int(w0), r, seed, epoch,
                                  shuffle)
        n_eff = ((len(order) // batch_size) * batch_size
                 if drop_remainder else len(order))
        rem.extend(order[min(int(b0) * batch_size, n_eff):n_eff])
    for wi, bi in history[1:]:
        parts = [rem[k::int(wi)] for k in range(int(wi))]
        rem = []
        for part in parts:
            rem.extend(part[min(int(bi) * batch_size, len(part)):])
    return rem


def _open_with_retry(path: str, mode: str):
    """Shard open under the shared IO `RetryPolicy` (the same policy
    checkpoint writes use): transient filesystem faults back off and
    retry instead of killing the epoch. Chaos sites are split by
    direction — ``data_read_fail`` fires only on read-mode opens (the
    input pipeline), ``data_write_fail`` only on writes
    (`write_shards`) — so arming read faults cannot corrupt a
    concurrent dataset write's premise."""
    site = "data_read_fail" if "r" in mode else "data_write_fail"

    def _attempt():
        if chaos.fires(site):
            raise chaos.ChaosError(
                f"injected shard open failure at {path} (site {site})")
        return open(path, mode)
    return default_io_policy().call(_attempt)


def _field_bytes(dtype: str, shape: Tuple[int, ...]) -> int:
    return int(np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64)))


def record_bytes(spec: Spec) -> int:
    return sum(_field_bytes(d, s) for _, d, s in spec)


def pack_records(spec: Spec, arrays: Dict[str, np.ndarray]) -> bytes:
    """Pack {name: [N, *shape] array} into N contiguous records."""
    n = len(next(iter(arrays.values())))
    parts = []
    for name, dtype, shape in spec:
        a = np.ascontiguousarray(arrays[name], dtype=np.dtype(dtype))
        if a.shape != (n, *shape):
            raise ValueError(
                f"field {name}: expected {(n, *shape)}, got {a.shape}")
        parts.append(a.reshape(n, -1).view(np.uint8).reshape(n, -1))
    return np.concatenate(parts, axis=1).tobytes()


def unpack_records(spec: Spec, buf: np.ndarray,
                   n: int) -> Dict[str, np.ndarray]:
    """Inverse of `pack_records` for a [n * record_bytes] uint8 buffer."""
    rb = record_bytes(spec)
    rows = buf[:n * rb].reshape(n, rb)
    out, off = {}, 0
    for name, dtype, shape in spec:
        fb = _field_bytes(dtype, shape)
        field = rows[:, off:off + fb].copy().view(np.dtype(dtype))
        out[name] = field.reshape(n, *shape)
        off += fb
    return out


def shard_paths(directory: str, prefix: str,
                num_shards: int) -> List[str]:
    """The deterministic shard file names `write_shards` produces —
    lets non-writer ranks construct the list without writing."""
    return [os.path.join(directory,
                         f"{prefix}-{s:05d}-of-{num_shards:05d}.bin")
            for s in range(num_shards)]


def write_shards(directory: str, prefix: str, spec: Spec,
                 arrays: Dict[str, np.ndarray],
                 num_shards: int) -> List[str]:
    """Split rows round-robin into `num_shards` binary shard files.

    Writes atomically (tmp + rename) so a concurrent reader never sees
    a truncated shard. In multi-process runs only one process should
    write (then barrier).
    """
    os.makedirs(directory, exist_ok=True)
    n = len(next(iter(arrays.values())))
    paths = shard_paths(directory, prefix, num_shards)
    for s, path in enumerate(paths):
        idx = np.arange(s, n, num_shards)
        shard = {k: v[idx] for k, v in arrays.items()}
        tmp = path + ".tmp"
        with _open_with_retry(tmp, "wb") as f:
            f.write(pack_records(spec, shard))
        os.replace(tmp, path)
    return paths


class _NativeLoader:
    def __init__(self, lib_path: str, files: Sequence[str], rb: int,
                 batch: int, capacity: int, shuffle: bool, seed: int,
                 rank: int, world: int, drop_remainder: bool):
        lib = ctypes.CDLL(lib_path)
        lib.hvd_dl_open.restype = ctypes.c_void_p
        lib.hvd_dl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int]
        lib.hvd_dl_start_epoch.argtypes = [ctypes.c_void_p,
                                           ctypes.c_uint64]
        try:
            lib.hvd_dl_start_epoch_at.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64]
            self._start_at = lib.hvd_dl_start_epoch_at
        except AttributeError:
            # A library without the resume entry (the build names each
            # library by its source's hash, so only an externally
            # pinned one lacks it): epoch() below fast-forwards on the
            # host instead — batches 0..k-1 are produced and
            # discarded, slow but cursor-correct.
            self._start_at = None
        lib.hvd_dl_next.restype = ctypes.c_int64
        lib.hvd_dl_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8)]
        lib.hvd_dl_num_records.restype = ctypes.c_int64
        lib.hvd_dl_num_records.argtypes = [ctypes.c_void_p]
        lib.hvd_dl_error.restype = ctypes.c_char_p
        lib.hvd_dl_error.argtypes = [ctypes.c_void_p]
        lib.hvd_dl_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        arr = (ctypes.c_char_p * len(files))(
            *[f.encode() for f in files])
        self._h = lib.hvd_dl_open(arr, len(files), rb, batch, capacity,
                                  int(shuffle), seed, rank, world,
                                  int(drop_remainder))
        if not self._h:
            raise ValueError("hvd_dl_open rejected arguments")
        self._rb, self._batch = rb, batch

    def num_records(self) -> int:
        return self._lib.hvd_dl_num_records(self._h)

    def epoch(self, epoch_idx: int, start_record: int = 0):
        skip_batches = 0
        if start_record > 0 and self._start_at is not None:
            self._start_at(self._h, epoch_idx, start_record)
        else:
            # Documented host-side fast-forward (no resume entry): producer
            # runs the whole epoch; the first start_record/batch full
            # batches are drained and discarded here.
            self._lib.hvd_dl_start_epoch(self._h, epoch_idx)
            skip_batches = start_record // self._batch
        buf = np.empty(self._batch * self._rb, np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            n = self._lib.hvd_dl_next(self._h, ptr)
            if n < 0:
                raise RuntimeError(
                    self._lib.hvd_dl_error(self._h).decode())
            if n == 0:
                return
            if skip_batches > 0:
                skip_batches -= 1
                continue
            yield buf, int(n)

    def close(self):
        if self._h:
            self._lib.hvd_dl_close(self._h)
            self._h = None


class _PythonLoader:
    """Same semantics, no prefetch thread — the degraded path."""

    def __init__(self, files, rb, batch, shuffle, seed, rank, world,
                 drop_remainder):
        self._files = [f for i, f in enumerate(files)
                       if i % world == rank]
        self._rb, self._batch = rb, batch
        self._shuffle, self._seed = shuffle, seed
        self._drop = drop_remainder

    def num_records(self) -> int:
        return sum(os.path.getsize(f) // self._rb for f in self._files)

    def epoch(self, epoch_idx: int, start_record: int = 0):
        order = []
        for fi, f in enumerate(self._files):
            n = os.path.getsize(f) // self._rb
            order += [(fi, r) for r in range(n)]
        if self._shuffle:
            # The SAME permutation the native loader computes
            # (splitmix64 keys + stable sort) — exact-resume parity.
            order = [order[i]
                     for i in shuffle_perm(len(order), self._seed,
                                           epoch_idx)]
        if start_record > 0:
            order = order[start_record:]
        buf = np.empty(self._batch * self._rb, np.uint8)
        n_in = 0
        handles = [_open_with_retry(f, "rb") for f in self._files]
        try:
            for fi, ri in order:
                handles[fi].seek(ri * self._rb)
                rec = handles[fi].read(self._rb)
                buf[n_in * self._rb:(n_in + 1) * self._rb] = (
                    np.frombuffer(rec, np.uint8))
                n_in += 1
                if n_in == self._batch:
                    yield buf, n_in
                    n_in = 0
            if n_in and not self._drop:
                yield buf, n_in
        finally:
            for h in handles:
                h.close()

    def close(self):
        pass


class ShardedDataset:
    """Per-rank sharded, prefetched dataset over binary record shards.

    >>> ds = ShardedDataset(paths, spec, batch_size=64, shuffle=True)
    >>> for epoch in range(3):
    ...     for batch in ds.epoch(epoch):   # dict of numpy arrays
    ...         step(state, batch)
    """

    def __init__(self, files: Sequence[str], spec: Spec,
                 batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, capacity: int = 4,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 drop_remainder: bool = False):
        from horovod_tpu_torch.runtime import bootstrap as bs

        if rank is None:
            rank = bs.rank() if bs.is_initialized() else 0
        if world is None:
            world = bs.size() if bs.is_initialized() else 1
        self.spec = list(spec)
        self._rb = record_bytes(spec)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self.seed = seed
        self.rank, self.world = rank, world
        self._files = [str(f) for f in files]
        self._num_files = len(files)
        self._capacity = capacity
        # (epoch, next batch) — advanced as epoch() yields, snapshotted
        # by state(), re-installed by restore().
        self._cursor = (0, 0)
        # Elastic-resize migration: when set, the cursor's epoch is
        # streamed from the rebalanced remainder instead of the impl's
        # file sharding;
        # {"epoch": e, "history": [[world, batches], ...]}.
        self._migration: Optional[Dict] = None
        self._counts: Optional[List[int]] = None
        self.last_rebalance: Optional[Dict] = None
        self._impl = self._build_impl()

    def _build_impl(self):
        from horovod_tpu_torch.runtime.config import config
        impl = None
        if config.use_native:
            try:
                from horovod_tpu_torch.ops import _build
                impl = _NativeLoader(
                    str(_build.build_host("data_loader")), self._files,
                    self._rb, self.batch_size, self._capacity,
                    self.shuffle, self.seed, self.rank, self.world,
                    self.drop_remainder)
            except Exception as e:  # noqa: BLE001 — degrade, loudly
                # Degrading silently would hide real misconfiguration
                # behind a slow single-threaded path.
                import warnings
                warnings.warn(
                    f"native data loader unavailable ({e!r}); falling "
                    f"back to the Python reader. Set "
                    f"HOROVOD_NO_NATIVE=1 to silence.")
                impl = None
        if impl is None:
            impl = _PythonLoader(self._files, self._rb,
                                 self.batch_size, self.shuffle,
                                 self.seed, self.rank, self.world,
                                 self.drop_remainder)
        return impl

    @property
    def native(self) -> bool:
        return isinstance(self._impl, _NativeLoader)

    def num_records(self) -> int:
        """Records owned by this rank — steps_per_epoch numerator
        (reference keras_mnist_advanced.py:113-119)."""
        return self._impl.num_records()

    def steps_per_epoch(self) -> int:
        """Batches `epoch()` yields for THIS rank: includes the final
        partial batch unless drop_remainder. Ranks can differ when
        shards divide unevenly — multi-rank training loops must
        truncate to the minimum across ranks (`global_steps_per_epoch`)
        or the ranks deadlock in the step's collectives."""
        n, b = self.num_records(), self.batch_size
        return n // b if self.drop_remainder else -(-n // b)

    def global_steps_per_epoch(self) -> int:
        """min over ranks of steps_per_epoch — the step count every
        rank can run in lockstep (the allgather-min the advanced
        example previously open-coded). Requires hvd.init()."""
        from horovod_tpu_torch.optim import allgather_object
        return int(min(allgather_object(self.steps_per_epoch())))

    def epoch(self, epoch_idx: int = 0, start_batch: int = 0):
        """Iterate one epoch of batches as {field: array} dicts.

        ``start_batch=k`` restarts mid-epoch: the yielded batches are
        bitwise identical to batches ``k..end`` of the uninterrupted
        ``epoch(epoch_idx)`` stream (the native loader seeks inside
        the producer; the fallback slices the shuffled order). Every
        yield advances the cursor `state()` snapshots, so a checkpoint
        cut after consuming batch j resumes at batch j+1 exactly.

        Under an installed resize migration (`restore(migrate=True)` /
        `rebalance`), the migrated epoch streams this rank's share of
        the rebalanced remainder through the host-side explicit-order
        reader instead of the impl; any other epoch abandons the
        migration and runs the normal file-sharded path under the
        current (rank, world)."""
        epoch_idx, b = int(epoch_idx), int(start_batch)
        if b < 0:
            raise ValueError(f"start_batch must be >= 0, got {b}")
        mig = self._migration
        if mig is not None:
            if epoch_idx == mig["epoch"]:
                self._cursor = (epoch_idx, b)
                yield from self._migrated_epoch(mig, epoch_idx, b)
                return
            self._migration = None
        self._cursor = (epoch_idx, b)
        for buf, n in self._impl.epoch(epoch_idx,
                                       b * self.batch_size):
            b += 1
            self._cursor = (epoch_idx, b)
            yield unpack_records(self.spec, buf, n)
        self._cursor = (epoch_idx + 1, 0)

    # -- elastic resize: the rebalanced remainder ----------------------

    def _file_counts(self) -> List[int]:
        """Per-file record counts in global file order (identical on
        every rank — the shard files are the shared input), cached."""
        if self._counts is None:
            self._counts = [os.path.getsize(f) // self._rb
                            for f in self._files]
        return self._counts

    def _migration_remainder(self, mig: Dict) -> List[Tuple[int, int]]:
        return remainder_after(
            self._file_counts(), [tuple(p) for p in mig["history"]],
            batch_size=self.batch_size, seed=self.seed,
            epoch=int(mig["epoch"]), shuffle=self.shuffle,
            drop_remainder=self.drop_remainder)

    def _migrated_epoch(self, mig: Dict, e: int, start_batch: int):
        """Stream this rank's share of the rebalanced remainder —
        explicit (file, record) reads, so it works identically under
        the native and pure-Python impls (prefetch resumes at the next
        epoch boundary). The final partial batch is yielded even under
        ``drop_remainder``: the remainder math already excluded the
        tail the uninterrupted epoch would have dropped, so every
        record still in the list is owed to the union."""
        rem = mig.get("_rem")
        if rem is None:
            rem = self._migration_remainder(mig)
        mine = rem[self.rank::self.world]
        bsz, rb = self.batch_size, self._rb
        buf = np.empty(bsz * rb, np.uint8)
        handles: Dict[int, object] = {}
        b = start_batch
        try:
            n_in = 0
            for fi, ri in mine[start_batch * bsz:]:
                h = handles.get(fi)
                if h is None:
                    h = handles[fi] = _open_with_retry(
                        self._files[fi], "rb")
                h.seek(ri * rb)
                buf[n_in * rb:(n_in + 1) * rb] = np.frombuffer(
                    h.read(rb), np.uint8)
                n_in += 1
                if n_in == bsz:
                    b += 1
                    self._cursor = (e, b)
                    yield unpack_records(self.spec, buf, n_in)
                    n_in = 0
            if n_in:
                b += 1
                self._cursor = (e, b)
                yield unpack_records(self.spec, buf, n_in)
        finally:
            for h in handles.values():
                h.close()
        self._migration = None
        self._cursor = (e + 1, 0)

    @property
    def migration(self) -> Optional[Dict]:
        """The active resize migration ({"epoch", "history"}) or None
        — read-only evidence for tests and the membership harness
        (the internal cached remainder is not part of the view)."""
        if not self._migration:
            return None
        return {k: v for k, v in self._migration.items()
                if not k.startswith("_")}

    def rebalance(self, new_rank: int, new_world: int) -> Dict:
        """Remap the LIVE stream onto a resized world, in place.

        Rebuilds the loader impl under ``(new_rank, new_world)`` and
        migrates the current cursor (`restore(state, migrate=True)`
        semantics): the untrained remainder of the in-progress epoch
        is repartitioned round-robin so the union over all new ranks
        is exactly the records no old rank had consumed. Returns the
        rebalance report (also kept as `last_rebalance`)."""
        new_rank, new_world = int(new_rank), int(new_world)
        if not 0 <= new_rank < new_world:
            raise ValueError(
                f"rebalance: rank {new_rank} outside world "
                f"{new_world}")
        st = self.state()
        self._impl.close()
        self.rank, self.world = new_rank, new_world
        self._impl = self._build_impl()
        self.restore(st, migrate=True)
        return dict(self.last_rebalance or {})

    # -- the checkpointable cursor ------------------------------------

    @property
    def cursor(self) -> Tuple[int, int]:
        """(epoch_idx, next_batch): where the NEXT batch would come
        from — feed it to ``epoch(e, start_batch=b)`` after a restart."""
        return self._cursor

    def state(self) -> Dict:
        """JSON-able snapshot of the data-pipeline position plus the
        identity fields that make the position meaningful (a cursor
        into a differently-seeded or differently-batched stream would
        silently yield the wrong records — `restore` refuses it)."""
        e, b = self._cursor
        out = {
            "schema": DATA_STATE_SCHEMA,
            "epoch": e, "next_batch": b,
            "seed": int(self.seed), "shuffle": bool(self.shuffle),
            "batch_size": int(self.batch_size),
            "drop_remainder": bool(self.drop_remainder),
            "rank": int(self.rank), "world": int(self.world),
            "num_files": int(self._num_files),
            "record_bytes": int(self._rb),
        }
        if self._migration is not None:
            out["migration"] = {
                "epoch": int(self._migration["epoch"]),
                "history": [[int(w), int(n)] for w, n
                            in self._migration["history"]],
            }
        return out

    @staticmethod
    def _check_migration(mig, epoch: int) -> Dict:
        """Validate a snapshot's migration leg (shape + epoch match);
        returns the normalized dict or raises `DataStateError`."""
        try:
            e = int(mig["epoch"])
            hist = [[int(w), int(n)] for w, n in mig["history"]]
        except (TypeError, ValueError, KeyError) as exc:
            raise DataStateError(
                f"malformed migration leg in data state: {exc!r}"
            ) from None
        if e != epoch:
            raise DataStateError(
                f"migration epoch {e} != cursor epoch {epoch}")
        if not hist or any(w <= 0 or n < 0 for w, n in hist):
            raise DataStateError(
                f"migration history out of range: {hist!r}")
        return {"epoch": e, "history": hist}

    def restore(self, state: Dict, *,
                migrate: bool = False) -> "ShardedDataset":
        """Re-install a `state()` snapshot onto this (fresh) dataset.

        Raises `DataStateError` naming every mismatched identity field
        (expected = this dataset, got = the snapshot) — resume logic
        treats that as a corrupt/incompatible cursor and falls back to
        the epoch boundary rather than serving a stream the snapshot
        does not describe.

        ``migrate=True`` makes the cursor world-portable (elastic
        resize): a snapshot
        from a different ``world`` extends the migration history and
        rebalances the epoch's untrained remainder across the current
        world; a bare ``rank`` relabel under the same world adopts the
        cursor as-is (streams are slot-indexed — whoever occupies rank
        k continues rank k's suffix). Every other identity mismatch
        still raises: a resize changes who reads what, never what the
        records are."""
        if not isinstance(state, dict):
            raise DataStateError(
                f"data state must be a dict, got {type(state).__name__}")
        if state.get("schema") != DATA_STATE_SCHEMA:
            raise DataStateError(
                f"data state schema {state.get('schema')!r} != "
                f"supported {DATA_STATE_SCHEMA}")
        mine = self.state()
        core = ("seed", "shuffle", "batch_size", "drop_remainder",
                "num_files", "record_bytes")
        world_keys = ("world", "rank")
        mismatched = [
            f"{k}: expected {mine[k]!r} (this dataset), got "
            f"{state.get(k)!r} (snapshot)"
            for k in core if state.get(k) != mine[k]]
        world_moved = [k for k in world_keys
                       if state.get(k) != mine[k]]
        if mismatched or (world_moved and not migrate):
            core_ok = not mismatched
            mismatched += [
                f"{k}: expected {mine[k]!r} (this dataset), got "
                f"{state.get(k)!r} (snapshot)"
                for k in world_moved]
            hint = ""
            if world_moved and core_ok:
                hint = (" — a cursor from a resized world needs "
                        "migration: restore(state, migrate=True) or "
                        "ShardedDataset.rebalance()")
            raise DataStateError(
                "data state incompatible with this dataset — "
                + "; ".join(mismatched) + hint)
        e, b = int(state["epoch"]), int(state["next_batch"])
        if e < 0 or b < 0:
            raise DataStateError(
                f"data state cursor out of range: epoch={e} batch={b}")
        self.last_rebalance = None
        mig = state.get("migration")
        try:
            old_world = int(state["world"])
        except (TypeError, ValueError, KeyError):
            raise DataStateError(
                f"data state world not an int: "
                f"{state.get('world')!r}") from None
        if old_world == self.world:
            # Same world: identical stream addressing (rank relabels
            # included — see docstring); adopt cursor and any active
            # migration verbatim.
            self._migration = (self._check_migration(mig, e)
                               if mig else None)
            self._cursor = (e, b)
            return self
        # World changed: extend the history with the snapshot's live
        # tail and rebalance the remainder over the current world.
        if old_world <= 0:
            raise DataStateError(
                f"data state world out of range: {old_world}")
        history = list((self._check_migration(mig, e)["history"]
                        if mig else []))
        history.append([old_world, b])
        new_mig = {"epoch": e, "history": history}
        # Computed ONCE: the shuffle-permutation replay behind the
        # remainder is O(total records · log) — the cached list also
        # feeds the migrated epoch's reader (`_rem` is in-memory
        # only; state() serializes epoch/history and a restored
        # cursor recomputes lazily).
        rem = self._migration_remainder(new_mig)
        if b == 0 and len(history) == 1:
            # Nothing of the epoch consumed yet: restart it cleanly
            # under the new world's normal file sharding (fast path —
            # native prefetch, no explicit-order reader).
            self._migration = None
        else:
            self._migration = dict(new_mig, _rem=rem)
        self._cursor = (e, 0)
        self.last_rebalance = {
            "epoch": e,
            "from_batch": b,
            "old_world": old_world,
            "new_world": int(self.world),
            "history": [list(p) for p in history],
            "records_reassigned": len(rem),
            "assigned": len(rem[self.rank::self.world]),
        }
        return self

    def close(self):
        self._impl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# LM token packing (text pipeline on top of the binary shard loader).
# ---------------------------------------------------------------------------

def pack_tokens(documents: Sequence[Sequence[int]], seq_len: int, *,
                eos_id: Optional[int] = None,
                dtype: str = "int32") -> np.ndarray:
    """Pack token documents into fixed [N, seq_len] training rows.

    The standard LM packing recipe: documents are concatenated into one
    stream (each terminated by ``eos_id`` when given, so the model can
    learn document boundaries) and sliced into full-length rows; the
    tail remainder that doesn't fill a row is dropped. No padding, no
    attention-mask bookkeeping — every position is a real token, which
    keeps the card busy on actual work.
    """
    if seq_len <= 0:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    parts = []
    for doc in documents:
        parts.append(np.asarray(doc, dtype=np.dtype(dtype)))
        if eos_id is not None:
            parts.append(np.asarray([eos_id], dtype=np.dtype(dtype)))
    stream = (np.concatenate(parts)
              if parts else np.zeros((0,), np.dtype(dtype)))
    n = len(stream) // seq_len
    return stream[:n * seq_len].reshape(n, seq_len)


def lm_spec(seq_len: int, dtype: str = "int32") -> Spec:
    """Record spec for packed LM rows (`ShardedDataset` field name is
    ``tokens``; batches feed `make_lm_train_step` directly)."""
    return [("tokens", dtype, (seq_len,))]


def write_token_shards(directory: str, prefix: str,
                       documents: Sequence[Sequence[int]],
                       seq_len: int, num_shards: int, *,
                       eos_id: Optional[int] = None,
                       dtype: str = "int32") -> List[str]:
    """`pack_tokens` + `write_shards` in one call; returns shard paths.

    Load with ``ShardedDataset(paths, lm_spec(seq_len), batch)`` —
    per-rank shard ownership and native prefetching included.
    """
    rows = pack_tokens(documents, seq_len, eos_id=eos_id, dtype=dtype)
    if len(rows) == 0:
        raise ValueError(
            f"no full rows packed: corpus has fewer than "
            f"seq_len={seq_len} tokens")
    return write_shards(directory, prefix, lm_spec(seq_len, dtype),
                        {"tokens": rows}, num_shards)
