"""Checkpoint / resume with the reference's consistency contract.

Counterpart of `horovod_tpu.utils.checkpoint`. The reference delegates
serialization to TF and imposes two rules (SURVEY §5.4): (a) only rank
0 writes, so concurrent workers cannot corrupt the checkpoint
(`README.md:79-81`, `examples/tensorflow_mnist.py:102`); (b) on
start/restore, rank-0 state is broadcast so every worker resumes from
identical weights (`horovod/tensorflow/__init__.py:93-124`).

This module keeps both rules. The state is a nested dict / list / tuple
of tensors (``{"model": model.state_dict(), "opt":
optimizer.state_dict(), "step": 7}``), numpy arrays and Python scalars.
A checkpoint is a directory holding ``state.pt`` (written by
`torch.save` from host copies of the tensors, read back by
``torch.load(weights_only=True)``; numpy leaves travel as tensors and
come back as numpy) and a ``_CHECKPOINT_METADATA`` marker written after
it — the marker name of the JAX package's Orbax trees, so a committed
step reads the same to the retention rule. Every write goes to a hidden
staging directory that is renamed into place once complete, so
discovery never sees half a checkpoint. `save()` is a no-op off rank 0;
`restore()` broadcasts the loaded tree from rank 0 when asked. The
reference's multi-host sharded mode (``distributed=True``, every host
writing its own shards) has no counterpart yet (ROADMAP Queue A 5).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience.retry import RetryPolicy, default_io_policy

STATE_FILE = "state.pt"
COMMIT_MARKER = "_CHECKPOINT_METADATA"
_NUMPY = "__hvd_numpy__"


class CheckpointError(RuntimeError):
    """Base class for checkpoint load/store failures."""


class CheckpointNotFoundError(CheckpointError):
    """`restore()` was pointed at a path with no checkpoint directory."""


class CheckpointCorruptError(CheckpointError):
    """The checkpoint directory exists but cannot be read back — a
    partial write (the process died mid-save), filesystem damage, or a
    template mismatch. The original error is chained."""


# -- the tree on disk --------------------------------------------------------

def _to_host(x: Any, copy: bool) -> Any:
    """The tree as `torch.save` writes it: tensors on the host (cloned
    when ``copy``: an async save must not see later in-place updates),
    numpy leaves wrapped as ``{_NUMPY: tensor}`` so that the
    ``weights_only`` loader reads them and they come back as numpy."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            return t.to("cpu")
        return t.clone() if copy else t
    if isinstance(x, (np.ndarray, np.generic)):
        return {_NUMPY: torch.from_numpy(np.array(x)),
                "scalar": isinstance(x, np.generic)}
    if isinstance(x, dict):
        return type(x)((k, _to_host(v, copy)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v, copy) for v in x)
    return x


def _from_disk(x: Any) -> Any:
    """Inverse of `_to_host`'s numpy wrapping."""
    if isinstance(x, dict):
        if _NUMPY in x:
            a = x[_NUMPY].numpy()
            return a[()] if x.get("scalar") else a
        return type(x)((k, _from_disk(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_from_disk(v) for v in x)
    return x


def _conform(x: Any, like: Any, where: str = "") -> Any:
    """``x`` in the structure, types, dtypes and devices of the template
    ``like`` (the reference's Orbax ``restore_args``); raises ValueError
    naming the first leaf that does not fit. An empty dict in the
    template takes the saved dict as it is: a fresh torch optimizer's
    ``state_dict()["state"]`` is empty until its first step (its
    ``load_state_dict`` places the moments by their parameters)."""
    if isinstance(like, dict) and not like and isinstance(x, dict):
        return x
    if isinstance(like, dict):
        if not isinstance(x, dict) or set(x) != set(like):
            got = (sorted(map(str, x)) if isinstance(x, dict)
                   else type(x).__name__)
            raise ValueError(f"template mismatch at {where or '/'}: keys "
                             f"{got} vs {sorted(map(str, like))}")
        return type(like)((k, _conform(x[k], v, f"{where}/{k}"))
                          for k, v in like.items())
    if isinstance(like, (list, tuple)):
        if not isinstance(x, (list, tuple)) or len(x) != len(like):
            raise ValueError(f"template mismatch at {where or '/'}: "
                             f"sequence of {len(like)} expected")
        return type(like)(_conform(a, b, f"{where}/{i}")
                          for i, (a, b) in enumerate(zip(x, like)))
    if isinstance(like, torch.Tensor):
        t = torch.as_tensor(x)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"template mismatch at {where}: shape "
                             f"{tuple(t.shape)} vs {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=like.dtype)
        if a.shape != np.shape(like):
            raise ValueError(f"template mismatch at {where}: shape "
                             f"{a.shape} vs {np.shape(like)}")
        return a[()] if isinstance(like, np.generic) else a
    if isinstance(like, (bool, int, float)) and not isinstance(
            x, (dict, list, tuple)):
        return type(like)(x.item() if isinstance(x, torch.Tensor) else x)
    return x


def _rank0() -> bool:
    from horovod_tpu_torch.runtime import bootstrap as bs
    return not bs.is_initialized() or bs.rank() == 0


def _write_tree(path: str, tree: Any, force: bool) -> None:
    """Write ``tree`` (already on the host) as the checkpoint directory
    ``path``: into a hidden staging sibling first, renamed into place
    when the state and then the commit marker are on disk."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise CheckpointError(f"checkpoint {path} exists (force=False)")
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}-"
                               f"{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            json.dump({"format": "torch.save", "file": STATE_FILE}, f)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# -- async saves -------------------------------------------------------------

class _Pending:
    """The one in-flight async save: its writer thread and the error it
    ended with (re-raised at the next fence)."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.registered = False


_pending = _Pending()


def wait_pending() -> None:
    """Block until any in-flight async save commits (no-op otherwise).

    STRICT fence: a failed background write (ENOSPC, permissions)
    re-raises here — this is the user's success signal for the last
    save, so it must not report success silently. Call it from normal
    program flow (end of training, before reading the directory);
    atexit uses the swallowing variant."""
    th = _pending.thread
    if th is not None:
        th.join()
        _pending.thread = None
    err, _pending.error = _pending.error, None
    if err is not None:
        raise err


def _fence_swallowing() -> None:
    """`wait_pending` for teardown paths: never raises."""
    try:
        wait_pending()
    except Exception as e:  # noqa: BLE001 — shutdown must proceed
        print(f"horovod_tpu_torch: async checkpoint fence failed ({e!r}); "
              f"the last save may not have committed — call "
              f"wait_pending() before exiting to surface this",
              file=sys.stderr)


def save(path: str, state: Any, *, force: bool = True,
         distributed: bool = False, block: bool = True,
         retry: Optional[RetryPolicy] = None) -> bool:
    """Write ``state`` (a nested dict / list / tuple of tensors, numpy
    arrays and scalars) to the checkpoint directory ``path``.

    Rank-0-only: returns True if this process wrote (or started
    writing). ``block=False``: async save — the tensors are copied to
    host memory now and written on a background thread, so the train
    loop keeps stepping; at most one save is in flight (a new one first
    fences the previous), `wait_pending()` (also registered atexit)
    fences explicitly.

    Transient write failures (`OSError`, injected `ChaosError`s at the
    ``ckpt_write_fail`` site) are retried with exponential backoff
    under ``retry`` — default `default_io_policy()` (3 attempts,
    ``HVD_IO_RETRIES`` overrides); all attempts exhausted raises
    `resilience.retry.RetryError`. With ``block=False`` the policy
    covers the scheduling of the save (the fence of the previous one
    included); a failure of the background write itself surfaces at
    the next fence. ``distributed=True`` (every host writing its own
    shards) raises `NotImplementedError`: ROADMAP Queue A 5."""
    if distributed:
        raise NotImplementedError(
            "distributed (multi-host sharded) checkpoints are a later "
            "slice of the PyTorch port (ROADMAP Queue A 5, multi-GPU "
            "parallelism); rank 0 writes the whole state meanwhile")
    if not _rank0():
        return False
    policy = retry if retry is not None else default_io_policy()
    if not block:
        # Fence the PREVIOUS async save OUTSIDE the retry: a failure
        # re-raised here belongs to that save and must propagate.
        wait_pending()
        tree = _to_host(state, copy=True)

        def _schedule():
            if chaos.fires("ckpt_write_fail"):
                raise chaos.ChaosError(
                    f"injected checkpoint write failure at {path} "
                    f"(site ckpt_write_fail)")

            def _run():
                try:
                    _write_tree(path, tree, force)
                except BaseException as e:  # noqa: BLE001 — re-raised at the fence
                    _pending.error = e

            _pending.thread = threading.Thread(
                target=_run, name="hvd-ckpt-async", daemon=True)
            _pending.thread.start()
        policy.call(_schedule)
        if not _pending.registered:
            import atexit
            atexit.register(_fence_swallowing)
            _pending.registered = True
        return True
    # The sync path also fences any in-flight async save: an async
    # write committing AFTER a sync write to the same path would
    # silently replace the newer data with the stale save.
    wait_pending()
    tree = _to_host(state, copy=False)

    def _write():
        if chaos.fires("ckpt_write_fail"):
            raise chaos.ChaosError(
                f"injected checkpoint write failure at {path} "
                f"(site ckpt_write_fail)")
        _write_tree(path, tree, force)
    policy.call(_write)
    return True


def restore(path: str, *, like: Optional[Any] = None,
            broadcast: bool = False) -> Any:
    """Load the tree at ``path`` (tensors on the host; numpy leaves as
    numpy).

    ``like``: optional template tree — restored leaves adopt its
    structure, types, dtypes and devices (a template that does not fit
    is a `CheckpointCorruptError`). ``broadcast=True`` re-asserts the
    reference's resume contract by broadcasting the loaded tree from
    rank 0 (every rank then holds rank 0's state).

    Failure surface: a missing directory raises
    `CheckpointNotFoundError`; a directory that exists but cannot be
    read back (partial write, corruption, template mismatch) raises
    `CheckpointCorruptError` with the path named and the underlying
    error chained. `restore_latest` catches both and falls back to the
    previous step."""
    apath = os.path.abspath(path)
    if not os.path.isdir(apath):
        raise CheckpointNotFoundError(
            f"no checkpoint directory at {apath}")
    try:
        restored = _from_disk(torch.load(os.path.join(apath, STATE_FILE),
                                         map_location="cpu",
                                         weights_only=True))
        if like is not None:
            _conform(restored, like)       # validate before any collective
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint at {apath} is unreadable — partial write, "
            f"corruption, or a template mismatch ({e!r})") from e
    if broadcast:
        restored = _broadcast_host_tree(restored)
    return restored if like is None else _conform(restored, like)


def _broadcast_host_tree(tree: Any) -> Any:
    """Rank 0's host tree on every rank (one object broadcast; the
    tensors stay on the host, each rank places them by its template)."""
    from horovod_tpu_torch.optim import broadcast_object
    return broadcast_object(tree, 0)


# -- step directories --------------------------------------------------------

def _step_entries(directory: str):
    """Sorted [(step, dirname)] for step checkpoint subdirectories
    (`step_00000100`-style or plain ints like `100`)."""
    if not os.path.isdir(directory):
        return []
    entries = []
    for name in os.listdir(directory):
        if not os.path.isdir(os.path.join(directory, name)):
            continue
        if name.isdigit():
            entries.append((int(name), name))
        elif name.startswith("step_") and name[5:].isdigit():
            entries.append((int(name[5:]), name))
    return sorted(entries)


def latest_step(directory: str) -> Optional[int]:
    """Highest step checkpoint under `directory`, or None — the
    resume-discovery helper."""
    entries = _step_entries(directory)
    return entries[-1][0] if entries else None


def _looks_committed(path: str) -> bool:
    """Cheap commit probe for the retention GC: every write ends in an
    atomic directory appearance whose tree carries the commit marker,
    so a discoverable step without it is externally damaged and must
    never count as the restorable entry the GC is obliged to keep."""
    return os.path.isfile(os.path.join(path, COMMIT_MARKER))


def _aux_path(directory: str, name: str) -> str:
    """Sidecar path for a step's auxiliary snapshot JSON (the
    data-pipeline cursor + host RNG + guard state of a TrainSnapshot,
    `resilience/elastic.py`)."""
    return os.path.join(directory, name + ".aux.json")


def _write_aux(directory: str, name: str, aux: Any):
    """Atomically (tmp + rename) write the aux sidecar. Written BEFORE
    the step directory becomes discoverable, so any discoverable step
    saved with aux has its sidecar on disk; a crash in the window
    between sidecar and state commit leaves only a harmless orphan
    that the next save of the same step overwrites (and pruning
    removes)."""
    path = _aux_path(directory, name)
    tmp = path + ".tmp"
    os.makedirs(directory, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(aux, f)
    os.replace(tmp, path)


def load_step_aux(directory: str, step: int
                  ) -> Tuple[Optional[Any], Optional[str]]:
    """Read the aux sidecar saved alongside step `step`.

    Returns ``(aux, None)`` on success, ``(None, reason)`` when the
    sidecar is missing or unreadable — the caller decides how loud the
    degraded path is (`ElasticTrainer.resume` falls back to the epoch
    boundary and emits a `cursor_fallbacks` metric + event)."""
    names = [n for s, n in _step_entries(directory) if s == step]
    if not names:
        return None, f"no step {step} under {directory}"
    path = _aux_path(directory, names[-1])
    if not os.path.isfile(path):
        return None, f"aux sidecar missing: {path}"
    try:
        with open(path) as f:
            return json.load(f), None
    except (OSError, ValueError) as e:
        return None, f"aux sidecar unreadable ({e!r}): {path}"


def save_step(directory: str, step: int, state: Any, *,
              keep: Optional[int] = None, block: bool = True,
              retry: Optional[RetryPolicy] = None,
              aux: Optional[Any] = None) -> bool:
    """`save()` into `directory/step_{step:08d}`, then prune the lowest
    steps down to `keep` entries (rank 0 only). ``keep=None`` reads
    the registered ``HVD_CKPT_KEEP`` knob (default 0 = keep all; the
    GC is opt-in because deleting history is the one thing a
    checkpoint layer must never surprise anyone with). The GC never
    deletes the step just written, nor the newest COMMITTED step —
    the one `restore_latest` would pick right now — so an async save
    still in flight can't leave the directory restorable-empty if the
    process dies before its commit lands. Pruned steps take their aux
    sidecars with them.

    ``aux``: optional JSON-able sidecar (`<step>.aux.json`, read back
    by `load_step_aux`) written atomically BEFORE the step becomes
    discoverable — the TrainSnapshot home for the data-pipeline
    cursor, host RNG, and guard state. Sidecar, not tree leaf: the
    cursor must survive a `like=` template that doesn't mention it,
    and a corrupt cursor must degrade to an epoch-boundary resume
    without poisoning the model restore.

    ``block=False`` saves asynchronously; the step directory appears
    atomically once the background write completes, so pruning only
    ever sees finished steps — which also means the in-flight save
    isn't counted yet and the directory can transiently hold `keep + 1`
    entries until the next call prunes it.

    The sync path is atomic end-to-end: the tree is written into a
    hidden ``.tmp.step_*`` staging directory (invisible to step
    discovery) and renamed into place only after the write fully
    committed — a process killed mid-save (the ``ckpt_kill`` chaos
    site injects exactly that) leaves either the previous checkpoint
    set or the complete new one, never a discoverable half-written
    step."""
    if keep is None:
        from horovod_tpu_torch.runtime.config import env_int
        keep = env_int("HVD_CKPT_KEEP", 0)
    current = f"step_{step:08d}"
    final = os.path.join(directory, current)
    if block:
        tmp = os.path.join(directory, f".tmp.{current}")
        shutil.rmtree(tmp, ignore_errors=True)  # stale staging dir
        wrote = save(tmp, state, block=True, retry=retry)
        if wrote:
            if chaos.fires("ckpt_kill"):
                # Simulated mid-save process death: the staged tree
                # exists, the rename never happens — discovery sees
                # only the previous steps (the crash-restart
                # equivalence harness's kill-during-save scenario).
                raise chaos.ChaosError(
                    f"injected process kill mid-save at {final} "
                    f"(site ckpt_kill)")
            if aux is not None:
                _write_aux(directory, current, aux)
            if os.path.isdir(final):
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
    else:
        wrote = save(final, state, block=False, retry=retry)
        if wrote and aux is not None:
            # Sidecar lands before the background write renames the
            # step into discoverability — same ordering contract as the
            # sync path.
            _write_aux(directory, current, aux)
    if wrote and keep > 0:
        entries = _step_entries(directory)
        protected = {current}
        committed = [n for _, n in entries
                     if _looks_committed(os.path.join(directory, n))]
        if committed:
            protected.add(committed[-1])
        candidates = [n for _, n in entries if n not in protected]
        excess = len(entries) - keep
        for name in candidates[:max(0, excess)]:
            shutil.rmtree(os.path.join(directory, name),
                          ignore_errors=True)
            try:
                os.unlink(_aux_path(directory, name))
            except OSError:
                pass
    return wrote


def restore_latest(directory: str, *, like: Optional[Any] = None,
                   broadcast: bool = False,
                   with_step: bool = False
                   ) -> Union[None, Any, Tuple[Any, int]]:
    """Restore the highest GOOD step under `directory`, or None if
    empty.

    Latest-good discovery: when the newest step directory is a partial
    write or corrupt (`CheckpointCorruptError`), it is skipped with a
    warning and the previous step is tried, newest to oldest. Only
    when *every* step fails does the last `CheckpointCorruptError`
    propagate — silent loss of the whole directory would hide real
    damage.

    ``with_step=True`` returns ``(state, step)`` so resume logic knows
    which step actually loaded (it may not be the highest on disk)."""
    entries = _step_entries(directory)
    if not entries:
        return None
    last_err: Optional[CheckpointError] = None
    restored = None
    found_step = None
    for step, name in reversed(entries):
        try:
            # broadcast deliberately NOT passed through: the per-step
            # read must stay collective-free, because ranks can
            # disagree on WHICH step is corrupt — a collective inside
            # this loop would pair mismatched broadcasts across ranks
            # and hang. Every rank broadcasts exactly once below.
            restored = restore(os.path.join(directory, name),
                               broadcast=False)
            if like is not None:
                _conform(restored, like)
            found_step = step
            break
        except ValueError as e:
            last_err = CheckpointCorruptError(
                f"checkpoint at {os.path.join(directory, name)} does not "
                f"fit the template ({e})")
            sys.stderr.write(
                f"horovod_tpu_torch: skipping bad checkpoint "
                f"{os.path.join(directory, name)} ({last_err}); falling "
                f"back to the previous step\n")
        except CheckpointError as e:
            sys.stderr.write(
                f"horovod_tpu_torch: skipping bad checkpoint "
                f"{os.path.join(directory, name)} ({e}); falling back "
                f"to the previous step\n")
            last_err = e
    if found_step is None:
        raise CheckpointCorruptError(
            f"no restorable checkpoint among {len(entries)} step(s) "
            f"in {directory}; newest failure chained") from last_err
    if broadcast:
        # Rank-0's tree wins even if this rank fell back to an older
        # step than rank 0 did (the returned step is then the LOCAL
        # discovery; the state is rank 0's — the reference's resume
        # contract).
        restored = _broadcast_host_tree(restored)
    if like is not None:
        restored = _conform(restored, like)
    return (restored, found_step) if with_step else restored
