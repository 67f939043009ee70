"""Runtime lock witness — the dynamic half of HVD007.

``HVD_LOCK_CHECK=1`` arms it: `register(name, lock)` then returns a
recording proxy instead of the raw lock, and every acquisition made
anywhere in the process appends to a per-thread held stack and a
global edge set ``(held, acquired)`` with the first witness (thread
name, file:line of the acquire). Two consistency properties fall out:

* an **inversion** — edge ``(b, a)`` observed when ``(a, b)`` already
  was — is a deadlock the test run actually walked (two threads just
  didn't interleave badly enough this time); the CI leg runs the
  serving + resilience suites armed and fails on any inversion;
* the observed graph must be a **subset** of HVD007's static
  acquisition graph (`lock_order.lock_order_graph`) — a runtime edge
  the static analysis missed is a resolver gap, pinned by a test.

Unarmed (the default), `register` hands back the raw lock object —
zero wrappers, zero overhead, nothing imported beyond this module.
Lock names follow the static convention: ``ClassName.attr`` for
instance locks, ``modstem.GLOBAL`` for module-level locks, so the two
graphs diff key-for-key.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["LockWitness", "register", "enabled", "default_witness"]


def enabled() -> bool:
    from horovod_tpu_torch.runtime.config import env_int
    return env_int("HVD_LOCK_CHECK", 0) != 0


class LockWitness:
    """Acquisition-order recorder. Thread-safe; its own mutex is a
    raw Lock (never registered — the witness must not witness
    itself)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held, acquired) -> first witness "thread @ file:line"
        self.edges: Dict[Tuple[str, str], str] = {}
        self.inversions: List[Dict] = []
        self._inverted_pairs = set()

    def _stack(self) -> List[str]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    @staticmethod
    def _site() -> str:
        # Innermost frame outside this module = the acquire site.
        for frame in reversed(traceback.extract_stack()):
            if os.path.basename(frame.filename) != "lockcheck.py":
                return f"{frame.filename}:{frame.lineno}"
        return "?"

    def acquired(self, name: str):
        stack = self._stack()
        first = name not in stack    # reentrant re-acquire adds no edge
        stack.append(name)
        if not first:
            return
        held = [n for n in dict.fromkeys(stack[:-1]) if n != name]
        if not held:
            return
        witness = f"{threading.current_thread().name} @ {self._site()}"
        with self._mu:
            for h in held:
                key = (h, name)
                if key not in self.edges:
                    self.edges[key] = witness
                inv = (name, h)
                if inv in self.edges:
                    pair = tuple(sorted((h, name)))
                    if pair not in self._inverted_pairs:
                        self._inverted_pairs.add(pair)
                        self.inversions.append({
                            "pair": list(pair),
                            "first": {"order": list(inv),
                                      "witness": self.edges[inv]},
                            "second": {"order": list(key),
                                       "witness": witness},
                        })

    def released(self, name: str):
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def wrap(self, name: str, lock):
        return _LockProxy(self, name, lock)

    def graph(self) -> Dict[str, List[str]]:
        with self._mu:
            out: Dict[str, List[str]] = {}
            for (a, b) in self.edges:
                out.setdefault(a, []).append(b)
        for succs in out.values():
            succs.sort()
        return out

    def snapshot(self) -> Dict:
        graph = self.graph()
        with self._mu:
            return {"edges": graph,
                    "witnesses": {f"{a} -> {b}": w
                                  for (a, b), w in self.edges.items()},
                    "inversions": list(self.inversions)}

    def dump(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.snapshot(), fh, indent=2, sort_keys=True)
            fh.write("\n")


class _LockProxy:
    """Context-manager + acquire/release facade over a real lock; the
    subset of the Lock/RLock API this codebase uses (`with`, and
    `locked()` in assertions)."""

    def __init__(self, witness: LockWitness, name: str, lock):
        self._witness = witness
        self._name = name
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._witness.acquired(self._name)
        return got

    def release(self):
        self._lock.release()
        self._witness.released(self._name)

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockcheck {self._name} {self._lock!r}>"


_DEFAULT: Optional[LockWitness] = None
_DEFAULT_MU = threading.Lock()


def default_witness() -> LockWitness:
    """The process-global witness (created on first armed register)."""
    global _DEFAULT
    with _DEFAULT_MU:
        if _DEFAULT is None:
            _DEFAULT = LockWitness()
            _install_dump_hook()
        return _DEFAULT


def register(name: str, lock):
    """Wrap ``lock`` under the static graph's node ``name`` when
    ``HVD_LOCK_CHECK=1``; hand the raw lock back otherwise. Wrap at
    construction: ``self._lock = lockcheck.register("Cls._lock",
    threading.Lock())`` — hvdlint's lock discovery sees through the
    call."""
    if not enabled():
        return lock
    return default_witness().wrap(name, lock)


def _install_dump_hook():
    """At exit, write the order graph to ``HVD_LOCK_CHECK_OUT`` (the
    CI leg's zero-inversion evidence) and warn on inversions."""
    import atexit

    def _dump():
        w = _DEFAULT
        if w is None:
            return
        from horovod_tpu_torch.runtime.config import env_str
        out = env_str("HVD_LOCK_CHECK_OUT")
        if out:
            try:
                w.dump(out)
            except OSError as e:
                sys.stderr.write(
                    f"lockcheck: cannot write {out!r}: {e}\n")
        for inv in w.inversions:
            sys.stderr.write(
                f"lockcheck: ORDER INVERSION {inv['pair']}: "
                f"{inv['first']['order']} at "
                f"{inv['first']['witness']} vs "
                f"{inv['second']['order']} at "
                f"{inv['second']['witness']}\n")

    atexit.register(_dump)
