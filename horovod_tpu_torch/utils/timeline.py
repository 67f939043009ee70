"""Horovod Timeline: a Chrome-trace (chrome://tracing) profile of the
host-side schedule.

Counterpart of `horovod_tpu.utils.timeline` (`:33-281`), the JAX
package's Python writer, with the same format: every tensor (or
request) is a trace *process* (pid = its interned index, announced by
a ``process_name`` metadata event); events are ``B``/``E`` duration
pairs and ``X`` instants; a per-tensor state machine {UNKNOWN,
NEGOTIATING, TOP_LEVEL, ACTIVITY} guards the transitions; events are
appended to the file on a 1 s cadence. ``HOROVOD_TIMELINE=/path.json``
opens it at `runtime.bootstrap.init`; `start_timeline` /
`stop_timeline` do so by hand.

The JAX package's C++ writer (`native/control_plane.cc`) is not
ported: this Python writer is that package's own default, and the port
has no native control plane. Device-side time belongs to
`torch.profiler`; this timeline shows what the host can see: eager
collectives (negotiation, then the collective), train-step brackets and
serving requests.
"""

from __future__ import annotations

import functools
import json
import sys
import threading
import time
from typing import Optional

UNKNOWN, NEGOTIATING, TOP_LEVEL, ACTIVITY = range(4)

FLUSH_INTERVAL_S = 1.0


class Timeline:
    """One trace file. Every method is thread-safe; after `close` (or
    an I/O failure, which warns once) every call is a no-op."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        self._pids = {}           # tensor name -> pid
        self._states = {}         # tensor name -> state
        self._events = []
        self._last_flush = time.time()
        self._start = time.time()
        self._closed = False
        try:
            # Truncate/create the file with the JSON array opener.
            with open(self._path, "w") as f:
                f.write("[\n")
        except OSError as e:
            # Warn and disable: an unwritable timeline costs the trace,
            # never the training run.
            sys.stderr.write(
                f"WARNING: Error opening the Horovod Timeline file "
                f"{self._path!r}, will not write a timeline: {e}\n")
            self._closed = True

    def _ts_us(self) -> int:
        return int((time.time() - self._start) * 1e6)

    def _pid(self, name: str) -> int:
        pid = self._pids.get(name)
        if pid is None:
            pid = len(self._pids)
            self._pids[name] = pid
            self._events.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": name},
            })
        return pid

    def _emit(self, ph: str, name: str, pid: int, **kw):
        ev = {"ph": ph, "name": name, "pid": pid, "ts": self._ts_us()}
        ev.update(kw)
        self._events.append(ev)

    def record(self, tensor: str, phase: str,
               activity: Optional[str] = None):
        """Record a phase transition for ``tensor``: ``phase`` is
        NEGOTIATING, TOP_LEVEL or DONE; ``activity`` opens a nested
        activity span (ALLREDUCE, ALLGATHER, BCAST, ALLTOALL,
        REDUCESCATTER, DISPATCH, ...)."""
        with self._lock:
            if self._closed:
                return
            pid = self._pid(tensor)
            state = self._states.get(tensor, UNKNOWN)
            if phase == "NEGOTIATING":
                self._emit("B", "NEGOTIATE", pid)
                self._states[tensor] = NEGOTIATING
            elif phase == "TOP_LEVEL":
                if state == NEGOTIATING:
                    self._emit("E", "NEGOTIATE", pid)
                self._emit("B", tensor, pid)
                self._states[tensor] = TOP_LEVEL
                if activity:
                    self._emit("B", activity, pid)
                    self._states[tensor] = ACTIVITY
            elif phase == "DONE":
                if state == ACTIVITY:
                    self._emit("E", "", pid)
                if state in (TOP_LEVEL, ACTIVITY):
                    self._emit("E", tensor, pid)
                elif state == NEGOTIATING:
                    self._emit("E", "NEGOTIATE", pid)
                self._states[tensor] = UNKNOWN
            self._maybe_flush()

    def begin_span(self, process: str, name: str,
                   args: Optional[dict] = None):
        """Open a named ``B`` span on ``process`` (interned as its own
        trace pid): the serving scheduler's request vocabulary (QUEUE,
        PREFILL, DECODE), with the request's ``trace_id`` in ``args``.
        Spans pair by name through `end_span` and nest freely."""
        with self._lock:
            if self._closed:
                return
            if args:
                self._emit("B", name, self._pid(process), args=args)
            else:
                self._emit("B", name, self._pid(process))
            self._maybe_flush()

    def end_span(self, process: str, name: str):
        """Close the matching `begin_span`."""
        with self._lock:
            if self._closed:
                return
            self._emit("E", name, self._pid(process))
            self._maybe_flush()

    def mark(self, tensor: str, name: str):
        """An instant event (``X`` with zero duration)."""
        with self._lock:
            if self._closed:
                return
            self._emit("X", name, self._pid(tensor), dur=0)
            self._maybe_flush()

    def _maybe_flush(self):
        if time.time() - self._last_flush >= FLUSH_INTERVAL_S:
            self._flush_locked()

    def _flush_locked(self):
        if not self._events:
            return
        try:
            with open(self._path, "a") as f:
                for ev in self._events:
                    f.write(json.dumps(ev) + ",\n")
        except OSError as e:
            # A mid-run I/O failure (disk full, file removed) costs the
            # trace, never the step or request that triggered the flush.
            sys.stderr.write(
                f"WARNING: Error writing the Horovod Timeline file "
                f"{self._path!r}, disabling the timeline: {e}\n")
            self._closed = True
        self._events = []
        self._last_flush = time.time()

    def close(self):
        """Flush and terminate the JSON array (``{}]``, so strict
        parsers read the file); idempotent."""
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            try:
                with open(self._path, "a") as f:
                    f.write("{}]\n")
            except OSError:
                pass  # the flush already warned
            self._closed = True


def start_timeline(path: str) -> Timeline:
    """Start (or restart, closing the previous file) the process's
    timeline at ``path``; ``HOROVOD_TIMELINE`` does the same at
    `init`."""
    from horovod_tpu_torch.runtime import state as _state
    st = _state.check_initialized()
    if st.timeline is not None:
        st.timeline.close()
    st.timeline = Timeline(path)
    return st.timeline


def stop_timeline() -> None:
    """Close the process's timeline, if one is open."""
    from horovod_tpu_torch.runtime import state as _state
    st = _state.check_initialized()
    if st.timeline is not None:
        st.timeline.close()
        st.timeline = None


def step_bracket(fn, name: str = "train_step"):
    """Wrap a train step so every call records a ``name`` span with a
    DISPATCH activity on the timeline: the step cadence, the gaps
    between steps (input stalls) and how eager collectives interleave
    with it. One attribute read when no timeline is open. The bracket
    times the host's dispatch; the card may still be running the step
    when it closes."""
    from horovod_tpu_torch.runtime import state as _state

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tl = _state.global_state().timeline
        if tl is None:
            return fn(*args, **kwargs)
        tl.record(name, "TOP_LEVEL", "DISPATCH")
        try:
            return fn(*args, **kwargs)
        finally:
            tl.record(name, "DONE")

    return wrapper
