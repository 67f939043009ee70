"""Stall detection.

Parity with the reference's `CheckForStalledTensors`
(`horovod/tensorflow/mpi_ops.cc:1150-1193`, invoked every 60 s from the
background loop at `:1446-1451`, threshold `STALL_WARNING_TIME = 60 s`,
`:228`): warn — don't kill — when a collective has been pending longer
than the threshold, naming the op. In the reference a stall means some
ranks never submitted a tensor (deadlock across ranks); in the TPU build
it means a dispatched collective (or a multi-controller rendezvous) has
not completed — e.g. a peer process died, which on TPU pods otherwise
surfaces only as a hang.
"""

from __future__ import annotations

import sys
import threading
import time

from horovod_tpu_torch.analysis import lockcheck


class StallMonitor:
    def __init__(self, warning_time_s: float = 60.0,
                 check_every_s: float = 10.0, native=None):
        # State the (idempotent) stop() touches is defined FIRST: a
        # partially-constructed monitor whose stop() is called from a
        # finally block must not AttributeError (the stop-before-start
        # race).
        self._thread = None
        self._stop = threading.Event()
        self._stopped = False
        self._lock = lockcheck.register(
            "StallMonitor._lock", threading.Lock())
        # Delegate to the C++ detector (control_plane.cc) when loaded;
        # it runs its own sweep thread.
        self._native = None
        if native is not None:
            try:
                native.stall_configure(warning_time_s, check_every_s)
                native.stall_start_thread()
                self._native = native
            # hvd: disable=HVD006(the C++ control plane is optional — ANY fault probing it degrades to the Python sweep, never fails init)
            except Exception:
                self._native = None
        self._warning_time = warning_time_s
        self._check_every = check_every_s
        self._pending = {}   # name -> start timestamp
        self._warned = set()
        if self._native is None:
            self._thread = threading.Thread(
                target=self._loop, name="hvd-stall-monitor", daemon=True)
            self._thread.start()

    def begin(self, name: str):
        if self._native is not None:
            self._native.stall_begin(name)
            return
        with self._lock:
            self._pending[name] = time.time()

    def end(self, name: str):
        if self._native is not None:
            self._native.stall_end(name)
            return
        with self._lock:
            self._pending.pop(name, None)
            self._warned.discard(name)

    def check_once(self, now=None):
        """One stall sweep; returns newly-stalled op names (warn-once,
        like the reference). `now` overrides the clock for tests and is
        honored only by the pure-Python backend; on the native backend
        the C++ sweep thread may consume a stall first — programmatic
        polling should use a large `check_every_s` (as the tests do) or
        the Python backend.
        """
        if self._native is not None:
            return self._record_stalls(self._native.stall_check())
        now = now if now is not None else time.time()
        stalled = []
        with self._lock:
            for name, t0 in self._pending.items():
                if now - t0 > self._warning_time and name not in self._warned:
                    stalled.append(name)
                    self._warned.add(name)
        self._record_stalls(stalled)
        if stalled:
            # Message shape follows mpi_ops.cc:1166-1186.
            sys.stderr.write(
                "WARNING: One or more tensors were submitted to be reduced, "
                "gathered or broadcasted by subset of ranks and are waiting "
                "for remainder of ranks for more than %d seconds. This may "
                "indicate that different ranks are trying to submit "
                "different tensors or that only subset of ranks is "
                "submitting tensors, which will cause deadlock.\n"
                "Stalled ops: %s\n" % (int(self._warning_time),
                                       ", ".join(stalled)))
        return stalled

    def _record_stalls(self, stalled):
        """Beyond the stderr warning, each newly-stalled op now lands
        in the observability plane (docs/observability.md): the
        ``hvd_resilience_stalls_total`` counter and one structured
        event per op — a stall is exactly the discrete incident
        signal the event log exists for.

        Coverage caveat: with the NATIVE control plane loaded the C++
        sweep thread owns the periodic check and warns on stderr
        directly — it never passes through here, so on that backend
        only programmatic `check_once()` polls reach the counter/
        event log (the pure-Python sweep, the in-process default,
        records everything). Routing the C++ sweep through the plane
        needs a native->Python callback; out of scope here."""
        if stalled:
            from horovod_tpu_torch.obs import catalog as _obs_catalog
            from horovod_tpu_torch.obs import events as _events
            from horovod_tpu_torch.obs import flightrec as _flightrec
            from horovod_tpu_torch.obs import straggler as _straggler
            _obs_catalog.resilience_metrics()["stalls"].inc(
                len(stalled))
            # The straggler link (obs/straggler.py): a stall warning
            # arrives with the newest cross-rank attribution attached.
            rep = _straggler.last_report()
            extra = ({"straggler": rep} if rep else {})
            for name in stalled:
                _events.emit(
                    "stall", op=name,
                    threshold_s=self._warning_time, **extra)
            # A stall trip is a flight-recorder trigger (no-op unless
            # HVD_FLIGHT_DIR is set): the bundle captures the pending
            # ops, the in-flight requests and the metric state the
            # post-mortem needs.
            _flightrec.trigger("stall", ops=list(stalled),
                               threshold_s=self._warning_time)
        return stalled

    def _loop(self):
        while not self._stop.wait(self._check_every):
            self.check_once()

    def stop(self, timeout: float = 5.0):
        """Stop the sweep and JOIN its thread so no warning can land
        after stop() returns (engines stop their monitor at shutdown
        and then tear down the state the sweep reads). Idempotent:
        double-stop and stop-before-start are both no-op-safe — the
        flag is claimed under the lock, so concurrent stops perform
        the native stop / join exactly once."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        if self._native is not None:
            self._native.stall_stop_thread()
            return
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
