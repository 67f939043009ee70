"""PyTorch port: the multi-process elastic drill
(`resilience/drill.py`) and the shared failure detector under both of
its consumers.

* One drill, run once for the module (``python -m
  horovod_tpu_torch.resilience.drill --world 3 --kill-rank 2``, which
  launches ``python -m horovod_tpu_torch.runner -np 3 --elastic``): three
  worker processes that import only the port meet at the launcher's
  `TCPStore`, worker 2 is SIGKILLed mid-epoch, and every assertion below
  reads that one run — the OK line, one death, one resize to world 2 at
  generation 1, the survivors' agreeing finals, and the union of the
  members' effective record streams: every record once per epoch, the
  expected union computed by the port and by the JAX package alike.
* The JAX package's ``tests/test_detector.py::TestSharedDetectorSingle
  Thread::test_router_plus_membership_one_sweep_thread`` on the port: a
  serving router and two `WorldMonitor`s register with one detector and
  add exactly one sweep thread between them.
"""

import collections
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu.resilience import drill as j_drill
from horovod_tpu_torch.resilience import drill as t_drill
from horovod_tpu_torch.resilience.detector import (install_detector,
                                                   shared_detector)
from horovod_tpu_torch.resilience.membership import (InProcessKV,
                                                     WorldMonitor)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("drill") / "mc")
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.resilience.drill",
         "--workdir", workdir, "--world", "3", "--kill-rank", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    summary = json.loads(next(ln for ln in res.stdout.splitlines()
                              if ln.startswith("{")))
    return dict(rc=res.returncode, out=res.stdout, err=res.stderr,
                summary=summary, workdir=workdir, seconds=time.time() - t0)


def _records(workdir, name):
    return t_drill._read_jsonl(os.path.join(workdir, name))


def test_drill_prints_its_ok_line(drill):
    assert drill["rc"] == 0, drill["out"][-3000:] + drill["err"][-3000:]
    assert "resize equivalence OK (multi-process): 1 SIGKILL(s), 1 " \
           "resize(s) to world 2 (generation 1)" in drill["out"]
    s = drill["summary"]
    assert s["ok"] and s["launcher_rc"] == 0 and s["error"] is None


def test_drill_one_sigkill_one_resize_generation_1(drill):
    deaths = _records(drill["workdir"], "deaths.jsonl")
    resizes = _records(drill["workdir"], "resizes.jsonl")
    assert [d["member"] for d in deaths] == ["rank2"]
    assert [(r["generation"], r["world"], r["kind"], r["died"], r["joined"])
            for r in resizes] == [(1, 2, "shrink", ["rank2"], [])]
    assert resizes[0]["records_reassigned"] > 0      # rolled back MID-epoch
    # the launcher saw a signal death and kept the job going
    assert "died with signal 9; elastic job continues" in (
        drill["out"] + drill["err"])
    s = drill["summary"]
    assert (s["deaths"], s["resizes"], s["final_world"],
            s["final_generation"]) == (1, 1, 2, 1)
    assert 0 < s["detect_s"] < 10.0 and 0 <= s["time_to_resume_s"] < 10.0


def test_drill_survivors_agree(drill):
    fdir = os.path.join(drill["workdir"], "final")
    finals = [json.load(open(os.path.join(fdir, n)))
              for n in sorted(os.listdir(fdir))]
    assert [f["member"] for f in finals] == ["rank0", "rank1"]
    assert len({(f["digest"], f["step"], f["generation"], f["world"])
                for f in finals}) == 1
    assert finals[0]["generation"] == 1 and finals[0]["world"] == 2


def test_drill_union_is_every_record_once_per_epoch(drill):
    """The union of the members' effective streams, rebuilt from the
    workdir (the corpse's log trimmed to the step the survivors rolled
    back to), equals `_expected_union`: every record once per epoch.
    The expected union is the same computed by the JAX package."""
    workdir = drill["workdir"]
    manifest = t_drill._load_manifest(workdir)
    logs = {n[:-len(".jsonl")]: t_drill._read_jsonl(
        os.path.join(workdir, "logs", n))
        for n in os.listdir(os.path.join(workdir, "logs"))
        if n.endswith(".jsonl")}
    for rz in _records(workdir, "resizes.jsonl"):
        for dm in rz["died"]:
            logs[dm] = [e for e in logs[dm]
                        if e["step"] <= rz["committed_step"]]
    union = sorted(k for entries in logs.values() for e in entries
                   for k in e["keys"])
    expected = t_drill._expected_union(manifest)
    assert union == expected
    assert expected == j_drill._expected_union(manifest)
    counts = collections.Counter(union)
    assert len(counts) == manifest["records"]
    assert set(counts.values()) == {manifest["epochs"]}
    assert drill["summary"]["records"] == len(expected)


def test_router_plus_membership_one_sweep_thread():
    """A host running a serving router AND training membership adds
    exactly ONE detector sweep thread for both, and both consumers'
    peers live in that one detector. Sweep threads other tests of this
    process left running are counted out: the check is on the threads
    this test adds, read once their number has settled."""
    from horovod_tpu_torch.serving.router import ServingRouter

    class _MiniEngine:
        """The minimal health/submit surface the router probes."""
        queue_depth = 0
        slo = None

        class pool:
            busy_slots = 0

        def _health(self):
            return {"healthy": True}

        def shutdown(self, *, drain=True, timeout=None):
            pass

    def sweepers():
        return {t for t in threading.enumerate()
                if t.name == "hvd-failure-detector" and t.is_alive()}

    prev = install_detector(None)   # a fresh shared instance
    if prev is not None:
        prev.stop()
    before = sweepers()
    try:
        router = ServingRouter(_MiniEngine, num_replicas=2,
                               health_poll_s=0.02, max_replacements=0)
        mons = [WorldMonitor(f"rank{i}", rank=i, world=2, kv=InProcessKV(),
                             lease_s=0.5, apply_runtime=False).start()
                for i in range(2)]
        try:
            seen, deadline = None, time.monotonic() + 5.0
            while time.monotonic() < deadline:
                time.sleep(0.05)
                now = sweepers() - before
                if now == seen:
                    break
                seen = now
            assert len(seen) == 1, seen
            det = shared_detector()
            assert seen == {det._thread}
            keys = set(det.peers())
            assert any(k.startswith("router/") for k in keys)
            assert any(k.startswith("wm/") for k in keys)
        finally:
            for m in mons:
                m.stop()
            router.shutdown(drain=False)
        # Teardown unregisters every consumer's namespace.
        assert shared_detector().peers() == {}
    finally:
        old = install_detector(prev)
        if old is not None:
            old.stop()
