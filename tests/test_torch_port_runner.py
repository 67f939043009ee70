"""PyTorch port: the ``hvdrun`` launcher (`horovod_tpu_torch.runner`) on
the CPU, and the package data an installed wheel needs.

Every launch here is ``python -m horovod_tpu_torch.runner ...
--platform cpu`` (gloo), as a user runs it. The collective worker
imports only the port, calls ``hvd.init()`` with no arguments (its
membership, platform and rendezvous store all come from the launcher)
and saves what it saw; its results are held against the JAX package's
collectives under ``jax.shard_map`` over a 2-device mesh. Tolerances:
float32 within 1e-6 (one sum order), integers exact.
"""

import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import tomllib
from fnmatch import fnmatch

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import collectives as C
from horovod_tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parent.parent

# argv: output dir. Everything else comes from the launcher's env.
WORKER = r'''
import os, sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.runtime import state
out = sys.argv[1]
torch.set_num_threads(1)
hvd.init()
st = state.global_state()
kv_port = int(os.environ["HOROVOD_KV"].rsplit(":", 1)[1])
assert st.store is not None and st.store.port == kv_port, st.store
assert st.devices == [torch.device("cpu")], st.devices
r = hvd.rank()
x = torch.from_numpy(np.random.RandomState(10 + r).randn(4, 3).astype(np.float32))
xi = torch.from_numpy(np.random.RandomState(20 + r).randint(-9, 9, (4, 2)).astype(np.int32))
res = {"allreduce": hvd.allreduce(x, average=False),
       "alltoall": hvd.alltoall(x), "reducescatter": hvd.reducescatter(x),
       "rs_int_avg": hvd.reducescatter(xi, average=True),
       "allgather": hvd.allgather(x[: r + 1]),
       "broadcast": hvd.broadcast(x, 1)}
torch.save(res, f"{out}/rank{r}.pt")
print(f"RUN_OK rank={r} size={hvd.size()} local={hvd.local_rank()}/"
      f"{hvd.local_size()}", flush=True)
hvd.shutdown()
'''


def _launch(args, timeout=180, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_KV",
              "HOROVOD_PLATFORM", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner"] + args,
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout, **kw)


def _x(r):
    return np.random.RandomState(10 + r).randn(4, 3).astype(np.float32)


def _xi(r):
    return np.random.RandomState(20 + r).randint(-9, 9, (4, 2)).astype(
        np.int32)


def _two_rank_jax(fn, xs):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    f = jax.jit(jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                              in_specs=P("data"), out_specs=P("data"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(np.stack(xs))))


def _check_against_jax(out_dir):
    xs = [_x(r) for r in range(2)]
    refs = {
        "allreduce": _two_rank_jax(lambda x: C.allreduce(x, average=False),
                                   xs),
        "alltoall": _two_rank_jax(C.alltoall, xs),
        "reducescatter": _two_rank_jax(C.reducescatter, xs),
        "rs_int_avg": _two_rank_jax(C.reducescatter,
                                    [_xi(r) for r in range(2)]) // 2,
        "broadcast": _two_rank_jax(lambda x: C.broadcast(x, 1), xs)}
    gathered = np.concatenate([xs[0][:1], xs[1][:2]])
    for r in range(2):
        res = torch.load(out_dir / f"rank{r}.pt")
        for name, ref in refs.items():
            got = res[name].numpy()
            assert got.dtype == ref[r].dtype, name
            np.testing.assert_allclose(got, ref[r], atol=1e-6,
                                       err_msg=name)
        np.testing.assert_array_equal(res["allgather"].numpy(), gathered)


def test_two_rank_collectives_match_jax(tmp_path):
    res = _launch(["-np", "2", "--platform", "cpu", sys.executable, "-c",
                   WORKER, str(tmp_path)])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[0] RUN_OK rank=0 size=2 local=0/2" in res.stdout
    assert "[1] RUN_OK rank=1 size=2 local=1/2" in res.stdout
    _check_against_jax(tmp_path)


def test_two_host_instances_get_rank_offsets(tmp_path):
    """Two launchers = two hosts of ``-H localhost:1,localhost:1``: host
    1's worker is global rank 1, local rank 0 of 1, and both meet at
    host 0's store for the same collectives."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    common = ["-H", "localhost:1,localhost:1", "--platform", "cpu", "--",
              sys.executable, "-c", WORKER, str(tmp_path)]
    results = {}

    def launch(idx, extra):
        results[idx] = _launch([f"--host-index={idx}"] + extra + common)

    threads = [threading.Thread(target=launch,
                                args=(0, ["--kv-port", str(port)])),
               threading.Thread(target=launch, args=(
                   1, ["--rendezvous", f"127.0.0.1:{port}"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=200)
        assert not t.is_alive()
    for idx in (0, 1):
        assert results[idx].returncode == 0, (results[idx].stdout
                                              + results[idx].stderr)
    assert "[0] RUN_OK rank=0 size=2 local=0/1" in results[0].stdout
    assert "[1] RUN_OK rank=1 size=2 local=0/1" in results[1].stdout
    _check_against_jax(tmp_path)


@pytest.mark.parametrize("args,message", [
    (["-np", "3", "-H", "localhost:1,localhost:1", "true"],
     "-np 3 != sum of -H slots 2"),
    (["-np", "2", "--platform", "cpu"], "missing worker command"),
    (["--platform", "cpu", "true"], "need -np or -H"),
    (["-np", "1", "--host-index", "1", "true"],
     "--host-index/--rendezvous require -H"),
    (["-H", "localhost:0", "true"], "bad host entry"),
])
def test_bad_arguments_are_rejected(args, message):
    res = _launch(args, timeout=60)
    assert res.returncode == 2, res.stdout + res.stderr
    assert message in res.stderr


def test_worker_failure_ends_the_job():
    """mpirun's contract: rank 0 fails with status 3, the launcher
    terminates the sleeping rank 1 and exits 3."""
    code = ("import os, sys, time; r = int(os.environ['HOROVOD_RANK']); "
            "time.sleep(0 if r == 0 else 120); sys.exit(3)")
    t0 = time.time()
    res = _launch(["-np", "2", "--platform", "cpu", sys.executable, "-c",
                   code])
    assert res.returncode == 3, res.stdout + res.stderr
    assert time.time() - t0 < 60


@pytest.mark.parametrize("elastic", [True, False])
def test_signal_death_under_elastic(elastic):
    """Under --elastic a worker killed by a signal does not fail the
    job when another finishes; without it, the job fails."""
    code = ("import os, signal, time; r = int(os.environ['HOROVOD_RANK']);"
            " time.sleep(0.5 * r);"
            " os.kill(os.getpid(), signal.SIGKILL) if r == 0 else None")
    res = _launch((["--elastic"] if elastic else [])
                  + ["-np", "2", "--platform", "cpu", sys.executable, "-c",
                     code])
    if elastic:
        assert res.returncode == 0, res.stdout + res.stderr
        assert f"died with signal {int(signal.SIGKILL)}" in res.stderr
    else:
        assert res.returncode != 0


def test_gpu_platform_without_enough_cards_spawns_nothing(tmp_path):
    """--platform gpu (the default) refuses more ranks than cards before
    anything starts; nothing falls back to the CPU."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    marker = tmp_path / "spawned"
    res = _launch(["-np", "2", sys.executable, "-c",
                   f"open({str(marker)!r}, 'w').close()"], timeout=60)
    assert res.returncode == 2, res.stdout + res.stderr
    assert "one rank per card" in res.stderr
    assert not marker.exists()


def test_package_data_ships_every_kernel_source():
    """Every file `ops/_build.py` reads from ``csrc/`` (the sources it
    compiles and the headers it hashes and includes) matches a
    ``package-data`` pattern, and the console script is declared."""
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"][
        "horovod_tpu_torch"]
    read = sorted(_build.CSRC.glob("*.cu")) + sorted(
        _build.CSRC.glob("*.cuh"))
    assert any(p.suffix == ".cuh" for p in read)
    pkg = _build.CSRC.parent
    for path in read:
        rel = path.relative_to(pkg).as_posix()
        assert any(fnmatch(rel, pat) for pat in patterns), rel
    assert cfg["project"]["scripts"]["hvdrun-torch"] == \
        "horovod_tpu_torch.runner:main"
