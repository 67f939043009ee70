"""hvdrun for the PyTorch port: the launcher.

Counterpart of `horovod_tpu/runner/__init__.py:44-276`, the
replacement for the reference's ``mpirun -np N python train.py``
contract: it spawns N worker processes, gives each its membership
(``HOROVOD_RANK`` / ``HOROVOD_SIZE`` / ``HOROVOD_LOCAL_RANK`` /
``HOROVOD_LOCAL_SIZE``), hosts the rendezvous the workers' process
group forms over (a `torch.distributed.TCPStore`, ``HOROVOD_KV``) and
tells them their platform (``HOROVOD_PLATFORM``). `hvd.init()` in a
worker reads all of it (`runtime.bootstrap`).

Usage::

    hvdrun-torch -np 4 python train.py             # one rank per card
    python -m horovod_tpu_torch.runner -np 2 --platform cpu python t.py

Under ``--platform gpu`` (the default) rank ``local_rank`` drives card
``local_rank`` over NCCL, and a host asked for more ranks than it has
cards is refused before anything is spawned; nothing falls back to the
CPU. ``--platform cpu`` runs gloo on the CPU; ``auto`` leaves the
choice to each worker's `init`.

Multi-host (the reference's ``mpirun -H server1:4,server2:4``): one
launcher per host with the same slot map. Host 0 serves the rendezvous
store; the others point at it::

    hvdrun-torch -H server1:4,server2:4 --host-index 0 --kv-port 29500 \\
        python train.py
    hvdrun-torch -H server1:4,server2:4 --host-index 1 \\
        --rendezvous server1:29500 python train.py

Each instance launches only its own host's slots, with global rank
offsets. The JAX launcher's ``--coordinator`` (the ``jax.distributed``
service) and ``--devices-per-proc`` (virtual XLA CPU devices) have no
counterpart over `torch.distributed` and are not ported.
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List


def _stream(prefix: str, pipe, out):
    for line in iter(pipe.readline, ""):
        out.write(f"[{prefix}] {line}")
        out.flush()
    pipe.close()


def _parse_hosts(spec: str):
    """'server1:4,server2:4' -> [('server1', 4), ('server2', 4)]
    (``mpirun -H`` slot syntax)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, slots = part.partition(":")
        n = int(slots) if sep else 1
        if not host or n < 1:
            raise ValueError(f"bad host entry {part!r} (need host:n "
                             f"with n >= 1)")
        out.append((host, n))
    if not out:
        raise ValueError(f"empty host spec {spec!r}")
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch N horovod_tpu_torch worker processes (mpirun "
                    "replacement).")
    ap.add_argument("-np", "--num-proc", type=int, default=None,
                    help="total worker processes across all hosts "
                         "(default: sum of -H slots)")
    ap.add_argument("-H", "--hosts", default=None,
                    help="host1:n,host2:n slot map; this instance "
                         "launches only the --host-index entry's slots "
                         "with global rank offsets")
    ap.add_argument("--host-index", type=int, default=0,
                    help="which -H entry this instance is")
    ap.add_argument("--rendezvous", default=None, metavar="HOST:PORT",
                    help="rendezvous store of host 0 (non-zero hosts "
                         "connect instead of serving)")
    ap.add_argument("--kv-port", type=int, default=0,
                    help="fixed port for the rendezvous store on host 0 "
                         "(default: any free port)")
    ap.add_argument("--platform", default="gpu",
                    choices=["gpu", "cpu", "auto"],
                    help="workers' device: gpu (one card per rank, NCCL; "
                         "refused when the host has fewer cards than "
                         "ranks), cpu (gloo), auto (each worker's init "
                         "decides)")
    ap.add_argument("--elastic", action="store_true",
                    help="a worker killed by a SIGNAL does not kill the "
                         "job — survivors keep running and the exit code "
                         "reflects them; a worker failing with a nonzero "
                         "STATUS still fails the job")
    ap.add_argument("--no-prefix", action="store_true",
                    help="don't prefix worker output with [rank]")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command, e.g. python train.py")
    return ap


def main(argv: List[str] | None = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing worker command")

    # This instance's slice of the world.
    if args.hosts is not None:
        try:
            hosts = _parse_hosts(args.hosts)
        except ValueError as e:
            ap.error(str(e))
        total = sum(s for _, s in hosts)
        if args.num_proc is not None and args.num_proc != total:
            ap.error(f"-np {args.num_proc} != sum of -H slots {total}")
        if not 0 <= args.host_index < len(hosts):
            ap.error(f"--host-index {args.host_index} out of range for "
                     f"{len(hosts)} hosts")
        rank_offset = sum(s for _, s in hosts[:args.host_index])
        local_n = hosts[args.host_index][1]
        head_host = hosts[0][0]
    else:
        if args.num_proc is None:
            ap.error("need -np or -H")
        if args.host_index != 0 or args.rendezvous is not None:
            # Without a slot map there are no rank offsets: a second
            # instance would relaunch ranks 0..n-1.
            ap.error("--host-index/--rendezvous require -H")
        total = local_n = args.num_proc
        rank_offset = 0
        head_host = "127.0.0.1"
    if local_n < 1:
        ap.error(f"-np must be >= 1, got {local_n}")

    import torch
    import torch.distributed as dist
    if args.platform == "gpu":
        cards = torch.cuda.device_count()
        if local_n > cards:
            print(f"hvdrun-torch: --platform gpu runs one rank per card, "
                  f"but this host has {cards} CUDA card(s) for {local_n} "
                  f"rank(s); launch fewer ranks, or use --platform cpu "
                  f"for gloo on the CPU", file=sys.stderr)
            return 2

    store = None
    if args.rendezvous is None and args.host_index == 0:
        # The launcher hosts the rendezvous (the rank-0 coordinator role
        # of Horovod's background thread); it waits for no worker, so
        # it never blocks on its own clients.
        store = dist.TCPStore("0.0.0.0" if args.hosts else "127.0.0.1",
                              args.kv_port, None, True,
                              datetime.timedelta(seconds=300),
                              wait_for_workers=False)
        host = head_host if args.hosts else "127.0.0.1"
        kv_addr = f"{host}:{store.port}"
        if args.hosts is not None and len(hosts) > 1:
            print(f"hvdrun-torch: rendezvous serving at {kv_addr} — start "
                  f"the other hosts with --rendezvous {kv_addr}",
                  file=sys.stderr)
    else:
        if args.rendezvous is None:
            ap.error("non-zero --host-index needs --rendezvous "
                     "(host 0's store address)")
        kv_addr = args.rendezvous

    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []
    for local_rank in range(local_n):
        rank = rank_offset + local_rank
        env = dict(os.environ)
        env.update({
            "HOROVOD_RANK": str(rank),
            "HOROVOD_SIZE": str(total),
            "HOROVOD_LOCAL_RANK": str(local_rank),
            "HOROVOD_LOCAL_SIZE": str(local_n),
            "HOROVOD_KV": kv_addr,
        })
        if args.platform != "auto":
            env["HOROVOD_PLATFORM"] = args.platform
        p = subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE if not args.no_prefix else None,
            stderr=subprocess.STDOUT if not args.no_prefix else None,
            text=not args.no_prefix)
        procs.append(p)
        if not args.no_prefix:
            t = threading.Thread(target=_stream,
                                 args=(str(rank), p.stdout, sys.stdout),
                                 daemon=True)
            t.start()
            threads.append(t)

    exit_code = 0
    clean_exits = 0
    try:
        remaining = set(range(local_n))
        while remaining:
            for i in list(remaining):
                rc = procs[i].poll()
                if rc is None:
                    continue
                remaining.discard(i)
                if rc == 0:
                    clean_exits += 1
                    continue
                if args.elastic and rc < 0:
                    # A signal death (preemption) is a membership event,
                    # not a job failure, for an elastic job.
                    print(f"hvdrun-torch: worker {rank_offset + i} died "
                          f"with signal {-rc}; elastic job continues",
                          file=sys.stderr)
                    continue
                if exit_code == 0:
                    exit_code = rc
                    if not args.elastic:
                        # mpirun's contract: one failure ends the job.
                        for j in remaining:
                            procs[j].terminate()
            if remaining:
                time.sleep(0.1)
        if args.elastic and exit_code == 0 and clean_exits == 0:
            # Every worker died by signal: nobody finished the job.
            exit_code = 1
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGINT)
        exit_code = 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in threads:
            t.join(timeout=2)
        del store
    return exit_code
