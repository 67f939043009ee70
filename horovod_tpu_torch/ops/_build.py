"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``horovod_tpu_torch/csrc/*.cu`` file is one kernel library with a
plain C interface (no PyTorch headers, so `nvcc` takes seconds, not the
minutes a `torch.utils.cpp_extension` build costs). The first call of
`library(name)` compiles EVERY source at once, one `nvcc` process per
file started together, into ``build/kernels/`` beside the package (the
directory `.gitignore` lists), and loads the results with `ctypes`.
Library file names carry a hash of the source, of every shared header
beside it (``csrc/*.cuh``, e.g. the TMA / wgmma helpers in
``hopper.cuh``) and of the flags, so an edited source or header never
loads a stale build. The compiler's ``-Xptxas -v``
report is kept beside each library (``<library>.ptxas.txt``), so a
cached build still reports its registers and shared memory.

Host libraries (``csrc/*.cc``: the native data loader) are built the
same way with the host's ``c++`` by `build_host`, into ``build/host/``.

Nothing here runs at import time: the CPU tests import every module,
and a CPU-only install has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
HOST_BUILD_DIR = _PKG.parent / "build" / "host"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> the compiler's `-Xptxas -v` report (registers, shared memory,
# spills per kernel instantiation) of the library this process loaded.
ptxas_reports: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """A kernel source failed to compile or load."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin); the port's "
        "CUDA kernels are built from source at first use")


def _target(src: pathlib.Path) -> pathlib.Path:
    """The library built from ``src``: named by a hash of the source,
    the shared headers of its directory and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _report_path(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns
    {source stem: CDLL}. Idempotent and thread-safe."""
    with _lock:
        if _libs:
            return dict(_libs)
        sources = sorted(CSRC.glob("*.cu"))
        if not sources:
            raise KernelBuildError(f"no CUDA sources under {CSRC}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in sources:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src.stem] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):"
                              f"\n{log}")
                continue
            _report_path(out).write_text(log)
            os.replace(tmp, out)
        if failed:
            raise KernelBuildError("kernel build failed:\n"
                                   + "\n".join(failed))
        for src in sources:
            lib = _target(src)
            try:
                _libs[src.stem] = ctypes.CDLL(str(lib))
            except OSError as e:
                raise KernelBuildError(f"loading {lib} failed: {e}") from e
            report = _report_path(lib)
            ptxas_reports[src.stem] = (report.read_text() if report.exists()
                                       else "")
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    libs = build_all()
    if name not in libs:
        raise KernelBuildError(f"no kernel source csrc/{name}.cu")
    return libs[name]


def build_host(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cc`` with the host's ``c++`` into
    ``build/host/lib<name>-<hash of source and flags>.so`` unless that
    library exists; returns its path. A temporary file renamed into
    place keeps concurrent builders (one per test worker or rank) from
    loading a half-written library. Raises `KernelBuildError` when the
    compiler is missing or fails."""
    src = CSRC / f"{name}.cc"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    out = HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise KernelBuildError("no host C++ compiler (c++ or g++) on PATH")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"{src.name} failed to build (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out
