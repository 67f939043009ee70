"""Overlap analysis of `torch.profiler` traces — measuring α.

Counterpart of `horovod_tpu.utils.profile_analysis`, for the Chrome
trace (`*.pt.trace.json`, or `.json.gz`) that `obs.profiling.
profiler_session` (torch.profiler's `export_chrome_trace`) writes. The
efficiency model rests on the exposed-collective fraction α (the share
of collective time NOT hidden under compute). For every collective we
take its WINDOW, subtract the union of compute intervals inside it,
and call the remainder exposed:

    alpha = exposed_collective_time / total_collective_window_time

The trace formats differ in one place, `_device_pids`: a TPU trace
names its device processes, while torch.profiler puts the card's work
on the device's pid as events of category ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` (CUPTI), beside host events and GPU user
annotations on other categories. So device events are classified by
category here. A collective is an NCCL kernel (AllReduce, AllGather,
ReduceScatter, SendRecv / AllToAll, Broadcast) on its stream; NCCL runs
a collective as one kernel, so its window is the kernel's own extent,
and compute on other streams during it hides it. Union arithmetic
makes overlapping events on several streams safe to count once.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# Peak dense bf16 FLOP/s by CUDA device name (NVIDIA's data sheets, SXM
# parts at their full power limit) — the MFU denominator of the
# obs-plane `hvd_training_mfu` gauge (obs/profiling.StepProfiler).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H200": 989e12,
}

# Event categories of the card's own work in a torch.profiler trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_peak_flops(device_kind: Optional[str]) -> Optional[float]:
    """Peak bf16 FLOP/s for a CUDA device name
    (`torch.cuda.get_device_name`); None for unknown hardware (the CPU,
    unlisted cards) — MFU is then unreported rather than fabricated."""
    if not device_kind:
        return None
    return PEAK_BF16_FLOPS.get(device_kind)


def mfu(flops_per_s: float,
        device_kind: Optional[str]) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over the device peak
    (coarse but honest); None when the peak is unknown."""
    peak = device_peak_flops(device_kind)
    if not peak:
        return None
    return round(flops_per_s / peak, 4)


# NCCL kernel names, e.g. "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)",
# "ncclKernel_AllGather_RING_LL_Sum_int8_t(...)", "ncclDevKernel_SendRecv".
_COLLECTIVE_RE = re.compile(
    r"^(?:void\s+)?nccl\w*?(AllReduce|AllGather|ReduceScatter|SendRecv|"
    r"AllToAll|Broadcast)", re.IGNORECASE)

_TRACE_GLOBS = ("*.pt.trace.json", "*.pt.trace.json.gz")


def find_trace_file(profile_dir: str,
                    min_mtime: Optional[float] = None) -> Optional[str]:
    """Newest `*.pt.trace.json[.gz]` under a trace directory.

    `min_mtime` guards against a REUSED profile dir: old captures are
    never cleaned, so without the bound a failed export would silently
    hand back a previous run's trace as this run's measurement. 2s of
    slack tolerates coarse-mtime filesystems / slight clock skew without
    readmitting day-old captures."""
    paths = [p for pat in _TRACE_GLOBS for p in glob.glob(
        os.path.join(profile_dir, "**", pat), recursive=True)
        if min_mtime is None or os.path.getmtime(p) >= min_mtime - 2.0]
    return max(paths, key=os.path.getmtime) if paths else None


def load_trace(profile_dir_or_file: str,
               min_mtime: Optional[float] = None) -> Dict[str, Any]:
    path = profile_dir_or_file
    if os.path.isdir(path):
        found = find_trace_file(path, min_mtime=min_mtime)
        if found is None:
            raise FileNotFoundError(
                f"no *.pt.trace.json[.gz] under {path!r}"
                + (" (newer than min_mtime)" if min_mtime else ""))
        path = found
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _merge(intervals: List[Tuple[float, float]]):
    """Sorted union of half-open intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _covered(window: Tuple[float, float],
             union: List[Tuple[float, float]]) -> float:
    """Length of `window` covered by the (merged) union."""
    s, e = window
    total = 0.0
    for us, ue in union:
        if ue <= s:
            continue
        if us >= e:
            break
        total += min(e, ue) - max(s, us)
    return total


def _device_pids(events):
    """pids that carry the card's work: events of a device category
    (`DEVICE_CATS`) — the one device/host classification, shared by the
    overlap and breakdown analyses."""
    return {e.get("pid") for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}


def _device_events(events, device_pids):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and e.get("pid") in device_pids and e.get("dur") is not None]


def analyze_overlap(trace: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Measured α from a loaded Chrome trace.

    Returns None when no device timeline is present (a CPU-only capture
    records host events only).
    """
    events = (trace if isinstance(trace, list)
              else trace.get("traceEvents", []))
    device_pids = _device_pids(events)
    if not device_pids:
        return None

    # (label, window) per collective — labels feed the top-exposed
    # report, windows the headline numbers.
    comm: List[Tuple[str, Tuple[float, float]]] = []
    compute: List[Tuple[float, float]] = []
    for e in sorted(_device_events(events, device_pids),
                    key=lambda e: float(e["ts"])):
        name = e.get("name", "")
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "kernel" and _COLLECTIVE_RE.match(name):
            comm.append((name, iv))
        else:
            compute.append(iv)
    comm_windows = [w for _, w in comm]
    if not comm_windows:
        return {"alpha": None, "t_comm_us": 0.0, "t_comm_exposed_us": 0.0,
                "t_compute_us": round(sum(e - s for s, e in
                                          _merge(compute)), 3),
                "n_collectives": 0, "device_pids": len(device_pids)}

    compute_union = _merge(compute)
    merged_comm = _merge(comm_windows)
    t_comm = sum(e - s for s, e in merged_comm)
    exposed = sum((e - s) - _covered((s, e), compute_union)
                  for s, e in merged_comm)
    # Per-window attribution for the top offenders (un-merged, so
    # overlapping windows may double-count individually).
    per_op = sorted(
        ((name, (w[1] - w[0]) - _covered(w, compute_union))
         for name, w in comm),
        key=lambda kv: -kv[1])

    return {
        "alpha": round(exposed / t_comm, 4) if t_comm else None,
        "t_comm_us": round(t_comm, 3),
        "t_comm_exposed_us": round(exposed, 3),
        "t_compute_us": round(sum(e - s for s, e in compute_union), 3),
        "n_collectives": len(comm_windows),
        "device_pids": len(device_pids),
        "top_exposed": [
            {"name": n, "exposed_us": round(v, 3)}
            for n, v in per_op[:5]],
    }


# cuBLAS / CUTLASS matrix products: "...gemm...", cuBLAS's Hopper kernels
# "nvjet_tst_256x128_...", "sm90_xmma_...".
_GEMM_RE = re.compile(r"gemm|nvjet|xmma", re.IGNORECASE)


def op_category(e: Dict[str, Any]) -> str:
    """A device event's category: its trace category for copies and
    memsets; ``nccl <Kind>`` for an NCCL collective; ``gemm`` for a
    cuBLAS / CUTLASS matrix product; ``elementwise`` for PyTorch's
    elementwise kernels; else the kernel's base name, without ``void``,
    namespaces, template arguments, parameters and trailing indices
    ("void (anonymous namespace)::flash_fwd_wgmma<128>(...)" ->
    "flash_fwd_wgmma")."""
    if e.get("cat") != "kernel":
        return e.get("cat", "")
    name = e.get("name", "")
    m = _COLLECTIVE_RE.match(name)
    if m:
        return f"nccl {m.group(1)}"
    if _GEMM_RE.search(name):
        return "gemm"
    if "elementwise_kernel" in name:
        return "elementwise"
    base = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    base = re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1]
    return re.sub(r"[.\d]+$", "", base) or name


def analyze_op_breakdown(trace: Dict[str, Any],
                         top_k: int = 10) -> Optional[Dict[str, Any]]:
    """Where the device step time goes, by kernel category
    (`op_category`). Returns total device-op time, per-category shares,
    and the top individual kernels by name; None without a device
    timeline or device time."""
    events = (trace if isinstance(trace, list)
              else trace.get("traceEvents", []))
    device_pids = _device_pids(events)
    if not device_pids:
        return None

    from collections import defaultdict
    cat_us: Dict[str, float] = defaultdict(float)
    op_us: Dict[str, float] = defaultdict(float)
    total = 0.0
    for e in _device_events(events, device_pids):
        dur = float(e["dur"])
        cat_us[op_category(e)] += dur
        op_us[e.get("name", "")] += dur
        total += dur
    if total <= 0:
        return None
    cats = sorted(cat_us.items(), key=lambda kv: -kv[1])
    ops = sorted(op_us.items(), key=lambda kv: -kv[1])
    return {
        "t_total_us": round(total, 3),
        "categories": [
            {"category": c, "us": round(v, 3),
             "share": round(v / total, 4)}
            for c, v in cats[:top_k]],
        "top_ops": [
            {"name": n, "us": round(v, 3),
             "share": round(v / total, 4)}
            for n, v in ops[:top_k]],
    }


def analyze_profile_dir(profile_dir: str,
                        min_mtime: Optional[float] = None
                        ) -> Optional[Dict[str, Any]]:
    """Convenience: load the newest trace under `profile_dir` (written
    at or after `min_mtime`, when given) and analyze — overlap α plus
    the per-category op breakdown (`op_breakdown` key); None when there
    is no (fresh enough) trace or no device timeline."""
    try:
        trace = load_trace(profile_dir, min_mtime=min_mtime)
    except (FileNotFoundError, OSError, ValueError):
        return None
    out = analyze_overlap(trace)
    if out is not None:
        out["op_breakdown"] = analyze_op_breakdown(trace)
    return out
