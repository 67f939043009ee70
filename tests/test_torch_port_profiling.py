"""PyTorch port: profiling (`obs.profiling`, `utils.profile_analysis`)
against the JAX package's.

The step brackets are host code: the same ``dt`` must record the same
counters, gauges and MFU in both packages' registries (each against its
own device-peak table). The analyses read different trace formats, so
one synthetic interval geometry is written once here and rendered in
each framework's naming: HLO op names on a TPU process for the
reference, ``kernel``-category NCCL and GEMM events on the device's pid
(as torch.profiler writes them) for the port; both must give the same
α, exposed and compute times and breakdown shares. On the CPU the
port's `profiler_session` writes a real torch.profiler trace, which
has no device timeline, so its analysis is None, as the reference's is
for a host-only capture.
"""

import gzip
import json
import time

import pytest
import torch

import horovod_tpu.obs.catalog as j_catalog
import horovod_tpu.runtime.config as j_config
from horovod_tpu.obs.profiling import StepProfiler as JStepProfiler
from horovod_tpu.utils import profile_analysis as jpa
from horovod_tpu_torch import obs
from horovod_tpu_torch.obs import catalog, events
from horovod_tpu_torch.obs.profiling import (StepProfiler, profile_step,
                                             profiler_session)
from horovod_tpu_torch.runtime import config as t_config
from horovod_tpu_torch.utils import profile_analysis as tpa

H100 = "NVIDIA H100 80GB HBM3"


def _values(m):
    return (m["steps"].value(), m["tokens_per_s"].value(),
            m["mfu"].value())


@pytest.mark.parametrize("dt", [1.0, 0.25, 0.0])
def test_step_profiler_records_what_the_reference_records(dt):
    """Same declared work, same ``dt``: the same step count delta,
    tokens/s and MFU (25 % of each package's own device peak)."""
    ours, ref = catalog.training_metrics(), j_catalog.training_metrics()
    o0, r0 = _values(ours), _values(ref)
    StepProfiler("unit_step", tokens_per_step=1000,
                 flops_per_step=989e12 * 0.25 * max(dt, 1e-9),
                 device_kind=H100).observe(dt)
    JStepProfiler("unit_step", tokens_per_step=1000,
                  flops_per_step=275e12 * 0.25 * max(dt, 1e-9),
                  device_kind="TPU v4").observe(dt)
    o1, r1 = _values(ours), _values(ref)
    assert o1[0] - o0[0] == r1[0] - r0[0] == 1
    if dt > 0:
        assert o1[1] == pytest.approx(r1[1]) == pytest.approx(1000 / dt)
        assert o1[2] == pytest.approx(r1[2]) == pytest.approx(0.25)
    else:   # a zero step records the count only, in both
        assert o1[1:] == o0[1:] and r1[1:] == r0[1:]


def test_step_profiler_unknown_device_reports_no_mfu():
    m = catalog.training_metrics()
    m["mfu"].set(0.5)
    StepProfiler("unit_step", flops_per_step=1e12,
                 device_kind="cpu").observe(1.0)
    assert m["mfu"].value() == 0.5
    if not torch.cuda.is_available():
        assert StepProfiler("unit_step")._device_kind is None


def test_profile_step_context():
    m = catalog.training_metrics()
    before = m["steps"].value()
    with profile_step("unit_step2", tokens=10) as prof:
        assert isinstance(prof, StepProfiler)
    assert m["steps"].value() == before + 1


def test_mfu_math():
    assert tpa.device_peak_flops(H100) == 989e12
    assert tpa.device_peak_flops("cpu") is None
    assert tpa.device_peak_flops(None) is None
    assert tpa.device_peak_flops("TPU v4") is None     # the TPU's, not ours
    assert tpa.mfu(989e12 / 2, H100) == pytest.approx(0.5)
    assert tpa.mfu(1e12, "unknown") is None


def test_profiling_names_exported_and_knob_declared():
    for name in ("StepProfiler", "profile_step", "profiler_session"):
        assert name in obs.__all__ and getattr(obs, name) is not None
    ours, ref = t_config.KNOBS["HVD_PROFILE_DIR"], j_config.KNOBS[
        "HVD_PROFILE_DIR"]
    assert (ours.kind, ours.default, ours.consumer) == (
        ref.kind, ref.default, ref.consumer)


def test_profiler_session_noop_without_knob(monkeypatch):
    monkeypatch.delenv("HVD_PROFILE_DIR", raising=False)
    with profiler_session() as d:
        assert d is None


def test_profiler_session_writes_a_trace_the_analysis_finds(
        monkeypatch, tmp_path):
    """With the knob: a torch.profiler Chrome trace lands in the dir,
    `find_trace_file` finds it, start/stop are in the event log, and a
    CPU capture has no device timeline, so the analysis is None."""
    monkeypatch.setenv("HVD_PROFILE_DIR", str(tmp_path))
    t0 = time.time()
    with profiler_session() as d:
        assert d == str(tmp_path)
        x = torch.randn(32, 32)
        (x @ x).sum()
    path = tpa.find_trace_file(str(tmp_path), min_mtime=t0)
    assert path is not None and path.endswith(".pt.trace.json")
    assert tpa.load_trace(str(tmp_path))["traceEvents"]
    assert tpa.analyze_profile_dir(str(tmp_path)) is None
    kinds = [(e["kind"], e.get("dir")) for e in events.tail(20)]
    assert ("profile.start", str(tmp_path)) in kinds
    assert ("profile.stop", str(tmp_path)) in kinds
    # A reused dir: a capture older than min_mtime is not this run's.
    assert tpa.find_trace_file(str(tmp_path),
                               min_mtime=time.time() + 60) is None


# The shared geometry, in us: compute [0, 50); an async all-reduce over
# [50, 100) under compute [52, 90) (38 hidden, 12 exposed); a sync
# all-gather [100, 120) (20 exposed); compute [120, 150). α = 32 / 70.
# Categories: two matrix products (50 + 38), one elementwise op (30),
# the all-reduce (50) and the all-gather (20) of 188 us of device time.
def _reference_events():
    def ev(name, ts, dur, cat, tid=1):
        return {"ph": "X", "pid": 1, "tid": tid, "name": name, "ts": ts,
                "dur": dur, "args": {"hlo_category": cat}}
    return [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        ev("fusion.1", 0, 50, "convolution fusion"),
        ev("all-reduce-start.5", 50, 2, "all-reduce"),
        ev("all-reduce-done.5", 52, 48, "all-reduce"),
        ev("fusion.2", 52, 38, "convolution fusion", tid=2),
        ev("all-gather.3", 100, 20, "all-gather"),
        ev("fusion.3", 120, 30, "loop fusion"),
        {"ph": "X", "pid": 9, "tid": 1, "name": "host-junk", "ts": 0,
         "dur": 1000},
    ]


def _port_events():
    def k(name, ts, dur, stream):
        return {"ph": "X", "cat": "kernel", "pid": 0, "tid": stream,
                "name": name, "ts": ts, "dur": dur, "args": {}}
    return [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        k("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
          0, 50, 7),
        k("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
          50, 50, 20),
        k("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128>"
          "(Params)", 52, 38, 7),
        k("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", 100, 20,
          20),
        k("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::AUnaryFunctor<float>>(int, float)", 120, 30, 7),
        # Host and annotation events on the device's pid or others are
        # not device work.
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "name": "train_step", "ts": 0, "dur": 150},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1,
         "name": "aten::mm", "ts": 0, "dur": 1000},
    ]


def _write(events, path, gz):
    path.parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.fixture
def both(tmp_path):
    ref_dir = tmp_path / "ref"
    _write(_reference_events(),
           ref_dir / "plugins" / "profile" / "x" / "m.trace.json.gz", True)
    port_dir = tmp_path / "port"
    _write(_port_events(), port_dir / "host_1.123.pt.trace.json", False)
    return (jpa.analyze_profile_dir(str(ref_dir)),
            tpa.analyze_profile_dir(str(port_dir)))


def test_overlap_alpha_equal_on_the_shared_geometry(both):
    ref, ours = both
    for key in ("alpha", "t_comm_us", "t_comm_exposed_us", "t_compute_us",
                "n_collectives", "device_pids"):
        assert ours[key] == ref[key], key
    assert ours["alpha"] == round(32 / 70, 4)
    assert ours["t_comm_exposed_us"] == 32.0
    assert [t["exposed_us"] for t in ours["top_exposed"]] == [20.0, 12.0]


def test_op_breakdown_shares_equal_on_the_shared_geometry(both):
    ref, ours = both
    rb, ob = ref["op_breakdown"], ours["op_breakdown"]
    assert ob["t_total_us"] == rb["t_total_us"] == 188.0
    assert ([c["share"] for c in ob["categories"]]
            == [c["share"] for c in rb["categories"]])
    assert {c["category"]: c["us"] for c in ob["categories"]} == {
        "gemm": 88.0, "nccl AllReduce": 50.0, "elementwise": 30.0,
        "nccl AllGather": 20.0}


def test_analysis_without_collectives_and_gz_trace(tmp_path):
    """A compute-only trace (a world-1 training step) has no α but its
    compute union; a gzipped torch trace loads the same."""
    evs = [e for e in _port_events() if "nccl" not in e["name"]]
    _write(evs, tmp_path / "a.pt.trace.json.gz", True)
    r = tpa.analyze_profile_dir(str(tmp_path))
    assert r["alpha"] is None and r["n_collectives"] == 0
    assert r["t_compute_us"] == 50.0 + 38.0 + 30.0


@pytest.mark.parametrize("name,cat,want", [
    ("void (anonymous namespace)::flash_fwd_wgmma<128>(CUtensorMap_st)",
     "kernel", "flash_fwd_wgmma"),
    ("void decode::decode_merge<__nv_bfloat16, 128>(float const*)",
     "kernel", "decode_merge"),
    ("ncclKernel_ReduceScatter_RING_LL_Sum_float(ncclWorkElem)", "kernel",
     "nccl ReduceScatter"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "kernel",
     "nccl SendRecv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_nn_n", "kernel", "gemm"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "kernel", "gemm"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy"
     "_kernel_cuda>(int)", "kernel", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>"
     "(at::native::ReduceOp<float>)", "kernel", "reduce_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "gpu_memcpy"),
    ("Memset (Device)", "gpu_memset", "gpu_memset"),
])
def test_op_category(name, cat, want):
    assert tpa.op_category({"name": name, "cat": cat}) == want
