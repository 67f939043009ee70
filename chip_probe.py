#!/usr/bin/env python3
"""Quick card probe of the flash forward and the two decode kernels: a
short call that builds, checks and times them without the model phases
of `chip_smoke.py`.

    python3 chip_probe.py [fwd] [decode] [paged] [sweep]   # default: all;
                                                           # one card, ~1 min

Builds every kernel (printing the ptxas lines of the forward and decode
sources) and then, per part asked for:

* fwd: reports the wgmma instantiations (`chip_smoke.py` phase 1), runs
  each case of `chip_smoke.FWD_CASES` against the plain forward and
  times the bf16 forward at [4, 512], [1, 2048] and [8, 2048] x 8 heads
  x 128 (causal) beside SDPA;
* decode: the flash-decode cases of `chip_smoke.check_decode`;
* paged: the paged-decode cases of `chip_smoke.check_paged`;
* sweep: both decode kernels timed over forced split counts (bf16, 8
  lanes x 2048, Hkv 8 and 2; flash decode at full and spread lengths,
  the paged decode at fill 2047 and at the paged engine's 16-lane
  geometry), each beside the split count its wrapper picks by itself.

A failing case is printed and the probe goes on to the next. With
decode or paged it then times both decode ticks as `chip_smoke.py`
phase 6 does (`chip_smoke.time_decode_kernels`: the kernel, its plain
version, the library yardstick, the bound, the split count, registers
and spills). `chip_smoke.py` stays the full check: this script proves
nothing it does not.
"""

import json
import sys
import time
import traceback


def probe_forward(cs, tfa, build, dev, g):
    import torch
    import torch.nn.functional as F
    try:
        cs.report_wgmma_kernels(build)
    except Exception:
        traceback.print_exc()
    errs = {"flash_fwd": {"max_abs_err_f32": 0.0, "lse_max_abs_err": 0.0}}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for name, (B, Sq, Sk, H, Hkv, D), kw, fused in cs.FWD_CASES:
            try:
                if fused:
                    q, k, v = cs.fused_qkv(B, Sq, H, D, dev, dt, g)
                else:
                    q = torch.randn(B, Sq, H, D, device=dev,
                                    generator=g).to(dt)
                    k = torch.randn(B, Sk, Hkv, D, device=dev,
                                    generator=g).to(dt)
                    v = torch.randn(B, Sk, Hkv, D, device=dev,
                                    generator=g).to(dt)
                ref = cs.check_forward_case(tfa, q, k, v, kw, dtype, name,
                                            errs)
                if dtype == "bfloat16" and name.startswith("window 4"):
                    cs.check_forward_rounding_fault(tfa, (q, k, v), ref, kw,
                                                    errs)
            except Exception:
                traceback.print_exc()
                torch.cuda.synchronize()
    print(errs, flush=True)
    bf = torch.bfloat16
    for B, S in ((4, 512), (1, 2048), (8, 2048)):
        q, k, v = (torch.randn(B, S, 8, 128, device=dev, generator=g).to(bf)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = cs.cuda_time_ms(lambda: tfa.flash_fwd_cuda(q, k, v, causal=True))
        lib = cs.cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        print(f"fwd [{B},{S},8,128] kernel {ms:.4f} ms SDPA {lib:.4f} ms",
              flush=True)


SWEEP_SPLITS = (2, 3, 4, 5, 6, 8, 10, 16)


def sweep_splits(cs, tfa, tpa, dev, g):
    """{case: {"rule": its wrapper's split count, "ms": {splits: ms}}}."""
    import torch
    bf = torch.bfloat16
    sms = tfa._sm_count(dev)
    rows = {}
    for hkv in (8, 2):
        q = torch.randn(8, 1, 8, 128, device=dev, generator=g).to(bf)
        kc, vc = (torch.randn(8, 2048, hkv, 128, device=dev,
                              generator=g).to(bf) for _ in range(2))
        for name, lens in (("full", [2048] * 8),
                           ("spread", [round(1 + i * 2047 / 7)
                                       for i in range(8)])):
            length = torch.tensor(lens, dtype=torch.int32, device=dev)
            rule = tfa.decode_splits(2048, hkv * 8, sms)
            rows[f"flash_decode Hkv {hkv} lengths {name}"] = dict(
                rule=rule, ms={ns: cs.cuda_time_ms(
                    lambda: tfa.flash_decode_cuda(q, kc, vc, length,
                                                  splits=ns), iters=50)
                    for ns in sorted({*SWEEP_SPLITS, rule})})
        for name, fills, kw in (("fill 2047", [2047] * 8, {}),
                                ("engine geometry", cs.ENGINE_FILLS,
                                 dict(nb=1025, free=(15,)))):
            args = cs.paged_case(g, dev, bf, hkv, fills, **kw)
            rule = tpa.paged_decode_splits(128, 16, hkv * len(fills), sms)
            rows[f"paged_decode Hkv {hkv} {name}"] = dict(
                rule=rule, ms={ns: cs.cuda_time_ms(
                    lambda: tpa.paged_decode_cuda(*args, splits=ns),
                    iters=50) for ns in sorted({*SWEEP_SPLITS, rule})})
    for name, r in rows.items():
        best = min(r["ms"], key=r["ms"].get)
        print(f"sweep {name}: rule {r['rule']} ({r['ms'][r['rule']]:.4f} "
              f"ms), best {best} ({r['ms'][best]:.4f} ms); "
              + ", ".join(f"{ns}: {ms:.4f}" for ns, ms in r["ms"].items()),
              flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA card", file=sys.stderr)
        return 2
    every = {"fwd", "decode", "paged", "sweep"}
    parts = set(sys.argv[1:]) or every
    if not parts <= every:
        print(f"chip_probe: unknown parts {sorted(parts)}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.ops import paged_attention as tpa
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), torch.__version__, torch.version.cuda,
          flush=True)
    t = time.time()
    _build.build_all()
    print("built", time.time() - t, flush=True)
    for stem in ("flash_fwd", "flash_decode", "paged_decode"):
        for line in _build.ptxas_reports[stem].splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "arning", "rror")):
                print(stem, line.strip())
    g = torch.Generator(device=dev).manual_seed(1234)
    if "fwd" in parts:
        probe_forward(cs, tfa, _build, dev, g)
    if "decode" in parts:
        errs = {"flash_decode": {"max_abs_err_f32": 0.0}}
        try:
            cs.check_decode(tfa, dev, g, errs)
        except Exception:
            traceback.print_exc()
        print(errs, flush=True)
    if "paged" in parts:
        try:
            print(cs.check_paged(tpa, dev), flush=True)
        except Exception:
            traceback.print_exc()
    if parts & {"decode", "paged"}:
        rows = cs.time_decode_kernels(tfa, dev, g)
        print(json.dumps(rows), flush=True)
        for name, r in rows.items():
            print(f"{name}: {r['ms']:.4f} ms, splits {r['splits']}, bound "
                  f"{r['bound_ms']:.4f} ms ({100 * r['bound_share']:.1f} %),"
                  f" library {r['library_ms']:.4f} ms", flush=True)
        e = rows["paged_decode"]["at_engine"]
        print(f"paged_decode at the engine geometry: {e['ms']:.4f} ms, "
              f"splits {e['splits']}, bound {e['bound_ms']:.4f} ms "
              f"({100 * e['bound_share']:.1f} %)", flush=True)
    if "sweep" in parts:
        sweep_splits(cs, tfa, tpa, dev, g)
    print(f"nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
