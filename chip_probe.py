#!/usr/bin/env python3
"""Quick card probe of the flash forward and flash decode kernels: a
short call that builds, checks and times them without the model phases
of `chip_smoke.py`.

    python3 chip_probe.py        # needs one CUDA card; ~1 minute

Builds every kernel (printing the ptxas lines of the forward and decode
sources), reports the wgmma instantiations (`chip_smoke.py` phase 1),
runs each forward case of `chip_smoke.FWD_CASES` and the decode cases of
`chip_smoke.check_decode` against the plain versions (phase 2, a
failing case printed and the probe going on to the next), and times the
bf16 forward at [4, 512], [1, 2048] and [8, 2048] x 8 heads x 128
(causal) and the decode tick at 8 lanes x 2048 beside SDPA, by CUDA
events. `chip_smoke.py` stays the full check: this script proves
nothing it does not.
"""

import sys
import time
import traceback


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA card", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    import chip_smoke as cs
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as tfa
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), torch.__version__, torch.version.cuda,
          flush=True)
    t = time.time()
    _build.build_all()
    print("built", time.time() - t, flush=True)
    for stem in ("flash_fwd", "flash_decode"):
        for line in _build.ptxas_reports[stem].splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "arning", "rror")):
                print(stem, line.strip())
    try:
        cs.report_wgmma_kernels(_build)
    except Exception:
        traceback.print_exc()
    g = torch.Generator(device=dev).manual_seed(1234)
    errs = {"flash_fwd": {"max_abs_err_f32": 0.0, "lse_max_abs_err": 0.0},
            "flash_decode": {"max_abs_err_f32": 0.0}}
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
    try:
        cs.check_decode(tfa, dev, g, errs)
    except Exception:
        traceback.print_exc()
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
    L, W = 8, 2048
    q1 = torch.randn(L, 1, 8, 128, device=dev, generator=g).to(bf)
    kc = torch.randn(L, W, 8, 128, device=dev, generator=g).to(bf)
    vc = torch.randn(L, W, 8, 128, device=dev, generator=g).to(bf)
    length = torch.full((L,), W, dtype=torch.int32, device=dev)
    ms = cs.cuda_time_ms(lambda: tfa.flash_decode_cuda(q1, kc, vc, length),
                         iters=50)
    qd, kd, vd = (x.transpose(1, 2).contiguous() for x in (q1, kc, vc))
    lib = cs.cuda_time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd),
                          iters=50)
    splits = tfa.decode_splits(W, 8 * L, tfa._sm_count(dev))
    print(f"decode 8x2048 kernel {ms:.4f} ms splits {splits} SDPA "
          f"{lib:.4f}", flush=True)
    nvidia = cs.nvidia_smi_line()
    print(f"nvidia-smi: {nvidia}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
