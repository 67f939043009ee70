#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`horovod_tpu_torch`) on one
NVIDIA H100: the quickest proof that the port builds, is right and
serves on the card.

    python3 chip_smoke.py [--json PATH]   # needs one CUDA card; ~1 minute

Phases (any failure exits nonzero; nothing is caught and passed over):

1. Card and build: the card's name and power limit (nvidia-smi), then
   the five CUDA kernels built from ``horovod_tpu_torch/csrc`` with
   nvcc, one process per source started together (the ``-Xptxas -v``
   register / shared-memory lines are printed). Each bf16 tensor-core
   instantiation of the forward and backward kernels (forward, dQ,
   dK/dV at D 64 and 128: six) reports its registers and spills
   (ptxas), its dynamic shared memory and its HGMMA (wgmma)
   instructions (cuobjdump -sass); a spill, or one with no HGMMA, fails
   the run.
2. Each kernel against its plain PyTorch version on the card, f32 and
   bf16, out within TOL and lse within LSE_TOL: flash forward at the
   generate path's [4, 512, 8, 128] and at [1, 2048, 8, 128] (causal),
   GQA + window + q_offset, ragged Sk and ragged Sq = Sk, D = 64 at
   [8, 2048, 8, 64], q/k/v as strided views of one fused [8, 2048,
   3 x 8 x 128] projection, Sq = 1, Sq = 40 < 64, fully masked rows
   (k_offset past the query; they must be exactly zero) and causal
   window 4 at [1, 1024, 8, 128]. On that last case (bf16) the plain
   forward with p rounded to one bf16 before p v (`rounded_forward`, a
   planted fault) must fail the same check and the bf16 hi + lo split
   that the wgmma forward uses must hold. Flash decode (split over the
   cache, then merged) at 8 lanes: W=2048, H=8, lengths spread over
   1..2048; lengths 0, 1, on and one past the split boundaries, W - 1
   and W under Hkv 8, 2 and 1 (GQA 1, 4, 8) and at W = 1000 (not a
   multiple of the split); a length-0 lane must be exactly zero. The
   decode kernel run one key short (length - 1, a planted fault) must
   fail the same check.
2b. The paged-decode kernels (each lane's table split across the card,
   then the partials merged) against their plain version, f32 and bf16:
   8 lanes, max_len 2048, block_size 16, H=8, D=128, Hkv 8 and 2, fills
   spread over 0..2047 plus 15, 16 and 2048, each lane's table a random
   draw of pool blocks; the same 8 lanes with fills on and one before
   each boundary of the kernel's own split count; and the paged engine's
   tick geometry, 16 lanes over 1025 blocks with one free lane on the
   all-null table, with spread fills and with split-boundary fills. Each
   case logs its split count; the timed shape (8 lanes, Hkv 8) must run
   at least 2. The same call with one lane's first table entry swapped
   with the entry holding its fill (in another split, so the merge sees
   it; a planted fault) must fail the check.
2c. The two flash-backward kernels (dQ, dK/dV) against the plain
   backward on the card, f32 and bf16, on the forward kernel's saved
   (out, lse): the training path's [8, 2048, 8, 128] causal, GQA 8/2 +
   window + q_offset, ragged Sq = Sk = 1000, non-causal Sq 200 != Sk
   1000, a cotangent on lse, D = 64 at [8, 2048, 8, 64], and the path
   shape with q/k/v as strided views of one fused [8, 2048, 3 x 8 x 128]
   projection. Two planted faults must fail the same check: the plain
   dK/dV run one query row short (row 0 dropped), and (bf16, path shape)
   the plain backward with p and ds rounded to one bf16 before the
   second-stage products, which the bf16 kernels avoid by feeding them
   as bf16 hi + lo (that variant must hold).
3. Full-width `generate` (the repo's serving bench model: vocab 32768,
   12 layers, 8 heads of 128, max_len 2048, bf16, attn_impl="flash",
   decode_prefix_impl="pallas", random weights from seed 0): 4 prompts
   x 512 -> 128 greedy tokens through both kernels; teacher-forced
   last-position logits of the prefill and the first 8 ticks against
   the same model on the plain versions; the plain decode run one key
   short must fail that comparison.
3b. Teacher-forced logits on the paged primitives at the paged
   engine's geometry (same model, 16 lanes over 1025 blocks of 16
   tokens, shuffled chains): 15 prompts of 32..2041 tokens prefilled
   through `paged_prefill_chunk`, then 8 batched ticks over all 16
   lanes (live, done, free, and one at the fill == max_len boundary)
   through the paged-decode kernel, against the same run on its plain
   version; the plain version one key short (a planted fault) must
   fail the comparison, and the pools must hold rows exactly where the
   fills put them.
4. Full-width `ServingEngine`: 8 slots, 16 requests with prompts of
   32..512 tokens and 64 new tokens each; TTFT/TPOT p50 and tokens/s.
4b. Full-width paged `ServingEngine(paged=True, paged_kernel="pallas")`:
   16 slots over 1025 blocks of 16 tokens (the 8-slot fixed pool's KV
   bytes), a burst of 24 requests, each a shared 256-token system
   prompt plus a 32..256-token tail, 64 new tokens each; TTFT/TPOT p50,
   tokens/s, ticks, prefix hits, prefill tokens skipped, peak lanes.
   Then the same burst on the fixed 8-slot pool (the same KV bytes).
5. Full-width training, the repo's training configuration
   (`bench.py::run_transformer`: the same model at vocab 32768, 12
   layers, 8 heads of 128, seq 2048, bf16 compute over f32 params,
   attn_impl="flash", loss_chunk=512, AdamW(3e-4, weight decay 1e-4 as
   optax's default), batch 8): ``hvd.init()`` over NCCL at world 1,
   `DistributedOptimizer`, `init_lm_state` from seed 0, a few steps of
   `make_lm_train_step` on one fixed random batch. The loss must be
   finite and fall; step time, tokens/s and peak memory are printed;
   the forward, dQ and dK/dV kernels must each launch >= 12 x steps.
   Then one B=2 step through the kernels against the same step with
   the plain forward and backward patched in (loss and per-parameter
   gradients), and with the plain backward one query row short (a
   planted fault) that must fail the comparison.
6. A ``{"kernels": [...]}`` line (launches on the main path, CUDA-event
   times of kernel / plain version / one PyTorch library call, and the
   roofline bound), the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``. Before it: the forward kernel and
   the SDPA forward at [1, 2048, 8, 128] and [8, 2048, 8, 128] (beside
   the row's [4, 512, 8, 128]), the decode tick's split count, and the
   whole `flash_backward` (its eager dvec pass and both kernels) against
   the SDPA backward at [8, 2048, 8, 128]. The decode rows also carry
   their split count, their share of the bound and the registers and
   spills of their split and merge kernels (ptxas); the paged-decode row
   a second reading at the paged engine's tick geometry.

Launch counts: every kernel wrapper counts its launches; the counts are
set to 0 just before each main-path phase (generate, engine, paged
engine, training) and read just after. Launches made to compare or time
a kernel do not count.
``--json PATH`` also writes every number to a JSON file.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version on identical inputs, |err| <= atol + rtol *
# |ref|. f32: both sides compute in f32 and differ by summation order
# only; the readings are <= 5.4e-7 (out) and <= 9.5e-7 (lse) over up to
# 2048 keys, so 1e-5 leaves a 10x margin. bf16: the f32 results differ
# by summation order and are rounded to bf16 on both sides, so one
# rounding flip (up to 2^-7 relative) is allowed by the 1e-2 relative
# term; the 2e-3 absolute term covers outputs near 0, where the
# readings are 2.4e-4 (decode) and 1.95e-3 (forward).
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-3, 1e-2)}
LSE_TOL = 1e-5
# Teacher-forced logits, kernels vs plain versions, bf16 model: the
# residual stream is bf16 through 12 layers and every bf16 rounding
# flip of an attention output propagates; the readings are 0.0293
# (generate) and 0.0312 (paged ticks), on an H100 80GB HBM3 at 700 W.
# The plain decode run one key short (a planted fault, checked every
# run) reads 0.0929 and 0.2500 there, so the tolerance sits between
# the two. Argmax agreement (tie-aware, see `argmax_agreement`) reads
# 1.000 and 0.992 (one near-tie of 119 rows); it guards against a
# fault that moves few logits far, which the max error already sees.
LOGIT_TOL = 0.06
MIN_ARGMAX_AGREEMENT = 0.99
# Backward kernels vs the plain backward: f32 sums over up to 2048
# queries x 4 heads in another order (readings <= 1.4e-5 at |ref| <= 7.3,
# under GQA; without GQA the kernels match the plain version bit for
# bit), so 1e-5 + 1e-5 |ref|; bf16 as TOL (one rounding flip of each
# f32 result; readings <= 3.9e-3 at |ref| 8.9).
GRAD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 1e-2)}
# The training step through the kernels vs the same step on the plain
# versions (bf16 compute, 12 layers, B=2): the largest per-parameter
# max|g_kernel - g_plain| / max|g_plain| reads 7.4e-3 (bf16 roundings),
# the loss difference 7.5e-5; the plain dK/dV one query row short reads
# 0.53, so the gradient tolerance sits between the two.
STEP_GRAD_TOL = 0.05
STEP_LOSS_TOL = 1e-3
# AdamW at 3e-4 with no warmup overshoots once on the fixed batch (step
# 5 reads 10.89 after 9.81, the same within 3e-3 with the plain
# attention and with the dot attention) and then falls again: 8 steps
# end at 9.34 from 10.60.
TRAIN_STEPS = 8

REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:321",
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:630",
    "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:654",
    "flash_decode": "horovod_tpu/ops/flash_attention.py:1105",
    "paged_decode": "horovod_tpu/ops/paged_attention.py:287",
}


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events.
    A GPU spin (~30 ms) is queued first, so the host enqueues every call
    before the card reaches them: host dispatch, which exceeds the
    device time of a ~20 us call, stays out of the measurement."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def argmax_agreement(logits, ref):
    """Share of rows whose argmax under ``logits`` is a greedy choice
    of ``ref``: a token at ``ref``'s row maximum. The logits are bf16
    products (a step of 2^-6 at |logit| 2..4), so a row of ``ref`` can
    tie exactly at its top; either tied token is then its argmax, and
    comparing bare argmaxes would count the tie-break as a
    disagreement."""
    pick = logits.argmax(-1, keepdim=True)
    return float((ref.gather(-1, pick)[..., 0] == ref.amax(-1))
                 .float().mean())


def near_ties(ref):
    """(rows of ``ref`` whose top two logits lie within LOGIT_TOL, of
    which tie exactly, rows): how many argmaxes a kernel within the
    tolerance may legitimately move."""
    top = ref.topk(2, -1).values
    gap = top[..., 0] - top[..., 1]
    return (int((gap < LOGIT_TOL).sum()), int((gap == 0).sum()),
            gap.numel())


def max_err(out, ref, tol):
    """max |out - ref|, and whether every element is within
    atol + rtol * |ref| (inf must match inf)."""
    import torch
    out, ref = out.float(), ref.float()
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(out)):
        return float("inf"), False
    if fin.any():
        err = (out[fin] - ref[fin]).abs()
        ok = bool((err <= tol[0] + tol[1] * ref[fin].abs()).all())
        return float(err.max()), ok
    return 0.0, bool(torch.equal(out, ref))


def ptxas_entries(report):
    """{kernel entry: {"registers", "spill_stores", "spill_loads"}} from
    an ``nvcc -Xptxas -v`` report."""
    import re
    entries, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = entries.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return entries


def sass_counts(build, lib, opcode):
    """{kernel entry: count of ``opcode`` in its SASS} of a built library
    (cuobjdump -sass, from the toolkit whose nvcc built it); raises where
    that toolkit has no cuobjdump."""
    import pathlib
    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise build.KernelBuildError(f"{tool} not found: the bf16 kernels' "
                                     "wgmma cannot be checked")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = 0
        elif cur is not None and opcode in line:
            counts[cur] += 1
    return counts


WGMMA_SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def report_wgmma_kernels(build):
    """Phase 1: each bf16 tensor-core instantiation of the forward and
    backward kernels (registers and spills from the ptxas report,
    dynamic shared memory from its C entry, wgmma = HGMMA instructions
    in its SASS); a spill, or an instantiation with no HGMMA, fails the
    run."""
    import ctypes
    rows = {}
    for stem in WGMMA_SOURCES:
        lib = build.library(stem)
        smem = getattr(lib, f"{stem}_smem_bytes")
        smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int]
        sass = sass_counts(build, build._target(build.CSRC / f"{stem}.cu"),
                           "HGMMA")
        for name, info in ptxas_entries(build.ptxas_reports[stem]).items():
            if "wgmma" not in name:
                continue
            D = 128 if "ILi128E" in name else 64
            info = dict(info, D=D, dynamic_smem_bytes=smem(D),
                        hgmma=sass.get(name, 0))
            rows[f"{stem} bf16 D={D}"] = info
            log(f"{stem} bf16 D={D}: {info['registers']} registers, spill "
                f"stores/loads {info['spill_stores']}/{info['spill_loads']}"
                f" bytes, {info['dynamic_smem_bytes']} bytes of dynamic "
                f"shared memory, {info['hgmma']} HGMMA (wgmma) in SASS")
            if info["spill_stores"] or info["spill_loads"]:
                raise AssertionError(f"{stem} D={D} spills: {info}")
            if info["hgmma"] == 0:
                raise AssertionError(f"{stem} D={D} issues no wgmma")
    if len(rows) != 2 * len(WGMMA_SOURCES):
        raise AssertionError(f"expected {2 * len(WGMMA_SOURCES)} wgmma "
                             f"instantiations, found {sorted(rows)}")
    return rows


def check_forward_case(tfa, q, k, v, kw, dtype, name, errs):
    """The forward kernel against the plain forward on one input set;
    returns the plain (out, lse)."""
    import torch
    out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
    ref, rlse = tfa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    lerr, lok = max_err(lse, rlse, (LSE_TOL, 0.0))
    log(f"flash_fwd {dtype:8s} {name:36s} max_abs_err {err:.3e} "
        f"(tol {TOL[dtype]}) lse {lerr:.3e}")
    if not (ok and lok):
        raise AssertionError(f"flash_fwd {dtype} {name}: out err {err}, "
                             f"lse err {lerr}")
    masked = torch.isneginf(rlse).transpose(1, 2)        # [B, Sq, H]
    if masked.any() and out[masked].any():
        raise AssertionError(f"flash_fwd {dtype} {name}: a fully masked "
                             f"row is not zero")
    e = errs["flash_fwd"]
    e["lse_max_abs_err"] = max(e["lse_max_abs_err"], lerr)
    if dtype == "float32":
        e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
    elif name.startswith("path"):
        e["max_abs_err"] = err
    else:
        e["max_abs_err_other_cases"] = max(
            e.get("max_abs_err_other_cases", 0.0), err)
    return ref, rlse


# (name, (B, Sq, Sk, H, Hkv, D), kwargs, q/k/v as views of one fused
# projection)
FWD_CASES = [
    ("path [4,512,8,128] causal", (4, 512, 512, 8, 8, 128),
     dict(causal=True), False),
    ("[1,2048,8,128] causal", (1, 2048, 2048, 8, 8, 128), dict(causal=True),
     False),
    ("gqa 8/2 window 300 q_offset 256", (2, 384, 640, 8, 2, 128),
     dict(causal=True, window=300, q_offset=256), False),
    ("ragged Sk 1000 non-causal", (2, 200, 1000, 8, 8, 128), {}, False),
    ("ragged Sq=Sk=1000 causal", (2, 1000, 1000, 8, 8, 128),
     dict(causal=True), False),
    ("D=64 [8,2048,8,64] causal", (8, 2048, 2048, 8, 8, 64),
     dict(causal=True), False),
    ("fused qkv views [8,2048,8,128]", (8, 2048, 2048, 8, 8, 128),
     dict(causal=True), True),
    ("Sq=1 q_offset 2047 causal", (4, 1, 2048, 8, 8, 128),
     dict(causal=True, q_offset=2047), False),
    ("Sq=40 Sk=300 q_offset 260 causal", (2, 40, 300, 8, 2, 128),
     dict(causal=True, q_offset=260), False),
    ("fully masked rows (k_offset 10)", (2, 128, 256, 8, 8, 128),
     dict(causal=True, k_offset=10), False),
    ("window 4 causal [1,1024,8,128]", (1, 1024, 1024, 8, 8, 128),
     dict(causal=True, window=4), False),
]


def check_kernels(tfa, dev):
    """Phase 2: the forward and decode kernels against their plain
    versions on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1234)
    # Per kernel: bf16 error at the path's shapes, the largest f32 and
    # lse errors over all cases.
    errs = {"flash_fwd": {"max_abs_err_f32": 0.0, "lse_max_abs_err": 0.0},
            "flash_decode": {"max_abs_err_f32": 0.0}}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, (B, Sq, Sk, H, Hkv, D), kw, fused in FWD_CASES:
            if fused:
                q, k, v = fused_qkv(B, Sq, H, D, dev, dt, g)
                if q.is_contiguous() or k.stride(1) != 3 * H * D:
                    raise AssertionError("fused views are not strided")
            else:
                q = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
                k = torch.randn(B, Sk, Hkv, D, device=dev,
                                generator=g).to(dt)
                v = torch.randn(B, Sk, Hkv, D, device=dev,
                                generator=g).to(dt)
            ref = check_forward_case(tfa, q, k, v, kw, dtype, name, errs)
            if dtype == "bfloat16" and name.startswith("window 4"):
                check_forward_rounding_fault(tfa, (q, k, v), ref, kw, errs)
            del q, k, v, ref
    check_decode(tfa, dev, g, errs)
    return errs


def check_forward_rounding_fault(tfa, args, ref, kw, errs):
    """The check must see the precision the bf16 forward's hi/lo split
    buys: the plain forward with p rounded to one bf16 before p v (a
    planted fault) fails the check against the plain forward where rows
    attend few keys; the same with the hi + lo split holds."""
    res = {}
    for split in (False, True):
        out, _ = rounded_forward(tfa, split)(*args, **kw)
        err, ok = max_err(out, ref[0], TOL["bfloat16"])
        n_out = int(((out.float() - ref[0].float()).abs()
                     > TOL["bfloat16"][0]
                     + TOL["bfloat16"][1] * ref[0].float().abs()).sum())
        res[split] = (err, ok)
        label = ("hi + lo split" if split
                 else "planted fault (p rounded to one bf16)")
        log(f"flash_fwd bfloat16 window 4 {label} vs plain: max_abs_err "
            f"{err:.3e}, elements out of tol {n_out} of {out.numel()}")
    if res[False][1]:
        raise AssertionError("the forward check does not see p rounded to "
                             "one bf16")
    if not res[True][1]:
        raise AssertionError(f"the hi + lo split misses the plain forward: "
                             f"{res[True][0]}")
    errs["flash_fwd"]["planted_fault_rounded_err"] = res[False][0]


def decode_cases(tfa, dev):
    """(name, L, W, Hkv, lengths) of the decode check: lengths 0, 1, on
    and one past the split boundaries of the kernel's own split count,
    and W, at the path geometry, under GQA 4 and 8, and at W = 1000 (not
    a multiple of the split); plus lengths spread over 1..2048."""
    import math
    sms = tfa._sm_count(dev)
    cases = [("lengths spread", 8, 2048, 8,
              [round(1 + i * 2047 / 7) for i in range(8)])]
    for W, hkv in ((2048, 8), (2048, 2), (2048, 1), (1000, 8)):
        splits = tfa.decode_splits(W, hkv * 8, sms)
        c = math.ceil(W / splits)
        lengths = [0, 1, c, c + 1, 2 * c, min(3 * c - 1, W - 1), W - 1, W]
        cases.append((f"splits {splits} (chunk {c})", 8, W, hkv, lengths))
    return cases


def check_decode(tfa, dev, g, errs):
    """The decode kernels (split + merge) against the plain decode; the
    kernel run one key short (a planted fault) must fail the check."""
    import torch
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, L, W, hkv, lens in decode_cases(tfa, dev):
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn(L, 1, 8, 128, device=dev, generator=g).to(dt)
            kc = torch.randn(L, W, hkv, 128, device=dev, generator=g).to(dt)
            vc = torch.randn(L, W, hkv, 128, device=dev, generator=g).to(dt)
            out = tfa.flash_decode_cuda(q, kc, vc, lengths)
            splits = tfa.decode_splits(W, hkv * L, tfa._sm_count(dev))
            ref = tfa.flash_decode_plain(q, kc, vc, lengths)
            torch.cuda.synchronize()
            err, ok = max_err(out, ref, TOL[dtype])
            log(f"flash_decode {dtype:8s} {name:22s} lanes {L} W {W} H 8 "
                f"Hkv {hkv} splits {splits} lengths {lens} max_abs_err "
                f"{err:.3e}")
            if not ok:
                raise AssertionError(f"flash_decode {dtype} {name} Hkv "
                                     f"{hkv}: err {err}")
            if 0 in lens and out[lens.index(0)].any():
                raise AssertionError("flash_decode: a length-0 lane is not "
                                     "zero")
            e = errs["flash_decode"]
            if dtype == "float32":
                e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
            elif hkv == 8 and W == 2048 and name.startswith("lengths"):
                e["max_abs_err"] = err
                # The check must see an off-by-one length: the kernel
                # run one key short against the plain version.
                short = tfa.flash_decode_cuda(q, kc, vc,
                                              (lengths - 1).clamp(min=1))
                ferr, fok = max_err(short, ref, TOL[dtype])
                log(f"flash_decode planted fault (length - 1): "
                    f"max_abs_err {ferr:.3e}, caught {not fok}")
                if fok:
                    raise AssertionError("the decode check does not see "
                                         "an off-by-one length")
                e["planted_fault_err"] = ferr
            else:
                e["max_abs_err_other_cases"] = max(
                    e.get("max_abs_err_other_cases", 0.0), err)
            if W == 2048 and hkv == 8 and splits < 2:
                raise AssertionError(f"the path's decode ran {splits} "
                                     f"split(s)")


def paged_case(g, dev, dt, hkv, fills, *, bs=16, T=128, nb=None,
               free=()):
    """One paged-decode input set: one lane per fill over a pool of
    ``nb`` blocks (default: lanes x T + 1), each lane's table a random
    draw of T distinct pool blocks (lanes may share blocks, as prefix
    sharing does); the lanes in ``free`` get the all-null table of a
    free engine lane."""
    import torch
    L = len(fills)
    nb = nb or L * T + 1
    kp = torch.randn(nb, bs, hkv, 128, device=dev, generator=g).to(dt)
    vp = torch.randn(nb, bs, hkv, 128, device=dev, generator=g).to(dt)
    tables = torch.stack([
        torch.randperm(nb - 1, device=dev, generator=g)[:T] + 1
        for _ in range(L)]).int()
    tables[list(free)] = 0
    q = torch.randn(L, 8, 128, device=dev, generator=g).to(dt)
    kn = torch.randn(L, hkv, 128, device=dev, generator=g).to(dt)
    vn = torch.randn(L, hkv, 128, device=dev, generator=g).to(dt)
    fill = torch.tensor(fills, dtype=torch.int32, device=dev)
    return q, kn, vn, tables, fill, kp, vp


PAGED_FILLS = [0, 15, 16, 700, 1024, 1500, 2047, 2048]
# The paged engine's tick geometry: 16 lanes over 1025 blocks, lane 15
# free (all-null table, fill 0).
ENGINE_FILLS = [0, 15, 16, 31, 255, 256, 511, 512, 700, 1023, 1024, 1500,
                2000, 2047, 2048, 0]


def boundary_fills(tpa, dev, lanes, hkv, others, *, T=128, bs=16):
    """``lanes`` fills: on (k * c, the new row opens split k) and then one
    before (k * c - 1, split k - 1 ends at the fill and split k is empty)
    each boundary of the kernel's own split count at this geometry,
    c = ceil(T / NS) * bs positions; then fills of ``others``."""
    ns = tpa.paged_decode_splits(T, bs, hkv * lanes, tpa._sm_count(dev))
    c = -(-T // ns) * bs
    fills = ([k * c for k in range(1, ns)]
             + [k * c - 1 for k in range(1, ns)])
    return (fills + [f for f in others if f not in fills])[:lanes]


def check_paged(tpa, dev):
    """Phase 2b: the paged-decode kernels against their plain version, at
    8 lanes (Hkv 8 and 2) and at the paged engine's 16 lanes over 1025
    blocks with a free lane, each with spread fills and with fills on
    the kernel's split boundaries."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4321)
    errs = {"max_abs_err_f32": 0.0, "max_abs_err": 0.0,
            "splits_by_case": {}}
    engine = dict(nb=1025, free=(15,))
    engine_edges = boundary_fills(tpa, dev, 16, 8, ENGINE_FILLS)[:15] + [0]
    cases = [("lanes 8", PAGED_FILLS, 8, {}),
             ("lanes 8", PAGED_FILLS, 2, {}),
             ("lanes 8, split boundaries",
              boundary_fills(tpa, dev, 8, 8, PAGED_FILLS), 8, {}),
             ("lanes 8, split boundaries",
              boundary_fills(tpa, dev, 8, 2, PAGED_FILLS), 2, {}),
             ("lanes 16 over 1025 blocks, lane 15 free", ENGINE_FILLS, 8,
              engine),
             ("lanes 16 over 1025 blocks, lane 15 free, split boundaries",
              engine_edges, 8, engine)]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, fills, hkv, kw in cases:
            args = paged_case(g, dev, dt, hkv, fills, **kw)
            out = tpa.paged_decode_cuda(*args)
            ns = tpa.paged_decode_cuda.splits_last
            ref = tpa.paged_decode_plain(*args)
            torch.cuda.synchronize()
            err, ok = max_err(out, ref, TOL[dtype])
            ce = -(-128 // ns)
            log(f"paged_decode {dtype:8s} {name} max_len 2048 bs 16 H 8 "
                f"Hkv {hkv} splits {ns} ({ce} entries, {ce * 16} "
                f"positions each) fills {fills} max_abs_err {err:.3e}")
            errs["splits_by_case"][f"{name}, Hkv {hkv}"] = ns
            if not ok or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"paged_decode {dtype} {name} Hkv "
                                     f"{hkv}: err {err}")
            if name == "lanes 8" and hkv == 8 and ns < 2:
                raise AssertionError(f"the timed paged tick ran {ns} "
                                     f"split(s)")
            if dtype == "float32":
                errs["max_abs_err_f32"] = max(errs["max_abs_err_f32"], err)
            elif hkv == 8:
                errs["max_abs_err"] = max(errs["max_abs_err"], err)
            if dtype == "bfloat16" and hkv == 8 and fills is PAGED_FILLS:
                # The check must see a table fault: lane 4's first entry
                # swapped with the entry holding its fill, which lies in
                # another split, so the merge carries it (swapping two
                # wholly attended blocks would be invisible — attention
                # is a function of the SET of rotated key/value rows).
                q, kn, vn, tables, fill, kp, vp = args
                bad = tables.clone()
                j = fills[4] // 16
                bad[4, [0, j]] = tables[4, [j, 0]]
                fout = tpa.paged_decode_cuda(q, kn, vn, bad, fill, kp, vp)
                ferr, fok = max_err(fout, ref, TOL[dtype])
                log(f"paged_decode planted fault (lane 4 entries 0 and "
                    f"{j} swapped, splits 0 and {j // ce}): max_abs_err "
                    f"{ferr:.3e}, caught {not fok}")
                if fok:
                    raise AssertionError("the paged-decode check does not "
                                         "see a swapped table entry")
                errs["planted_fault_err"] = ferr
    return errs


def planted_short_backward(tfa):
    """The plain backward with query row 0 dropped from dK/dV (a planted
    fault): under causal masking that row alone attends key 0 with p =
    1, so dv_0 loses a whole dO row."""
    def short(q, k, v, o, lse, g, *, causal=False, window=None,
              q_offset=0, k_offset=0, dlse=None):
        kw = dict(causal=causal, window=window, k_offset=k_offset)
        dq = tfa.flash_backward_plain(q, k, v, o, lse, g, q_offset=q_offset,
                                      dlse=dlse, **kw)[0]
        _, dk, dv = tfa.flash_backward_plain(
            q[:, 1:], k, v, o[:, 1:], lse[:, :, 1:], g[:, 1:],
            q_offset=q_offset + 1,
            dlse=None if dlse is None else dlse[:, :, 1:], **kw)
        return dq, dk, dv
    return short


def bf16_rounding(split):
    """x rounded as a bf16 kernel feeds it to wgmma: to one bf16, or with
    ``split`` to bf16 hi + bf16 lo (hi = x rounded, lo = the rest
    rounded)."""
    def rnd(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi
    return rnd


def masked_scores(tfa, q, k, *, causal, window, q_offset, k_offset):
    """The plain versions' f32 scores (scale q) k^T [B, H, Sq, Sk] with
    k repeated over each kv head's query group and the causal / window
    mask at -inf; returns (scores, group)."""
    import torch
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qs = q.float().transpose(1, 2) * D ** -0.5
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        kp = k_offset + torch.arange(Sk, device=q.device)
        s = s.masked_fill(~tfa.banded_causal_mask(qp, kp, window),
                          float("-inf"))
    return s, group


def rounded_forward(tfa, split=False):
    """The plain forward walked in 64-key tiles with the kernel's online
    softmax (f32 running max and sum over the unrounded p), with p
    rounded before o += p v: to one bf16 (a planted fault: the usual
    tensor-core design, which the check must see), or with ``split`` to
    bf16 hi + bf16 lo, as the bf16 forward feeds it to wgmma. Returns
    (out at q.dtype, lse [B, H, Sq] f32)."""
    import torch
    rnd = bf16_rounding(split)

    def forward(q, k, v, *, causal=False, window=None, q_offset=0,
                k_offset=0):
        s, group = masked_scores(tfa, q, k, causal=causal, window=window,
                                 q_offset=q_offset, k_offset=k_offset)
        vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
        ninf = float("-inf")
        m = torch.full(s.shape[:-1] + (1,), ninf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(s.shape[:-1] + (q.shape[-1],), device=q.device)
        for k0 in range(0, s.shape[-1], 64):
            st = s[..., k0:k0 + 64]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            shift = torch.where(m_new == ninf, 0.0, m_new)
            p = torch.exp(st - shift)
            corr = torch.where(m == ninf, 0.0, torch.exp(m - shift))
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(rnd(p), vf[..., k0:k0 + 64, :])
            m = m_new
        out = acc / torch.where(l == 0, 1.0, l)
        lse = torch.where(l == 0, ninf, m + torch.log(l))[..., 0]
        return out.transpose(1, 2).to(q.dtype), lse
    return forward


def rounded_backward(tfa, split=False):
    """The plain backward with p and ds rounded before the second-stage
    products (dv = p^T dO, dq = ds k, dk = ds^T q): to one bf16 each (a
    planted fault: the obvious tensor-core design, which the check must
    see), or with ``split`` to bf16 hi + bf16 lo, as the bf16 kernels
    feed them to wgmma. Otherwise `flash_backward_plain`'s f32 math;
    returns (dq, dk, dv) at the input dtypes."""
    import torch
    rnd = bf16_rounding(split)

    def backward(q, k, v, o, lse, g, *, causal=False, window=None,
                 q_offset=0, k_offset=0, dlse=None):
        D = q.shape[-1]
        Hkv = k.shape[2]
        s, group = masked_scores(tfa, q, k, causal=causal, window=window,
                                 q_offset=q_offset, k_offset=k_offset)
        qs = q.float().transpose(1, 2) * D ** -0.5
        kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
        vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
        do = g.float().transpose(1, 2)
        row = lse.float()[..., None]
        p = torch.where(torch.isfinite(row), torch.exp(s - row),
                        torch.zeros_like(s))
        dvec = (do * o.float().transpose(1, 2)).sum(-1)
        if dlse is not None:
            dvec = dvec - dlse.float()
        ds = rnd(p * (torch.matmul(do, vf.transpose(-1, -2))
                      - dvec[..., None]))
        p = rnd(p)
        dq = torch.matmul(ds, kf) * D ** -0.5
        dk = torch.matmul(ds.transpose(-1, -2), qs).unflatten(
            1, (Hkv, group)).sum(2)
        dv = torch.matmul(p.transpose(-1, -2), do).unflatten(
            1, (Hkv, group)).sum(2)
        return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype))
    return backward


def fused_qkv(B, S, H, D, dev, dt, g):
    """q, k, v as strided [B, S, H, D] views of one fused [B, S, 3 H D]
    projection output, the layout the model hands to attention
    (`parallel/tensor.py`): no contiguous copies."""
    import torch
    qkv = torch.randn(B, S, 3 * H * D, device=dev, generator=g).to(dt)
    return [t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1)]


def check_backward(tfa, dev):
    """Phase 2c: the dQ and dK/dV kernels against the plain backward on
    the forward kernel's saved (out, lse)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(2468)
    errs = {n: {"max_abs_err_f32": 0.0} for n in ("flash_bwd_dq",
                                                  "flash_bwd_dkv")}
    # (name, (B, Sq, Sk, H, Hkv, D), kwargs, cotangent on lse, q/k/v as
    # views of one fused projection)
    cases = [
        ("path [8,2048,8,128] causal", (8, 2048, 2048, 8, 8, 128),
         dict(causal=True), False, False),
        ("gqa 8/2 window 300 q_offset 256", (2, 384, 640, 8, 2, 128),
         dict(causal=True, window=300, q_offset=256), False, False),
        ("ragged Sq=Sk=1000 causal", (2, 1000, 1000, 8, 8, 128),
         dict(causal=True), False, False),
        ("non-causal Sq 200 Sk 1000", (2, 200, 1000, 8, 8, 128), {}, False,
         False),
        ("dlse cotangent, gqa 8/2 causal", (2, 512, 512, 8, 2, 128),
         dict(causal=True), True, False),
        ("D=64 [8,2048,8,64] causal", (8, 2048, 2048, 8, 8, 64),
         dict(causal=True), False, False),
        ("fused qkv views [8,2048,8,128]", (8, 2048, 2048, 8, 8, 128),
         dict(causal=True), False, True),
    ]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tol = GRAD_TOL[dtype]
        for name, (B, Sq, Sk, H, Hkv, D), kw, with_dlse, fused in cases:
            if fused:
                q, k, v = fused_qkv(B, Sq, H, D, dev, dt, g)
                if q.is_contiguous() or k.stride(1) != 3 * H * D:
                    raise AssertionError("fused views are not strided")
            else:
                q = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
                k = torch.randn(B, Sk, Hkv, D, device=dev,
                                generator=g).to(dt)
                v = torch.randn(B, Sk, Hkv, D, device=dev,
                                generator=g).to(dt)
            go = torch.randn(B, Sq, H, D, device=dev, generator=g).to(dt)
            out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
            dlse = (torch.randn(B, H, Sq, device=dev, generator=g)
                    if with_dlse else None)
            got = tfa.flash_backward(q, k, v, out, lse, go, dlse=dlse, **kw)
            ref = tfa.flash_backward_plain(q, k, v, out, lse, go, dlse=dlse,
                                           **kw)
            torch.cuda.synchronize()
            res = [max_err(a, b, tol) for a, b in zip(got, ref)]
            log(f"flash_bwd {dtype:8s} {name:32s} max_abs_err dq "
                f"{res[0][0]:.3e} dk {res[1][0]:.3e} dv {res[2][0]:.3e} "
                f"(tol {tol}), |ref| max "
                f"{max(float(b.float().abs().max()) for b in ref):.3f}")
            if not all(ok for _, ok in res):
                raise AssertionError(f"flash_bwd {dtype} {name}: {res}")
            for kern, err in (("flash_bwd_dq", res[0][0]),
                              ("flash_bwd_dkv", max(res[1][0], res[2][0]))):
                e = errs[kern]
                if dtype == "float32":
                    e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
                elif name.startswith("path"):
                    e["max_abs_err"] = err
                else:
                    e["max_abs_err_other_cases"] = max(
                        e.get("max_abs_err_other_cases", 0.0), err)
            if name.startswith("path"):
                # The check must see a dK/dV one query row short.
                bad = planted_short_backward(tfa)(q, k, v, out, lse, go,
                                                  **kw)
                fres = [max_err(a, b, tol) for a, b in zip(got[1:],
                                                             bad[1:])]
                ferr = max(e for e, _ in fres)
                caught = not all(ok for _, ok in fres)
                log(f"flash_bwd {dtype} planted fault (plain dK/dV one "
                    f"query row short): max_abs_err {ferr:.3e}, caught "
                    f"{caught}")
                if not caught:
                    raise AssertionError("the backward check does not see "
                                         "a dK/dV one query row short")
                errs["flash_bwd_dkv"][f"planted_fault_err_{dtype}"] = ferr
            if name.startswith("path") and dtype == "bfloat16":
                check_rounding_fault(tfa, (q, k, v, out, lse, go), ref, kw,
                                     tol, errs)
            del q, k, v, go, out, lse, got, ref
    return errs


def check_rounding_fault(tfa, args, ref, kw, tol, errs):
    """The check must see the precision the bf16 kernels' hi/lo split
    buys: the plain backward with p and ds rounded to one bf16 before the
    second-stage products (a planted fault) fails the check against the
    plain backward; the same with the hi + lo split holds."""
    counts = {}
    for split in (False, True):
        got = rounded_backward(tfa, split)(*args, **kw)
        res = [max_err(a, b, tol) for a, b in zip(got, ref)]
        out = [int(((a.float() - b.float()).abs()
                    > tol[0] + tol[1] * b.float().abs()).sum())
               for a, b in zip(got, ref)]
        counts[split] = res
        label = ("hi + lo split" if split
                 else "planted fault (p, ds rounded to one bf16)")
        log(f"flash_bwd bfloat16 {label} vs plain: max_abs_err dq "
            f"{res[0][0]:.3e} dk {res[1][0]:.3e} dv {res[2][0]:.3e}, "
            f"elements out of tol (dq, dk, dv) {out} of "
            f"{got[0].numel()}")
        del got
    if all(ok for _, ok in counts[False]):
        raise AssertionError("the backward check does not see p and ds "
                             "rounded to one bf16")
    if not all(ok for _, ok in counts[True]):
        raise AssertionError(f"the hi + lo split misses the plain "
                             f"backward: {counts[True]}")
    errs["flash_bwd_dq"]["planted_fault_rounded_err"] = counts[False][0][0]
    errs["flash_bwd_dkv"]["planted_fault_rounded_err"] = max(
        counts[False][1][0], counts[False][2][0])


def paged_bound(fill, L, H, Hkv, D, T, bs):
    """(ms, "bytes" | "operations"): the least time of a bf16 paged tick
    over these fills. Each lane needs its positions [0, npos), npos =
    min(fill + 1, T * bs): npos - 1 pool rows and k_new / v_new where
    fill < T * bs (else T * bs pool rows), K and V; its q and out; and
    the ceil(npos / bs) table entries that cover them, and its fill."""
    fills = [int(f) for f in fill.tolist()]
    span = T * bs
    npos = [min(f + 1, span) for f in fills]
    row = Hkv * D * 2 * 2                            # one K + V row, bf16
    nbytes = (sum(npos) * row + 2 * L * H * D * 2
              + sum(-(-n // bs) for n in npos) * 4 + L * 4)
    flops = 4.0 * sum(npos) * H * D
    t_flop, t_byte = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_flop, t_byte) * 1e3,
            "operations" if t_flop >= t_byte else "bytes")


def kernel_resources(stem):
    """{"<kernel> <dtype> D=<d>[ GRP=<g>]": {"registers", "spill_stores",
    "spill_loads"}} of every split and merge kernel instantiation in the
    ptxas report of ``csrc/<stem>.cu``."""
    import re
    from horovod_tpu_torch.ops import _build
    rows = {}
    for name, info in ptxas_entries(_build.ptxas_reports[stem]).items():
        m = re.search(r"(paged_decode_split|flash_decode_split|decode_merge)"
                      r"I(13__nv_bfloat16|f)"
                      r"((?:Li\d+E)+)", name)
        if not m:
            continue
        dims = re.findall(r"Li(\d+)E", m.group(3))
        key = (f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'} "
               f"D={dims[0]}" + (f" GRP={dims[1]}" if len(dims) > 1 else ""))
        rows[key] = info
    return rows


def path_resources(row):
    """The decode rows' extra keys for the kernels line: the timed tick's
    split count and share of its bound, and the registers and spills of
    the instantiations the path runs (bf16, D = 128, one query head a kv
    head, and the merge)."""
    if "resources" not in row:
        return {}
    return dict(splits=row["splits"], bound_share=row["bound_share"],
                resources={k: v for k, v in row["resources"].items()
                           if "bf16 D=128" in k
                           and ("GRP=1" in k or "merge" in k)})


def time_decode_kernels(tfa, dev, g):
    """The two decode ticks, bf16: flash decode at 8 lanes x 2048 and the
    paged decode at 8 lanes x 2048 positions and at the paged engine's
    tick geometry; kernel, plain-version and library times, the bound
    and its share, split counts, and the split and merge kernels'
    registers and spills."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import paged_attention as tpa
    bf = torch.bfloat16
    H, D = 8, 128
    L, W, Hkv = 8, 2048, 8           # the engine's 8 slots, full caches
    q1 = torch.randn(L, 1, H, D, device=dev, generator=g).to(bf)
    kc = torch.randn(L, W, Hkv, D, device=dev, generator=g).to(bf)
    vc = torch.randn(L, W, Hkv, D, device=dev, generator=g).to(bf)
    length = torch.full((L,), W, dtype=torch.int32, device=dev)
    qd, kd, vd = (t.transpose(1, 2).contiguous() for t in (q1, kc, vc))
    need = int(length.sum().item())                  # positions read
    nbytes = need * Hkv * D * 2 * 2 + 2 * L * H * D * 2
    flops = 4.0 * need * H * D
    t_flop, t_byte = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    rows = {}
    rows["flash_decode"] = dict(
        shape=[L, W, H, Hkv, D], dtype="bfloat16", lengths=W,
        ms=cuda_time_ms(lambda: tfa.flash_decode_cuda(q1, kc, vc, length),
                        iters=50),
        splits=tfa.decode_splits(W, Hkv * L, tfa._sm_count(dev)),
        plain_ms=cuda_time_ms(
            lambda: tfa.flash_decode_plain(q1, kc, vc, length)),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd), iters=50),
        bound_ms=max(t_flop, t_byte) * 1e3,
        bound_by="operations" if t_flop >= t_byte else "bytes",
        library="torch.nn.functional.scaled_dot_product_attention "
                "(equal lengths)",
        resources=kernel_resources("flash_decode"))
    rows["flash_decode"]["bound_share"] = (rows["flash_decode"]["bound_ms"]
                                           / rows["flash_decode"]["ms"])

    # The paged tick at 8 lanes, each attending 2048 positions (fill
    # 2047: 2047 pool rows through shuffled tables + the merged row).
    bs, T = 16, W // 16
    args8 = paged_case(g, dev, bf, Hkv, [W - 1] * L, bs=bs, T=T)
    q8, kn, vn, tables, fill, kp, vp = args8
    qg = q8[:, :, None]                              # [L, H, 1, D]

    def gather_sdpa():
        kg = kp[tables.long()].flatten(1, 2).transpose(1, 2)
        vg = vp[tables.long()].flatten(1, 2).transpose(1, 2)
        return F.scaled_dot_product_attention(qg, kg, vg)

    ms = cuda_time_ms(lambda: tpa.paged_decode_cuda(*args8), iters=50)
    bound_ms, bound_by = paged_bound(fill, L, H, Hkv, D, T, bs)
    rows["paged_decode"] = dict(
        shape=[L, W, H, Hkv, D], dtype="bfloat16", block_size=bs,
        fill=W - 1, ms=ms, splits=tpa.paged_decode_cuda.splits_last,
        plain_ms=cuda_time_ms(lambda: tpa.paged_decode_plain(*args8),
                              iters=5, warmup=1),
        library_ms=cuda_time_ms(gather_sdpa, iters=50),
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
        library="k_pool[table] gather + scaled_dot_product_attention "
                "(two calls: no single PyTorch call reads through a "
                "block table)",
        resources=kernel_resources("paged_decode"))
    # The paged engine's tick geometry: 16 lanes over 1025 blocks, lane
    # 15 free (no single library call serves ragged fills).
    argse = paged_case(g, dev, bf, Hkv, ENGINE_FILLS, bs=bs, T=T, nb=1025,
                       free=(15,))
    ms = cuda_time_ms(lambda: tpa.paged_decode_cuda(*argse), iters=50)
    bound_ms, bound_by = paged_bound(argse[4], 16, H, Hkv, D, T, bs)
    rows["paged_decode"]["at_engine"] = dict(
        lanes=16, fills=ENGINE_FILLS, blocks=1025,
        positions=sum(min(f + 1, T * bs) for f in ENGINE_FILLS), ms=ms,
        splits=tpa.paged_decode_cuda.splits_last, bound_ms=bound_ms,
        bound_by=bound_by, bound_share=bound_ms / ms)
    return rows


def time_kernels(tfa, dev):
    """Kernel, plain-version and library times at the path's shapes,
    and the roofline bound computed from these inputs."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(99)
    bf = torch.bfloat16
    rows = {}

    B, S, H, D = 4, 512, 8, 128      # generate's prefill
    q, k, v = (torch.randn(B, S, H, D, device=dev, generator=g).to(bf)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 2.0 * S * S * D * H * B                  # causal: half of 4*S^2*D
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4   # q,k,v,out + lse
    t_flop, t_byte = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    rows["flash_fwd"] = dict(
        shape=[B, S, H, D], dtype="bfloat16",
        ms=cuda_time_ms(lambda: tfa.flash_fwd_cuda(q, k, v, causal=True)),
        plain_ms=cuda_time_ms(
            lambda: tfa.flash_attention_plain(q, k, v, causal=True)),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound_ms=max(t_flop, t_byte) * 1e3,
        bound_by="operations" if t_flop >= t_byte else "bytes",
        library="torch.nn.functional.scaled_dot_product_attention")

    rows.update(time_decode_kernels(tfa, dev, g))

    # One 2048-token sequence: the compute-bound reference shape.
    B2, S2 = 1, 2048
    q2, k2, v2 = (torch.randn(B2, S2, H, D, device=dev, generator=g).to(bf)
                  for _ in range(3))
    ms2 = cuda_time_ms(lambda: tfa.flash_fwd_cuda(q2, k2, v2, causal=True))
    flops2 = 2.0 * S2 * S2 * D * H * B2
    qt2, kt2, vt2 = (t.transpose(1, 2).contiguous() for t in (q2, k2, v2))
    rows["flash_fwd"]["at_1x2048"] = dict(
        ms=ms2, bound_ms=max(flops2 / PEAK_BF16_FLOPS,
                             4 * B2 * S2 * H * D * 2 / PEAK_BYTES) * 1e3,
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt2, kt2, vt2, is_causal=True)))

    # The training step's attention, [8, 2048, 8, 128] bf16 causal.
    B3, S3 = 8, 2048
    q3, k3, v3, g3 = (torch.randn(B3, S3, H, D, device=dev,
                                  generator=g).to(bf) for _ in range(4))
    o3, lse3 = tfa.flash_fwd_cuda(q3, k3, v3, causal=True)
    dvec3 = (g3.float() * o3.float()).sum(-1).transpose(1, 2).contiguous()
    prod = 2.0 * S3 * S3 * D * H * B3 / 2    # one causal [S,D]x[D,S] product
    tensor = B3 * S3 * H * D * 2             # one [B, S, H, D] bf16 tensor
    rowv = 2 * B3 * H * S3 * 4               # lse and dvec, f32
    ms3 = cuda_time_ms(lambda: tfa.flash_fwd_cuda(q3, k3, v3, causal=True),
                       iters=10)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q3, k3, v3))
    rows["flash_fwd"]["at_8x2048"] = dict(
        ms=ms3, bound_ms=max(2 * prod / PEAK_BF16_FLOPS,
                             (4 * tensor + rowv / 2) / PEAK_BYTES) * 1e3,
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), iters=10))
    plain_ms = cuda_time_ms(lambda: tfa.flash_backward_plain(
        q3, k3, v3, o3, lse3, g3, causal=True), iters=3, warmup=1)
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    gs = g3.transpose(1, 2).contiguous()
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        os_, (qs, ks, vs), gs, retain_graph=True), iters=10)
    # The whole backward as the training step runs it (the eager dvec
    # pass, then both kernels) against the SDPA backward, which also
    # computes its own rowsum(dO * O).
    rows["flash_backward"] = dict(
        shape=[B3, S3, H, D], dtype="bfloat16",
        ms=cuda_time_ms(lambda: tfa.flash_backward(
            q3, k3, v3, o3, lse3, g3, causal=True), iters=10),
        library_ms=lib_ms)
    kw = dict(causal=True)
    # The function's own products: dQ = s, dp, ds k; dK/dV = s, dp,
    # p^T dO, ds^T q. The bf16 kernels run ds k (dQ), and p^T dO and
    # ds^T q (dK/dV), twice each (bf16 hi + lo): that is a choice of
    # implementation, not work the function needs, so it is not bound.
    for name, fn, nprod, nbytes in (
            ("flash_bwd_dq", lambda: tfa.flash_bwd_dq_cuda(
                q3, k3, v3, g3, lse3, dvec3, **kw), 3, 5 * tensor + rowv),
            ("flash_bwd_dkv", lambda: tfa.flash_bwd_dkv_cuda(
                q3, k3, v3, g3, lse3, dvec3, **kw), 4, 6 * tensor + rowv)):
        t_flop, t_byte = nprod * prod / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        rows[name] = dict(
            shape=[B3, S3, H, D], dtype="bfloat16",
            ms=cuda_time_ms(fn, iters=20), plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=max(t_flop, t_byte) * 1e3,
            bound_by="operations" if t_flop >= t_byte else "bytes",
            library="backward of scaled_dot_product_attention(is_causal="
                    "True) through torch.autograd.grad: dQ, dK and dV in "
                    "one call, the same number in both backward rows; the "
                    "plain time is flash_backward_plain, which also "
                    "computes all three")
    return rows


class plain_training_attention:
    """Context: `FlashAttentionFn` runs the PLAIN forward and backward
    on the card (the comparison model; the port itself never does), or
    with ``backward`` in place of the plain backward (a planted
    fault)."""

    def __init__(self, tfa, backward=None):
        self.tfa = tfa
        self.backward = backward or tfa.flash_backward_plain

    def __enter__(self):
        tfa = self.tfa
        self.saved = (tfa._flash_forward, tfa.flash_backward)

        def forward(q, k, v, causal, window, q_offset, k_offset):
            return tfa.flash_attention_plain(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                k_offset=k_offset)
        tfa._flash_forward = forward
        tfa.flash_backward = self.backward
        return self

    def __exit__(self, *exc):
        self.tfa._flash_forward, self.tfa.flash_backward = self.saved


def run_training(tfa, dev):
    """Phase 5: the repo's training configuration at full width, data
    parallel over NCCL at world 1, then one B=2 step through the
    kernels against the plain versions."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      init_lm_state,
                                                      make_lm_train_step)
    from horovod_tpu_torch.ops.fusion import fused_allreduce_leaves
    hvd.init()
    try:
        probe = torch.arange(4.0, device=dev)
        if not torch.equal(fused_allreduce_leaves([probe])[0], probe):
            raise AssertionError("world-1 NCCL allreduce changed its input")
        model = TransformerLM(32768, 12, 8, 128, max_len=2048,
                              dtype=torch.bfloat16, attn_impl="flash",
                              device=dev)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))
        init_lm_state(model, opt, seed=0)
        step = make_lm_train_step(model, opt, loss_chunk=512)
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, 32768, (8, 2048))).to(dev)
        wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                    "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                    "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.time()
            loss = step(tokens)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(float(loss))
        launches = {k: fn.launches for k, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        steady = sorted(times[1:])[len(times[1:]) // 2]
        # bench.py's estimate: 6 N per token for the matmuls plus the
        # causal attention term 6 L S d.
        n_params = sum(p.numel() for p in model.parameters())
        flops_per_token = 6 * n_params + 6 * 12 * 2048 * 1024
        mfu = flops_per_token * 8 * 2048 / steady / PEAK_BF16_FLOPS
        info = dict(steps=TRAIN_STEPS, losses=losses, step_s=times,
                    step_ms_median_after_first=steady * 1e3,
                    tokens_per_s=8 * 2048 / steady, mfu=mfu,
                    max_memory_allocated=peak, launches=launches)
        log(f"training B=8 x 2048, {TRAIN_STEPS} AdamW steps: losses "
            f"{[round(x, 4) for x in losses]}, step s "
            f"{[round(t, 4) for t in times]}, median after the first "
            f"{steady * 1e3:.1f} ms = {8 * 2048 / steady:.0f} tokens/s, "
            f"MFU {mfu:.4f} of 989 TFLOP/s, peak memory "
            f"{peak / 1e9:.2f} GB, launches {launches}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"training loss not finite and falling: "
                                 f"{losses}")
        for k, n in launches.items():
            if n < model.num_layers * TRAIN_STEPS:
                raise AssertionError(f"{k} launched {n} < "
                                     f"{model.num_layers} x {TRAIN_STEPS}")
        info.update(check_train_step(model, tfa, tokens[:2]))
        return info
    finally:
        hvd.shutdown()


def check_train_step(model, tfa, tokens):
    """Loss and every parameter's gradient of one step through the
    kernels against the same step on the plain versions, and against
    the plain backward one query row short (a planted fault)."""
    import torch
    from horovod_tpu_torch.models.transformer import _lm_data_loss

    def grads():
        model.zero_grad(set_to_none=True)
        loss = _lm_data_loss(model, tokens, 512)
        loss.backward()
        return float(loss.detach()), [p.grad.clone()
                                      for p in model.parameters()]

    k_loss, k_grads = grads()
    with plain_training_attention(tfa):
        p_loss, p_grads = grads()
    with plain_training_attention(tfa, planted_short_backward(tfa)):
        f_loss, f_grads = grads()
    model.zero_grad(set_to_none=True)

    def worst(gs):
        return max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(gs, p_grads))

    err, ferr = worst(k_grads), worst(f_grads)
    names = [n for n, _ in model.named_parameters()]
    per = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for n, a, b in zip(names, k_grads, p_grads)}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    log(f"train step B=2, kernels vs plain: loss {k_loss:.6f} vs "
        f"{p_loss:.6f} (|diff| {abs(k_loss - p_loss):.2e}, tol "
        f"{STEP_LOSS_TOL}), worst per-parameter gradient error "
        f"{err:.3e} (tol {STEP_GRAD_TOL}; top {top})")
    log(f"train step B=2, planted fault (plain dK/dV one query row short) "
        f"vs plain: worst per-parameter gradient error {ferr:.3e}, loss "
        f"|diff| {abs(f_loss - p_loss):.2e}")
    if abs(k_loss - p_loss) > STEP_LOSS_TOL or err > STEP_GRAD_TOL:
        raise AssertionError(f"train step through the kernels differs: "
                             f"loss {k_loss} vs {p_loss}, grad err {err}")
    if ferr <= STEP_GRAD_TOL:
        raise AssertionError(f"the train-step check does not see a dK/dV "
                             f"one query row short ({ferr})")
    return dict(check_loss=k_loss, check_plain_loss=p_loss,
                check_grad_err=err, check_planted_fault_grad_err=ferr)


def teacher_forced_logits(model, prompt, forced, n_ticks):
    """Last-position logits of the prefill and ``n_ticks`` decode ticks
    fed the tokens ``forced`` [B, >= n_ticks]."""
    import torch
    from horovod_tpu_torch.models.transformer import init_cache
    cache = init_cache(model, prompt.shape[0])
    outs = []
    toks = prompt
    for t in range(n_ticks + 1):
        hidden, head = model(toks, cache, return_hidden=True)
        cache.index += toks.shape[1]
        outs.append((hidden[:, -1] @ head.to(hidden.dtype).T).float())
        toks = forced[:, t:t + 1]
    return torch.stack(outs, 1)


class plain_attention:
    """Context: the model's attention runs the kernels' PLAIN versions
    on the card (the comparison model; the port itself never does).
    ``decode`` replaces the plain decode (a planted fault)."""

    def __init__(self, model, tfa, decode=None):
        self.model, self.tfa = model, tfa
        self.decode = decode or tfa.flash_decode_plain

    def __enter__(self):
        tfa = self.tfa

        def fwd(q, k, v, m):
            return tfa.flash_attention_plain(q, k, v, causal=True)[0]
        fwd.native_gqa = True
        self.saved = [(b.attn, b.attn.attn_fn) for b in self.model.blocks]
        for attn, _ in self.saved:
            attn.attn_fn = fwd
        self.saved_decode = tfa.flash_decode_attention
        tfa.flash_decode_attention = self.decode
        return self

    def __exit__(self, *exc):
        for attn, fn in self.saved:
            attn.attn_fn = fn
        self.tfa.flash_decode_attention = self.saved_decode


def run_generate(model, tfa, dev):
    """Phase 3: full-width generate through both kernels."""
    import torch
    from horovod_tpu_torch.models.transformer import generate
    g = torch.Generator(device=dev).manual_seed(7)
    prompt = torch.randint(0, model.vocab_size, (4, 512), device=dev,
                           generator=g)
    torch.cuda.synchronize()
    tfa.flash_fwd_cuda.launches = 0
    tfa.flash_decode_cuda.launches = 0
    t0 = time.time()
    out = generate(model, prompt, 128)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"flash_fwd": tfa.flash_fwd_cuda.launches,
                "flash_decode": tfa.flash_decode_cuda.launches}
    log(f"generate 4x512 -> 128 greedy: {dt:.3f} s wall, "
        f"launches {launches}")
    if out.shape != (4, 640) or not bool((out >= 0).all()) \
            or not bool((out < model.vocab_size).all()):
        raise AssertionError(f"generate output {tuple(out.shape)} invalid")
    want = {"flash_fwd": model.num_layers,
            "flash_decode": 127 * model.num_layers}
    if launches != want:
        raise AssertionError(f"generate launches {launches} != {want}")
    gen = out[:, 512:]
    def one_key_short(q, k, v, length):
        return tfa.flash_decode_plain(q, k, v, length - 1)

    with torch.no_grad():
        k_logits = teacher_forced_logits(model, prompt, gen, 8)
        with plain_attention(model, tfa):
            p_logits = teacher_forced_logits(model, prompt, gen, 8)
        with plain_attention(model, tfa, decode=one_key_short):
            f_logits = teacher_forced_logits(model, prompt, gen, 8)
    torch.cuda.synchronize()
    err = float((k_logits - p_logits).abs().max())
    agree = argmax_agreement(k_logits, p_logits)
    fault_err = float((f_logits - p_logits).abs().max())
    fault_agree = argmax_agreement(f_logits, p_logits)
    finite = bool(torch.isfinite(k_logits).all())
    log(f"teacher-forced logits (prefill + 8 ticks), kernels vs plain: "
        f"max_abs_err {err:.4f} (tol {LOGIT_TOL}), argmax agreement "
        f"{agree:.3f} (min {MIN_ARGMAX_AGREEMENT}), |logit| max "
        f"{float(p_logits.abs().max()):.3f}")
    log(f"teacher-forced logits, planted decode fault (length - 1) vs "
        f"plain: max_abs_err {fault_err:.4f}, argmax agreement "
        f"{fault_agree:.3f}")
    if not finite or err > LOGIT_TOL:
        raise AssertionError(f"generate logits differ: {err}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"generate argmax agreement {agree}")
    if fault_err <= LOGIT_TOL:
        raise AssertionError(f"the logits check does not see an "
                             f"off-by-one decode length ({fault_err})")
    if not torch.equal(k_logits.argmax(-1)[:, :-1], gen[:, :8]):
        raise AssertionError("generate's greedy tokens are not the argmax "
                             "of its own teacher-forced logits")
    return dict(seconds=dt, launches=launches, logits_max_abs_err=err,
                argmax_agreement=agree, planted_fault_logits_err=fault_err,
                planted_fault_argmax_agreement=fault_agree)


def serve_burst(model, prompts, new, kernels, **engine_kw):
    """Submit ``prompts`` as one burst to a warmed `ServingEngine`
    (``new`` tokens each) and wait for all of them. The launch counts
    of ``kernels`` ({name: wrapper}) are set to 0 just before the burst
    and read just after it. Returns (results, snapshot, seconds,
    launches, KV bytes of the pool)."""
    import torch
    from horovod_tpu_torch.serving import ServingEngine
    with ServingEngine(model, max_queue=len(prompts), warmup=True,
                       **engine_kw) as eng:
        pool = eng.pool
        leaves = ([t for pair in pool._pools for t in pair]
                  if engine_kw.get("paged") else
                  pool._cache.k + pool._cache.v)
        kv_bytes = sum(t.numel() * t.element_size() for t in leaves)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
            if hasattr(fn, "splits_last"):
                fn.splits_last = None
        t0 = time.time()
        handles = [eng.submit(p, new) for p in prompts]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        splits = {k: fn.splits_last for k, fn in kernels.items()
                  if getattr(fn, "splits_last", None) is not None}
        snap = eng.metrics_snapshot()
    for r in results:
        if len(r.tokens) != new or r.finish_reason != "length":
            raise AssertionError(f"request {r.request_id}: "
                                 f"{len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
        if not ((r.tokens >= 0) & (r.tokens < model.vocab_size)).all():
            raise AssertionError(f"request {r.request_id}: bad token ids")
    tokens = sum(len(r.tokens) for r in results)
    return dict(seconds=dt, ticks=snap["ticks"], launches=launches,
                splits=splits, completed=snap["completed"], tokens=tokens,
                tokens_per_s=tokens / dt,
                ttft_ms_p50=snap["ttft_ms"]["p50"],
                tpot_ms_p50=snap["tpot_ms"]["p50"],
                prefix_hits=snap["prefix_hits"],
                prefill_tokens_skipped=snap["prefill_tokens_skipped"],
                peak_active=snap["peak_active"], kv_bytes=kv_bytes,
                prompt_tokens=int(sum(len(p) for p in prompts)))


def run_engine(model, kernels):
    """Phase 4: full-width ServingEngine, 8 slots, 16 requests."""
    import numpy as np
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, model.vocab_size, (int(n),))
               for n in rs.randint(32, 513, 16)]
    info = serve_burst(model, prompts, 64, kernels, num_slots=8)
    launches, ticks = info["launches"], info["ticks"]
    if launches["flash_decode"] < ticks * model.num_layers:
        raise AssertionError(f"decode launches {launches['flash_decode']}"
                             f" < ticks {ticks} x {model.num_layers}")
    return info


class plain_paged_decode:
    """Context: the paged S=1 attention runs ``fn`` on the card instead
    of the kernel: its PLAIN version (the walk at the block size, the
    comparison model) by default, or a planted fault."""

    def __init__(self, tpa, fn=None):
        self.tpa = tpa
        self.fn = fn or tpa.paged_decode_plain

    def __enter__(self):
        self.saved = self.tpa.paged_decode_attention
        self.tpa.paged_decode_attention = self.fn
        return self

    def __exit__(self, *exc):
        self.tpa.paged_decode_attention = self.saved


def paged_teacher_forced(model, tpa, dev):
    """Phase 3b: teacher-forced logits on the paged primitives, the
    paged-decode kernel vs its plain version, at the paged engine's
    geometry: 16 lanes over 1025 blocks of 16 tokens, each lane's chain
    of blocks a random draw with the rest of its table null. Lanes
    0..12 are prefilled in 128-token chunks (`paged_prefill_chunk`)
    and then live; lane 12 ends its ticks at the fill == max_len
    boundary. Lanes 13 and 14 are prefilled and done, lane 15 is free.
    Then 8 teacher-forced ticks over all 16 lanes as ONE batched call
    each (`paged_decode_logits`, the engine tick's model half). The
    plain decode run one key short (a planted fault) must fail the
    same comparison, and the pools must hold rows exactly where the
    lanes' fills put them: no write of a done, free or boundary lane
    reaches a real block."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import transformer as tt
    g = torch.Generator(device=dev).manual_seed(11)
    L, n_ticks, bs, nb, chunk = 16, 8, 16, 1025, 128
    W = model.max_len
    lens = [32, 47, 100, 128, 200, 255, 256, 300, 384, 420, 511, 512,
            W - n_ticks + 1, 160, 96, 0]
    live = torch.tensor([n > 0 for n in lens], device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    done[[13, 14]] = True
    adv = (live & ~done).cpu().numpy()
    final = [min(n + n_ticks, W) if adv[b] else n
             for b, n in enumerate(lens)]
    spec = tt.paged_cache_spec(model, bs)
    perm = (torch.randperm(nb - 1, generator=torch.Generator()
                           .manual_seed(11)) + 1).tolist()
    tables = torch.zeros(L, spec.blocks_per_seq, dtype=torch.int32)
    written = np.zeros((nb, bs), bool)      # rows filled after the ticks
    prefilled = np.zeros((nb, bs), bool)    # rows filled before them
    off = 0
    for b, n in enumerate(lens):
        need = -(-final[b] // bs)
        chain = perm[off:off + need]
        off += need
        tables[b, :need] = torch.tensor(chain, dtype=torch.int32)
        for p in range(final[b]):
            written[chain[p // bs], p % bs] = True
            prefilled[chain[p // bs], p % bs] = p < n
    tables = tables.to(dev)
    prompt = torch.randint(0, model.vocab_size, (L, max(lens)), device=dev,
                           generator=g)
    forced = torch.randint(0, model.vocab_size, (L, n_ticks), device=dev,
                           generator=g)

    def run(snapshot=False):
        pools = tt.init_paged_pools(model, spec, nb)
        fills = torch.zeros(L, dtype=torch.int32, device=dev)
        outs = []
        for b, n in enumerate(lens):
            for o in range(0, n, chunk):
                last = tt.paged_prefill_chunk(
                    model, spec, pools, tables, fills, b,
                    prompt[b, o:min(o + chunk, n)], paged_kernel="pallas",
                    fill=o)
            if n:
                outs.append(last)
        snap = ([(k.clone(), v.clone()) for k, v in pools] if snapshot
                else None)
        ticks = [tt.paged_decode_logits(
            model, spec, pools, tables, fills, forced[:, t], live, done,
            paged_kernel="pallas", prefix_len=max(lens) + t + 1)
            for t in range(n_ticks)]
        return torch.stack(outs), torch.stack(ticks, 1), pools, fills, snap

    def one_key_short(q, k_new, v_new, table, fill, k_pool, v_pool):
        return tpa.paged_decode_plain(q, k_new, v_new, table,
                                      (fill - 1).clamp(min=0), k_pool,
                                      v_pool)

    sel = torch.from_numpy(adv).to(dev)

    def compared(run_out):
        pre, ticks = run_out[:2]
        return torch.cat([pre.flatten(0, -2), ticks[sel].flatten(0, -2)])

    with torch.no_grad():
        before = tpa.paged_decode_cuda.launches
        k_out = run(snapshot=True)
        launched = tpa.paged_decode_cuda.launches - before
        with plain_paged_decode(tpa):
            p_out = run()
        with plain_paged_decode(tpa, one_key_short):
            f_out = run()
    torch.cuda.synchronize()
    if launched != n_ticks * model.num_layers:
        raise AssertionError(f"paged teacher forcing launched the kernel "
                             f"{launched} times, not "
                             f"{n_ticks * model.num_layers}")
    k_logits, p_logits, f_logits = map(compared, (k_out, p_out, f_out))
    err = float((k_logits - p_logits).abs().max())
    agree = argmax_agreement(k_logits, p_logits)
    fault_err = float((f_logits - p_logits).abs().max())
    fault_agree = argmax_agreement(f_logits, p_logits)
    finite = bool(torch.isfinite(k_out[1]).all())
    log(f"paged teacher-forced logits (16 lanes: prefill + {n_ticks} "
        f"batched ticks), kernel vs plain: max_abs_err {err:.4f} (tol "
        f"{LOGIT_TOL}), argmax agreement {agree:.3f} (min "
        f"{MIN_ARGMAX_AGREEMENT}), |logit| max "
        f"{float(p_logits.abs().max()):.3f}; plain rows within the "
        f"tolerance of a tie / tied / all: {near_ties(p_logits)}")
    log(f"paged teacher-forced logits, planted decode fault (one key "
        f"short) vs plain: max_abs_err {fault_err:.4f}, argmax agreement "
        f"{fault_agree:.3f}")
    if not finite or err > LOGIT_TOL:
        raise AssertionError(f"paged logits differ: {err}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"paged argmax agreement {agree}")
    if fault_err <= LOGIT_TOL:
        raise AssertionError(f"the paged logits check does not see a "
                             f"decode one key short ({fault_err})")
    # The tick's write routing, on the kernel run's pools and fills:
    # rows hold bytes exactly where the fills put them, and the ticks
    # left every prefilled row as it was (a clipped id at the boundary
    # would overwrite the lane's last real block).
    _, _, pools, fills, snap = k_out
    want = [n + n_ticks if adv[b] else n for b, n in enumerate(lens)]
    if fills.tolist() != want:
        raise AssertionError(f"paged fills {fills.tolist()} != {want}")
    rows = torch.from_numpy(written).to(dev)
    old = torch.from_numpy(prefilled).to(dev)
    for pair, was in zip(pools, snap):
        for pool, pool0 in zip(pair, was):
            nonzero = pool[1:].flatten(2).ne(0).any(-1)     # [nb-1, bs]
            if not torch.equal(nonzero, rows[1:]):
                raise AssertionError("the paged ticks wrote rows outside "
                                     "the lanes' fills")
            if not torch.equal(pool[old], pool0[old]):
                raise AssertionError("the paged ticks overwrote a "
                                     "prefilled row")
    return dict(logits_max_abs_err=err, argmax_agreement=agree,
                planted_fault_logits_err=fault_err,
                planted_fault_argmax_agreement=fault_agree,
                lanes=L, ticks=n_ticks)


def run_paged_engine(model, kernels):
    """Phase 4b: the full-width paged engine through the paged-decode
    kernel, 16 slots over the 8-slot fixed pool's KV bytes; then the
    same burst on that fixed 8-slot pool (same KV bytes), the paged
    pool's yardstick."""
    import numpy as np
    rs = np.random.RandomState(5)
    system = rs.randint(0, model.vocab_size, (256,))
    prompts = [np.concatenate([system, rs.randint(0, model.vocab_size,
                                                  (int(n),))])
               for n in rs.randint(32, 257, 24)]
    paged = serve_burst(model, prompts, 64, kernels, num_slots=16,
                        paged=True, paged_kernel="pallas",
                        kv_block_size=16, kv_blocks=1025)
    ticks = paged["ticks"]
    if paged["prefill_tokens_skipped"] <= 0:
        raise AssertionError("the paged engine skipped no prefill tokens "
                             "(no prefix-cache hit)")
    if paged["launches"]["paged_decode"] < ticks * model.num_layers:
        raise AssertionError(f"paged_decode launches "
                             f"{paged['launches']['paged_decode']} < "
                             f"ticks {ticks} x {model.num_layers}")
    paged["fixed_same_burst"] = serve_burst(model, prompts, 64, kernels,
                                            num_slots=8)
    return paged


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every number to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 2
    # Imported before anything is printed: a checkout without the
    # package fails here with no result.
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      serving_params)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.ops import paged_attention as tpa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    smi = nvidia_smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.build_all()
    log(f"kernels built in {time.time() - t0:.1f} s "
        f"({_build.BUILD_DIR})")
    for stem, report in sorted(_build.ptxas_reports.items()):
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry", "arning")):
                log(f"ptxas[{stem}] {line.strip()}")
    wgmma_report = report_wgmma_kernels(_build)

    errs = check_kernels(tfa, dev)
    errs["paged_decode"] = check_paged(tpa, dev)
    errs.update(check_backward(tfa, dev))

    t0 = time.time()
    model = TransformerLM(32768, 12, 8, 128, max_len=2048,
                          dtype=torch.bfloat16, attn_impl="flash",
                          decode_prefix_block=256,
                          decode_prefix_impl="pallas", device=dev)
    model.init_weights(0)
    serving_params(model)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params / 1e6:.1f} M params, "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f} GB, "
        f"built in {time.time() - t0:.1f} s")

    gen = run_generate(model, tfa, dev)
    paged_tf = paged_teacher_forced(model, tpa, dev)
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    eng = run_engine(model, kernels)
    label = f"[{smi}]"
    log(f"engine 16 req x 64 new, 8 slots: {eng['seconds']:.2f} s, "
        f"{eng['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{eng['ttft_ms_p50']} ms, TPOT p50 {eng['tpot_ms_p50']} ms, "
        f"{eng['ticks']} ticks, launches {eng['launches']} {label}")
    peng = run_paged_engine(model, kernels)
    log(f"paged engine 24 req (256 shared + 32..256 tail) x 64 new, 16 "
        f"slots, 1025 blocks x 16 ({peng['kv_bytes'] / 1e9:.3f} GB KV): "
        f"{peng['seconds']:.2f} s, {peng['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {peng['ttft_ms_p50']} ms, TPOT p50 "
        f"{peng['tpot_ms_p50']} ms, {peng['ticks']} ticks, prefix hits "
        f"{peng['prefix_hits']}, prefill tokens skipped "
        f"{peng['prefill_tokens_skipped']}, peak lanes "
        f"{peng['peak_active']}, launches {peng['launches']}, splits of "
        f"the last paged tick {peng['splits']} {label}")
    fx = peng["fixed_same_burst"]
    log(f"the same burst on the fixed pool, 8 slots "
        f"({fx['kv_bytes'] / 1e9:.3f} GB KV): {fx['seconds']:.2f} s, "
        f"{fx['tokens_per_s']:.1f} tokens/s, TTFT p50 {fx['ttft_ms_p50']} "
        f"ms, TPOT p50 {fx['tpot_ms_p50']} ms, {fx['ticks']} ticks, peak "
        f"lanes {fx['peak_active']} {label}")

    del model
    train = run_training(tfa, dev)
    log(f"training: {train['step_ms_median_after_first']:.1f} ms per step, "
        f"{train['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{train['max_memory_allocated'] / 1e9:.2f} GB {label}")

    timing = time_kernels(tfa, dev)
    main_launches = {k: sum(run["launches"].get(k, 0)
                            for run in (gen, eng, peng, train))
                     for k in REPLACES}
    kernels = []
    for name in REPLACES:
        t = timing[name]
        if main_launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": errs[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: v for k, v in errs[name].items()
               if k != "max_abs_err"},
            **path_resources(t)})
        log(f"{name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
            f"plain, {t['library_ms']:.4f} ms library, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) at {t['shape']} "
            f"{label}")
    for at in ("at_1x2048", "at_8x2048"):
        t = timing["flash_fwd"][at]
        log(f"flash_fwd {at}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"ms, library (SDPA forward) {t['library_ms']:.4f} ms {label}")
    for name in ("flash_decode", "paged_decode"):
        t = timing[name]
        log(f"{name} tick at {t['shape']}: {t['splits']} splits a (kv "
            f"head, lane), {t['splits'] * t['shape'][0] * t['shape'][3]} "
            f"split blocks, {t['ms']:.4f} ms = {100 * t['bound_share']:.1f}"
            f" % of its {t['bound_ms']:.4f} ms bound {label}")
        for kern, info in sorted(t["resources"].items()):
            if "bf16 D=128" in kern:
                log(f"{name} {kern}: {info.get('registers')} registers, "
                    f"spill stores/loads {info.get('spill_stores')}/"
                    f"{info.get('spill_loads')} bytes")
    t = timing["paged_decode"]["at_engine"]
    log(f"paged_decode at the engine's tick geometry (16 lanes over 1025 "
        f"blocks, lane 15 free, {t['positions']} positions): "
        f"{t['splits']} splits, {t['ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
        f"{100 * t['bound_share']:.1f} % {label}")
    t = timing["flash_backward"]
    both = timing["flash_bwd_dq"]["ms"] + timing["flash_bwd_dkv"]["ms"]
    log(f"flash_backward (dvec pass + dQ + dK/dV) at {t['shape']}: "
        f"{t['ms']:.4f} ms ({both:.4f} ms in the two kernels), SDPA "
        f"backward {t['library_ms']:.4f} ms; bounds "
        f"{timing['flash_bwd_dq']['bound_ms']:.4f} + "
        f"{timing['flash_bwd_dkv']['bound_ms']:.4f} ms {label}")

    record = dict(card=smi, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda,
                  kernels=kernels, timing=timing, generate=gen, engine=eng,
                  paged_teacher_forced=paged_tf, paged_engine=peng,
                  training=train, wgmma_kernels=wgmma_report,
                  seconds=time.time() - t_start)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    log(f"total {time.time() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
