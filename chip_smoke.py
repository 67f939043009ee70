#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`horovod_tpu_torch`) on one
NVIDIA H100: the quickest proof that the port builds, is right and
serves on the card.

    python3 chip_smoke.py [--json PATH]   # needs one CUDA card; ~1 minute

Phases (any failure exits nonzero; nothing is caught and passed over):

1. Card and build: the card's name and power limit (nvidia-smi), then
   both CUDA kernels built from ``horovod_tpu_torch/csrc`` with nvcc
   (the ``-Xptxas -v`` register / shared-memory lines are printed).
2. Each kernel against its plain PyTorch version on the card, f32 and
   bf16: flash forward at the generate path's [4, 512, 8, 128] and at
   [1, 2048, 8, 128] (causal), plus GQA + window + q_offset and a
   ragged Sk; flash decode at 8 lanes, W=2048, H=8, Hkv 8 and 2, with
   per-lane lengths spread over 1..2048. The decode kernel run one key
   short (length - 1, a planted fault) must fail the same check.
3. Full-width `generate` (the repo's serving bench model: vocab 32768,
   12 layers, 8 heads of 128, max_len 2048, bf16, attn_impl="flash",
   decode_prefix_impl="pallas", random weights from seed 0): 4 prompts
   x 512 -> 128 greedy tokens through both kernels; teacher-forced
   last-position logits of the prefill and the first 8 ticks against
   the same model on the plain versions; the plain decode run one key
   short must fail that comparison.
4. Full-width `ServingEngine`: 8 slots, 16 requests with prompts of
   32..512 tokens and 64 new tokens each; TTFT/TPOT p50 and tokens/s.
5. A ``{"kernels": [...]}`` line (launches on the main path, CUDA-event
   times of kernel / plain version / one PyTorch library call, and the
   roofline bound), the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Launch counts: every kernel wrapper counts its launches; the counts are
set to 0 just before each main-path phase (generate, engine) and read
just after. Launches made to compare or time a kernel do not count.
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
# flip of an attention output propagates; the reading is 0.0293. The
# plain decode run one key short (a planted fault, checked every run)
# reads 0.0929 with argmax agreement 0.972, so the tolerance sits
# between the two and the agreement floor above the fault's.
LOGIT_TOL = 0.06
MIN_ARGMAX_AGREEMENT = 0.99

REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:321",
    "flash_decode": "horovod_tpu/ops/flash_attention.py:1105",
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


def check_kernels(tfa, dev):
    """Phase 2: each kernel against its plain version on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1234)
    # Per kernel: bf16 error at the path's shapes, the largest f32 and
    # lse errors over all cases.
    errs = {"flash_fwd": {"max_abs_err_f32": 0.0, "lse_max_abs_err": 0.0},
            "flash_decode": {"max_abs_err_f32": 0.0}}
    fwd_cases = [
        ("path [4,512,8,128] causal", (4, 512, 512, 8, 8),
         dict(causal=True)),
        ("[1,2048,8,128] causal", (1, 2048, 2048, 8, 8), dict(causal=True)),
        ("gqa 8/2 window 300 q_offset 256", (2, 384, 640, 8, 2),
         dict(causal=True, window=300, q_offset=256)),
        ("ragged Sk 1000 non-causal", (2, 200, 1000, 8, 8), {}),
    ]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, (B, Sq, Sk, H, Hkv), kw in fwd_cases:
            q = torch.randn(B, Sq, H, 128, device=dev, generator=g).to(dt)
            k = torch.randn(B, Sk, Hkv, 128, device=dev, generator=g).to(dt)
            v = torch.randn(B, Sk, Hkv, 128, device=dev, generator=g).to(dt)
            out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
            ref, rlse = tfa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err, ok = max_err(out, ref, TOL[dtype])
            lerr, lok = max_err(lse, rlse, (LSE_TOL, 0.0))
            log(f"flash_fwd {dtype:8s} {name:34s} max_abs_err {err:.3e} "
                f"(tol {TOL[dtype]}) lse {lerr:.3e}")
            if not (ok and lok):
                raise AssertionError(f"flash_fwd {dtype} {name}: out err "
                                     f"{err}, lse err {lerr}")
            e = errs["flash_fwd"]
            e["lse_max_abs_err"] = max(e["lse_max_abs_err"], lerr)
            if dtype == "float32":
                e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
            elif name.startswith("path"):
                e["max_abs_err"] = err
    lengths = torch.linspace(1, 2048, 8).round().int().to(dev)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for hkv in (8, 2):
            q = torch.randn(8, 1, 8, 128, device=dev, generator=g).to(dt)
            kc = torch.randn(8, 2048, hkv, 128, device=dev,
                             generator=g).to(dt)
            vc = torch.randn(8, 2048, hkv, 128, device=dev,
                             generator=g).to(dt)
            out = tfa.flash_decode_cuda(q, kc, vc, lengths)
            ref = tfa.flash_decode_plain(q, kc, vc, lengths)
            torch.cuda.synchronize()
            err, ok = max_err(out, ref, TOL[dtype])
            log(f"flash_decode {dtype:8s} lanes 8 W 2048 H 8 Hkv {hkv} "
                f"lengths {lengths.tolist()} max_abs_err {err:.3e}")
            if not ok:
                raise AssertionError(f"flash_decode {dtype} Hkv {hkv}: "
                                     f"err {err}")
            e = errs["flash_decode"]
            if dtype == "float32":
                e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
            elif hkv == 8:
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
    return errs


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
    rows["flash_decode"] = dict(
        shape=[L, W, H, Hkv, D], dtype="bfloat16", lengths=W,
        ms=cuda_time_ms(lambda: tfa.flash_decode_cuda(q1, kc, vc, length),
                        iters=50),
        plain_ms=cuda_time_ms(
            lambda: tfa.flash_decode_plain(q1, kc, vc, length)),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd), iters=50),
        bound_ms=max(t_flop, t_byte) * 1e3,
        bound_by="operations" if t_flop >= t_byte else "bytes",
        library="torch.nn.functional.scaled_dot_product_attention "
                "(equal lengths)")

    # One 2048-token sequence: the compute-bound reference shape.
    B2, S2 = 1, 2048
    q2, k2, v2 = (torch.randn(B2, S2, H, D, device=dev, generator=g).to(bf)
                  for _ in range(3))
    ms2 = cuda_time_ms(lambda: tfa.flash_fwd_cuda(q2, k2, v2, causal=True))
    flops2 = 2.0 * S2 * S2 * D * H * B2
    rows["flash_fwd"]["at_1x2048"] = dict(
        ms=ms2, bound_ms=max(flops2 / PEAK_BF16_FLOPS,
                             4 * B2 * S2 * H * D * 2 / PEAK_BYTES) * 1e3)
    return rows


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
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1))
                  .float().mean())
    fault_err = float((f_logits - p_logits).abs().max())
    fault_agree = float((f_logits.argmax(-1) == p_logits.argmax(-1))
                        .float().mean())
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


def run_engine(model, tfa, dev):
    """Phase 4: full-width ServingEngine, 8 slots, 16 requests."""
    import numpy as np
    import torch
    from horovod_tpu_torch.serving import ServingEngine
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, model.vocab_size, (int(n),))
               for n in rs.randint(32, 513, 16)]
    new = 64
    with ServingEngine(model, num_slots=8, max_queue=16,
                       warmup=True) as eng:
        torch.cuda.synchronize()
        tfa.flash_fwd_cuda.launches = 0
        tfa.flash_decode_cuda.launches = 0
        t0 = time.time()
        handles = [eng.submit(p, new) for p in prompts]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {"flash_fwd": tfa.flash_fwd_cuda.launches,
                    "flash_decode": tfa.flash_decode_cuda.launches}
        snap = eng.metrics_snapshot()
    for r in results:
        if len(r.tokens) != new or r.finish_reason != "length":
            raise AssertionError(f"request {r.request_id}: "
                                 f"{len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
        if not ((r.tokens >= 0) & (r.tokens < model.vocab_size)).all():
            raise AssertionError(f"request {r.request_id}: bad token ids")
    ticks = snap["ticks"]
    if launches["flash_decode"] < ticks * model.num_layers:
        raise AssertionError(f"decode launches {launches['flash_decode']}"
                             f" < ticks {ticks} x {model.num_layers}")
    tokens = sum(len(r.tokens) for r in results)
    info = dict(seconds=dt, ticks=ticks, launches=launches,
                completed=snap["completed"], tokens=tokens,
                tokens_per_s=tokens / dt,
                ttft_ms_p50=snap["ttft_ms"]["p50"],
                tpot_ms_p50=snap["tpot_ms"]["p50"],
                prompt_tokens=int(sum(len(p) for p in prompts)))
    return info


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
                                       "Compiling entry")):
                log(f"ptxas[{stem}] {line.strip()}")

    errs = check_kernels(tfa, dev)

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
    eng = run_engine(model, tfa, dev)
    label = f"[{smi}]"
    log(f"engine 16 req x 64 new, 8 slots: {eng['seconds']:.2f} s, "
        f"{eng['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{eng['ttft_ms_p50']} ms, TPOT p50 {eng['tpot_ms_p50']} ms, "
        f"{eng['ticks']} ticks, launches {eng['launches']} {label}")

    timing = time_kernels(tfa, dev)
    main_launches = {k: gen["launches"][k] + eng["launches"][k]
                     for k in REPLACES}
    kernels = []
    for name in ("flash_fwd", "flash_decode"):
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
               if k != "max_abs_err"}})
        log(f"{name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
            f"plain, {t['library_ms']:.4f} ms library, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) at {t['shape']} "
            f"{label}")
    log(f"flash_fwd at [1,2048,8,128]: "
        f"{timing['flash_fwd']['at_1x2048']['ms']:.4f} ms, bound "
        f"{timing['flash_fwd']['at_1x2048']['bound_ms']:.4f} ms {label}")

    record = dict(card=smi, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda,
                  kernels=kernels, timing=timing, generate=gen, engine=eng,
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
