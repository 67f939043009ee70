#!/usr/bin/env python3
"""Quick card probe of the flash forward and the two decode kernels: a
short call that builds, checks and times them without the model phases
of `chip_smoke.py`.

    python3 chip_probe.py [fwd] [decode] [paged] [sweep] [spec] [hf]
                          [bwd256] [train12] [lr12] [loader] [elastic13]
                          [sp14] [tp15] [rowmm15] [moe16] [moe16c]
                          # default: all but spec, hf, bwd256, train12,
                          # loader, elastic13, sp14, tp15, rowmm15,
                          # moe16 and moe16c;
                          # one card, ~1 min each (hf: ~5 min); loader
                          # and rowmm15 alone build no kernel

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
  geometry), each beside the split count its wrapper picks by itself;
* spec: `chip_smoke.py`'s serving model, the perturbed draft's
  acceptance in `generate_speculative` (512 -> 64 tokens, k =
  `chip_smoke.SPEC_K`) over a ladder of noise shares (how
  `chip_smoke.SPEC_NOISE` was chosen), then phases 4, 4b and 8 of
  `chip_smoke.py`.
* hf: phase 11's models over four (weight seed, prompt seed) pairs, the
  first `chip_smoke.py`'s own: the teacher-forced logits (prefill + 8
  ticks of the greedy tokens), kernels vs plain versions, in bf16 (how
  `chip_smoke.HF_LOGIT_TOL` was chosen) beside the plain decode one key
  short and losing half of each lane's keys, and in f32 beside the
  decode one key short (how `chip_smoke.HF_F32_LOGIT_TOL` was chosen);
  for the first two pairs the f32 paged teacher forcing at the model's
  own tables (`chip_smoke.paged_teacher_forced`, 4 ticks, timed); then the
  kernels line's rows of each model (`chip_smoke.time_coverage`).
* bwd256: the dQ and dK/dV kernels at head_dim 256 (`chip_smoke.py`
  phase 12a case by case, the wgmma report, and the two kernels timed
  at [B, 2048, 8, 256] over one kv head for B 1, 2 and 4).
* train12: `chip_smoke.py` phases 12b (Gemma-2B's training steps and
  its kernels-vs-plain step, bf16 and the f32 twin) and 12c (the
  resumable loop), 12c once without and once with
  ``torch.use_deterministic_algorithms``.
* lr12: `chip_smoke.py` phase 12b at each (rate, warmup steps) of
  LR12_SWEEP in turn (how `chip_smoke.GEMMA_LR` and `GEMMA_WARMUP` were
  chosen); a setting whose losses fail 12b's check is printed and the
  probe goes on.
* loader: both readers of `horovod_tpu_torch.data` (the native one and
  the Python one) on 12b's feed over a 1 GiB corpus (`probe_loader`);
  host only.
* elastic13: `chip_smoke.py` phase 13 alone (13a's elastic world of 4
  LMs and its planted fault, 13b's multi-process drill), then 13a's
  control leg at each lease of ELASTIC13_LEASES: the resizes an
  uninterrupted world makes when the lease is too short for its
  members' heartbeat threads (how `chip_smoke.ELASTIC_LEASE_S` was
  chosen).
* sp14: two processes on ``cuda:0`` in one gloo world: which
  collectives gloo takes on CUDA tensors (all_reduce, broadcast,
  all_gather, all_gather_into_tensor, all_to_all_single,
  reduce_scatter_tensor), the port's seq mesh, `ppermute` and
  `alltoall` over it (values and staged bytes printed), and last a
  gloo `batch_isend_irecv` of CUDA tensors (it kills the process:
  gloo has no CUDA point-to-point path); then `chip_smoke.py` phase 14
  alone (its step walls at 2 x 2048 a rank).
* tp15: two processes on ``cuda:0`` in one gloo world: the latency of a
  sum (all_reduce) of a [16, 2048] bf16 CUDA tensor and of its f32
  twin, and of an all_gather of [16, 128000] f32 rows (Gemma-2B's
  vocab half), medians of 50 after 5 warm-ups; then `chip_smoke.py`
  phase 15 alone (each rank's peak memory with two Gemma-2B ranks
  resident, the sharded engine's TPOT).
* rowmm15: the row-parallel partial product at phase 15's shapes
  (`ROWMM15_CASES`), bf16 operands, forward and forward + backward, as
  the f32 upcast, as `parallel.tensor.f32_product` and as a bf16
  product (`probe_rowmm15`); builds no kernel.
* moe16: `chip_smoke.py` phase 16 alone (the MoE model served,
  trained, and trained over expert=2 on two ranks sharing the card);
  moe16c: its 16c alone.

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


def probe_spec(cs, tfa, tpa, dev):
    """The perturbed draft's acceptance over noise shares, then
    chip_smoke phases 4, 4b and 8 on the serving model."""
    import torch
    from horovod_tpu_torch.models.speculative import generate_speculative
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      serving_params)
    model = TransformerLM(32768, 12, 8, 128, max_len=2048,
                          dtype=torch.bfloat16, attn_impl="flash",
                          decode_prefix_block=256,
                          decode_prefix_impl="pallas", device=dev)
    model.init_weights(0)
    serving_params(model)
    model.eval()
    prompt = torch.randint(0, 32768, (1, 512), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(9))
    for share in (0.0, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5):
        draft = cs.perturbed_draft(model, share) if share else model
        t0 = time.time()
        _, st = generate_speculative(draft, model, prompt, 64, k=cs.SPEC_K,
                                     return_stats=True)
        print(f"spec share {share}: {st['rounds']} rounds, accepted / k x "
              f"rounds {st['draft_accepted'] / (cs.SPEC_K * st['rounds']):.3f}"
              f", {time.time() - t0:.3f} s", flush=True)
        del draft
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    eng = cs.run_engine(model, kernels)
    peng = cs.serve_burst(model, cs.paged_prompts(32768), 64, kernels,
                          num_slots=16, paged=True, paged_kernel="pallas",
                          kv_block_size=16, kv_blocks=1025)
    for name, r in (("4", eng), ("4b", peng)):
        print(f"phase {name}: {r['seconds']:.2f} s, TTFT p50 "
              f"{r['ttft_ms_p50']} ms, TPOT p50 {r['tpot_ms_p50']} ms, "
              f"{r['tokens_per_s']:.1f} tokens/s", flush=True)
    t0 = time.time()
    try:
        out = cs.run_speculative(model, tfa, eng, peng)
        print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    except Exception:
        traceback.print_exc()
    print(f"phase 8: {time.time() - t0:.1f} s", flush=True)


def probe_hf(cs, tfa, tpa, dev):
    """Readings of phase 11's logits rules over seeds (see the module
    docstring)."""
    import torch
    from horovod_tpu_torch.models.transformer import generate

    def err(a, b):
        return float((a - b).abs().max())

    for what, tag, family, cfg, seed, pseed in cs.HF_MODELS:
        for i in range(4):
            w_seed, p_seed = seed + 10 * i, 17 + i
            t0 = time.time()
            model = cs.build_hf(family, cfg, dev, w_seed, torch.bfloat16)
            prompt = cs.hf_prompt(model, dev, p_seed)
            with torch.no_grad():
                gen = generate(model, prompt, 8)[:, 512:]
            k, p, f = cs.forced_logits(model, tfa, prompt, gen,
                                       cs.one_key_short(tfa))
            _, _, h = cs.forced_logits(
                model, tfa, prompt, gen,
                lambda q, k, v, n: tfa.flash_decode_plain(q, k, v,
                                                          (n + 1) // 2))
            print(f"hf {what} seeds ({w_seed}, {p_seed}) bf16: kernels vs "
                  f"plain {err(k, p):.4f}, scale {float(p.abs().max()):.3f}"
                  f", argmax agreement {cs.argmax_agreement(k, p):.3f}; "
                  f"one key short {err(f, p):.4f}; half the keys lost "
                  f"{err(h, p):.4f}", flush=True)
            del model
            torch.cuda.empty_cache()
            model = cs.build_hf(family, cfg, dev, w_seed, torch.float32)
            k, p, f = cs.forced_logits(model, tfa, prompt, gen,
                                       cs.one_key_short(tfa))
            print(f"hf {what} seeds ({w_seed}, {p_seed}) f32: kernels vs "
                  f"plain {err(k, p):.4g}, scale {float(p.abs().max()):.3f}"
                  f", argmax agreement {cs.argmax_agreement(k, p):.3f}; "
                  f"one key short {err(f, p):.4g} ({time.time() - t0:.1f} "
                  f"s)", flush=True)
            if i < 2:
                def key_short(q, k_new, v_new, table, fill, k_pool, v_pool):
                    return tpa.paged_decode_cuda(
                        q, k_new, v_new, table, (fill - 1).clamp(min=0),
                        k_pool, v_pool)
                t0 = time.time()
                try:
                    cs.paged_teacher_forced(
                        model, tpa, dev, tol=1e-2,
                        n_ticks=4, fault=key_short,
                        what=f"hf {what} seeds ({w_seed}) f32 paged")
                except Exception:
                    traceback.print_exc()
                print(f"hf {what} f32 paged teacher forcing "
                      f"{time.time() - t0:.1f} s", flush=True)
            del model
            torch.cuda.empty_cache()
        t0 = time.time()
        try:
            rows = cs.time_coverage(tfa, tpa, dev, cfg, pseed)
            print(json.dumps({tag: rows}), flush=True)
        except Exception:
            traceback.print_exc()
        print(f"hf {what} time_coverage {time.time() - t0:.1f} s",
              flush=True)


def probe_bwd256(cs, tfa, build, dev):
    """The backward kernels at head_dim 256: the wgmma report (registers,
    spills, shared memory, HGMMA), phase 12a's checks case by case, and
    both kernels timed at [B, 2048, 8, 256] over one kv head for B 1, 2
    and 4."""
    import torch
    for stem in ("flash_bwd_dq", "flash_bwd_dkv"):
        for line in build.ptxas_reports[stem].splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "arning", "rror")):
                print(stem, line.strip())
    try:
        cs.report_wgmma_kernels(build)
    except Exception:
        traceback.print_exc()
    for case in cs.BWD256_CASES:
        try:
            print(cs.check_backward(tfa, dev, cases=[case],
                                    names=cs.BWD256_NAMES), flush=True)
        except Exception:
            traceback.print_exc()
            torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(4321)
    for B in (1, 2, 4):
        try:
            rows = cs.time_backward(tfa, dev, g, B, 2048, 8, 1, 256)
            print(json.dumps({k: {f: r.get(f) for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for k, r in rows.items()}), flush=True)
        except Exception:
            traceback.print_exc()


def probe_train12(cs, tfa, dev):
    """Phases 12b and 12c of `chip_smoke.py` alone: Gemma-2B's training
    steps and its kernels-vs-plain step (bf16 and the f32 twin), then
    the resumable loop twice, once with ``torch.use_deterministic_
    algorithms`` (12c's step is bitwise without it)."""
    import shutil
    import tempfile
    import torch

    def deterministic_resume():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            cs.run_resume(tfa, dev, f"{work}/r1")
        finally:
            torch.use_deterministic_algorithms(False)
    work = tempfile.mkdtemp(prefix="hvd_probe12_")
    try:
        for name, fn in (
                ("12b", lambda: cs.run_gemma_training(
                    tfa, dev, f"{work}/gemma")),
                ("12c", lambda: cs.run_resume(tfa, dev, f"{work}/r0")),
                ("12c deterministic algorithms", deterministic_resume)):
            t = time.time()
            try:
                fn()
            except Exception:
                traceback.print_exc()
            torch.cuda.empty_cache()
            print(f"{name}: {time.time() - t:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# AdamW's (rate, warmup steps) for 12b's Gemma-2B from random weights.
LR12_SWEEP = [(3e-4, 1), (3e-4, 3), (1e-4, 1), (1e-4, 3), (5e-5, 1),
              (3e-5, 1), (1e-5, 1)]


def probe_lr12(cs, tfa, dev):
    """Phase 12b of `chip_smoke.py` at each setting of LR12_SWEEP."""
    import gc
    import shutil
    import tempfile
    import torch
    work = tempfile.mkdtemp(prefix="hvd_probe_lr12_")
    saved = cs.GEMMA_LR, cs.GEMMA_WARMUP
    try:
        for lr, warmup in LR12_SWEEP:
            cs.GEMMA_LR, cs.GEMMA_WARMUP = lr, warmup
            t = time.time()
            try:
                info = cs.run_gemma_training(tfa, dev, f"{work}/{lr}")
                print(json.dumps(dict(lr=lr, warmup=warmup,
                                      losses=info["losses"])), flush=True)
            except Exception:
                traceback.print_exc()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"lr {lr} warmup {warmup}: {time.time() - t:.1f} s",
                  flush=True)
    finally:
        cs.GEMMA_LR, cs.GEMMA_WARMUP = saved
        shutil.rmtree(work, ignore_errors=True)


# The loader probe's corpus: LOADER_ROWS rows of 2048 int32 tokens
# (1 GiB, 268 M tokens) in LOADER_SHARDS shards.
LOADER_ROWS = 131072
LOADER_SHARDS = 16


def probe_loader(cs):
    """Both readers of `horovod_tpu_torch.data` on 12b's feed (batches of
    `chip_smoke.GEMMA_TRAIN_BATCH` x 2048 int32 tokens, shuffled with
    12b's seed, one rank) over LOADER_ROWS seeded rows written to a temp
    dir at run time (so every read is warm: the files were just
    written). Twice each, alternating: the time from construction to the
    first batch, to the first batch of a start at mid-epoch, and per
    batch over the rest of the epoch, with an order-sensitive checksum
    of each stream (the two must agree)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from horovod_tpu_torch import data as hd
    from horovod_tpu_torch.runtime.config import config
    S, B = 2048, cs.GEMMA_TRAIN_BATCH
    spec = hd.lm_spec(S)
    work = tempfile.mkdtemp(prefix="hvd_probe_loader_")
    saved = config.use_native
    try:
        rs = np.random.RandomState(cs.GEMMA_TRAIN_SEED)
        tokens = rs.randint(0, 256000, size=(LOADER_ROWS, S),
                            dtype=np.int32)
        t = time.perf_counter()
        paths = hd.write_shards(work, "corpus", spec, {"tokens": tokens},
                                LOADER_SHARDS)
        print(f"loader: wrote {tokens.nbytes / 2**30:.2f} GiB in "
              f"{LOADER_SHARDS} shards in {time.perf_counter() - t:.2f} s "
              f"({os.cpu_count()} host cores)", flush=True)
        del tokens
        sums = {}
        for native in (True, False, True, False):
            config.use_native = native
            t0 = time.perf_counter()
            ds = hd.ShardedDataset(paths, spec, B, shuffle=True,
                                   seed=cs.GEMMA_TRAIN_SEED, rank=0,
                                   world=1, drop_remainder=True)
            if ds.native != native:
                raise AssertionError(f"asked native={native}, got "
                                     f"{ds.native}")
            steps = ds.steps_per_epoch()
            it = ds.epoch(0)
            chk = hash(next(it)["tokens"].tobytes())
            first_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            n = 1
            for batch in it:
                chk = hash((chk, batch["tokens"][:, :8].tobytes()))
                n += 1
            per_batch_s = (time.perf_counter() - t1) / (n - 1)
            t2 = time.perf_counter()
            mid = next(ds.epoch(0, start_batch=steps // 2))["tokens"]
            mid_s = time.perf_counter() - t2
            chk = hash((chk, mid.tobytes()))
            ds.close()
            name = "native" if native else "python"
            if sums.setdefault("stream", chk) != chk:
                raise AssertionError(f"the {name} reader's stream differs")
            print(json.dumps(dict(
                reader=name, batches=n, batch=B, seq=S,
                first_batch_ms=first_s * 1e3,
                mid_epoch_first_batch_ms=mid_s * 1e3,
                per_batch_us=per_batch_s * 1e6,
                mb_per_s=B * S * 4 / per_batch_s / 1e6)), flush=True)
    finally:
        config.use_native = saved
        shutil.rmtree(work, ignore_errors=True)


# Leases for 13a's uninterrupted control leg (seconds).
ELASTIC13_LEASES = (0.1, 0.25, 0.5, 1.0)


def probe_elastic13(cs, tfa, dev):
    """Phase 13 of `chip_smoke.py` alone, then the control leg of 13a
    at each lease of ELASTIC13_LEASES (a resize there is a false
    death)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from horovod_tpu_torch.resilience import membership
    t = time.time()
    try:
        cs.run_phase13(tfa, dev)
    except Exception:
        traceback.print_exc()
    print(f"phase 13: {time.time() - t:.1f} s", flush=True)
    work = tempfile.mkdtemp(prefix="hvd_probe13_")
    try:
        paths = cs.elastic_corpus(f"{work}/data")
        models = cs.member_models(dev, cs.ELASTIC_WORLD + 1)
        lm = cs.elastic_lm(models, dev)
        state0 = {n: p.detach().clone()
                  for n, p in models.all[0].named_parameters()}
        default = cs.ELASTIC_LEASE_S
        for lease in ELASTIC13_LEASES:
            cs.ELASTIC_LEASE_S = lease
            try:
                rep, s = cs.elastic_leg(membership.SimulatedWorld, lm, paths,
                                        f"{work}/l{lease}", state0)
                walls = np.diff(lm.applied.get("hvd-sim-rank0", [0.0]))
                lm.applied = {}
                print(f"control leg at lease {lease} s: {s:.1f} s, "
                      f"completed {rep.completed}, resizes "
                      f"{[(r['generation'], r['died']) for r in rep.resizes]},"
                      f" step wall median "
                      f"{float(np.median(walls)) * 1e3:.1f} ms, max "
                      f"{float(walls.max()) * 1e3:.1f} ms, error "
                      f"{rep.error}", flush=True)
            except Exception:
                traceback.print_exc()
            finally:
                cs.ELASTIC_LEASE_S = default
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


GLOO_CUDA_PROBE = r"""
import sys, torch, torch.distributed as dist
r, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store, rank=r,
                        world_size=2)
x = torch.full((4,), float(r + 1), device="cuda")
ops = {
    "all_reduce": lambda: dist.all_reduce(x.clone()),
    "broadcast": lambda: dist.broadcast(x.clone(), src=0),
    "all_gather": lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(2)], x),
    "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
        torch.empty(8, device="cuda"), x),
    "all_to_all_single": lambda: dist.all_to_all_single(
        torch.empty_like(x), x),
    "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
        torch.empty(2, device="cuda"), x),
}
for name, fn in ops.items():
    try:
        fn()
        torch.cuda.synchronize()
        print(f"rank {r} gloo {name} on CUDA: ok", flush=True)
    except Exception as e:
        print(f"rank {r} gloo {name} on CUDA: {type(e).__name__} "
              f"{str(e).splitlines()[0][:160]}", flush=True)
    dist.barrier()
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.ops import collectives as C
m = M.make_mesh(seq=2, device_type="cuda")
with M.use(m):
    y = C.ppermute(x, "seq", M.ring_perms("seq")[0])
    z = C.alltoall(torch.arange(4.0, device="cuda") + 10 * r,
                   axis_name="seq")
    print(f"rank {r} mesh {M.mesh_shape(m)} ppermute {y.tolist()} "
          f"alltoall {z.tolist()} staged {C.staged_bytes()} B", flush=True)
# Last: gloo has no CUDA path for point-to-point, and this kills the
# process (gloo::IoException, writev: Bad address).
print(f"rank {r} gloo batch_isend_irecv on CUDA: trying", flush=True)
for q in dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, x, 1 - r),
         dist.P2POp(dist.irecv, torch.empty_like(x), 1 - r)]):
    q.wait()
print(f"rank {r} gloo batch_isend_irecv on CUDA: ok", flush=True)
dist.destroy_process_group()
"""


def probe_sp14(cs, tfa, dev):
    """Two processes on ``cuda:0`` in one gloo world: which collectives
    take CUDA tensors there, and the port's mesh, ppermute and alltoall
    over it; then `chip_smoke.py` phase 14 alone."""
    import os
    import subprocess
    import tempfile
    work = tempfile.mkdtemp(prefix="hvd_probe14_")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_CUDA_PROBE, str(r), f"{work}/store"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
        for r in range(2)]
    for p in procs:
        try:
            print(p.communicate(timeout=180)[0], flush=True)
        except subprocess.TimeoutExpired:
            p.kill()
            print("gloo probe timed out", flush=True)
    t = time.time()
    try:
        cs.run_phase14(tfa, dev)
    except Exception:
        traceback.print_exc()
    print(f"phase 14: {time.time() - t:.1f} s", flush=True)


GLOO_TP_PROBE = r"""
import sys, time, torch, torch.distributed as dist
r, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store, rank=r,
                        world_size=2)
def median_ms(fn, n=50, warm=5):
    for _ in range(warm):
        fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return sorted(walls)[n // 2]
for name, x in (("all_reduce [16, 2048] bf16",
                 torch.ones(16, 2048, device="cuda", dtype=torch.bfloat16)),
                ("all_reduce [16, 2048] f32",
                 torch.ones(16, 2048, device="cuda"))):
    try:
        ms = median_ms(lambda: dist.all_reduce(x))
        print(f"rank {r} gloo {name} on CUDA: {ms:.3f} ms", flush=True)
    except Exception as e:
        print(f"rank {r} gloo {name}: {type(e).__name__} "
              f"{str(e).splitlines()[0][:160]}", flush=True)
y = torch.ones(16, 128000, device="cuda")
parts = [torch.empty_like(y) for _ in range(2)]
ms = median_ms(lambda: dist.all_gather(parts, y), n=20)
print(f"rank {r} gloo all_gather [16, 128000] f32 on CUDA: {ms:.3f} ms",
      flush=True)
dist.destroy_process_group()
"""


def probe_tp15(cs, tfa, dev):
    """Two processes on ``cuda:0``: gloo's latency for the sums and the
    logits gather a tensor-parallel tick makes; then `chip_smoke.py`
    phase 15 alone."""
    import os
    import subprocess
    import tempfile
    work = tempfile.mkdtemp(prefix="hvd_probe15_")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_TP_PROBE, str(r), f"{work}/store"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
        for r in range(2)]
    for p in procs:
        try:
            print(p.communicate(timeout=180)[0], flush=True)
        except subprocess.TimeoutExpired:
            p.kill()
            print("gloo probe timed out", flush=True)
    t = time.time()
    try:
        cs.run_phase15(tfa, dev)
    except Exception:
        traceback.print_exc()
    print(f"phase 15: {time.time() - t:.1f} s", flush=True)


# The row-parallel products of phase 15, (rows, in/tp, out): 15a's
# attention out and MLP down at [2, 2048] tokens a rank, and Gemma-2B's
# (15b) at a 256-token prefill and an 8-lane tick.
ROWMM15_CASES = {"15a attn out": (4096, 512, 1024),
                 "15a mlp down": (4096, 2048, 1024),
                 "15b mlp down prefill": (256, 8192, 2048),
                 "15b mlp down tick": (8, 8192, 2048)}


def probe_rowmm15(cs):
    """The row-parallel partial product at phase 15's shapes, bf16
    operands, forward and backward, timed three ways in one process:
    the f32 upcast (both operands cast, an f32 GEMM on the CUDA cores
    with TF32 off), `parallel.tensor.f32_product` (one bf16 GEMM on the
    tensor cores with an f32 output) and the plain bf16 product (bf16
    partials); the largest difference of f32_product's output from the
    upcast's. Means of 50 calls after 5 warm-ups
    (`chip_smoke.cuda_time_ms`)."""
    import torch
    from horovod_tpu_torch.parallel.tensor import f32_product
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    ways = {"f32 upcast": lambda x, w: x.float() @ w.float(),
            "f32_product": f32_product,
            "bf16 product": lambda x, w: x @ w}
    for name, (rows, k, n) in ROWMM15_CASES.items():
        x = torch.randn(rows, k, device=dev, generator=g,
                        dtype=torch.bfloat16).requires_grad_()
        w = (torch.randn(k, n, device=dev, generator=g) * k ** -0.5).to(
            torch.bfloat16).requires_grad_()
        cot = torch.randn(rows, n, device=dev, generator=g,
                          dtype=torch.bfloat16)
        outs = {}
        for way, fn in ways.items():
            def fwd():
                return fn(x, w)

            def fwd_bwd():
                y = fn(x, w).to(torch.bfloat16)
                y.backward(cot)
            with torch.no_grad():
                outs[way] = fwd().float()
            ms = [cs.cuda_time_ms(f, iters=50, warmup=5) for f in (
                lambda: torch.no_grad()(fwd)(), fwd_bwd)]
            print(f"rowmm15 {name} [{rows}, {k}] @ [{k}, {n}] {way}: "
                  f"forward {ms[0]:.4f} ms, forward+backward "
                  f"{ms[1]:.4f} ms", flush=True)
        err = (outs["f32_product"] - outs["f32 upcast"]).abs().max()
        print(f"rowmm15 {name}: f32_product vs f32 upcast max abs "
              f"{float(err):.3e} (output max "
              f"{float(outs['f32 upcast'].abs().max()):.3f})", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA card", file=sys.stderr)
        return 2
    every = {"fwd", "decode", "paged", "sweep"}
    parts = set(sys.argv[1:]) or every
    if not parts <= every | {"spec", "hf", "bwd256", "train12", "lr12",
                             "loader", "elastic13", "sp14", "tp15",
                             "rowmm15", "moe16", "moe16c"}:
        print(f"chip_probe: unknown parts {sorted(parts)}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    if "loader" in parts:
        probe_loader(cs)
        parts.discard("loader")
        if not parts:
            return 0
    if "rowmm15" in parts:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs.nvidia_smi_line(), torch.__version__, torch.version.cuda,
              flush=True)
        probe_rowmm15(cs)
        parts.discard("rowmm15")
        if not parts:
            return 0
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
    if "spec" in parts:
        probe_spec(cs, tfa, tpa, dev)
    if "hf" in parts:
        probe_hf(cs, tfa, tpa, dev)
    if "bwd256" in parts:
        probe_bwd256(cs, tfa, _build, dev)
    if "train12" in parts:
        probe_train12(cs, tfa, dev)
    if "lr12" in parts:
        probe_lr12(cs, tfa, dev)
    if "elastic13" in parts:
        probe_elastic13(cs, tfa, dev)
    if "sp14" in parts:
        probe_sp14(cs, tfa, dev)
    if "tp15" in parts:
        probe_tp15(cs, tfa, dev)
    if parts & {"moe16", "moe16c"}:
        t = time.time()
        try:
            if "moe16" in parts:
                cs.run_phase16(tfa, tpa, dev)
            else:
                cs.run_moe16c(dev)
        except Exception:
            traceback.print_exc()
        print(f"phase 16: {time.time() - t:.1f} s", flush=True)
    print(f"nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
