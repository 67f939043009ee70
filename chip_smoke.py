#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`horovod_tpu_torch`) on one
NVIDIA H100: the quickest proof that the port builds, is right and
serves on the card.

    python3 chip_smoke.py [--json PATH]   # needs one CUDA card; ~15 minutes

Phases (any failure exits nonzero; nothing is caught and passed over):

1. Card and build: the card's name and power limit (nvidia-smi), then
   the five CUDA kernels built from ``horovod_tpu_torch/csrc`` with
   nvcc, one process per source started together (the ``-Xptxas -v``
   register / shared-memory lines are printed). Each bf16 tensor-core
   instantiation of the forward and backward kernels (forward, dQ and
   dK/dV at D 64, 128 and 256: nine) reports its registers and spills
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

7. Horovod's data-parallel surface on the card, after phase 5, at world
   1 over NCCL (``hvd.init()``, nothing caught and passed over):
   (a) word2vec at the JAX model's width (vocab 50000, dim 128, f32):
   8 `make_train_step` steps under `DistributedOptimizer(Adagrad)` on a
   fixed batch of 4096 Zipf skip-grams with 16 negatives, the embedding
   gradient a sparse CUDA tensor; the loss must be finite and fall; the
   sparse allreduce (`IndexedSlices`) of one step's slices, taken to
   dense, must equal the dense gradient, and the same with one slice
   dropped (a planted fault) must not; the sparse rows are printed
   beside the table's. (b) Phase 5's configuration under
   `DistributedOptimizer(..., compression="powersgd",
   compression_rank=4)`: 4 steps, the loss finite and falling, the
   forward, dQ and dK/dV kernels each >= 12 x steps (added to their
   ``kernels`` rows); then one checked step: error feedback (approx +
   new err == grad + old err) on every compressed leaf, the card's
   approximations against the same compressor on the CPU from the same
   gradients and state, and the host syncs of one compressor update
   counted under CUDA's sync debug mode; the compressed leaves, the wire
   ratio and the step time beside phase 5's are printed. (c) (a) and (b)
   run under `start_timeline`: the trace must parse, name its
   processes, pair every B with an E and hold the ``train_step``
   brackets and the sparse allreduce's allgathers. (d) ``python -m
   horovod_tpu_torch.runner -np 1`` runs a worker that must land on
   ``cuda:0`` over NCCL through the launcher's store, run every eager op
   and one word2vec step, and print its line; ``-np <cards + 1>
   --platform gpu`` must be refused before spawning (a planted misuse).

8. Speculative decoding at full width (phase 3's model, k = 4), after
   phase 4b, with the self-draft (the target itself) and a perturbed
   draft (the target's weights plus seeded Gaussian noise at SPEC_NOISE
   of each leaf's own standard deviation): (a) `generate_speculative`
   of one 512-token prompt -> 128 tokens against a plain batch-1
   `generate` of it (the flash forward must launch: the one-pass
   prefill of both models); (b) the fixed engine, 8 slots, on phase
   4's 16 requests x 64 tokens, each draft; (c) the paged engine, 16
   slots over 1025 blocks of 16, on phase 4b's burst, perturbed draft.
   Every stream must equal the plain greedy stream (phases 4 and 4b,
   or the plain run of (a)) but for a first difference at a near tie
   (`stream_verdict`: the plain stream's teacher-forced logits have
   their top two within LOGIT_TOL there, the spec token among them).
   Rounds, acceptance, tokens per tick, TTFT/TPOT p50, tokens/s and
   wall time are printed beside the plain numbers (no speed claimed).
   The perturbed draft's acceptance must lie in SPEC_ACCEPT_RANGE; the
   flash-decode kernel must launch >= 12 x (k+1) x rounds times in each
   engine run (the draft ticks); one steady round on the fixed and the
   paged pool must make ONE host sync (CUDA's sync debug mode); and (b)
   with the rewind one row past pre + n_emit (a planted fault) must
   fail the stream check.

9. Int8 weights, int8 KV and the rolling window at full width, after
   phase 8 (phase 3's model unless said): (a) `quantize_lm` of the
   model, one forward at [4, 512], must equal bitwise the float model
   loaded with the dequantized state dict at bf16, and lie within
   QUANT_LOGIT_TOL of the float logits; the weight bytes are printed.
   (b) ``weight_quant="int8"``: `generate` 4 x 512 -> 128, the fixed
   engine (8 slots, phase 4's burst) and the paged engine (16 slots
   over 1025 blocks of 16, phase 4b's burst), both quantizing at the
   door; the engines' streams against `generate_bucketed` of the int8
   model under the tie-aware rule; B1, B3 and B4 must launch; TTFT /
   TPOT p50 and tokens/s beside phases 3-4b. (c) ``kv_quant="int8"``:
   teacher-forced logits of a 4 x 512 prompt and 64 ticks, linear cache
   and paged pool, within KV_INT8_TOL of the bf16-KV run of each; the
   fixed engine on phase 4's burst completes every request; B3 and B4
   make no launch (the reference keeps int8 KV off its kernels); a
   codec whose stored scale is one a position (the largest over the
   heads) while its codes keep their per-head scales (a planted fault)
   must fail the check. (d) RoPE with a 512 window (`bench.py
   --pos-emb rope --window 512`, seed 0) at full width cut to
   WINDOW_LAYERS layers: `generate` of 4 x 1024 ->
   1100 tokens, past max_len, B1 in the banded prefill; every
   generated token within WINDOW_TIE_TOL of the top of one one-pass
   forward of the whole sequence; the same model in f32, teacher-forced
   over 64 ticks past max_len, within WINDOW_F32_TOL of its forward,
   where the rolling branch without the call's own rows (a planted
   fault) must fail; the fixed engine on phase 4's burst against
   `generate_bucketed` under the tie-aware rule.
10. Threefry sampling and the serving fleet, after phase 9 (phase 3's
   model; each paged replica is phase 4b's engine, 16 slots over 1025
   blocks of 16, the replicas sharing the model's weights). (a) Random
   bits, uniforms, splits and fold-ins on the card bitwise the CPU's
   for a [16, 32768] draw over 16 keys (Gumbel noise within the port's
   stated ulp rule); a seeded `generate` of 4 x 512 -> 128
   (temperature 0.8, top_p 0.95) equal run to run, and with the key
   advanced one split too many (a planted fault) different; one tick
   of phase 4's 8 lanes greedy against sampled, and the threefry draw
   alone. (b) Phase 4b's burst, half greedy and half seeded, on one
   paged engine (the reference), then through `ServingRouter` over two
   paged replicas, then again with ``router.replica_kill`` armed once
   request 0 has 16 tokens: every stream equal to its reference under
   the tie-aware rule (extended to seeded streams with their Gumbel
   noise); migrations and replacements printed; the dead replica's KV
   freed before its replacement is built (peak memory within half a
   pool of the level before the kill). (c) The burst through
   `DisaggRouter` (one prefill, one decode replica) in host and in
   device transfer mode: streams equal to the one engine's, handoffs
   and prompt tokens the decode side skipped > 0; a
   ``disagg.block_corrupt`` drill on a fresh prompt drops the transfer
   and keeps the stream. (d) The exporter on an ephemeral port,
   scraped during (b): /metrics parses and carries the router's
   counters. (e) TTFT p50, TPOT p50 and tokens/s of (b) and (c) beside
   phase 4b's. (f) B4 launches >= ticks x 12 over each run's engines.

11. The HF families at full width, the instantiations they bring, and
   the first torch.profiler traces. (a) Gemma-1 2B (google/gemma-2b's
   config: vocab 256000, 18 layers, 8 heads x 256 over 1 kv head,
   GeGLU, 2.51 B params) and (b) Qwen2-0.5B (Qwen/Qwen2-0.5B's: vocab
   151936, 24 layers, 14 heads x 64 over 2, qkv biases, tied head; its
   max_position_embeddings cut to 4096 for the caches), each from
   random HF-layout weights (seeded) mapped through
   `compat.hf.from_hf_state_dict`: `generate` 4 x 512 -> 128, its
   teacher-forced logits against the plain versions (HF_LOGIT_TOL of
   the family, argmax agreement; the plain decode one key short, a
   planted fault, must fail), a seeded `generate` (its
   extra-split fault), and the paged engine (16 slots) over 16 requests
   of 64..512 prompt tokens x 64 new. Then the same weights in f32:
   the teacher-forced logits and phase 3b's paged teacher forcing at
   the model's own tables, held to HF_F32_LOGIT_TOL, each refusing a
   decode one key short. (c) The forward at [2,1024,8,256] (Hkv 1) and
   [2,1024,14,64] (Hkv 2), both decode kernels at D = 256 groups 1 and
   8, D = 128 group 6 and D = 64 groups 3, 5 and 7, f32 and bf16, each
   against its plain version and its planted fault (the forward one key
   short, the decode one key short, the paged table swap). (d) One
   training step of phase 5 and one tick of phase 4b's paged pool
   traced through `obs.profiler_session` and read by
   `utils.profile_analysis`: top categories and kernels by device time,
   the device's busy share of the window, and the launches of the
   forward, dQ, dK/dV (12 each a step) and paged-decode (12 a tick)
   kernels, which must match. The kernels line gains rows for each HF
   model's path (``name@gemma-2b``, ``name@qwen2-0.5b``): the forward
   at its prefill shape [4, 512], the decode tick at 4 lanes x 640
   keys and the paged tick at its engine's 16 lanes, each kernel held
   against its plain version (and a planted fault) on the very inputs
   it is timed on.

12. Gemma-2B training, resumably (after phase 11, in a temporary
   directory removed after it). (a) The dQ and dK/dV kernels at
   head_dim 256 against the plain backward, f32 and bf16 at phase 2c's
   GRAD_TOL (`BWD256_CASES`: Gemma's attention [1, 2048, 8, 256] over
   one kv head, causal; a 512 window; Hkv = H; ragged Sq = Sk = 1000
   under Hkv 2 with a cotangent on lse; fused qkv views), phase 2c's
   planted faults on the first (dK/dV one query row short; p and ds
   rounded to one bf16 against the hi + lo split), then both kernels
   timed at [2, 2048, 8, 256], Hkv 1, beside the plain backward, SDPA's
   backward (GQA) and the bound. (b) Gemma-2B at full width and depth
   (phase 11's config, 2.506 B params) from random HF-layout weights,
   f32 params and bf16 compute, AdamW, ``attn_impl="flash"``,
   ``loss_chunk=512``, B = 2 x 2048, no remat: GEMMA_TRAIN_STEPS steps
   fed by `data.ShardedDataset` (the native loader, asserted) over
   `write_token_shards` files of `pack_tokens`-packed seeded
   documents; the loss finite and falling, each training kernel
   launched >= 18 x steps, step time, tokens/s and peak memory
   printed; then one B = 1 step through the kernels against the plain
   forward and backward (phase 5's tolerances) and its f32 twin, which
   must hold GEMMA_F32_GRAD_TOL and refuse the planted fault. (c) Phase
   5's model on `resilience.ElasticTrainer` with a `TrainSnapshot`
   (dataset cursor, torch.Generator): async saves every
   RESUME_SAVE_EVERY steps (keep 2), the process's own SIGTERM after
   step RESUME_KILL_AT (the emergency save), then a fresh model,
   optimizer, dataset and trainer `resume()`: the restored tree equal
   to the saved one bitwise, ``resume_gap_batches == 0``, and the
   resumed losses, final parameters and AdamW state equal to an
   uninterrupted run's bitwise. The kernels line gains the rows
   ``flash_bwd_dq@gemma-2b`` and ``flash_bwd_dkv@gemma-2b`` (12a's
   readings, 12b's launches).

13. Elastic membership on the card (after phase 12). (a) The forward,
   dQ and dK/dV kernels against their plain versions at the world's
   attention, [2, 513, 8, 128] causal as views of one fused projection,
   f32 and bf16; then `resilience.membership.SimulatedWorld` of 4
   members, each a thread owning the repo's LM at full width (vocab
   32768, 8 heads x 128, max_len 2048, gpt preset, bf16 compute over
   f32 params, ``attn_impl="flash"``) cut to 2 layers, built on the card
   from one seed; `grad_fn` the LM loss and autograd through the three
   kernels, the world's float64 average on the card, `apply_fn` plain
   SGD cast back to f32; fed by `ShardedDataset` over 4 shards of 128
   seeded 513-token rows, batch 2 a member, 2 epochs, the leader's
   `ElasticTrainer(migrate_world=True)` saving every 4 steps into a
   temporary directory. An uninterrupted control leg (no resize), then
   the chaos leg under ``rank_death:1,rank_join:1``: 1 death, 1 join,
   2 resizes, world 4 at generation 2, the union stream equal to the
   control's as a multiset, every state leaf finite; then the chaos leg
   with the trainer's migration off (a planted fault) must run to its
   end (no error, the same deaths, joins and resizes) and fail the
   union check. The kernels launch >= 2 x the members' steps; detect_s
   and time_to_resume_s, records reassigned, the lease, a lockstep
   step's wall and its parts on one thread (a member's grad_fn, the
   float64 average, an apply, a checkpoint save) and peak memory are
   printed.
   (b) ``python -m horovod_tpu_torch.resilience.drill --world 3
   --kill-rank 2`` (worker processes over the launcher's store, no
   CUDA) within HVD_ELASTIC_DRILL_TIMEOUT_S: its OK line, detect_s and
   time_to_resume_s.

14. Sequence parallelism on the card (after phase 13). (a) The kernels
   at the ring's rotations: a [2, 4096, 8, 128] causal attention cut
   into 4 blocks of 1024; the last block's queries against the K/V
   block of each rotation d = 0..3 at q_offset = d x 1024, f32 and
   bf16: the forward's (out, lse) and the backward under a cotangent on
   lse against their plain versions; again under window 1536, where
   rotation 2 holds fully masked rows and rotation 3 is masked whole
   (out 0, lse -inf, zero and finite gradients). The logsumexp merge of
   the four kernel partials (`parallel.sequence._merge_partials`)
   against one forward launch at the full length, within TOL; the merge
   without its -inf guard (taking the masked rotation first) and
   rotation 3 without its window (planted faults) must fail it. The
   bf16 forward of a live and of the masked rotation are timed.
   (b) SP14_SP rank processes sharing ``cuda:0`` in a gloo world
   (``hvd.init(device="cpu")``: NCCL refuses two ranks on one device),
   a ``seq`` mesh (`parallel.mesh.make_mesh(seq=2)`) over them: the
   repo's LM at full width (vocab 32768, 8 heads x 128, gpt preset, bf16
   compute over f32 params) with max_len 4096 cut to 2 layers, from one
   seed, each rank on its 2048 columns of a seeded [2, 4096] batch
   through `make_lm_train_step(model, opt, mesh)` under AdamW (the
   step averages the gradients over the seq ranks), ``loss_chunk=512``, for
   ``attn_impl="ring_flash"`` and then ``"ulysses_flash"``: the first
   step's loss and averaged gradients against the single-process flash
   step on the global batch from the same weights (bf16 at phase 5's
   STEP_LOSS_TOL / STEP_GRAD_TOL; the f32 twin at SP14_F32_LOSS_TOL /
   SP14_F32_GRAD_TOL), then 4 more AdamW steps with the loss finite and
   falling; each rank's forward, dQ and dK/dV launches >= its live
   rotations (ring: its seq coordinate + 1; Ulysses: 1) x layers x
   steps; the bytes its transfers staged through the host and its step
   walls are printed. The causal ring with the wrapped-rank skip removed
   (a planted fault: rank 0 attends rank 1's future block) must fail
   the comparison, in bf16 and f32.
15. Tensor parallelism on the card (after phase 14), TP15 rank
   processes sharing ``cuda:0`` in a gloo world with a ``model`` mesh
   (`parallel.mesh.make_mesh(model=2)`). (a) Phase 14b's LM (vocab
   32768, 8 heads x 128, gpt preset, bf16 compute over f32 params) at
   max_len 2048, 2 layers, ``attn_impl="flash"``, built over the mesh
   (4 query heads and 16384 vocab rows a rank) from one seed, both ranks
   on a seeded [2, 2048] batch through `make_lm_train_step(model, opt,
   mesh)` (AdamW, ``loss_chunk=512``, the vocab-parallel loss): the
   first step's loss and gathered gradients against the single-process
   flash step from the same weights (bf16 at STEP_LOSS_TOL /
   STEP_GRAD_TOL, the f32 twin at TP15_TOL's tighter limits), then 4
   more AdamW steps with the loss finite and falling; each rank's
   forward, dQ and dK/dV launches >= layers x steps. The row-parallel
   output without g and the gradients averaged over ``model`` (planted
   faults) must fail the comparison. (b) Phase 11's Gemma-2B and
   Qwen2-0.5B at full width and depth, each rank building the whole
   model from the same seed and the engine sharding it at its door
   (Gemma-2B: 4 query heads, its one kv head and 128000 vocab rows a
   rank; Qwen2-0.5B: 7 over 1, 75968 rows): teacher-forced logits
   (TP15_LANES x TP15_PROMPT prefill + TP15_TICKS ticks) on the fixed
   cache (flash decode) and on the paged pools (paged decode) against
   the unsharded model on the card, within phase 11's HF_LOGIT_TOL and
   its argmax agreement; each rank's decode launches >= ticks x layers.
   Gemma-2B's greedy burst through the sharded paged engine (model
   rank 0 leads, rank 1 follows in lockstep) beside the unsharded
   engine: stream agreement, TPOT p50 and the model-axis collective
   bytes printed; the f32 twin at TP15_F32_LAYERS layers must give the
   same streams. Planted faults: Qwen2-0.5B's fused qkv cut
   contiguously must fail the logits rule, and a follower that drops
   one free descriptor must raise `ShardDivergence`.
16. Mixture of experts and expert parallelism (after phase 15;
   MOE16_MODEL: the flagship with every second block a mixture of 8
   experts, the top 2 a token, capacity factor 1.25). (a) Served in
   bf16: `generate` 4 x 512 -> 128 through the forward and decode
   kernels; its teacher-forced logits (prefill + 8 ticks) against the
   plain versions under the MoE rule (MOE16_FLIP_MAX: routing flips
   counted, rows whose own token kept its experts held to
   MOE16_LOGIT_TOL); a burst of 16 requests (64..512 prompt tokens, 64
   new) through the fixed engine (8 slots) and the paged engine (16
   slots, the paged kernel) at the drop-free factor 8.0 and at 1.25
   (walls, TPOT p50, the dropped share of prefill chunks and of ticks,
   which route each lane alone and never drop); the kernels line's
   ``@moe`` rows at this model's shapes; then an f32 twin of
   MOE16_F32_LAYERS layers, whose logits must refuse the decode one key
   short and whose fixed engine, paged engine and `generate` streams
   must agree at 8.0. (b) Trained at B = 2 x 2048 (AdamW, f32 params,
   bf16 compute, flash attention, the aux term at 0.01): step time,
   tokens/s, MFU counted with k experts a token, peak memory, the aux
   loss and the dropped share; the step through the kernels against
   the plain versions (and its f32 twin, which holds the MoE blocks'
   gradients too), the plain dK/dV one query row short refused. (c)
   expert=2 over two rank processes sharing ``cuda:0`` over gloo
   (`chip_smoke.py --ep-rank R WORKDIR`), the model cut to 2 layers,
   AdamW steps against the same steps in one process (first-step
   gradients, every loss, the last parameters), the step medians and
   the expert axis's bytes a step printed; the experts' input gradient
   left unsummed over the axis (a planted fault) must be refused.

Launch counts: every kernel wrapper counts its launches; the counts are
set to 0 just before each main-path phase (generate, engine, paged
engine, training, training under PowerSGD, each speculative run, each
phase-9 generate and engine run, each phase-10 generate, engine,
router and disagg run, each phase-11 generate and engine run, 12b's
training steps, 13a's control and chaos legs, each run of 14b in each
rank, each step run of 15a and each logits and burst run of 15b in each
rank, 16a's generate and each burst, 16b's steps and each step run of
16c in each rank) and read just after.
Each HF model's runs count into its own rows of the kernels line (12b
into Gemma-2B's), and phase 16's into the ``@moe`` rows (its backward
launches into the backward rows). Launches made to compare or time a kernel, and the
traced step and tick, do not count.
``--json PATH`` also writes every number to a JSON file.
"""

import argparse
import contextlib
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
# Phase 8, speculative decoding: k proposals a round; the perturbed
# draft's noise, as a share of each weight leaf's own standard deviation
# (seeded), is chosen so that its acceptance lies inside
# SPEC_ACCEPT_RANGE: `chip_probe.py spec` read accepted / (k x rounds)
# 0.875, 0.750, 0.406, 0.200 and 0.013 at shares 0, 0.02, 0.05, 0.1
# and 0.2 (512 -> 64 tokens, an H100 80GB HBM3 at 700 W).
SPEC_K = 4
SPEC_NOISE = 0.05
SPEC_NOISE_SEED = 8
SPEC_ACCEPT_RANGE = (0.2, 0.9)
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

# Phase 7, the data-parallel surface. Word2vec at the JAX model's
# default width; Zipf skip-grams (exponent 1.1, the shape of word
# frequencies) of one fixed batch, so 8 Adagrad steps must lower the loss.
W2V_VOCAB, W2V_DIM, W2V_BATCH, W2V_NEG, W2V_STEPS = 50000, 128, 4096, 16, 8
# The sparse allreduce's dense result against the dense gradient of the
# same loss, relative to the gradient's largest entry: both sum the same
# f32 rows (scatter-add vs autograd's embedding backward), in other
# orders (reading 4.4e-7; one slice dropped reads 1.7e-2).
SPARSE_TOL = 1e-5
# The flagship LM under PowerSGD: rank 4, 4 AdamW steps on one batch.
PSGD_RANK, PSGD_STEPS = 4, 4
# Error feedback: approx + new err == grad + old err in float32 up to
# one rounding of each term, relative to the leaf's largest |grad + err|
# (reading 1.1e-7).
EF_TOL = 1e-5
# The compressor on the card against the same compressor on the CPU from
# the same gradients and state: the approximations agree up to f32
# summation order (cuBLAS vs the CPU BLAS over up to 32768 rows) and
# the two QR implementations, relative to each leaf's largest entry;
# the reading is 3.4e-6 on an H100 80GB HBM3 at 700 W.
PSGD_CPU_TOL = 1e-4
# Phase 9. int8 weights against the float model's logits, relative to
# the largest float logit: the reference's sanity bound
# (tests/test_quantization.py). int8 KV against bf16 KV, teacher-forced
# logits relative to the largest logit: the reference's bound there.
QUANT_LOGIT_TOL = 0.05
KV_INT8_TOL = 0.08
# The rolling-window model (`bench.py --pos-emb rope --window 512`): each
# generated token's logit in one one-pass forward of the whole sequence
# lies within WINDOW_TIE_TOL of that row's top (the tie-aware rule of
# phase 8, at its tolerance).
WINDOW = 512
# Its depth: the rolling cache's bookkeeping is per layer, so 4 of the
# 12 layers keep every check (the f32 planted fault reads 0.131 at 4
# layers against WINDOW_F32_TOL, on the CPU) at a third of the
# phase's time (phase 15 made room).
WINDOW_LAYERS = 4
WINDOW_TIE_TOL = LOGIT_TOL
# The same model in f32: its rolling decode's teacher-forced logits
# against its one-pass forward (absolute, logit units).
WINDOW_F32_TOL = 1e-3
# Phase 10, the fleet: the seeded half of phase 4b's burst samples at
# this temperature (no nucleus, so the tie-aware rule sees the exact
# scores); `generate`'s seed; the chaos kill is armed once request 0
# has FLEET_KILL_AT of its 64 tokens, under the chaos seed.
FLEET_TEMPERATURE = 0.8
FLEET_SEED = 2026
FLEET_KILL_AT = 16
FLEET_CHAOS_SEED = 10

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
    import re
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
            D = int(re.search(r"ILi(\d+)E", name).group(1))
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
    want = {f"{stem} bf16 D={D}" for stem in WGMMA_SOURCES
            for D in (64, 128, 256)}
    if set(rows) != want:
        raise AssertionError(f"expected the wgmma instantiations "
                             f"{sorted(want)}, found {sorted(rows)}")
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
               free=(), H=8, D=128):
    """One paged-decode input set: one lane per fill over a pool of
    ``nb`` blocks (default: lanes x T + 1), each lane's table a random
    draw of T distinct pool blocks (lanes may share blocks, as prefix
    sharing does); the lanes in ``free`` get the all-null table of a
    free engine lane."""
    import torch
    L = len(fills)
    nb = nb or L * T + 1
    kp = torch.randn(nb, bs, hkv, D, device=dev, generator=g).to(dt)
    vp = torch.randn(nb, bs, hkv, D, device=dev, generator=g).to(dt)
    tables = torch.stack([
        torch.randperm(nb - 1, device=dev, generator=g)[:T] + 1
        for _ in range(L)]).int()
    tables[list(free)] = 0
    q = torch.randn(L, H, D, device=dev, generator=g).to(dt)
    kn = torch.randn(L, hkv, D, device=dev, generator=g).to(dt)
    vn = torch.randn(L, hkv, D, device=dev, generator=g).to(dt)
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


def check_backward(tfa, dev, cases=None, names=("flash_bwd_dq",
                                                 "flash_bwd_dkv"),
                   seed=2468):
    """Phase 2c (and 12a with ``cases=BWD256_CASES``): the dQ and dK/dV
    kernels against the plain backward on the forward kernel's saved
    (out, lse). The case named "path ..." also carries the planted
    faults: the plain dK/dV one query row short (both dtypes) and, in
    bf16, p and ds rounded to one bf16 against the hi + lo split. Errors
    go to ``names`` (the dQ and the dK/dV row)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    n_dq, n_dkv = names
    errs = {n: {"max_abs_err_f32": 0.0} for n in names}
    # (name, (B, Sq, Sk, H, Hkv, D), kwargs, cotangent on lse, q/k/v as
    # views of one fused projection)
    cases = cases or [
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
            for kern, err in ((n_dq, res[0][0]),
                              (n_dkv, max(res[1][0], res[2][0]))):
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
                errs[n_dkv][f"planted_fault_err_{dtype}"] = ferr
            if name.startswith("path") and dtype == "bfloat16":
                check_rounding_fault(tfa, (q, k, v, out, lse, go), ref, kw,
                                     tol, errs, names)
            del q, k, v, go, out, lse, got, ref
    return errs


def check_rounding_fault(tfa, args, ref, kw, tol, errs,
                         names=("flash_bwd_dq", "flash_bwd_dkv")):
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
    errs[names[0]]["planted_fault_rounded_err"] = counts[False][0][0]
    errs[names[1]]["planted_fault_rounded_err"] = max(
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
    q3, k3, v3 = (torch.randn(B3, S3, H, D, device=dev,
                              generator=g).to(bf) for _ in range(3))
    prod = 2.0 * S3 * S3 * D * H * B3 / 2    # one causal [S,D]x[D,S] product
    tensor = B3 * S3 * H * D * 2             # one [B, S, H, D] bf16 tensor
    ms3 = cuda_time_ms(lambda: tfa.flash_fwd_cuda(q3, k3, v3, causal=True),
                       iters=10)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q3, k3, v3))
    rows["flash_fwd"]["at_8x2048"] = dict(
        ms=ms3, bound_ms=max(2 * prod / PEAK_BF16_FLOPS,
                             (4 * tensor + B3 * H * S3 * 4) / PEAK_BYTES)
        * 1e3,
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), iters=10))
    del q3, k3, v3, qs, ks, vs
    rows.update(time_backward(tfa, dev, g, B3, S3, H, H, D))
    return rows


def time_backward(tfa, dev, g, B, S, H, Hkv, D, tag=""):
    """The dQ and dK/dV kernels (rows ``flash_bwd_dq<tag>``,
    ``flash_bwd_dkv<tag>``) and the whole backward as the training step
    runs it (``flash_backward<tag>``: the eager dvec pass, then both
    kernels), bf16 causal at [B, S, H, D] over Hkv kv heads, beside the
    plain backward, SDPA's backward and the bound from these inputs.
    First the forward, dQ and dK/dV kernels are held against their plain
    versions on these same inputs (TOL, LSE_TOL, GRAD_TOL): each row's
    ``max_abs_err`` is read on the inputs it is timed on."""
    import torch
    import torch.nn.functional as F
    bf = torch.bfloat16
    q, go = (torch.randn(B, S, H, D, device=dev, generator=g).to(bf)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, device=dev, generator=g).to(bf)
            for _ in range(2))
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal=True)
    dvec = (go.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    # Each kernel against its plain version on the inputs it is timed
    # on: the forward that saves (o, lse), then dQ and dK/dV.
    ro, rlse = tfa.flash_attention_plain(q, k, v, causal=True)
    ref = tfa.flash_backward_plain(q, k, v, o, lse, go, causal=True)
    got = (tfa.flash_bwd_dq_cuda(q, k, v, go, lse, dvec, causal=True),
           *tfa.flash_bwd_dkv_cuda(q, k, v, go, lse, dvec, causal=True))
    torch.cuda.synchronize()
    fwd = [max_err(o, ro, TOL["bfloat16"]), max_err(lse, rlse, (LSE_TOL, 0))]
    res = [max_err(a, b, GRAD_TOL["bfloat16"]) for a, b in zip(got, ref)]
    log(f"timed inputs [{B},{S},{H},{D}] Hkv {Hkv} bf16 causal, kernels vs "
        f"plain: forward out {fwd[0][0]:.3e} lse {fwd[1][0]:.3e}, dq "
        f"{res[0][0]:.3e} dk {res[1][0]:.3e} dv {res[2][0]:.3e}")
    if not all(ok for _, ok in fwd + res):
        raise AssertionError(f"kernels vs plain on the timed inputs "
                             f"[{B},{S},{H},{D}] Hkv {Hkv}: forward {fwd}, "
                             f"backward {res}")
    checked = {"flash_bwd_dq": res[0][0],
               "flash_bwd_dkv": max(res[1][0], res[2][0])}
    del ro, rlse, ref, got
    prod = 2.0 * S * S * D * H * B / 2    # one causal [S,D]x[D,S] product
    qh = B * S * H * D * 2                # one [B, S, H, D] bf16 tensor
    kvh = B * S * Hkv * D * 2             # one [B, S, Hkv, D] bf16 tensor
    rowv = 2 * B * H * S * 4              # lse and dvec, f32
    plain_ms = cuda_time_ms(lambda: tfa.flash_backward_plain(
        q, k, v, o, lse, go, causal=True), iters=3, warmup=1)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gqa = dict(enable_gqa=True) if Hkv != H else {}
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, **gqa)
    gs = go.transpose(1, 2).contiguous()
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        os_, (qs, ks, vs), gs, retain_graph=True), iters=10)
    del os_, qs, ks, vs
    # SDPA's backward also computes its own rowsum(dO * O).
    rows = {f"flash_backward{tag}": dict(
        shape=[B, S, H, D], hkv=Hkv, dtype="bfloat16",
        ms=cuda_time_ms(lambda: tfa.flash_backward(
            q, k, v, o, lse, go, causal=True), iters=10),
        library_ms=lib_ms, fwd_max_abs_err=fwd[0][0],
        fwd_lse_max_abs_err=fwd[1][0])}
    kw = dict(causal=True)
    # The function's own products: dQ = s, dp, ds k; dK/dV = s, dp,
    # p^T dO, ds^T q (per query head, folded over the group). The bf16
    # kernels run ds k (dQ), and p^T dO and ds^T q (dK/dV), twice each
    # (bf16 hi + lo), and at D = 256 the dK/dV kernel's two warpgroups
    # each compute s and dp: choices of implementation, not work the
    # function needs, so they are not bound. Bytes: dQ reads q, k, v,
    # dO, lse, dvec and writes dq; dK/dV writes dk and dv instead.
    for name, fn, nprod, nbytes in (
            ("flash_bwd_dq", lambda: tfa.flash_bwd_dq_cuda(
                q, k, v, go, lse, dvec, **kw), 3, 3 * qh + 2 * kvh + rowv),
            ("flash_bwd_dkv", lambda: tfa.flash_bwd_dkv_cuda(
                q, k, v, go, lse, dvec, **kw), 4, 2 * qh + 4 * kvh + rowv)):
        t_flop, t_byte = nprod * prod / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        rows[name + tag] = dict(
            shape=[B, S, H, D], hkv=Hkv, dtype="bfloat16",
            ms=cuda_time_ms(fn, iters=20), plain_ms=plain_ms,
            max_abs_err=checked[name],
            library_ms=lib_ms, bound_ms=max(t_flop, t_byte) * 1e3,
            bound_by="operations" if t_flop >= t_byte else "bytes",
            library="backward of scaled_dot_product_attention(is_causal="
                    f"True{', enable_gqa=True' if gqa else ''}) through "
                    "torch.autograd.grad: dQ, dK and dV in one call, the "
                    "same number in both backward rows; the plain time is "
                    "flash_backward_plain, which also computes all three")
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
        # 11d: one more step under the profiler (not counted above).
        info["trace"] = traced(lambda: step(tokens), "training step "
                               "(B=8 x 2048, AdamW)")
        for k in wrappers:
            n = info["trace"]["launches"][k]
            if n != model.num_layers:
                raise AssertionError(f"the traced step launched {k} {n} "
                                     f"times, not {model.num_layers}")
        info.update(check_train_step(model, tfa, tokens[:2]))
        return info
    finally:
        hvd.shutdown()


def train_step_errors(model, tfa, tokens):
    """Loss and every parameter's gradient of one step through the
    kernels against the same step on the plain versions, and against
    the plain backward one query row short (a planted fault): the plain
    step's gradients are kept, the other two are held to them as they
    are computed (per-parameter max |k - p| / max |p|), so the
    gradients are on the card at most twice beside the model."""
    from horovod_tpu_torch.models.transformer import _lm_data_loss
    named = list(model.named_parameters())

    def backward():
        model.zero_grad(set_to_none=True)
        loss = _lm_data_loss(model, tokens, 512)
        loss.backward()
        return float(loss.detach())

    with plain_training_attention(tfa):
        p_loss = backward()
    p_grads = [p.grad for _, p in named]

    def errors():
        return {n: float((p.grad - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for (n, p), g in zip(named, p_grads)}

    k_loss = backward()
    per = errors()
    with plain_training_attention(tfa, planted_short_backward(tfa)):
        f_loss = backward()
    ferr = max(errors().values())
    model.zero_grad(set_to_none=True)
    return dict(check_loss=k_loss, check_plain_loss=p_loss,
                check_grad_err=max(per.values()),
                check_planted_fault_grad_err=ferr,
                check_planted_fault_loss=f_loss,
                top=sorted(per.items(), key=lambda kv: -kv[1])[:3])


def check_train_step(model, tfa, tokens):
    """Phase 5's `train_step_errors`, held to STEP_LOSS_TOL and
    STEP_GRAD_TOL, which the planted fault must exceed."""
    r = train_step_errors(model, tfa, tokens)
    k_loss, p_loss = r["check_loss"], r["check_plain_loss"]
    err, ferr = r["check_grad_err"], r["check_planted_fault_grad_err"]
    log(f"train step B=2, kernels vs plain: loss {k_loss:.6f} vs "
        f"{p_loss:.6f} (|diff| {abs(k_loss - p_loss):.2e}, tol "
        f"{STEP_LOSS_TOL}), worst per-parameter gradient error "
        f"{err:.3e} (tol {STEP_GRAD_TOL}; top {r['top']})")
    log(f"train step B=2, planted fault (plain dK/dV one query row short) "
        f"vs plain: worst per-parameter gradient error {ferr:.3e}, loss "
        f"|diff| {abs(r['check_planted_fault_loss'] - p_loss):.2e}")
    if abs(k_loss - p_loss) > STEP_LOSS_TOL or err > STEP_GRAD_TOL:
        raise AssertionError(f"train step through the kernels differs: "
                             f"loss {k_loss} vs {p_loss}, grad err {err}")
    if ferr <= STEP_GRAD_TOL:
        raise AssertionError(f"the train-step check does not see a dK/dV "
                             f"one query row short ({ferr})")
    return {k: v for k, v in r.items()
            if k not in ("top", "check_planted_fault_loss")}


def teacher_forced_logits(model, prompt, forced, n_ticks):
    """Last-position logits of the prefill and ``n_ticks`` decode ticks
    fed the tokens ``forced`` [B, >= n_ticks]."""
    import torch
    from horovod_tpu_torch.models.transformer import init_cache
    from horovod_tpu_torch.models.transformer import project_logits
    cache = init_cache(model, prompt.shape[0])
    outs = []
    toks = prompt
    for t in range(n_ticks + 1):
        hidden, head = model(toks, cache, return_hidden=True)
        cache.index += toks.shape[1]
        outs.append(project_logits(hidden[:, -1], head).float())
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
        leaves = ([t for layer in pool._pools for t in layer]
                  if engine_kw.get("paged") else pool._cache.tensors())
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
                streams=[r.tokens.tolist() for r in results],
                spec_rounds=snap["spec_rounds"],
                spec_acceptance_rate=snap["spec_acceptance_rate"],
                tokens_per_tick=snap["tokens_per_tick"],
                splits=splits, completed=snap["completed"], tokens=tokens,
                tokens_per_s=tokens / dt,
                ttft_ms_p50=snap["ttft_ms"]["p50"],
                tpot_ms_p50=snap["tpot_ms"]["p50"],
                prefix_hits=snap["prefix_hits"],
                prefill_tokens_skipped=snap["prefill_tokens_skipped"],
                peak_active=snap["peak_active"], kv_bytes=kv_bytes,
                prompt_tokens=int(sum(len(p) for p in prompts)))


def engine_prompts(vocab):
    """Phase 4's burst: 16 prompts of 32..512 tokens."""
    import numpy as np
    rs = np.random.RandomState(3)
    return [rs.randint(0, vocab, (int(n),)) for n in rs.randint(32, 513, 16)]


def paged_prompts(vocab):
    """Phase 4b's burst: 24 prompts, a shared 256-token system prompt
    plus a 32..256-token tail each."""
    import numpy as np
    rs = np.random.RandomState(5)
    system = rs.randint(0, vocab, (256,))
    return [np.concatenate([system, rs.randint(0, vocab, (int(n),))])
            for n in rs.randint(32, 257, 24)]


def run_engine(model, kernels):
    """Phase 4: full-width ServingEngine, 8 slots, 16 requests."""
    prompts = engine_prompts(model.vocab_size)
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


def paged_teacher_forced(model, tpa, dev, *, tol=LOGIT_TOL, n_ticks=8,
                         fault=None, what="paged"):
    """Phase 3b: teacher-forced logits on the paged primitives, the
    paged-decode kernel vs its plain version, at the paged engine's
    geometry: 16 lanes over 1025 blocks of 16 tokens, each lane's chain
    of blocks a random draw with the rest of its table null. Lanes
    0..12 are prefilled in 128-token chunks (`paged_prefill_chunk`)
    and then live; lane 12 ends its ticks at the fill == max_len
    boundary. Lanes 13 and 14 are prefilled and done, lane 15 is free.
    Then ``n_ticks`` teacher-forced ticks over all 16 lanes as ONE
    batched call each (`paged_decode_logits`, the engine tick's model
    half), held to ``tol``. The decode one key short (a planted fault:
    ``fault``, by default the plain version) must fail the same
    comparison, and the pools must hold rows exactly where the lanes'
    fills put them: no write of a done, free or boundary lane reaches a
    real block."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import transformer as tt
    g = torch.Generator(device=dev).manual_seed(11)
    L, bs, nb, chunk = 16, 16, 1025, 128
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

    def prefill():
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
        return torch.stack(outs), pools, fills

    def run():
        """The ticks from copies of the prefilled pools and fills."""
        pools = [tuple(t.clone() for t in layer) for layer in snap]
        fills = fills0.clone()
        ticks = [tt.paged_decode_logits(
            model, spec, pools, tables, fills, forced[:, t], live, done,
            paged_kernel="pallas", prefix_len=max(lens) + t + 1)
            for t in range(n_ticks)]
        return torch.stack(ticks, 1), pools, fills

    def one_key_short(q, k_new, v_new, table, fill, k_pool, v_pool):
        return tpa.paged_decode_plain(q, k_new, v_new, table,
                                      (fill - 1).clamp(min=0), k_pool,
                                      v_pool)

    sel = torch.from_numpy(adv).to(dev)

    def compared(run_out):
        return torch.cat([pre.flatten(0, -2),
                          run_out[0][sel].flatten(0, -2)])

    with torch.no_grad():
        # The prefill (S > 1 chunks) walks the tables without the
        # paged-decode kernel: one prefill serves the three tick runs.
        pre, snap, fills0 = prefill()
        before = tpa.paged_decode_cuda.launches
        k_out = run()
        launched = tpa.paged_decode_cuda.launches - before
        with plain_paged_decode(tpa):
            p_out = run()
        with plain_paged_decode(tpa, fault or one_key_short):
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
    finite = bool(torch.isfinite(k_out[0]).all())
    log(f"{what} teacher-forced logits (16 lanes: prefill + {n_ticks} "
        f"batched ticks), kernel vs plain: max_abs_err {err:.4g} (tol "
        f"{tol}), argmax agreement {agree:.3f} (min "
        f"{MIN_ARGMAX_AGREEMENT}), |logit| max "
        f"{float(p_logits.abs().max()):.3f}; plain rows within the "
        f"tolerance of a tie / tied / all: {near_ties(p_logits)}")
    log(f"{what} teacher-forced logits, planted decode fault (one key "
        f"short) vs plain: max_abs_err {fault_err:.4g}, argmax agreement "
        f"{fault_agree:.3f}")
    if not finite or err > tol:
        raise AssertionError(f"{what} logits differ: {err}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"{what} argmax agreement {agree}")
    if fault_err <= tol:
        raise AssertionError(f"the {what} logits check does not see a "
                             f"decode one key short ({fault_err})")
    # The tick's write routing, on the kernel run's pools and fills:
    # rows hold bytes exactly where the fills put them, and the ticks
    # left every prefilled row as it was (a clipped id at the boundary
    # would overwrite the lane's last real block).
    _, pools, fills = k_out
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
                lanes=L, ticks=n_ticks, table_entries=spec.blocks_per_seq)


def run_paged_engine(model, kernels):
    """Phase 4b: the full-width paged engine through the paged-decode
    kernel, 16 slots over the 8-slot fixed pool's KV bytes; then the
    same burst on that fixed 8-slot pool (same KV bytes), the paged
    pool's yardstick."""
    prompts = paged_prompts(model.vocab_size)
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


def perturbed_draft(model, share, seed=SPEC_NOISE_SEED):
    """Phase 8's perturbed draft: a copy of ``model`` whose every weight
    leaf gets seeded Gaussian noise at ``share`` x the leaf's own
    standard deviation (added in f32, rounded to the leaf's dtype;
    constant leaves such as fresh norm scales and zero biases stay as
    they are). The JAX spec tests' `noisy_draft` at full width."""
    import copy
    import torch
    draft = copy.deepcopy(model)
    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for p in draft.parameters():
            x = p.float()
            noise = torch.randn(x.shape, device=x.device, generator=g)
            p.copy_((x + share * x.std() * noise).to(p.dtype))
    return draft


def stream_verdict(model, prompt, plain, spec, tol=LOGIT_TOL):
    """The tie-aware stream rule: None when ``spec`` equals ``plain``;
    else, at their first difference d, the plain stream's teacher-forced
    logits for token d (one forward of the prompt and the plain stream's
    first d tokens) and whether the difference is a near tie: the logit of ``spec[d]`` there
    within ``tol`` (LOGIT_TOL by default) of the row's top, so that the two picks are the top
    two within LOGIT_TOL (bf16 logits tie exactly often, and three-way
    ties occur). The verify's S=k+1 logits on the plain prefix loop and
    the tick's S=1 logits on the decode kernel differ by summation order
    in bf16, which may flip such a pick. Any other difference is a
    fault."""
    import torch
    if list(spec) == list(plain):
        return None
    d = next(i for i, (a, b) in enumerate(zip(plain, spec)) if a != b)
    seq = torch.as_tensor(list(prompt) + list(plain[:d]),
                          device=model.device)[None].long()
    with torch.no_grad():
        hidden, head = model(seq, return_hidden=True)
        row = (hidden[0, -1] @ head.to(hidden.dtype).T).float()
    gap = float(row.max() - row[int(spec[d])])
    return dict(position=d, gap=gap, near_tie=gap < tol)


def check_streams(model, prompts, plain, spec, what, *, fault=False):
    """Every spec stream against its plain stream under `stream_verdict`.
    Returns (streams equal, near-tie divergences, faults). Raises on a
    fault unless ``fault`` (a planted-fault run, whose caller asserts
    that faults were seen)."""
    equal, ties, faults = 0, [], []
    for i, (p, a, b) in enumerate(zip(prompts, plain, spec)):
        v = stream_verdict(model, p, a, b)
        if v is None:
            equal += 1
        elif v["near_tie"]:
            ties.append(dict(stream=i, **v))
        else:
            faults.append(dict(stream=i, **v))
    if faults and not fault:
        raise AssertionError(f"{what}: spec streams differ from the plain "
                             f"greedy streams off a near tie: {faults}")
    return equal, ties, faults


def spec_round_syncs(model, draft, prompts, paged):
    """Host syncs of one steady spec round (a warm round first), counted
    under CUDA's sync debug mode as in phase 7b: 8 lanes of phase 4's
    prompts on the fixed pool, or on a paged pool of 16-token blocks
    through the paged kernel's mode."""
    import warnings
    import torch
    from horovod_tpu_torch.serving import PagedSlotPool, SlotPool
    if paged:
        pool = PagedSlotPool(model, 8, block_size=16, kernel="pallas",
                             spec_draft=draft, spec_k=SPEC_K)
    else:
        pool = SlotPool(model, 8, spec_draft=draft, spec_k=SPEC_K)
    for p in prompts[:8]:
        pool.prefill(pool.admit(p, 64).slot, p, 0.0, None, 0, max_chunk=128)
    pool.spec_round()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pool.spec_round()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


@contextlib.contextmanager
def planted_rewind(tt):
    """Context: the spec round's rewind lands one row past pre + n_emit
    on every advancing lane (a planted fault, patched into
    `models.transformer`, where the round looks it up at call time)."""
    saved = tt._rewind_indices

    def one_past(cache, pre, delta):
        saved(cache, pre, delta + (delta > 0).to(delta.dtype))
    tt._rewind_indices = one_past
    try:
        yield
    finally:
        tt._rewind_indices = saved


def run_speculative(model, tfa, eng, peng):
    """Phase 8: speculative decoding at full width, k = SPEC_K, with the
    self-draft (the target itself) and the perturbed draft. (a)
    `generate_speculative` of one 512-token prompt -> 128 tokens against
    a plain batch-1 `generate` of it; (b) the fixed engine, 8 slots, on
    phase 4's burst against phase 4's streams; (c) the paged engine, 16
    slots over 1025 blocks of 16, on phase 4b's burst (perturbed draft)
    against phase 4b's streams. Every stream under the tie-aware rule
    (`check_streams`); the perturbed draft's acceptance in
    SPEC_ACCEPT_RANGE; the flash-decode kernel >= layers x (k+1) x
    rounds launches in each engine run and the flash forward in (a); one
    host sync a steady round; and the rewind one row past (a planted
    fault) must break (b)'s perturbed streams."""
    import torch
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.models.speculative import generate_speculative
    L = model.num_layers
    drafts = {"self": model,
              "perturbed": perturbed_draft(model, SPEC_NOISE)}
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda}
    out = dict(k=SPEC_K, noise_share=SPEC_NOISE, runs={})
    runs = out["runs"]

    # (a) generate_speculative against a plain batch-1 generate.
    g = torch.Generator(device=model.device).manual_seed(9)
    prompt = torch.randint(0, model.vocab_size, (1, 512),
                           device=model.device, generator=g)
    torch.cuda.synchronize()
    t0 = time.time()
    plain = tt.generate(model, prompt, 128)[0, 512:].tolist()
    plain_s = time.time() - t0
    for name, draft in drafts.items():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.time()
        toks, stats = generate_speculative(draft, model, prompt, 128,
                                           k=SPEC_K, return_stats=True)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        equal, ties, _ = check_streams(
            model, [prompt[0].tolist()], [plain], [toks[0, 512:].tolist()],
            f"generate_speculative ({name} draft)")
        r = runs[f"8a_{name}"] = dict(
            seconds=dt, plain_seconds=plain_s, launches=launches,
            rounds=stats["rounds"], accepted=stats["draft_accepted"],
            acceptance=stats["draft_accepted"] / (SPEC_K * stats["rounds"]),
            tokens_per_tick=(stats["tokens"] - 1) / stats["rounds"],
            tokens_per_s=stats["tokens"] / dt, equal=equal, ties=ties)
        if launches["flash_fwd"] < 2 * L or launches["flash_decode"] <= 0:
            raise AssertionError(f"generate_speculative ({name}) launches "
                                 f"{launches}")
        log(f"8a generate_speculative 512 -> 128, {name} draft: "
            f"{r['rounds']} rounds, acceptance (accepted / k x rounds) "
            f"{r['acceptance']:.3f}, tokens/tick {r['tokens_per_tick']:.2f},"
            f" {dt:.3f} s wall, {r['tokens_per_s']:.1f} tokens/s (plain "
            f"batch-1 generate {plain_s:.3f} s); stream equal {equal}/1, "
            f"near ties {ties}; launches {launches}")

    def engine_run(tag, prompts, plain_streams, plain_info, draft,
                   **engine_kw):
        info = serve_burst(model, prompts, 64, kernels, spec_draft=draft,
                           spec_k=SPEC_K, **engine_kw)
        info["equal"], info["ties"], _ = check_streams(
            model, prompts, plain_streams, info["streams"], tag)
        rounds = info["spec_rounds"]
        if info["launches"]["flash_decode"] < L * (SPEC_K + 1) * rounds:
            raise AssertionError(
                f"{tag}: flash_decode launches "
                f"{info['launches']['flash_decode']} < {L} x "
                f"{SPEC_K + 1} x {rounds} rounds")
        runs[tag] = info
        log(f"{tag}: {rounds} rounds, acceptance "
            f"{info['spec_acceptance_rate']}, tokens/tick "
            f"{info['tokens_per_tick']}, TTFT p50 {info['ttft_ms_p50']} ms,"
            f" TPOT p50 {info['tpot_ms_p50']} ms, "
            f"{info['tokens_per_s']:.1f} tokens/s, {info['seconds']:.2f} s "
            f"wall (plain: TTFT p50 {plain_info['ttft_ms_p50']} ms, TPOT "
            f"p50 {plain_info['tpot_ms_p50']} ms, "
            f"{plain_info['tokens_per_s']:.1f} tokens/s, "
            f"{plain_info['seconds']:.2f} s, {plain_info['ticks']} ticks); "
            f"streams equal {info['equal']}/{len(prompts)}, near ties "
            f"{info['ties']}; launches {info['launches']}")
        return info

    # (b) the fixed engine on phase 4's burst.
    e_prompts = engine_prompts(model.vocab_size)
    for name, draft in drafts.items():
        engine_run(f"8b_fixed_{name}", e_prompts, eng["streams"], eng,
                   draft, num_slots=8)
    acc = runs["8b_fixed_perturbed"]["spec_acceptance_rate"]
    lo, hi = SPEC_ACCEPT_RANGE
    if not lo < acc < hi:
        raise AssertionError(f"perturbed draft (share {SPEC_NOISE}) "
                             f"acceptance {acc} outside ({lo}, {hi})")
    # (c) the paged engine on phase 4b's burst, perturbed draft.
    c = engine_run("8c_paged_perturbed", paged_prompts(model.vocab_size),
                   peng["streams"], peng, drafts["perturbed"],
                   num_slots=16, paged=True, paged_kernel="pallas",
                   kv_block_size=16, kv_blocks=1025)
    if c["prefill_tokens_skipped"] != 0:
        raise AssertionError("spec mode must turn the prefix cache off")

    # One host sync a steady round.
    out["round_syncs"] = {}
    for pool_kind in ("fixed", "paged"):
        syncs = spec_round_syncs(model, drafts["perturbed"], e_prompts,
                                 pool_kind == "paged")
        out["round_syncs"][pool_kind] = len(syncs)
        log(f"host syncs in one steady spec round, {pool_kind} pool, 8 "
            f"lanes: {len(syncs)} {sorted(set(syncs))[:3]}")
        if len(syncs) != 1:
            raise AssertionError(f"{pool_kind} spec round made "
                                 f"{len(syncs)} host syncs, not 1")

    # The planted fault: the rewind one row past pre + n_emit.
    with planted_rewind(tt):
        bad = serve_burst(model, e_prompts, 64, kernels, num_slots=8,
                          spec_draft=drafts["perturbed"], spec_k=SPEC_K)
    _, f_ties, faults = check_streams(model, e_prompts, eng["streams"],
                                      bad["streams"], "planted", fault=True)
    out["planted_rewind_faults"] = len(faults)
    log(f"8b planted fault (rewind one row past pre + n_emit): "
        f"{len(faults)} of {len(e_prompts)} streams fail the tie-aware "
        f"check, near ties {len(f_ties)}")
    if not faults:
        raise AssertionError("the stream check does not see a spec rewind "
                             "one row past pre + n_emit")
    return out


# -- phase 9: int8 weights, int8 KV and the rolling window -------------------

def variant(model, **changes):
    """The serving model's configuration with ``changes``, sharing its
    weights (phase 9c's int8-KV model)."""
    v = model.clone(**changes)
    v.load_state_dict(model.state_dict(), assign=True)
    return v.eval()


def quant_sites(model):
    """The float model's block-matmul kernels `quantize_lm` replaces."""
    from horovod_tpu_torch.ops.quantization import QUANT_KERNEL_MODULES
    return [m.kernel for name, m in model.named_modules()
            if name.rsplit(".", 1)[-1] in QUANT_KERNEL_MODULES]


def run_int8_bitwise(model, dev):
    """Phase 9a: `quantize_lm` of the serving model, one forward at [4,
    512], against the float model loaded with the dequantized state dict
    at bf16 (bitwise) and against the float model (within
    QUANT_LOGIT_TOL of its largest logit); the weight bytes."""
    import torch
    from horovod_tpu_torch.ops.quantization import (dequantize_lm_params,
                                                    quantize_lm)
    qmodel = quantize_lm(model)
    deq = model.clone()
    deq.load_state_dict(dequantize_lm_params(qmodel.state_dict(),
                                             torch.bfloat16), assign=True)
    deq.eval()
    g = torch.Generator(device=dev).manual_seed(21)
    toks = torch.randint(0, model.vocab_size, (4, 512), device=dev,
                         generator=g)
    with torch.no_grad():
        q_logits = qmodel(toks)
        d_logits = deq(toks)
        f_logits = model(toks)
    torch.cuda.synchronize()
    diff = float((q_logits.float() - d_logits.float()).abs().max())
    rel = float((q_logits.float() - f_logits.float()).abs().max()
                / f_logits.float().abs().max())
    fl = sum(k.numel() * k.element_size() for k in quant_sites(model))
    qb = sum(b.numel() * b.element_size()
             for name, b in qmodel.named_buffers()
             if name.endswith(("kernel_q", "kernel_scale")))
    log(f"9a int8 weights (quantize_lm), forward [4, 512]: max |int8 model "
        f"- float model on the dequantized (bf16) state dict| {diff} "
        f"(must be 0; bitwise equal {torch.equal(q_logits, d_logits)}); "
        f"max |int8 - float| / max |float| {rel:.4f} (tol "
        f"{QUANT_LOGIT_TOL}); block kernels {qb / 1e6:.1f} MB int8 + scales "
        f"vs {fl / 1e6:.1f} MB bf16")
    if not torch.equal(q_logits, d_logits):
        raise AssertionError(f"int8 forward is not bitwise the dequantized "
                             f"model's (max |diff| {diff})")
    if not rel < QUANT_LOGIT_TOL:
        raise AssertionError(f"int8 logits off the float logits by {rel}")
    del deq
    return qmodel, dict(max_abs_diff_vs_dequantized=diff,
                        rel_err_vs_float=rel, int8_weight_bytes=qb,
                        bf16_weight_bytes=fl)


def check_bucketed(model, prompts, engine_streams, what):
    """``generate_bucketed`` of ``prompts`` (64 new tokens each) as the
    reference of an engine run's streams, under the tie-aware rule
    (`check_streams`). Returns (equal, near ties, seconds)."""
    import torch
    from horovod_tpu_torch.models.transformer import generate_bucketed
    torch.cuda.synchronize()
    t0 = time.time()
    ref = generate_bucketed(model, [torch.as_tensor(p) for p in prompts],
                            64)
    torch.cuda.synchronize()
    dt = time.time() - t0
    ref = [r[len(p):].tolist() for r, p in zip(ref, prompts)]
    equal, ties, _ = check_streams(model, prompts, ref, engine_streams, what)
    return equal, ties, dt


def run_int8_main_path(model, qmodel, tfa, kernels, gen, eng, peng):
    """Phase 9b: the int8-weight model on the main path: `generate` 4 x
    512 -> 128, the fixed engine (8 slots, phase 4's burst) and the
    paged engine (16 slots over 1025 blocks of 16, phase 4b's burst),
    both quantizing at the door (``weight_quant="int8"``); each engine's
    streams against `generate_bucketed` of the int8 model under the
    tie-aware rule; B1, B3 and B4 must launch."""
    import torch
    from horovod_tpu_torch.models.transformer import generate
    g = torch.Generator(device=model.device).manual_seed(7)
    prompt = torch.randint(0, model.vocab_size, (4, 512),
                           device=model.device, generator=g)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    out = generate(qmodel, prompt, 128)
    torch.cuda.synchronize()
    g_s = time.time() - t0
    g_launch = {k: fn.launches for k, fn in kernels.items()}
    want = {"flash_fwd": model.num_layers,
            "flash_decode": 127 * model.num_layers, "paged_decode": 0}
    if out.shape != (4, 640) or g_launch != want:
        raise AssertionError(f"int8 generate {tuple(out.shape)}, launches "
                             f"{g_launch} != {want}")
    fixed = serve_burst(model, engine_prompts(model.vocab_size), 64,
                        kernels, num_slots=8, weight_quant="int8")
    paged = serve_burst(model, paged_prompts(model.vocab_size), 64,
                        kernels, num_slots=16, paged=True,
                        paged_kernel="pallas", kv_block_size=16,
                        kv_blocks=1025, weight_quant="int8")
    res = dict(generate=dict(seconds=g_s, launches=g_launch,
                             plain_seconds=gen["seconds"]),
               fixed=fixed, paged=paged)
    for tag, info, prompts in (
            ("fixed", fixed, engine_prompts(model.vocab_size)),
            ("paged", paged, paged_prompts(model.vocab_size))):
        info["equal"], info["ties"], info["bucketed_seconds"] = (
            check_bucketed(qmodel, prompts, info["streams"],
                           f"9b int8 {tag} engine"))
    L = model.num_layers
    if fixed["launches"]["flash_decode"] < fixed["ticks"] * L:
        raise AssertionError(f"9b fixed: B3 launches {fixed['launches']}")
    if paged["launches"]["paged_decode"] < paged["ticks"] * L:
        raise AssertionError(f"9b paged: B4 launches {paged['launches']}")
    log(f"9b int8 generate 4x512 -> 128: {g_s:.3f} s wall (bf16 weights, "
        f"phase 3: {gen['seconds']:.3f} s), launches {g_launch}")
    for tag, info, plain in (("fixed engine, 8 slots", fixed, eng),
                             ("paged engine, 16 slots", paged, peng)):
        log(f"9b int8 {tag}: TTFT p50 {info['ttft_ms_p50']} ms, TPOT p50 "
            f"{info['tpot_ms_p50']} ms, {info['tokens_per_s']:.1f} "
            f"tokens/s, {info['ticks']} ticks (bf16 weights, phase 4/4b: "
            f"TTFT p50 {plain['ttft_ms_p50']} ms, TPOT p50 "
            f"{plain['tpot_ms_p50']} ms, {plain['tokens_per_s']:.1f} "
            f"tokens/s); streams equal to generate_bucketed "
            f"{info['equal']}/{len(info['streams'])}, near ties "
            f"{info['ties']}; launches {info['launches']}")
    return res


@contextlib.contextmanager
def planted_kv_codec(tensor, kind):
    """Context: the KV codec (`parallel.tensor._kv_quantize`, looked up
    at call time) replaced. ``"coarse"``: one scale per position over
    all heads for codes and scales alike (a coarser codec, still
    consistent); ``"per_position_scale"`` (the planted fault): the codes
    keep their per-(position, head) scales while the stored scale is
    one per position, the largest over the heads."""
    import torch
    from horovod_tpu_torch.ops.quantization import quantize_int8
    saved = tensor._kv_quantize

    def coarse(t):
        q, s = quantize_int8(t.flatten(-2), axis=-1)
        return q.view(t.shape), s[..., None].expand(t.shape[:-1]).contiguous()

    def per_position_scale(t):
        q, s = quantize_int8(t, axis=-1)
        return q, torch.amax(s, -1, keepdim=True).expand(s.shape).contiguous()
    tensor._kv_quantize = {"coarse": coarse,
                           "per_position_scale": per_position_scale}[kind]
    try:
        yield
    finally:
        tensor._kv_quantize = saved


def paged_forced_logits(model, prompt, forced, bs=16, chunk=128):
    """Teacher-forced last-position logits on the paged primitives: each
    lane's prompt prefilled in ``chunk``-token chunks into its own chain
    of blocks, then one batched S=1 tick per forced token (the paged
    kernel's mode: B4, or the walk for int8 pools)."""
    import torch
    from horovod_tpu_torch.models import transformer as tt
    L, P = prompt.shape
    n = forced.shape[1]
    dev = prompt.device
    spec = tt.paged_cache_spec(model, bs)
    T = spec.blocks_per_seq
    pools = tt.init_paged_pools(model, spec, L * T + 1)
    tables = (torch.arange(L * T, dtype=torch.int32, device=dev)
              .view(L, T) + 1)
    fills = torch.zeros(L, dtype=torch.int32, device=dev)
    outs = []
    for b in range(L):
        for o in range(0, P, chunk):
            last = tt.paged_prefill_chunk(model, spec, pools, tables, fills,
                                          b, prompt[b, o:o + chunk],
                                          paged_kernel="pallas", fill=o)
        outs.append(last)
    rows = [torch.stack(outs)]
    live = torch.ones(L, dtype=torch.bool, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    for t in range(n):
        rows.append(tt.paged_decode_logits(
            model, spec, pools, tables, fills, forced[:, t], live, done,
            paged_kernel="pallas", prefix_len=P + t + 1))
    return torch.stack(rows, 1)


def run_int8_kv(model, tfa, tpa, kernels):
    """Phase 9c: the serving model with ``kv_quant="int8"`` (its
    weights): teacher-forced logits of a 4 x 512 prompt and 64 S=1 ticks
    on the linear cache and on the paged pool against the bf16-KV run
    of each, within KV_INT8_TOL of the largest logit; the fixed engine
    on phase 4's burst; B3 and B4 make no launch under int8 KV (the
    reference routes int8 KV off its kernels). The codec with one
    stored scale per position (`planted_kv_codec`, a planted fault)
    must fail the linear check."""
    import torch
    from horovod_tpu_torch.parallel import tensor
    kvq = variant(model, kv_quant="int8")
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(31)
    prompt = torch.randint(0, model.vocab_size, (4, 512), device=dev,
                           generator=g)
    forced = torch.randint(0, model.vocab_size, (4, 64), device=dev,
                           generator=g)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    with torch.no_grad():
        ref_lin = teacher_forced_logits(model, prompt, forced, 64)
        ref_pag = paged_forced_logits(model, prompt, forced)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        lin = teacher_forced_logits(kvq, prompt, forced, 64)
        pag = paged_forced_logits(kvq, prompt, forced)
        torch.cuda.synchronize()
        tf_launches = {k: fn.launches for k, fn in kernels.items()}
        engine = serve_burst(kvq, engine_prompts(model.vocab_size), 64,
                             kernels, num_slots=8)
        tf_launches = {k: n + engine["launches"][k]
                       for k, n in tf_launches.items()}
        readings = {}
        for kind in ("coarse", "per_position_scale"):
            with planted_kv_codec(tensor, kind):
                readings[kind] = rel(teacher_forced_logits(
                    kvq, prompt, forced, 64), ref_lin)
    e_lin, e_pag = rel(lin, ref_lin), rel(pag, ref_pag)
    W, Hkv, D = model.max_len, model.num_kv, model.head_dim
    L = model.num_layers
    kv_int8 = 2 * L * W * Hkv * D
    kv_scales = 2 * L * W * Hkv * 4
    kv_bf16 = 2 * L * W * Hkv * D * 2
    log(f"9c int8 KV teacher-forced logits (4 x 512 prompt + 64 ticks) vs "
        f"bf16 KV, max |diff| / max |logit|: linear {e_lin:.4f}, paged "
        f"{e_pag:.4f} (tol {KV_INT8_TOL}); coarser codec (one scale a "
        f"position for codes and scales) {readings['coarse']:.4f}; planted "
        f"fault (codes per (position, head), one stored scale a position) "
        f"{readings['per_position_scale']:.4f}")
    log(f"9c KV bytes a slot: {kv_int8 / 1e6:.1f} MB int8 + "
        f"{kv_scales / 1e6:.1f} MB scales vs {kv_bf16 / 1e6:.1f} MB bf16; "
        f"fixed engine on phase 4's burst: {engine['completed']} of "
        f"{len(engine['streams'])} completed, TTFT p50 "
        f"{engine['ttft_ms_p50']} ms, TPOT p50 {engine['tpot_ms_p50']} ms, "
        f"{engine['tokens_per_s']:.1f} tokens/s; launches under int8 KV "
        f"(teacher forcing + engine) {tf_launches}: B3 and B4 stay off, "
        f"the reference's route")
    if not (e_lin < KV_INT8_TOL and e_pag < KV_INT8_TOL):
        raise AssertionError(f"int8 KV logits off: {e_lin}, {e_pag}")
    if not readings["per_position_scale"] >= KV_INT8_TOL:
        raise AssertionError("the int8-KV check does not see one stored "
                             "scale a position")
    if tf_launches["flash_decode"] or tf_launches["paged_decode"]:
        raise AssertionError(f"B3/B4 launched under int8 KV: {tf_launches}")
    if engine["completed"] != len(engine["streams"]):
        raise AssertionError("9c engine did not complete every request")
    return dict(linear_rel_err=e_lin, paged_rel_err=e_pag,
                coarse_codec_rel_err=readings["coarse"],
                planted_fault_rel_err=readings["per_position_scale"],
                kv_bytes_int8=kv_int8, kv_bytes_scales=kv_scales,
                kv_bytes_bf16=kv_bf16, launches=tf_launches, engine=engine)


@contextlib.contextmanager
def planted_no_block(tensor):
    """Context: the rolling branch attends its cache without the call's
    own rows (a planted fault, patched into `parallel.tensor`, where
    the branch looks `rolling_keep` up at call time)."""
    saved = tensor.rolling_keep

    def cache_only(index, qpos, W, window):
        keep = saved(index, qpos, W, window).clone()
        keep[..., W:] = False
        return keep
    tensor.rolling_keep = cache_only
    try:
        yield
    finally:
        tensor.rolling_keep = saved


def forward_logits(model, seq, start):
    """One one-pass forward of ``seq`` [B, T]: the f32 logits of rows
    start - 1 .. T - 2, each predicting the token after it."""
    import torch
    with torch.no_grad():
        hidden, head = model(seq, return_hidden=True)
        return (hidden[:, start - 1:-1] @ head.to(hidden.dtype).T).float()


def run_window(dev, tfa, kernels):
    """Phase 9d: the serving model with RoPE and a 512 window (`bench.py
    --pos-emb rope --window 512`, weights from seed 0), cut to
    WINDOW_LAYERS layers: `generate` of 4
    x 1024 -> 1100 tokens (to position 2123 > max_len) through B1's
    banded prefill and the rolling cache, checked against one one-pass
    forward of the whole sequence (B1 with the window): every generated
    token's logit within WINDOW_TIE_TOL of its row's top. The same model
    in f32 then checks the rolling cache's bookkeeping at f32 precision:
    its teacher-forced logits (a one-pass prefill of the first 2048
    generated tokens, then 64 ticks past max_len) against its one-pass
    forward within WINDOW_F32_TOL; the same ticks with the rolling
    branch attending its cache without the call's own rows
    (`planted_no_block`, a planted fault) must fail that check. Then
    the fixed engine on phase 4's burst against `generate_bucketed`
    under the tie-aware rule."""
    import torch
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      generate,
                                                      serving_params)
    from horovod_tpu_torch.parallel import tensor
    wmodel = TransformerLM(32768, WINDOW_LAYERS, 8, 128, max_len=2048,
                           pos_emb="rope",
                           window=WINDOW, dtype=torch.bfloat16,
                           attn_impl="flash", decode_prefix_block=256,
                           decode_prefix_impl="pallas", device=dev)
    wmodel.init_weights(0)
    serving_params(wmodel)
    wmodel.eval()
    g = torch.Generator(device=dev).manual_seed(41)
    P, steps, at, n_tf = 1024, 1100, 2048, 64
    prompt = torch.randint(0, wmodel.vocab_size, (4, P), device=dev,
                           generator=g)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    out = generate(wmodel, prompt, steps)
    torch.cuda.synchronize()
    g_s = time.time() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    fwd = forward_logits(wmodel, out, P)
    gaps = fwd.amax(-1) - fwd.gather(-1, out[:, P:, None])[..., 0]
    max_gap = float(gaps.max())
    n_off = int((gaps > 0).sum())
    del fwd
    w32 = wmodel.clone(dtype=torch.float32)
    w32.load_state_dict({k: v.float() for k, v in
                         wmodel.state_dict().items()}, assign=True)
    w32.eval()
    seq = out[:, :at + n_tf]
    rows = forward_logits(w32, seq, at)

    def forced():
        with torch.no_grad():
            return teacher_forced_logits(w32, out[:, :at],
                                         out[:, at:at + n_tf], n_tf)
    tf_err = float((forced()[:, :n_tf] - rows).abs().max())
    with planted_no_block(tensor):
        bad_err = float((forced()[:, :n_tf] - rows).abs().max())
    torch.cuda.synchronize()
    del w32, rows
    L = wmodel.num_layers
    cache_lane = 2 * L * WINDOW * wmodel.num_kv * wmodel.head_dim * 2
    log(f"9d rope + window {WINDOW}: generate 4 x {P} -> {steps} (last "
        f"position {P + steps - 1} > max_len {wmodel.max_len}): "
        f"{g_s:.3f} s wall, launches {launches}; one-pass forward (B1, "
        f"window) vs the generated tokens: {n_off} of {gaps.numel()} "
        f"tokens not its argmax, max gap {max_gap:.4f} (tol "
        f"{WINDOW_TIE_TOL}); cache {cache_lane / 1e6:.1f} MB a lane "
        f"({WINDOW} slots) vs {cache_lane * 4 / 1e6:.1f} MB at 2048")
    log(f"9d f32 teacher-forced rolling decode (prefill {at}, {n_tf} ticks) "
        f"vs the f32 one-pass forward: max_abs_err {tf_err:.3e} (tol "
        f"{WINDOW_F32_TOL}); planted fault (the rolling branch without the "
        f"call's own rows): {bad_err:.3e}")
    if out.shape != (4, P + steps) or launches["flash_fwd"] < L:
        raise AssertionError(f"window generate {tuple(out.shape)}, "
                             f"launches {launches}")
    if not max_gap < WINDOW_TIE_TOL:
        raise AssertionError(f"window generate off the one-pass forward: "
                             f"max gap {max_gap}")
    if not tf_err <= WINDOW_F32_TOL:
        raise AssertionError(f"rolling decode logits off the forward: "
                             f"{tf_err}")
    if not bad_err > WINDOW_F32_TOL:
        raise AssertionError("the window logits check does not see the "
                             "rolling branch without its own rows")
    prompts = engine_prompts(wmodel.vocab_size)
    eng = serve_burst(wmodel, prompts, 64, kernels, num_slots=8)
    eng["equal"], eng["ties"], eng["bucketed_seconds"] = check_bucketed(
        wmodel, prompts, eng["streams"], "9d window fixed engine")
    log(f"9d window fixed engine, 8 slots, phase 4's burst: TTFT p50 "
        f"{eng['ttft_ms_p50']} ms, TPOT p50 {eng['tpot_ms_p50']} ms, "
        f"{eng['tokens_per_s']:.1f} tokens/s, {eng['ticks']} ticks; "
        f"streams equal to generate_bucketed {eng['equal']}/16 "
        f"({eng['bucketed_seconds']:.1f} s), near ties {eng['ties']}; "
        f"launches {eng['launches']}")
    return dict(generate=dict(seconds=g_s, launches=launches,
                              max_gap=max_gap, tokens_off_argmax=n_off,
                              tokens=int(gaps.numel())),
                forced_logits_err=tf_err, planted_fault_logits_err=bad_err,
                cache_bytes_lane=cache_lane, engine=eng)


def run_variants(model, tfa, tpa, dev, gen, eng, peng):
    """Phase 9: int8 weights (9a, 9b), int8 KV (9c) and the rolling
    window (9d) at full width."""
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    t0 = time.time()
    qmodel, bitwise = run_int8_bitwise(model, dev)
    main = run_int8_main_path(model, qmodel, tfa, kernels, gen, eng, peng)
    del qmodel
    kv = run_int8_kv(model, tfa, tpa, kernels)
    window = run_window(dev, tfa, kernels)
    out = dict(int8_bitwise=bitwise, int8_main_path=main, int8_kv=kv,
               window=window, seconds=time.time() - t0)
    out["runs"] = dict(int8_generate=main["generate"],
                       int8_fixed=main["fixed"], int8_paged=main["paged"],
                       int8_kv_engine=kv["engine"],
                       window_generate=window["generate"],
                       window_engine=window["engine"])
    return out


# -- phase 10: threefry sampling and the serving fleet ----------------------

def fleet_engine_kw():
    """Each paged replica of phase 10: phase 4b's engine (16 slots over
    1025 blocks of 16 tokens through the paged-decode kernel)."""
    return dict(num_slots=16, paged=True, paged_kernel="pallas",
                kv_block_size=16, kv_blocks=1025, max_queue=64,
                warmup=True)


def fleet_requests(vocab):
    """Phase 4b's burst, half greedy and half seeded: the odd requests
    sample at FLEET_TEMPERATURE with seed 1000 + i."""
    return [(p, FLEET_TEMPERATURE if i % 2 else 0.0, 1000 + i)
            for i, p in enumerate(paged_prompts(vocab))]


def drill_request(vocab):
    """The corrupt-block drill's request: a fresh 300-token prompt (no
    block of it is cached anywhere), seeded."""
    import numpy as np
    return (np.random.RandomState(23).randint(0, vocab, (300,)),
            FLEET_TEMPERATURE, 4242)


def serve_requests(submit, reqs, new=64):
    """Submit ``reqs`` [(prompt, temperature, seed)] as one burst through
    ``submit`` and wait for all; returns (results, wall seconds)."""
    import torch
    t0 = time.time()
    handles = [submit(p, new, temperature=t, seed=s) for p, t, s in reqs]
    results = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    return results, time.time() - t0


def fleet_readings(results, seconds):
    """TTFT / TPOT p50 (ms) and output tokens/s of one burst, from the
    client-visible results."""
    import numpy as np
    tokens = sum(len(r.tokens) for r in results)
    return dict(seconds=seconds, tokens=tokens,
                tokens_per_s=tokens / seconds,
                ttft_ms_p50=float(np.median([r.ttft_s for r in results]))
                * 1e3,
                tpot_ms_p50=float(np.median([r.tpot_s for r in results]))
                * 1e3)


def sampled_verdict(model, req, ref, got):
    """`stream_verdict` for greedy or seeded streams: None when equal;
    else, at the first difference d, the scores that picked token d —
    the reference stream's teacher-forced logits over the temperature
    plus the request's Gumbel noise for ordinal d (the key after d
    carry-splits, then split) — and whether both picks sit within
    LOGIT_TOL / temperature of the top (a near tie that another
    summation order may flip). Anything else is a fault."""
    import torch
    from horovod_tpu_torch.ops import threefry
    prompt, temp, seed = req
    if list(got) == list(ref):
        return None
    d = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
             min(len(ref), len(got)))
    if d >= min(len(ref), len(got)):
        return dict(position=d, gap=float("inf"), near_tie=False)
    seq = torch.as_tensor(list(prompt) + list(ref[:d]),
                          device=model.device)[None].long()
    with torch.no_grad():
        hidden, head = model(seq, return_hidden=True)
        scores = (hidden[0, -1] @ head.to(hidden.dtype).T).float()
    tol = LOGIT_TOL
    if temp > 0:
        r = threefry.split(threefry.advance(threefry.prng_key(seed), d))[1]
        scores = scores / temp + threefry.gumbel(
            r, (model.vocab_size,), device=model.device)
        tol = LOGIT_TOL / temp
    gap = float(scores.max() - torch.minimum(scores[int(ref[d])],
                                             scores[int(got[d])]))
    return dict(position=d, gap=gap, near_tie=gap < tol)


def check_fleet_streams(model, reqs, ref, got, what):
    """Every stream of ``got`` against ``ref`` under `sampled_verdict`;
    raises on a fault. Returns (streams equal, near-tie divergences)."""
    equal, ties, faults = 0, [], []
    for i, (req, a, b) in enumerate(zip(reqs, ref, got)):
        v = sampled_verdict(model, req, a, b)
        if v is None:
            equal += 1
        elif v["near_tie"]:
            ties.append(dict(stream=i, **v))
        else:
            faults.append(dict(stream=i, **v))
    log(f"10 {what}: {equal} of {len(reqs)} streams equal, near ties "
        f"{ties}")
    if faults:
        raise AssertionError(f"{what}: streams differ off a near tie: "
                             f"{faults}")
    return equal, ties


class counting:
    """Context: the launch counts of ``kernels`` set to 0 on entry and
    read into ``self.launches`` on exit (after a synchronize)."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        for fn in self.kernels.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.launches = {k: fn.launches for k, fn in self.kernels.items()}


def check_fleet_launches(run, engines, layers, what):
    """B4 launched at least ticks x layers over the run's engines."""
    ticks = sum(e.metrics_snapshot()["ticks"] for e in engines)
    run["ticks"] = ticks
    if run["launches"]["paged_decode"] < ticks * layers:
        raise AssertionError(f"{what}: paged_decode launches "
                             f"{run['launches']['paged_decode']} < ticks "
                             f"{ticks} x {layers}")


def check_threefry_card(dev):
    """10a: random bits, uniforms, splits and fold-ins on the card
    against the same calls on the CPU for a [16, 32768] draw over 16
    keys (seeds 0..13, 2**31 - 1 and 2**32 + 5)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.ops import threefry
    seeds = list(range(14)) + [2 ** 31 - 1, 2 ** 32 + 5]
    keys = np.stack([threefry.prng_key(s) for s in seeds])
    kt = torch.from_numpy(keys.astype(np.int64))
    V = 32768
    checks = {
        "random_bits": torch.equal(
            threefry.random_bits(keys, (V,), device=dev).cpu(),
            threefry.random_bits(keys, (V,))),
        "uniform": torch.equal(
            threefry.uniform(keys, (V,), device=dev).cpu(),
            threefry.uniform(keys, (V,))),
        "split": torch.equal(threefry.split(kt.to(dev), 3).cpu(),
                             threefry.split(kt, 3))
        and np.array_equal(threefry.split(kt, 3).numpy(),
                           threefry.split(keys, 3)),
        "fold_in": torch.equal(
            threefry.fold_in(kt.to(dev), 2 ** 31 - 1).cpu(),
            threefry.fold_in(kt, 2 ** 31 - 1))
        and np.array_equal(threefry.fold_in(kt, 7).numpy(),
                           threefry.fold_in(keys, 7)),
    }
    g = threefry.gumbel(keys, (V,), device=dev).cpu().numpy()
    gc = threefry.gumbel(keys, (V,)).numpy()
    gumbel_err = float(np.abs(g - gc).max())
    checks["gumbel"] = bool(np.all(np.abs(g - gc)
                                   <= np.spacing(np.abs(gc)) + 2.0 ** -23))
    log(f"10a threefry on the card vs the CPU, [16, {V}] over 16 keys: "
        f"{checks}, gumbel max |diff| {gumbel_err:.3g}")
    if not all(checks.values()):
        raise AssertionError(f"threefry differs on the card: {checks}")
    return dict(checks=checks, gumbel_max_abs_diff=gumbel_err)


def seeded_generate(model, kernels, dev, temperature=FLEET_TEMPERATURE):
    """10a: a seeded `generate` of 4 x 512 -> 128 (``temperature``, top_p
    0.95) twice, which must agree token for token, then with the key
    advanced one split too many (a planted fault), which must change the
    stream (its first 16 tokens: every token's noise moves)."""
    import torch
    from horovod_tpu_torch.models.transformer import generate
    from horovod_tpu_torch.ops import threefry
    g = torch.Generator(device=dev).manual_seed(7)
    prompt = torch.randint(0, model.vocab_size, (4, 512), device=dev,
                           generator=g)
    key = threefry.prng_key(FLEET_SEED)
    kw = dict(temperature=temperature, top_p=0.95)
    with counting(kernels) as c:
        t0 = time.time()
        first = generate(model, prompt, 128, rng=key, **kw)
        torch.cuda.synchronize()
        dt = time.time() - t0
    again = generate(model, prompt, 128, rng=key, **kw)
    fault = generate(model, prompt, 16, rng=threefry.split(key)[0], **kw)
    same = bool(torch.equal(first, again))
    caught = not bool(torch.equal(first[:, :528], fault))
    log(f"10a seeded generate 4x512 -> 128 (T {temperature:.3g}, top_p "
        f"0.95): {dt:.3f} s, run to run equal {same}; one extra split "
        f"(planted fault) changes the stream: {caught}, launches "
        f"{c.launches}")
    if first.shape != (4, 640) or not same:
        raise AssertionError("seeded generate is not reproducible")
    if not caught:
        raise AssertionError("an extra split of the key went unseen")
    return dict(seconds=dt, launches=c.launches, reproducible=same,
                planted_extra_split_caught=caught)


def time_sampled_tick(model, dev):
    """10a: one tick of phase 4's 8-slot pool (its first 8 prompts
    prefilled), all lanes greedy against all lanes seeded; and the
    threefry draw alone (the 8 lanes' split on the host plus their
    [8, 32768] Gumbel noise on the card), by CUDA events."""
    import torch
    from horovod_tpu_torch.ops import threefry
    from horovod_tpu_torch.serving import SlotPool
    pool = SlotPool(model, 8)
    for p in engine_prompts(model.vocab_size)[:8]:
        pool.prefill(pool.alloc(), p, 0.0, None, 0, max_chunk=128)

    def per_tick_ms(n=10):
        pool.tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pool.tick()
        return (time.perf_counter() - t0) / n * 1e3

    greedy = per_tick_ms()
    for slot in range(8):
        pool._temps[slot] = FLEET_TEMPERATURE
        pool._keys.install(slot, threefry.prng_key(100 + slot))
    sampled = per_tick_ms()
    draw = cuda_time_ms(lambda: pool._keys.noise(model.vocab_size, dev))
    pool.release()
    log(f"10a one tick, 8 lanes (phase 4's prompts): greedy {greedy:.3f} "
        f"ms, sampled {sampled:.3f} ms; the threefry draw alone "
        f"{draw:.4f} ms (device)")
    return dict(greedy_tick_ms=greedy, sampled_tick_ms=sampled,
                threefry_draw_ms=draw)


def scrape_metrics(url):
    """One Prometheus scrape of ``url``/metrics: every line must parse
    as HELP / TYPE / a sample. Returns the text."""
    import re
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'(NaN|[+-]Inf|[-+0-9.eE]+)$')
    bad = [ln for ln in text.splitlines()
           if ln and not ln.startswith("#") and not sample.match(ln)]
    if bad:
        raise AssertionError(f"/metrics does not parse: {bad[:3]}")
    return text


def router_completed(text):
    import re
    return sum(int(m) for m in re.findall(
        r'^hvd_router_requests_total\{[^}]*outcome="completed"[^}]*\} '
        r'(\d+)', text, re.M))


def run_router(model, kernels, reqs, ref):
    """10b + 10d: `ServingRouter` over two paged replicas, the mixed
    burst without a fault (the exporter scraped meanwhile), then with
    ``router.replica_kill`` armed once request 0 has FLEET_KILL_AT
    tokens (chaos seed FLEET_CHAOS_SEED). The dead replica's KV must be
    freed before its replacement is built."""
    import torch
    from horovod_tpu_torch.obs.exporter import MetricsServer
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.serving import ServingEngine, ServingRouter
    layers = model.num_layers
    built = []

    def factory():
        eng = ServingEngine(model, **fleet_engine_kw())
        built.append(eng)
        return eng

    with MetricsServer(port=0) as srv:
        with ServingRouter(factory, num_replicas=2) as router:
            before = router_completed(scrape_metrics(srv.url))
            with counting(kernels) as c:
                hs = [router.submit(p, 64, temperature=t, seed=s)
                      for p, t, s in reqs]
                t0 = time.time()
                wait_for(lambda: len(hs[0].tokens_so_far()) >= 8)
                during = scrape_metrics(srv.url)
                results = [h.result(timeout=600) for h in hs]
                torch.cuda.synchronize()
                dt = time.time() - t0
            after = scrape_metrics(srv.url)
            snap = router.metrics_snapshot()
        plain = dict(fleet_readings(results, dt), launches=c.launches,
                     migrations=snap["migrations"],
                     hedges=snap["hedges"])
        check_fleet_launches(plain, built, layers, "router")
        plain["streams"] = [r.tokens.tolist() for r in results]
        scraped = router_completed(after) - before
        log(f"10d exporter on port {srv.port}: /metrics parses "
            f"({len(during.splitlines())} lines mid-burst, "
            f"{len(after.splitlines())} after), router completed counter "
            f"+{scraped}")
        if scraped < len(reqs) or "hvd_router_replicas" not in during:
            raise AssertionError(f"the exporter does not carry the "
                                 f"router's counters ({scraped})")
    equal, ties = check_fleet_streams(model, reqs, ref, plain["streams"],
                                      "router vs one paged engine")
    plain.update(equal_streams=equal, near_ties=ties)

    built.clear()
    with ServingRouter(factory, num_replicas=2) as router:
        with counting(kernels) as c:
            hs = [router.submit(p, 64, temperature=t, seed=s)
                  for p, t, s in reqs]
            t0 = time.time()
            wait_for(lambda: len(hs[0].tokens_so_far()) >= FLEET_KILL_AT,
                     dt=0.001)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with chaos.armed("router.replica_kill:1",
                             seed=FLEET_CHAOS_SEED) as monkey:
                wait_for(lambda: monkey.fired("router.replica_kill") == 1)
                killed_at = len(hs[0].tokens_so_far())
                results = [h.result(timeout=600) for h in hs]
            torch.cuda.synchronize()
            dt = time.time() - t0
            wait_for(lambda: router.metrics_snapshot()["replacements"] == 1)
            torch.cuda.synchronize()
        snap = router.metrics_snapshot()
        peak = torch.cuda.max_memory_allocated()
        after_mem = torch.cuda.memory_allocated()
        kv = sum(t.numel() * t.element_size() for layer in
                 built[-1].pool._pools for t in layer)
    kill = dict(fleet_readings(results, dt), launches=c.launches,
                migrations=snap["migrations"],
                migrated_tokens=snap["migrated_tokens"],
                replacements=snap["replacements"],
                replica_deaths=snap["replica_deaths"],
                request0_tokens_at_kill=killed_at, base_bytes=base,
                peak_bytes=peak, after_bytes=after_mem, pool_kv_bytes=kv)
    check_fleet_launches(kill, built, layers, "router under kill")
    kill["streams"] = [r.tokens.tolist() for r in results]
    log(f"10b router kill: request 0 at {killed_at} tokens, deaths "
        f"{kill['replica_deaths']}, migrations {kill['migrations']} "
        f"({kill['migrated_tokens']} tokens), replacements "
        f"{kill['replacements']}; memory base {base / 1e9:.3f} GB, peak "
        f"after the replacement {peak / 1e9:.3f} GB, now "
        f"{after_mem / 1e9:.3f} GB (one pool {kv / 1e9:.3f} GB)")
    if (kill["replica_deaths"] != 1 or kill["migrations"] < 1
            or kill["replacements"] != 1):
        raise AssertionError(f"the kill did not migrate: {kill}")
    if peak - base > kv // 2 or after_mem - base > kv // 4:
        raise AssertionError(f"a killed replica's KV outlived its "
                             f"replacement's build: base {base}, peak "
                             f"{peak}, after {after_mem}, pool {kv}")
    equal, ties = check_fleet_streams(model, reqs, plain["streams"],
                                      kill["streams"],
                                      "router kill vs no-kill router")
    kill.update(equal_streams=equal, near_ties=ties)
    return dict(plain=plain, kill=kill)


def run_disagg(model, kernels, reqs, ref, drill, drill_ref):
    """10c: `DisaggRouter`, one prefill and one decode paged replica,
    the mixed burst in host then device transfer mode; after the host
    burst the ``disagg.block_corrupt`` drill on a fresh prompt."""
    import torch
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.serving import ServingEngine, ServingRouter
    out = {}
    for mode in ("host", "device"):
        built = []

        def factory():
            eng = ServingEngine(model, **fleet_engine_kw())
            built.append(eng)
            return eng

        router = ServingRouter(factory, disagg={
            "prefill": 1, "decode": 1, "transfer": mode})
        try:
            with counting(kernels) as c:
                results, dt = serve_requests(router.submit, reqs)
            snap = router.metrics_snapshot()
            run = dict(fleet_readings(results, dt), launches=c.launches,
                       handoffs=snap["disagg"]["handoffs"],
                       fallbacks=snap["disagg"]["fallbacks"],
                       decode_prefix_tokens=sum(r.prefix_tokens_cached
                                                for r in results))
            check_fleet_launches(run, built, model.num_layers,
                                 f"disagg {mode}")
            run["streams"] = [r.tokens.tolist() for r in results]
            if mode == "host":
                with chaos.armed("disagg.block_corrupt:1") as monkey:
                    (res,), _ = serve_requests(router.submit, [drill])
                run["drill"] = dict(
                    fired=monkey.fired("disagg.block_corrupt"),
                    prefix_tokens_cached=res.prefix_tokens_cached,
                    stream=res.tokens.tolist())
        finally:
            router.shutdown()
        log(f"10c disagg ({mode}): handoffs {run['handoffs']}, fallbacks "
            f"{run['fallbacks']}, prompt tokens the decode side skipped "
            f"{run['decode_prefix_tokens']}, ticks {run['ticks']}, "
            f"launches {run['launches']}")
        if run["handoffs"] <= 0 or run["decode_prefix_tokens"] <= 0:
            raise AssertionError(f"disagg {mode}: no transfer landed")
        equal, ties = check_fleet_streams(
            model, reqs, ref, run["streams"],
            f"disagg {mode} vs one paged engine")
        run.update(equal_streams=equal, near_ties=ties)
        out[mode] = run
    d = out["host"]["drill"]
    log(f"10c corrupt-block drill: fired {d['fired']}, prompt tokens the "
        f"decode side took from the transfer {d['prefix_tokens_cached']}")
    if d["fired"] != 1 or d["prefix_tokens_cached"] != 0:
        raise AssertionError(f"the corrupt transfer was not dropped: {d}")
    check_fleet_streams(model, [drill], [drill_ref], [d["stream"]],
                        "corrupt drill vs one paged engine")
    return out


def wait_for(cond, timeout=300.0, dt=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(dt)


def run_fleet(model, tfa, tpa, dev, peng):
    """Phase 10: threefry on the card (10a), the router (10b) with the
    exporter scraped (10d), disaggregated serving (10c), and their
    readings beside phase 4b's (10e)."""
    import torch
    from horovod_tpu_torch.serving import ServingEngine
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    t0 = time.time()
    card = check_threefry_card(dev)
    gen = seeded_generate(model, kernels, dev)
    tick = time_sampled_tick(model, dev)
    reqs = fleet_requests(model.vocab_size)
    drill = drill_request(model.vocab_size)
    with ServingEngine(model, **fleet_engine_kw()) as eng:
        with counting(kernels) as c:
            results, dt = serve_requests(eng.submit, reqs)
        single = dict(fleet_readings(results, dt), launches=c.launches)
        check_fleet_launches(single, [eng], model.num_layers,
                             "one paged engine")
        (drill_res,), _ = serve_requests(eng.submit, [drill])
    ref = [r.tokens.tolist() for r in results]
    router = run_router(model, kernels, reqs, ref)
    disagg = run_disagg(model, kernels, reqs, ref, drill,
                        drill_res.tokens.tolist())
    label = f"[{nvidia_smi_line()}]"
    rows = [("phase 4b paged engine (greedy burst)", peng),
            ("one paged engine, mixed burst", single),
            ("router, 2 replicas", router["plain"]),
            ("router, 2 replicas, one killed", router["kill"]),
            ("disagg host", disagg["host"]),
            ("disagg device", disagg["device"])]
    for name, r in rows:
        log(f"10e {name}: {r['seconds']:.2f} s, {r['tokens_per_s']:.1f} "
            f"tokens/s, TTFT p50 {r['ttft_ms_p50']:.2f} ms, TPOT p50 "
            f"{r['tpot_ms_p50']:.2f} ms {label}")
    out = dict(threefry=card, seeded_generate=gen, tick=tick,
               single=single, router=router, disagg=disagg,
               seconds=time.time() - t0)
    out["runs"] = dict(fleet_generate=gen, fleet_single=single,
                       fleet_router=router["plain"],
                       fleet_router_kill=router["kill"],
                       fleet_disagg_host=disagg["host"],
                       fleet_disagg_device=disagg["device"])
    torch.cuda.synchronize()
    return out


def zipf_ids(rs, n, vocab, a=1.1):
    """``n`` ids in [0, vocab) with P(k) proportional to 1 / (k + 1)^a."""
    import numpy as np
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return rs.choice(vocab, size=n, p=p / p.sum())


def run_word2vec(hvd, dev):
    """Phase 7a: the sparse path at word2vec's full width: 8 steps of
    `make_train_step` under `DistributedOptimizer(Adagrad)`, the
    embedding gradient a sparse CUDA tensor; then the sparse allreduce
    of one step's slices against the dense gradient (and the same with
    one slice dropped, a planted fault that must fail)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models.word2vec import Word2Vec
    rs = np.random.RandomState(0)
    batch = [torch.from_numpy(x).to(dev) for x in (
        zipf_ids(rs, W2V_BATCH, W2V_VOCAB), zipf_ids(rs, W2V_BATCH, W2V_VOCAB),
        zipf_ids(rs, W2V_BATCH * W2V_NEG, W2V_VOCAB).reshape(W2V_BATCH,
                                                             W2V_NEG))]
    model = Word2Vec(W2V_VOCAB, W2V_DIM, device=dev).init_weights(0)
    opt = hvd.DistributedOptimizer(torch.optim.Adagrad(model.parameters(),
                                                       lr=0.1))
    step = hvd.make_train_step(model, opt)
    losses, times = [], []
    for _ in range(W2V_STEPS):
        t0 = time.time()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(loss))
    grad = model.embeddings.grad
    if not (grad.is_sparse and grad.device.type == dev.type):
        raise AssertionError(f"embedding gradient is not sparse on "
                             f"{dev}: {grad.layout} on {grad.device}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"word2vec loss not finite and falling: "
                             f"{losses}")
    slices = hvd.IndexedSlices.from_sparse(grad)
    nnz = int(slices.indices.numel())
    # The same loss, its embedding gradient dense, on the same params.
    model.zero_grad(set_to_none=True)
    model.sparse = False
    model(*batch).backward()
    dense = model.embeddings.grad
    model.zero_grad(set_to_none=True)
    model.sparse = True
    model(*batch).backward()
    fresh = hvd.IndexedSlices.from_sparse(model.embeddings.grad)
    scale = float(dense.abs().max())
    got = hvd.allreduce(fresh).to_dense()
    err = float((got - dense).abs().max()) / scale
    short = hvd.IndexedSlices(fresh.values[:-1], fresh.indices[:-1],
                              fresh.dense_shape)
    ferr = float((hvd.allreduce(short).to_dense() - dense).abs().max()
                 ) / scale
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"word2vec {W2V_VOCAB} x {W2V_DIM}, batch {W2V_BATCH} x "
        f"{W2V_NEG} negatives, {W2V_STEPS} Adagrad steps: losses "
        f"{[round(x, 4) for x in losses]}, median step after the first "
        f"{steady * 1e3:.2f} ms; sparse gradient {nnz} of {W2V_VOCAB} rows "
        f"({nnz * (W2V_DIM + 1) * 4 / 1e6:.3f} MB as rows + indices vs "
        f"{W2V_VOCAB * W2V_DIM * 4 / 1e6:.3f} MB dense, "
        f"{W2V_VOCAB * W2V_DIM / (nnz * (W2V_DIM + 1)):.1f}x fewer bytes)")
    log(f"word2vec allreduce(IndexedSlices) to dense vs the dense "
        f"gradient: max |err| / max |grad| {err:.3e} (tol {SPARSE_TOL}); "
        f"planted fault (last slice dropped) {ferr:.3e}")
    if err > SPARSE_TOL:
        raise AssertionError(f"sparse allreduce differs from the dense "
                             f"gradient by {err}")
    if ferr <= SPARSE_TOL:
        raise AssertionError("the sparse check does not see a dropped "
                             "slice")
    return dict(losses=losses, step_s=times,
                step_ms_median_after_first=steady * 1e3, nnz_rows=nnz,
                table_rows=W2V_VOCAB, sparse_err=err,
                planted_fault_err=ferr)


def powersgd_check(opt, model, tokens):
    """One PowerSGD step of phase 7b, checked: the gradients and the
    compressor's state are captured, the optimizer steps, and then (1)
    error feedback holds for every compressed leaf, (2) the compressor
    run on the CPU from the captured gradients and state gives the same
    approximations, and (3) the compressor run alone on the card under
    CUDA's sync debug mode counts its host synchronizations."""
    import warnings
    import torch
    from horovod_tpu_torch.models.transformer import _lm_data_loss
    from horovod_tpu_torch.ops.compression import PowerSGDState
    params = list(model.parameters())
    opt.zero_grad(set_to_none=True)
    _lm_data_loss(model, tokens, 512).backward()
    grads = [p.grad.detach().clone() for p in params]
    old = [opt.state[p].get("powersgd_err") for p in params]
    state = PowerSGDState(
        tuple(None if opt.state[p].get("powersgd_q") is None
              else opt.state[p]["powersgd_q"].clone() for p in params),
        tuple(None if e is None else e.clone() for e in old),
        opt._hvd_powersgd.seed)
    opt.step()
    ef_err = cpu_err = 0.0
    cpu_out, _ = opt._hvd_powersgd.update(
        [g.cpu() for g in grads],
        PowerSGDState(*(tuple(None if t is None else t.cpu() for t in ts)
                        for ts in state[:2]), state.seed))
    for p, g, e0, c in zip(params, grads, state.errs, cpu_out):
        if e0 is None:
            continue
        m = g.reshape(-1, g.shape[-1]).float() + e0
        approx = p.grad.reshape(m.shape).float()
        e1 = opt.state[p]["powersgd_err"]
        scale = float(m.abs().max())
        ef_err = max(ef_err, float((approx + e1 - m).abs().max()) / scale)
        ref = c.reshape(m.shape).float()
        cpu_err = max(cpu_err, float((approx.cpu() - ref).abs().max())
                      / float(ref.abs().max()))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            opt._hvd_powersgd.update(grads, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # One warning per synchronizing call; the mode's own notice that it
    # is a prototype is not one.
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return ef_err, cpu_err, syncs


def run_powersgd(hvd, tfa, dev, base_step_ms):
    """Phase 7b: phase 5's training configuration under
    `DistributedOptimizer(..., compression="powersgd",
    compression_rank=4)`: 4 steps whose loss must fall and whose forward
    and backward kernels must each launch >= 12 x steps, then one
    checked step (`powersgd_check`)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      init_lm_state,
                                                      make_lm_train_step)
    model = TransformerLM(32768, 12, 8, 128, max_len=2048,
                          dtype=torch.bfloat16, attn_impl="flash",
                          device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        compression="powersgd", compression_rank=PSGD_RANK)
    init_lm_state(model, opt, seed=0)
    comp = [p for p in model.parameters() if "powersgd_q" in opt.state[p]]
    full = sum(p.numel() for p in comp)
    wire = sum(PSGD_RANK * (p.numel() // p.shape[-1] + p.shape[-1])
               for p in comp)
    step = make_lm_train_step(model, opt, loss_chunk=512)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32768, (8, 2048))).to(dev)
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(PSGD_STEPS):
        t0 = time.time()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(loss))
    launches = {k: fn.launches for k, fn in wrappers.items()}
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"training under PowerSGD rank {PSGD_RANK}: {len(comp)} of "
        f"{len(list(model.parameters()))} leaves compressed, wire ratio "
        f"sum r(n+m) / sum nm = {wire} / {full} = {wire / full:.5f}; "
        f"losses {[round(x, 4) for x in losses]}, step s "
        f"{[round(t, 4) for t in times]}, median after the first "
        f"{steady * 1e3:.1f} ms (uncompressed, phase 5: "
        f"{base_step_ms:.1f} ms), launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"PowerSGD training loss not finite and "
                             f"falling: {losses}")
    for k, n in launches.items():
        if n < model.num_layers * PSGD_STEPS:
            raise AssertionError(f"{k} launched {n} < {model.num_layers} "
                                 f"x {PSGD_STEPS} under PowerSGD")
    ef_err, cpu_err, syncs = powersgd_check(opt, model, tokens)
    log(f"PowerSGD checked step: error feedback |approx + err' - (g + "
        f"err)| / max {ef_err:.3e} (tol {EF_TOL}); card vs CPU compressor "
        f"on the same gradients and state {cpu_err:.3e} (tol "
        f"{PSGD_CPU_TOL}); host syncs inside one compressor update "
        f"{len(syncs)} {sorted(set(syncs))[:3]}")
    if ef_err > EF_TOL:
        raise AssertionError(f"PowerSGD error feedback broken: {ef_err}")
    if cpu_err > PSGD_CPU_TOL:
        raise AssertionError(f"PowerSGD on the card differs from the CPU "
                             f"by {cpu_err}")
    return dict(steps=PSGD_STEPS, losses=losses, step_s=times,
                step_ms_median_after_first=steady * 1e3,
                uncompressed_step_ms=base_step_ms, launches=launches,
                compressed_leaves=len(comp), wire_floats=wire,
                dense_floats=full, wire_ratio=wire / full,
                error_feedback_err=ef_err, card_vs_cpu_err=cpu_err,
                host_syncs=len(syncs), host_sync_kinds=sorted(set(syncs)))


def check_timeline(path):
    """Phase 7c: the trace parses, names its processes, pairs every B
    with an E, and holds the train-step brackets and the eager ops."""
    with open(path) as f:
        events = json.load(f)
    names = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    stacks = {}
    for e in events:
        if e.get("ph") == "B":
            stacks.setdefault(e["pid"], []).append(e["name"])
        elif e.get("ph") == "E":
            if not stacks.get(e["pid"]):
                raise AssertionError(f"timeline E without B: {e}")
            stacks[e["pid"]].pop()
    if any(stacks.values()):
        raise AssertionError(f"timeline B without E: {stacks}")
    want = {"train_step", f"HorovodAllgather_vx{W2V_DIM}_float32",
            "HorovodAllgather_v_int64"}
    if not want <= names:
        raise AssertionError(f"timeline misses {want - names}: {names}")
    n_b = sum(e.get("ph") == "B" for e in events)
    log(f"timeline: {len(events)} events, {n_b} B/E pairs, processes "
        f"{sorted(names)}")
    return dict(events=len(events), spans=n_b, processes=sorted(names))


# The launcher's worker: no device argument; it must land on card 0 over
# NCCL through the launcher's store, run every eager op at world 1 and
# one word2vec step.
LAUNCH_WORKER = r"""
import os, numpy as np, torch, torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.word2vec import Word2Vec
from horovod_tpu_torch.runtime import state
hvd.init()
st = state.global_state()
assert st.devices == [torch.device("cuda", 0)], st.devices
assert dist.get_backend() == "nccl", dist.get_backend()
assert st.store.port == int(os.environ["HOROVOD_KV"].rsplit(":", 1)[1])
x = torch.arange(12.0, device="cuda").reshape(4, 3)
for out in (hvd.allreduce(x), hvd.allgather(x), hvd.broadcast(x, 0),
            hvd.alltoall(x), hvd.reducescatter(x, average=True)):
    assert torch.equal(out, x), out
s = hvd.allreduce(hvd.IndexedSlices(x, torch.tensor([0, 2, 2, 5],
                                                    device="cuda"), (6, 3)))
assert torch.equal(s.to_dense()[2], x[1] + x[2])
g = hvd.grouped_allreduce([x, x[0].long()], average=False)
assert torch.equal(g[0], x) and torch.equal(g[1], x[0].long())
m = Word2Vec(50000, 128).init_weights(0)
opt = hvd.DistributedOptimizer(torch.optim.Adagrad(m.parameters(), lr=0.1))
rs = np.random.RandomState(1)
b = [torch.from_numpy(v).cuda() for v in (rs.randint(0, 50000, 512),
     rs.randint(0, 50000, 512), rs.randint(0, 50000, (512, 16)))]
loss = float(hvd.make_train_step(m, opt)(*b))
assert m.embeddings.grad.is_sparse and np.isfinite(loss)
print(f"LAUNCH_OK rank={hvd.rank()} size={hvd.size()} device={st.devices[0]} "
      f"backend={dist.get_backend()} word2vec_loss={loss:.4f}", flush=True)
hvd.shutdown()
"""


def run_launcher():
    """Phase 7d: ``python -m horovod_tpu_torch.runner -np 1`` on the
    card (its worker's line must arrive), then ``-np N+1 --platform
    gpu`` with N cards, which must exit nonzero with the launcher's
    message before spawning (a planted misuse)."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "horovod_tpu_torch.runner"]
    t0 = time.time()
    ok = subprocess.run(base + ["-np", "1", sys.executable, "-c",
                                LAUNCH_WORKER], cwd=here, env=env,
                        capture_output=True, text=True, timeout=300)
    seconds = time.time() - t0
    line = next((ln for ln in ok.stdout.splitlines() if "LAUNCH_OK" in ln),
                None)
    if ok.returncode != 0 or line is None:
        raise AssertionError(f"launcher -np 1 failed ({ok.returncode}):\n"
                             f"{ok.stdout[-3000:]}\n{ok.stderr[-3000:]}")
    n = torch.cuda.device_count() + 1
    bad = subprocess.run(base + ["-np", str(n), "--platform", "gpu",
                                 sys.executable, "-c", "print('SPAWNED')"],
                         cwd=here, env=env, capture_output=True, text=True,
                         timeout=120)
    if (bad.returncode == 0 or "one rank per card" not in bad.stderr
            or "SPAWNED" in bad.stdout):
        raise AssertionError(f"launcher -np {n} --platform gpu was not "
                             f"refused: {bad.returncode}\n{bad.stdout}\n"
                             f"{bad.stderr}")
    log(f"launcher -np 1 on the card: {line.strip()} ({seconds:.1f} s); "
        f"-np {n} --platform gpu refused with exit {bad.returncode}: "
        f"{bad.stderr.strip().splitlines()[-1]}")
    return dict(worker_line=line.strip(), seconds=seconds,
                refused_exit=bad.returncode)


def run_dp_surface(tfa, dev, base_step_ms):
    """Phase 7: the data-parallel surface on the card at world 1 over
    NCCL: word2vec (7a) and the LM under PowerSGD (7b) under the
    timeline (7c), then the launcher (7d)."""
    import tempfile
    import horovod_tpu_torch as hvd
    hvd.init()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "timeline.json")
        try:
            hvd.start_timeline(path)
            w2v = run_word2vec(hvd, dev)
            psgd = run_powersgd(hvd, tfa, dev, base_step_ms)
            hvd.stop_timeline()
            timeline = check_timeline(path)
        finally:
            hvd.shutdown()
    launcher = run_launcher()
    return dict(word2vec=w2v, powersgd=psgd, timeline=timeline,
                launcher=launcher)


# ---------------------------------------------------------------------------
# Phase 11: the HF families at full width, the kernel instantiations they
# bring, and the first torch.profiler traces.
# ---------------------------------------------------------------------------

# 11c: the forward at Gemma-2B's heads (8 x 256 over 1 kv head) and
# Qwen2-0.5B's (14 x 64 over 2), (name, (B, S, H, Hkv, D)).
COVERAGE_FWD = [("Gemma-2B [2,1024,8,256] Hkv 1", (2, 1024, 8, 1, 256)),
                ("Qwen2-0.5B [2,1024,14,64] Hkv 2", (2, 1024, 14, 2, 64))]
# 11c: the decode kernels' new instantiations, (H, Hkv, D): D = 256 at
# groups 1 and 8 (Gemma's), D = 128 at group 6 (Qwen2-1.5B's), D = 64 at
# groups 3, 5 and 7 (Qwen2-0.5B's is 7).
COVERAGE_DECODE = [(8, 8, 256), (8, 1, 256), (12, 2, 128), (6, 2, 64),
                   (10, 2, 64), (14, 2, 64)]


def coverage_lengths(tfa, dev, L, W, hkv):
    """Decode lengths 0, 1, on and one past the first split boundaries
    of the kernel's own split count, W - 1 and W; L of them."""
    import math
    c = math.ceil(W / tfa.decode_splits(W, hkv * L, tfa._sm_count(dev)))
    return ([0, 1, c, c + 1, 2 * c, min(3 * c - 1, W - 1), W - 1, W]
            + [W // 2] * L)[:L]


def coverage_key(kind, dtype, H, Hkv, D):
    return f"{kind} {dtype} H={H} Hkv={Hkv} D={D}"


def hold(step, kind, name, out, ref, dtype, fault_out):
    """``out`` (a kernel's) against ``ref`` (its plain version on the
    same inputs) under TOL[dtype], and ``fault_out`` (a planted fault),
    which the same rule must refuse. Returns the two errors."""
    import torch
    err, ok = max_err(out, ref, TOL[dtype])
    ferr, fok = max_err(fault_out, ref, TOL[dtype])
    log(f"{step} {kind} {dtype:8s} {name}: max_abs_err {err:.3e} (tol "
        f"{TOL[dtype]}); planted fault {ferr:.3e}, caught {not fok}")
    if not ok or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{kind} {dtype} {name}: err {err}")
    if fok:
        raise AssertionError(f"{kind} {dtype} {name}: the check does not "
                             f"see its planted fault")
    return dict(case=name, max_abs_err=err, planted_fault_err=ferr)


def check_coverage(tfa, tpa, dev):
    """Phase 11c: every new instantiation against its plain version, f32
    and bf16, each with a planted fault it must catch: the forward's
    plain version one key short (q_offset -1: each row misses its own
    key, row 0 attends nothing), the decode kernel run one key short
    (length - 1) and the paged table fault of phase 2b (a lane's first
    entry swapped with the entry holding its fill)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1111)
    errs = {}

    def held(kind, geo, name, out, ref, dtype, fault_out):
        errs[coverage_key(kind, dtype, *geo)] = hold(
            "11c", kind, name, out, ref, dtype, fault_out)

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, (B, S, H, Hkv, D) in COVERAGE_FWD:
            q = torch.randn(B, S, H, D, device=dev, generator=g).to(dt)
            k, v = (torch.randn(B, S, Hkv, D, device=dev,
                                generator=g).to(dt) for _ in range(2))
            out, lse = tfa.flash_fwd_cuda(q, k, v, causal=True)
            ref, rlse = tfa.flash_attention_plain(q, k, v, causal=True)
            short, _ = tfa.flash_attention_plain(q, k, v, causal=True,
                                                 q_offset=-1)
            torch.cuda.synchronize()
            lerr, lok = max_err(lse, rlse, (LSE_TOL, 0.0))
            if not lok:
                raise AssertionError(f"flash_fwd {dtype} {name}: lse err "
                                     f"{lerr}")
            held("flash_fwd", (H, Hkv, D), name, out, ref, dtype, short)
            del q, k, v, out, ref, short
        for H, Hkv, D in COVERAGE_DECODE:
            L, W = 8, 2048
            name = f"H {H} Hkv {Hkv} D {D} (group {H // Hkv})"
            lens = coverage_lengths(tfa, dev, L, W, Hkv)
            length = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn(L, 1, H, D, device=dev, generator=g).to(dt)
            kc, vc = (torch.randn(L, W, Hkv, D, device=dev,
                                  generator=g).to(dt) for _ in range(2))
            out = tfa.flash_decode_cuda(q, kc, vc, length)
            short = tfa.flash_decode_cuda(q, kc, vc,
                                          (length - 1).clamp(min=0))
            ref = tfa.flash_decode_plain(q, kc, vc, length)
            torch.cuda.synchronize()
            if out[lens.index(0)].any():
                raise AssertionError(f"flash_decode {name}: a length-0 "
                                     f"lane is not zero")
            held("flash_decode", (H, Hkv, D), f"{name} lengths {lens}", out,
                 ref, dtype, short)
            fills = PAGED_FILLS
            args = paged_case(g, dev, dt, Hkv, fills, H=H, D=D)
            out = tpa.paged_decode_cuda(*args)
            qq, kn, vn, tables, fill, kp, vp = args
            bad = tables.clone()
            j = fills[4] // 16
            bad[4, [0, j]] = tables[4, [j, 0]]
            fault = tpa.paged_decode_cuda(qq, kn, vn, bad, fill, kp, vp)
            ref = tpa.paged_decode_plain(*args)
            torch.cuda.synchronize()
            held("paged_decode", (H, Hkv, D), f"{name} fills {fills}", out,
                 ref, dtype, fault)
            del q, kc, vc, args, out, fault, ref
    return errs


def gqa_sdpa(q, k, v, **kw):
    """One PyTorch call for grouped-query attention on [B, S, H, D]
    layouts already transposed to [B, H, S, D] (the library yardstick;
    the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def hf_prompts(vocab, seed):
    """Phase 11's engine burst: 16 prompts of 64..512 tokens."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (int(n),)) for n in rs.randint(64, 513, 16)]


# 11a: google/gemma-2b's published config (its "hidden_act" reads
# "gelu", which transformers runs as the tanh approximation for Gemma;
# both activation fields are written here as that approximation, the
# one `compat.hf` converts with parity).
GEMMA_2B = dict(
    model_type="gemma", vocab_size=256000, hidden_size=2048,
    intermediate_size=16384, num_hidden_layers=18, num_attention_heads=8,
    num_key_value_heads=1, head_dim=256, hidden_act="gelu_pytorch_tanh",
    hidden_activation="gelu_pytorch_tanh", max_position_embeddings=8192,
    rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True,
    attention_bias=False)
# 11b: Qwen/Qwen2-0.5B's published config, max_position_embeddings cut
# from 131072 to 4096 (the caches are sized by it; the phase's sequences
# stay under 700 positions).
QWEN2_0_5B = dict(
    model_type="qwen2", vocab_size=151936, hidden_size=896,
    intermediate_size=4864, num_hidden_layers=24, num_attention_heads=14,
    num_key_value_heads=2, hidden_act="silu", max_position_embeddings=4096,
    rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=True,
    use_sliding_window=False, sliding_window=None)
QWEN2_PUBLISHED_MAX_POSITION = 131072
# Phase 11's models: (name, the kernels line's row tag, family, config,
# weight seed, the engine burst's prompt seed).
HF_MODELS = [("Gemma-2B", "gemma-2b", "gemma", GEMMA_2B, 2, 11),
             ("Qwen2-0.5B", "qwen2-0.5b", "qwen2", QWEN2_0_5B, 3, 12)]
# Teacher-forced logits of the bf16 HF models (prefill + 8 ticks),
# kernels vs plain versions, max |k - p| per family. The bf16 roundings
# of 18-24 layers this wide exceed phase 3's 0.06: over four (weight,
# prompt) seeds `chip_probe.py hf` read 0.1094-0.1152 (Gemma-2B, logit
# scale 6.5-7.4) and 0.0547-0.0625 (Qwen2-0.5B, 3.1-3.4), and the plain
# decode one key short (the planted fault here too) 0.1538-0.1797 and
# 0.1816-0.2109, on an H100 80GB HBM3 at 700 W. Each limit sits just
# above its family's readings and under its faults; Gemma's margin is a
# bf16 step either way, so the f32 twin below is the fine check.
HF_LOGIT_TOL = {"gemma": 0.14, "qwen2": 0.09}
# The same weights computing in f32, where the kernels and their plain
# versions differ by summation order only: the probe read 3.09e-5 to
# 3.49e-5 (Gemma-2B) and 6.4e-6 to 7.4e-6 (Qwen2-0.5B) on `generate`'s
# path, 1.2e-5 to 1.3e-5 and 4.6e-6 to 5.2e-6 on the paged path (4
# ticks), against 0.049-0.21 for the decode one key short: each limit
# is ~1.5x its family's largest reading.
HF_F32_LOGIT_TOL = {"gemma": 5e-5, "qwen2": 1.2e-5}
# Ticks of the f32 paged teacher forcing at the HF geometry (its plain
# walk reads whole tables of max_position / 16 entries: 0.45 s a call
# at Gemma's 512).
HF_PAGED_TICKS = 2


def hf_heads(cfg):
    """(H, Hkv, D, max_position) of an HF config."""
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return (H, Hkv, cfg.get("head_dim") or cfg["hidden_size"] // H,
            cfg["max_position_embeddings"])


def time_coverage(tfa, tpa, dev, cfg, prompt_seed):
    """The kernels line's rows of one HF model's path (bf16, the model's
    heads): the forward at the prefill shape [4, 512, H, D], the decode
    tick of `generate` (4 lanes of 640 keys in its max_position-slot
    cache) and the paged tick at the engine's geometry (the 16 lanes of
    the burst half way through their 64 new tokens, tables of
    max_position / 16 entries). Each kernel is first held against its
    plain version on the very inputs it is timed on (TOL bf16), with a
    planted fault the same rule must refuse: the plain forward one key
    short (q_offset -1), the decode kernels one key short on every lane
    (length - 1, fill - 1). Then kernel, plain-version and library
    times, and the bound from these inputs."""
    import torch
    g = torch.Generator(device=dev).manual_seed(98)
    bf = torch.bfloat16
    H, Hkv, D, W = hf_heads(cfg)
    name = f"H {H} Hkv {Hkv} D {D}"
    rows = {}
    B, S = 4, 512
    q = torch.randn(B, S, H, D, device=dev, generator=g).to(bf)
    k, v = (torch.randn(B, S, Hkv, D, device=dev, generator=g).to(bf)
            for _ in range(2))
    out, _ = tfa.flash_fwd_cuda(q, k, v, causal=True)
    ref, _ = tfa.flash_attention_plain(q, k, v, causal=True)
    short, _ = tfa.flash_attention_plain(q, k, v, causal=True, q_offset=-1)
    torch.cuda.synchronize()
    held = hold("11", "flash_fwd", f"{name} [{B},{S}] causal", out, ref,
                "bfloat16", short)
    del out, ref, short
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 2.0 * S * S * D * H * B                  # causal: half of 4*S^2*D
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * 2 + B * H * S * 4
    t_flop, t_byte = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    rows["flash_fwd"] = dict(
        shape=[B, S, H, Hkv, D], dtype="bfloat16", **held,
        ms=cuda_time_ms(lambda: tfa.flash_fwd_cuda(q, k, v, causal=True)),
        plain_ms=cuda_time_ms(
            lambda: tfa.flash_attention_plain(q, k, v, causal=True)),
        library_ms=cuda_time_ms(lambda: gqa_sdpa(qt, kt, vt,
                                                 is_causal=True)),
        bound_ms=max(t_flop, t_byte) * 1e3,
        bound_by="operations" if t_flop >= t_byte else "bytes",
        library="torch.nn.functional.scaled_dot_product_attention("
                "enable_gqa=True)")

    L, n = 4, 640
    q1 = torch.randn(L, 1, H, D, device=dev, generator=g).to(bf)
    kc, vc = (torch.randn(L, W, Hkv, D, device=dev, generator=g).to(bf)
              for _ in range(2))
    length = torch.full((L,), n, dtype=torch.int32, device=dev)
    out = tfa.flash_decode_cuda(q1, kc, vc, length)
    short = tfa.flash_decode_cuda(q1, kc, vc, length - 1)
    ref = tfa.flash_decode_plain(q1, kc, vc, length)
    torch.cuda.synchronize()
    held = hold("11", "flash_decode", f"{name} {L} lanes x {n} of {W}",
                out, ref, "bfloat16", short)
    del out, ref, short
    qd = q1.transpose(1, 2).contiguous()
    kd, vd = (t[:, :n].transpose(1, 2).contiguous() for t in (kc, vc))
    nbytes = L * n * Hkv * D * 2 * 2 + 2 * L * H * D * 2 + L * 4
    flops = 4.0 * L * n * H * D
    t_flop, t_byte = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    rows["flash_decode"] = dict(
        shape=[L, W, H, Hkv, D], dtype="bfloat16", lengths=n, **held,
        ms=cuda_time_ms(lambda: tfa.flash_decode_cuda(q1, kc, vc, length),
                        iters=50),
        splits=tfa.decode_splits(W, Hkv * L, tfa._sm_count(dev)),
        plain_ms=cuda_time_ms(
            lambda: tfa.flash_decode_plain(q1, kc, vc, length)),
        library_ms=cuda_time_ms(lambda: gqa_sdpa(qd, kd, vd), iters=50),
        bound_ms=max(t_flop, t_byte) * 1e3,
        bound_by="operations" if t_flop >= t_byte else "bytes",
        library=f"scaled_dot_product_attention(enable_gqa=True) over the "
                f"{n} filled rows")
    rows["flash_decode"]["bound_share"] = (rows["flash_decode"]["bound_ms"]
                                           / rows["flash_decode"]["ms"])

    bs, T = 16, W // 16
    fills = [len(p) + 32
             for p in hf_prompts(cfg["vocab_size"], prompt_seed)]
    args = paged_case(g, dev, bf, Hkv, fills, bs=bs, T=T,
                      nb=len(fills) * T + 1, H=H, D=D)
    qp, kn, vn, tables, fill, kp, vp = args
    out = tpa.paged_decode_cuda(*args)
    short = tpa.paged_decode_cuda(qp, kn, vn, tables, fill - 1, kp, vp)
    ref = tpa.paged_decode_plain(*args)
    torch.cuda.synchronize()
    held = hold("11", "paged_decode", f"{name} {len(fills)} lanes, tables "
                f"of {T}, fills {fills}", out, ref, "bfloat16", short)
    del out, ref, short
    span = -(-max(f + 1 for f in fills) // bs)      # entries any lane needs
    pos = torch.arange(span * bs, device=dev)
    keep = (pos[None, :] <= fill[:, None].long())[:, None, None, :]

    def gather_sdpa():
        kg = kp[tables[:, :span].long()].flatten(1, 2).transpose(1, 2)
        vg = vp[tables[:, :span].long()].flatten(1, 2).transpose(1, 2)
        return gqa_sdpa(qp[:, :, None], kg, vg, attn_mask=keep)

    ms = cuda_time_ms(lambda: tpa.paged_decode_cuda(*args), iters=50)
    bound_ms, bound_by = paged_bound(fill, len(fills), H, Hkv, D, T, bs)
    rows["paged_decode"] = dict(
        shape=[len(fills), T * bs, H, Hkv, D], dtype="bfloat16",
        block_size=bs, fills=fills, ms=ms, **held,
        splits=tpa.paged_decode_cuda.splits_last,
        plain_ms=cuda_time_ms(lambda: tpa.paged_decode_plain(*args),
                              iters=5, warmup=1),
        library_ms=cuda_time_ms(gather_sdpa, iters=50),
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
        library="k_pool[table] gather of the filled span + "
                "scaled_dot_product_attention(enable_gqa=True) with a "
                "length mask (two calls)")
    return rows


def hf_state_dict(family, cfg, dev, seed):
    """Random weights in the HF checkpoint layout of ``family`` (the key
    names and [out, in] shapes transformers' model carries), bf16 on the
    card from ``seed``: projections, embedding and q/k/v biases N(0,
    0.02) (the configs' initializer range), norm weights N(0, 0.02)
    around their init (Gemma's (1 + w): 0; Qwen2's w: 1)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    d, H, Hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    hd = cfg.get("head_dim") or d // H
    inter = cfg["intermediate_size"]
    off = 0.0 if family == "gemma" else 1.0

    def w(*shape, mean=0.0):
        t = torch.randn(shape, generator=g, device=dev,
                        dtype=torch.bfloat16)
        return t.mul_(0.02).add_(mean)

    sd = {"model.embed_tokens.weight": w(cfg["vocab_size"], d),
          "model.norm.weight": w(d, mean=off)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, rows in (("q", H * hd), ("k", Hkv * hd), ("v", Hkv * hd)):
            sd[p + f"self_attn.{name}_proj.weight"] = w(rows, d)
            if family == "qwen2":
                sd[p + f"self_attn.{name}_proj.bias"] = w(rows)
        sd[p + "self_attn.o_proj.weight"] = w(d, H * hd)
        sd[p + "mlp.gate_proj.weight"] = w(inter, d)
        sd[p + "mlp.up_proj.weight"] = w(inter, d)
        sd[p + "mlp.down_proj.weight"] = w(d, inter)
        sd[p + "input_layernorm.weight"] = w(d, mean=off)
        sd[p + "post_attention_layernorm.weight"] = w(d, mean=off)
    return sd


def build_hf(family, cfg, dev, seed, dtype):
    """``cfg`` at full width with random HF-layout weights from ``seed``,
    mapped through the port's `compat.hf.from_hf_state_dict` (the card
    has no `transformers`), computing in ``dtype`` (bf16: its weights
    cast for serving)."""
    import torch
    from horovod_tpu_torch.compat.hf import from_hf_state_dict
    from horovod_tpu_torch.models.transformer import serving_params
    sd = hf_state_dict(family, cfg, dev, seed)
    model = from_hf_state_dict(
        family, cfg, sd, dtype=dtype, attn_impl="flash", device=dev,
        decode_prefix_block=256, decode_prefix_impl="pallas")
    del sd
    if dtype == torch.bfloat16:
        serving_params(model)
    model.eval()
    torch.cuda.synchronize()
    return model


def hf_prompt(model, dev, seed=17):
    """`generate`'s prompt in phase 11: 4 x 512 tokens."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, model.vocab_size, (4, 512), device=dev,
                         generator=g)


def forced_logits(model, tfa, prompt, forced, fault):
    """Teacher-forced logits (prefill + 8 ticks of ``forced``) through the
    kernels, through the plain versions, and through the plain versions
    with the decode ``fault`` (q, k, v, length)."""
    import torch
    with torch.no_grad():
        k_logits = teacher_forced_logits(model, prompt, forced, 8)
        with plain_attention(model, tfa):
            p_logits = teacher_forced_logits(model, prompt, forced, 8)
        with plain_attention(model, tfa, decode=fault):
            f_logits = teacher_forced_logits(model, prompt, forced, 8)
    torch.cuda.synchronize()
    return k_logits, p_logits, f_logits


def one_key_short(tfa):
    """The plain decode one key short (phase 3's planted fault)."""
    return lambda q, k, v, length: tfa.flash_decode_plain(q, k, v,
                                                          length - 1)


def run_hf_generate(model, tfa, dev, what, tol):
    """11a/11b `generate`: 4 x 512 -> 128 greedy through the forward and
    decode kernels, then teacher-forced logits (prefill + 8 ticks)
    against the same model on the plain versions, max |k - p| <= ``tol``
    and the tie-aware argmax agreement, and against the plain decode
    one key short (a planted fault), which the rule must see. Returns
    (readings, prompt, generated tokens)."""
    import torch
    from horovod_tpu_torch.models.transformer import generate
    prompt = hf_prompt(model, dev)
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda}
    with counting(kernels) as c:
        t0 = time.time()
        out = generate(model, prompt, 128)
        torch.cuda.synchronize()
        dt = time.time() - t0
    want = {"flash_fwd": model.num_layers,
            "flash_decode": 127 * model.num_layers}
    log(f"11 {what} generate 4x512 -> 128 greedy: {dt:.3f} s wall, "
        f"launches {c.launches}")
    if out.shape != (4, 640) or not bool((out >= 0).all()) \
            or not bool((out < model.vocab_size).all()):
        raise AssertionError(f"{what} generate output invalid")
    if c.launches != want:
        raise AssertionError(f"{what} generate launches {c.launches} != "
                             f"{want}")
    gen = out[:, 512:]
    k_logits, p_logits, f_logits = forced_logits(model, tfa, prompt, gen,
                                                 one_key_short(tfa))
    err = float((k_logits - p_logits).abs().max())
    ferr = float((f_logits - p_logits).abs().max())
    agree = argmax_agreement(k_logits, p_logits)
    scale = float(p_logits.abs().max())
    log(f"11 {what} teacher-forced logits (prefill + 8 ticks), kernels vs "
        f"plain: max_abs_err {err:.4f} (tol {tol}) at a logit scale (max "
        f"|logit|) of {scale:.3f}; argmax agreement {agree:.3f} (min "
        f"{MIN_ARGMAX_AGREEMENT}); planted fault (decode one key short) "
        f"max_abs_err {ferr:.4f}, caught {ferr > tol}")
    if not bool(torch.isfinite(k_logits).all()) or err > tol:
        raise AssertionError(f"{what} logits differ: {err}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"{what} argmax agreement {agree}")
    if ferr <= tol:
        raise AssertionError(f"{what}: the logits check does not see a "
                             f"decode one key short ({ferr})")
    if not torch.equal(k_logits.argmax(-1)[:, :-1], gen[:, :8]):
        raise AssertionError(f"{what} generate's greedy tokens are not the "
                             f"argmax of its own teacher-forced logits")
    return (dict(seconds=dt, launches=c.launches, logits_max_abs_err=err,
                 logits_tol=tol, logit_scale=scale, argmax_agreement=agree,
                 planted_fault_logits_err=ferr), prompt, gen)


def run_hf_f32(what, family, cfg, seed, tfa, tpa, dev, prompt, gen):
    """11a/11b in f32: the same weights computing in f32, where kernels
    and plain versions differ by summation order only, so that a fault
    as fine as one lost key shows. `generate`'s teacher-forced logits
    (the bf16 run's prompt and first 8 tokens), then phase 3b's paged
    teacher forcing at this model's geometry (tables of max_position /
    16 entries, `HF_PAGED_TICKS` ticks), each held to the family's
    HF_F32_LOGIT_TOL and against the decode one key short, which it
    must refuse (the plain decode in the first; the paged kernel itself
    in the second, whose plain walk over whole tables is slow)."""
    import torch
    t0 = time.time()
    tol = HF_F32_LOGIT_TOL[family]
    model = build_hf(family, cfg, dev, seed, torch.float32)
    k_logits, p_logits, f_logits = forced_logits(model, tfa, prompt,
                                                 gen[:, :8],
                                                 one_key_short(tfa))
    err = float((k_logits - p_logits).abs().max())
    ferr = float((f_logits - p_logits).abs().max())
    agree = argmax_agreement(k_logits, p_logits)
    log(f"11 {what} f32 teacher-forced logits (prefill + 8 ticks), "
        f"kernels vs plain: max_abs_err {err:.4g} (tol {tol}) "
        f"at a logit scale of {float(p_logits.abs().max()):.3f}; argmax "
        f"agreement {agree:.3f}; planted fault (decode one key short) "
        f"max_abs_err {ferr:.4g}, caught {ferr > tol}")
    if not bool(torch.isfinite(k_logits).all()) or err > tol:
        raise AssertionError(f"{what} f32 logits differ: {err}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"{what} f32 argmax agreement {agree}")
    if ferr <= tol:
        raise AssertionError(f"{what}: the f32 logits check does not see "
                             f"a decode one key short ({ferr})")

    def kernel_key_short(q, k_new, v_new, table, fill, k_pool, v_pool):
        return tpa.paged_decode_cuda(q, k_new, v_new, table,
                                     (fill - 1).clamp(min=0), k_pool,
                                     v_pool)

    paged = paged_teacher_forced(model, tpa, dev, tol=tol,
                                 n_ticks=HF_PAGED_TICKS,
                                 fault=kernel_key_short,
                                 what=f"11 {what} f32 paged")
    del model
    torch.cuda.empty_cache()
    return dict(logits_max_abs_err=err, planted_fault_logits_err=ferr,
                argmax_agreement=agree, paged=paged,
                seconds=time.time() - t0)


def run_hf_model(what, family, cfg, seed, prompt_seed, tfa, tpa, dev):
    """11a / 11b: ``cfg`` at full width in bf16 (`build_hf`): `generate`
    and its logits check, one seeded `generate`, and the paged engine
    (16 slots) over a burst of 16 requests of 64..512 prompt tokens, 64
    new tokens each; then the f32 checks (`run_hf_f32`)."""
    import torch
    t0 = time.time()
    model = build_hf(family, cfg, dev, seed, torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"11 {what}: {n_params / 1e9:.3f} B params, {nbytes / 1e9:.3f} GB "
        f"bf16, {model.num_layers} layers, {model.num_heads} heads x "
        f"{model.head_dim} over {model.num_kv} kv heads, built from the HF "
        f"layout in {time.time() - t0:.1f} s")
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    gen, prompt, tokens = run_hf_generate(model, tfa, dev, what,
                                          HF_LOGIT_TOL[family])
    # Sampling at a quarter of the measured logit scale, as phase 10's
    # FLEET_TEMPERATURE of 0.8 is of its model's scale of 3.3, keeps the
    # draw as live at any scale.
    seeded = seeded_generate(model, kernels, dev,
                             temperature=gen["logit_scale"] / 4)
    prompts = hf_prompts(model.vocab_size, prompt_seed)
    peng = serve_burst(model, prompts, 64, kernels, num_slots=16,
                       paged=True, paged_kernel="pallas", kv_block_size=16)
    if peng["launches"]["paged_decode"] < peng["ticks"] * model.num_layers:
        raise AssertionError(f"{what} paged_decode launches "
                             f"{peng['launches']['paged_decode']} < ticks "
                             f"{peng['ticks']} x {model.num_layers}")
    log(f"11 {what} paged engine, 16 slots, 16 req (64..512 prompt "
        f"tokens) x 64 new: {peng['seconds']:.2f} s, "
        f"{peng['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{peng['ttft_ms_p50']} ms, TPOT p50 {peng['tpot_ms_p50']} ms, "
        f"{peng['ticks']} ticks, launches {peng['launches']}, KV "
        f"{peng['kv_bytes'] / 1e9:.3f} GB")
    del model
    torch.cuda.empty_cache()
    f32 = run_hf_f32(what, family, cfg, seed, tfa, tpa, dev, prompt, tokens)
    return dict(params=n_params, weight_bytes=nbytes, generate=gen,
                seeded_generate=seeded, paged_engine=peng, f32=f32,
                seconds=time.time() - t0,
                runs={"generate": gen, "seeded": seeded, "engine": peng})


# 11d: the kernel names a traced step and tick must show, each launch
# one event: the bf16 training kernels and the paged split kernel.
TRACE_KERNELS = {"flash_fwd": "flash_fwd_wgmma",
                 "flash_bwd_dq": "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv": "flash_bwd_dkv_wgmma",
                 "paged_decode": "paged_decode_split"}


def traced(fn, what):
    """Run ``fn`` once under the port's `profiler_session` into a fresh
    directory and read the trace back with the port's analysis: top ops
    by device time, the device's busy share of the traced window
    (union of device events over the extent of every event), and the
    launches of each `TRACE_KERNELS` entry."""
    import re
    import shutil
    import tempfile
    from horovod_tpu_torch.obs.profiling import profiler_session
    from horovod_tpu_torch.utils import profile_analysis as pa
    d = tempfile.mkdtemp(prefix="hvd_trace_")
    try:
        t0 = time.time()
        with profiler_session(d):
            fn()
        res = pa.analyze_profile_dir(d, min_mtime=t0)
        trace = pa.load_trace(d, min_mtime=t0)
        trace_bytes = os.path.getsize(pa.find_trace_file(d, min_mtime=t0))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if res is None:
        raise AssertionError(f"the {what} trace has no device timeline")
    events = trace["traceEvents"]
    dev_ev = pa._device_events(events, pa._device_pids(events))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X" and "dur" in e]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = sum(e - s for s, e in pa._merge(
        [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
         for e in dev_ev]))
    counts = {k: sum(1 for e in dev_ev if e.get("cat") == "kernel"
                     and re.search(rf"\b{name}\b", e.get("name", "")))
              for k, name in TRACE_KERNELS.items()}
    b = res["op_breakdown"]
    log(f"11d {what} trace: window {window / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms = {100 * busy / window:.1f} %, device "
        f"events {len(dev_ev)}, kernel launches {counts}, trace "
        f"{trace_bytes / 1e6:.1f} MB")
    log(f"11d {what} top categories by device time: " + "; ".join(
        f"{c['category']} {c['us'] / 1e3:.3f} ms ({100 * c['share']:.1f} %)"
        for c in b["categories"][:8]))
    log(f"11d {what} top kernels by device time: " + "; ".join(
        f"{o['name'][:60]} {o['us'] / 1e3:.3f} ms ({100 * o['share']:.1f} %)"
        for o in b["top_ops"][:6]))
    return dict(window_us=window, device_busy_us=busy,
                busy_share=busy / window, device_events=len(dev_ev),
                launches=counts, overlap={k: v for k, v in res.items()
                                          if k != "op_breakdown"},
                op_breakdown=b)


def trace_paged_tick(model, tpa, dev):
    """11d: one tick of phase 4b's paged pool (16 lanes over 1025 blocks
    of 16, the kernel mode of the engine) with 16 of phase 4b's
    prompts prefilled, traced; the trace must count one paged-decode
    launch per layer."""
    from horovod_tpu_torch.serving.paging import PagedSlotPool
    pool = PagedSlotPool(model, 16, num_blocks=1025, block_size=16,
                         kernel="pallas")
    for prompt in paged_prompts(model.vocab_size)[:16]:
        adm = pool.admit(prompt, 64)
        pool.prefill(adm.slot, prompt, 0.0, None, 0)
    pool.tick()                                   # warm
    out = traced(pool.tick, "paged tick (phase 4b's pool, 16 lanes)")
    pool.release()
    n = out["launches"]["paged_decode"]
    if n != model.num_layers:
        raise AssertionError(f"the traced tick launched paged_decode {n} "
                             f"times, not {model.num_layers}")
    return out


def run_hf(tfa, tpa, dev):
    """Phase 11 (a-c): the new instantiations against their plain
    versions, then each of `HF_MODELS` at full width and the kernels
    line's rows of its path."""
    t0 = time.time()
    coverage = check_coverage(tfa, tpa, dev)
    log(f"11c: {len(coverage)} instantiation checks held, every planted "
        f"fault caught, in {time.time() - t0:.1f} s")
    models = {}
    for what, tag, family, cfg, seed, prompt_seed in HF_MODELS:
        if cfg is QWEN2_0_5B:
            log(f"11b {what}: max_position_embeddings cut from "
                f"{QWEN2_PUBLISHED_MAX_POSITION} to "
                f"{cfg['max_position_embeddings']} (the caches' length)")
        models[tag] = run_hf_model(what, family, cfg, seed, prompt_seed,
                                   tfa, tpa, dev)
        models[tag]["timing"] = time_coverage(tfa, tpa, dev, cfg,
                                              prompt_seed)
    return dict(coverage=coverage, models=models, seconds=time.time() - t0)


# -- phase 12: Gemma-2B training, resumably ---------------------------------

# 12b trains Gemma-2B at B = GEMMA_TRAIN_BATCH x 2048; 12a checks and
# times the backward kernels at that shape.
GEMMA_TRAIN_BATCH = 2

# 12a: the backward kernels at head_dim 256 (Gemma-1's heads over one kv
# head) against the plain backward, at phase 2c's GRAD_TOL, in the same
# form as phase 2c's cases. The path case is 12b's training attention
# and carries the planted faults.
BWD256_CASES = [
    (f"path [{GEMMA_TRAIN_BATCH},2048,8,256] Hkv 1 causal",
     (GEMMA_TRAIN_BATCH, 2048, 2048, 8, 1, 256), dict(causal=True), False,
     False),
    ("window 512 [1,2048,8,256] Hkv 1", (1, 2048, 2048, 8, 1, 256),
     dict(causal=True, window=512), False, False),
    ("Hkv = H [1,1024,8,256] causal", (1, 1024, 1024, 8, 8, 256),
     dict(causal=True), False, False),
    ("ragged Sq=Sk=1000 Hkv 2, dlse", (2, 1000, 1000, 8, 2, 256),
     dict(causal=True), True, False),
    ("fused qkv views [1,1024,8,256]", (1, 1024, 1024, 8, 8, 256),
     dict(causal=True), False, True),
]
BWD256_NAMES = ("flash_bwd_dq@gemma-2b", "flash_bwd_dkv@gemma-2b")


def run_bwd256(tfa, dev, batch):
    """12a: the D = 256 checks, then both kernels timed at the Gemma-2B
    training step's attention, [batch, 2048, 8, 256] over one kv head,
    beside the plain backward, SDPA's backward and the bound."""
    import torch
    t0 = time.time()
    errs = check_backward(tfa, dev, cases=BWD256_CASES, names=BWD256_NAMES,
                          seed=1357)
    g = torch.Generator(device=dev).manual_seed(4321)
    timing = time_backward(tfa, dev, g, batch, 2048, 8, 1, 256,
                           tag="@gemma-2b")
    for name in BWD256_NAMES:
        t = timing[name]
        log(f"12a {name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
            f"plain, {t['library_ms']:.4f} ms SDPA backward, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) at {t['shape']} "
            f"Hkv 1, max_abs_err {t['max_abs_err']:.3e} on these inputs, "
            f"{errs[name]['max_abs_err']:.3e} in the bf16 path case")
    t = timing["flash_backward@gemma-2b"]
    log(f"12a whole backward (dvec pass + dQ + dK/dV) at {t['shape']} Hkv "
        f"1: {t['ms']:.4f} ms, SDPA backward {t['library_ms']:.4f} ms")
    return dict(errs=errs, timing=timing, seconds=time.time() - t0)


# 12b: Gemma-2B (phase 11's config, full width and depth) training from
# random HF-layout weights, f32 params and bf16 compute as phase 5, fed
# by the port's data pipeline. B = 2 x 2048 fits without remat: ~40 GB
# of f32 params, grads and AdamW moments, the rest activations.
GEMMA_TRAIN_STEPS = 8
GEMMA_TRAIN_SEED = 5
# AdamW's rate, ramped linearly over the first GEMMA_WARMUP steps (1:
# no ramp). From random weights 3e-4 overshoots (losses 12.20, 9.65,
# 18.14, 11.15, 10.46, 10.44), and so do 3e-4 and 1e-4 ramped over 3
# steps; 5e-5 falls at every step, 12.20 to 6.77 in 8, and 3e-5 and
# 1e-5 do too, more slowly (`chip_probe.py lr12`, an H100 80GB HBM3 at
# 700 W). The loss must fall for real: no step above the first, and the
# median of the last half at least GEMMA_LOSS_DROP nats below the
# first (5e-5 reads 4.97).
GEMMA_LR = 5e-5
GEMMA_WARMUP = 1
GEMMA_LOSS_DROP = 2.0
# The packed corpus: documents of Zipf-distributed ids over the first
# GEMMA_DOC_VOCAB ids (a learnable unigram, so a few steps lower the
# loss), DOCS documents of 300..1500 tokens, packed into 2048-token rows
# over 3 shards; at B = 2 the rows repeat within the run.
GEMMA_DOC_VOCAB = 4096
GEMMA_DOCS = 24
# 12b's f32 twin: the same weights computing in f32, kernels vs plain
# versions, worst per-parameter gradient error. In bf16 the planted
# fault (dK/dV one query row short) moved Gemma-2B's gradients by
# 6.8e-3 against the kernels' own 7.1e-3, so bf16 cannot see it; in f32
# the kernels read 9.3e-7 and the fault 4.0e-3 (`chip_probe.py
# train12`, an H100 80GB HBM3 at 700 W). The limit sits between them,
# two orders of magnitude from each. An f32 model runs the f32
# CUDA-core backward kernels, so the twin holds those; the bf16 wgmma
# kernels that 12b trains with are held by 12a at 12b's shape.
GEMMA_F32_GRAD_TOL = 1e-4


def packed_corpus(workdir, vocab, seq, docs, seed, *, doc_vocab=None):
    """`write_token_shards` of ``docs`` seeded documents (Zipf ids below
    ``doc_vocab``, eos 1) into ``workdir``: (paths, rows)."""
    import numpy as np
    from horovod_tpu_torch import data as hd
    rs = np.random.RandomState(seed)
    top = min(doc_vocab or vocab, vocab)
    documents = [np.minimum(rs.zipf(1.2, rs.randint(300, 1500)) + 1,
                            top - 1) for _ in range(docs)]
    paths = hd.write_token_shards(workdir, "corpus", documents, seq, 3,
                                  eos_id=1)
    rows = len(hd.pack_tokens(documents, seq, eos_id=1))
    return paths, rows


def batches(ds, start=(0, 0)):
    """The dataset's batches from cursor ``start`` on, across epochs, as
    (cursor after the batch, tokens [B, S] numpy)."""
    e, b = start
    while True:
        for batch in ds.epoch(e, start_batch=b):
            yield ds.cursor, batch["tokens"]
        e, b = e + 1, 0


def run_gemma_training(tfa, dev, workdir):
    """12b: Gemma-2B at full width and depth trains GEMMA_TRAIN_STEPS
    AdamW steps on batches of the port's `ShardedDataset` (the native
    loader) through the forward, dQ and dK/dV kernels at D = 256; the
    loss must be finite and fall (see GEMMA_LOSS_DROP), each kernel
    launch >= 18 x steps. Then one B = 1 step through the kernels
    against the same step on the plain forward and backward (phase 5's
    STEP_LOSS_TOL and STEP_GRAD_TOL), and its f32 twin (the same
    weights computing in f32, through the f32 kernels) within
    GEMMA_F32_GRAD_TOL, where the planted fault must fail."""
    import numpy as np
    import torch
    from horovod_tpu_torch import data as hd
    from horovod_tpu_torch.compat.hf import from_hf_state_dict
    from horovod_tpu_torch.models.transformer import make_lm_train_step
    t0 = time.time()
    cfg = GEMMA_2B
    S, B = 2048, GEMMA_TRAIN_BATCH
    paths, rows = packed_corpus(workdir, cfg["vocab_size"], S, GEMMA_DOCS,
                                GEMMA_TRAIN_SEED,
                                doc_vocab=GEMMA_DOC_VOCAB)
    ds = hd.ShardedDataset(paths, hd.lm_spec(S), B, shuffle=True,
                           seed=GEMMA_TRAIN_SEED, rank=0, world=1,
                           drop_remainder=True)
    if not ds.native:
        raise AssertionError("12b: the native data loader did not load")
    sd = hf_state_dict("gemma", cfg, dev, GEMMA_TRAIN_SEED)
    model = from_hf_state_dict("gemma", cfg, sd, dtype=torch.bfloat16,
                               attn_impl="flash", device=dev)
    del sd
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    opt = torch.optim.AdamW(model.parameters(), lr=GEMMA_LR,
                            weight_decay=1e-4)
    step = make_lm_train_step(model, opt, loss_chunk=512)
    build_s = time.time() - t0
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    losses, times = [], []
    feed = batches(ds)
    for i in range(GEMMA_TRAIN_STEPS):
        for group in opt.param_groups:
            group["lr"] = GEMMA_LR * min(1.0, (i + 1) / GEMMA_WARMUP)
        t1 = time.time()
        _, tokens = next(feed)
        loss = step(torch.from_numpy(tokens).to(dev, non_blocking=True))
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        losses.append(float(loss))
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])[len(times[1:]) // 2]
    L = cfg["num_hidden_layers"]
    # 6 N a token for the matmuls plus the causal attention term
    # 6 L S d (as phase 5), d the attention width H x head_dim.
    flops_per_token = 6 * n_params + 6 * L * S * 8 * 256 / 2
    mfu = flops_per_token * B * S / steady / PEAK_BF16_FLOPS
    ds.close()
    info = dict(params=n_params, batch=B, seq=S, corpus_rows=rows,
                steps=GEMMA_TRAIN_STEPS, lr=GEMMA_LR, warmup=GEMMA_WARMUP,
                losses=losses, step_s=times,
                step_ms_median_after_first=steady * 1e3,
                tokens_per_s=B * S / steady, mfu=mfu,
                max_memory_allocated=peak, launches=launches,
                build_s=build_s, native_loader=True)
    log(f"12b Gemma-2B training ({n_params / 1e9:.3f} B params, f32 params"
        f" + bf16 compute, AdamW), B = {B} x {S} from {rows} packed rows "
        f"(native loader): losses {[round(x, 4) for x in losses]}, step s "
        f"{[round(t, 3) for t in times]}, median after the first "
        f"{steady * 1e3:.1f} ms = {B * S / steady:.0f} tokens/s, MFU "
        f"{mfu:.4f} of 989 TFLOP/s, peak memory {peak / 1e9:.2f} GB, "
        f"launches {launches}")
    late = float(np.median(losses[len(losses) // 2:]))
    if (not all(np.isfinite(losses)) or max(losses[1:]) >= losses[0]
            or late > losses[0] - GEMMA_LOSS_DROP):
        raise AssertionError(f"12b loss not finite and falling (every "
                             f"step below the first, the last half's "
                             f"median {late:.4f} at least "
                             f"{GEMMA_LOSS_DROP} below it): {losses}")
    for k, n in launches.items():
        if n < L * GEMMA_TRAIN_STEPS:
            raise AssertionError(f"12b {k} launched {n} < {L} x "
                                 f"{GEMMA_TRAIN_STEPS}")
    del opt, step
    torch.cuda.empty_cache()
    _, tokens = next(batches(hd.ShardedDataset(
        paths, hd.lm_spec(S), 1, rank=0, world=1)))
    tokens = torch.from_numpy(tokens).to(dev)
    chk = train_step_errors(model, tfa, tokens)
    info["check_bf16"] = chk
    log(f"12b train step B=1, kernels vs plain: loss {chk['check_loss']:.6f}"
        f" vs {chk['check_plain_loss']:.6f} (tol {STEP_LOSS_TOL}), worst "
        f"per-parameter gradient error {chk['check_grad_err']:.3e} (tol "
        f"{STEP_GRAD_TOL}); the planted fault (plain dK/dV one query row "
        f"short) {chk['check_planted_fault_grad_err']:.3e}, under the bf16"
        f" noise: the bf16 kernels are held by 12a at this shape")
    if (abs(chk["check_loss"] - chk["check_plain_loss"]) > STEP_LOSS_TOL
            or chk["check_grad_err"] > STEP_GRAD_TOL):
        raise AssertionError(f"12b train step through the kernels differs: "
                             f"{chk}")
    f32 = model.clone(dtype=torch.float32)
    f32.load_state_dict(model.state_dict(), assign=True)
    del model
    torch.cuda.empty_cache()
    chk = train_step_errors(f32, tfa, tokens)
    info["check_f32"] = chk
    log(f"12b f32 twin (the f32 kernels), kernels vs plain: loss "
        f"{chk['check_loss']:.6f} vs "
        f"{chk['check_plain_loss']:.6f}, worst per-parameter gradient error"
        f" {chk['check_grad_err']:.3e} (tol {GEMMA_F32_GRAD_TOL}); planted "
        f"fault {chk['check_planted_fault_grad_err']:.3e}, caught "
        f"{chk['check_planted_fault_grad_err'] > GEMMA_F32_GRAD_TOL}")
    if (abs(chk["check_loss"] - chk["check_plain_loss"]) > STEP_LOSS_TOL
            or chk["check_grad_err"] > GEMMA_F32_GRAD_TOL):
        raise AssertionError(f"12b f32 train step through the kernels "
                             f"differs: {chk}")
    if chk["check_planted_fault_grad_err"] <= GEMMA_F32_GRAD_TOL:
        raise AssertionError("12b: the f32 train-step check does not see "
                             "a dK/dV one query row short")
    del f32
    torch.cuda.empty_cache()
    info["seconds"] = time.time() - t0
    return info


# 12c: the resumable loop on phase 5's model (its checkpoint with AdamW
# is ~2.2 GB): periodic async saves every RESUME_SAVE_EVERY steps, the
# process's own SIGTERM after step RESUME_KILL_AT (the emergency save),
# then a fresh model, optimizer, dataset and trainer resume and run to
# RESUME_STEPS; against one uninterrupted run, bitwise.
RESUME_STEPS = 7
RESUME_SAVE_EVERY = 3
RESUME_KILL_AT = 5
RESUME_BATCH = 2


def resume_model(dev, seed):
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    model = TransformerLM(32768, 12, 8, 128, max_len=2048,
                          dtype=torch.bfloat16, attn_impl="flash",
                          device=dev).init_weights(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    return model, opt


def train_state(model, opt):
    return {"model": model.state_dict(), "opt": opt.state_dict()}


def clone_tree(tree):
    """A deep copy of a checkpoint tree (tensors cloned)."""
    import torch
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def trees_equal(a, b, where=""):
    """None when the trees are bitwise equal, else the first leaf that
    differs."""
    import torch
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return f"{where}: keys differ"
        for k in a:
            bad = trees_equal(a[k], b[k], f"{where}/{k}")
            if bad:
                return bad
        return None
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return f"{where}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            bad = trees_equal(x, y, f"{where}/{i}")
            if bad:
                return bad
        return None
    if isinstance(a, torch.Tensor):
        ok = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
              and a.shape == b.shape
              and torch.equal(a.cpu(), b.cpu()))
        return None if ok else f"{where}: tensors differ"
    return None if a == b else f"{where}: {a!r} != {b!r}"


def resume_leg(tfa, dev, paths, ckpt_dir, *, kill_at=None, resume=False,
               init_seed=0):
    """One process lifetime of 12c: a fresh model, optimizer, dataset,
    host RNG and `ElasticTrainer`; `resume()` when asked, then steps to
    RESUME_STEPS (or until the process's own SIGTERM after step
    ``kill_at`` has cut the emergency save). Returns the losses by step,
    the final state, and the trainer's readings."""
    import signal
    import torch
    from horovod_tpu_torch import data as hd
    from horovod_tpu_torch.models.transformer import make_lm_train_step
    from horovod_tpu_torch.resilience import ElasticTrainer
    model, opt = resume_model(dev, init_seed)
    step_fn = make_lm_train_step(model, opt, loss_chunk=512)
    ds = hd.ShardedDataset(paths, hd.lm_spec(2048), RESUME_BATCH,
                           shuffle=True, seed=7, rank=0, world=1)
    rng = torch.Generator().manual_seed(11)
    trainer = ElasticTrainer(ckpt_dir, save_every=RESUME_SAVE_EVERY,
                             keep=2, dataset=ds, rng=rng)
    out = dict(losses={}, native=ds.native)
    try:
        start, restored = 0, None
        t0 = time.time()
        if resume:
            restored, start = trainer.resume(like=train_state(model, opt))
            # Held before loading: the optimizer keeps (and later steps
            # update) the restored step counts in place.
            out["restored"] = clone_tree(restored)
            model.load_state_dict(restored["model"])
            opt.load_state_dict(restored["opt"])
            torch.cuda.synchronize()
            out.update(resume_s=time.time() - t0, start=start,
                       data_start=list(trainer.data_start),
                       gap=trainer.resume_gap_batches,
                       exact=trainer.snapshot.exact,
                       fallbacks=trainer.cursor_fallbacks)
        feed = batches(ds, trainer.data_start)
        save_s = []
        for i in range(start, RESUME_STEPS):
            _, tokens = next(feed)
            shift = int(torch.randint(0, 2048, (1,), generator=rng))
            tokens = torch.from_numpy(tokens).to(dev).roll(shift, 1)
            out["losses"][i + 1] = float(step_fn(tokens))
            if kill_at is not None and i + 1 == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            t1 = time.time()
            trainer.after_step(i + 1, train_state(model, opt),
                               out["losses"][i + 1])
            save_s.append(time.time() - t1)
            if trainer.should_stop:
                out["saved"] = clone_tree(train_state(model, opt))
                out["emergency_save_s"] = save_s[-1]
                break
        from horovod_tpu_torch.utils import checkpoint as ckpt
        ckpt.wait_pending()
        out["periodic_save_s"] = [t for j, t in enumerate(save_s)
                                  if (start + j + 1) % RESUME_SAVE_EVERY
                                  == 0 and start + j + 1 != kill_at]
        out["final"] = clone_tree(train_state(model, opt))
        out["should_stop"] = trainer.should_stop
    finally:
        trainer.close()
        ds.close()
    return out


def run_resume(tfa, dev, workdir):
    """12c: an uninterrupted run, then the same run killed by its own
    SIGTERM after step RESUME_KILL_AT and resumed in a fresh trainer:
    the restored state equals the emergency save's bitwise, the resumed
    losses and final parameters equal the uninterrupted run's bitwise,
    and `resume_gap_batches == 0`. The step is deterministic on the
    card as it is (the kernels use no atomics; `chip_probe.py train12`
    read the embedding's backward bitwise from run to run too)."""
    import torch
    t0 = time.time()
    paths, rows = packed_corpus(os.path.join(workdir, "data"), 32768, 2048,
                                8, 13)
    ref = resume_leg(tfa, dev, paths, os.path.join(workdir, "ref"))
    killed = resume_leg(tfa, dev, paths, os.path.join(workdir, "run"),
                        kill_at=RESUME_KILL_AT)
    if not killed["should_stop"] or "saved" not in killed:
        raise AssertionError("12c: the SIGTERM did not stop the loop")
    resumed = resume_leg(tfa, dev, paths, os.path.join(workdir, "run"),
                         resume=True, init_seed=99)
    bad_restore = trees_equal(resumed.pop("restored"), killed["saved"])
    losses = {**killed["losses"], **resumed["losses"]}
    bad_final = trees_equal(resumed["final"], ref["final"])
    info = dict(
        rows=rows, steps=RESUME_STEPS, kill_at=RESUME_KILL_AT,
        save_every=RESUME_SAVE_EVERY, native=ref["native"],
        ref_losses=ref["losses"], losses=losses, start=resumed["start"],
        data_start=resumed["data_start"], gap=resumed["gap"],
        exact=resumed["exact"], fallbacks=resumed["fallbacks"],
        resume_s=resumed["resume_s"],
        emergency_save_s=killed["emergency_save_s"],
        periodic_save_s=ref["periodic_save_s"],
        restore_bitwise=bad_restore is None,
        losses_bitwise=losses == ref["losses"],
        final_bitwise=bad_final is None)
    log(f"12c resume on phase 5's model (B = {RESUME_BATCH} x 2048, AdamW):"
        f" SIGTERM after step {RESUME_KILL_AT}, emergency save "
        f"{killed['emergency_save_s']:.2f} s, periodic async saves "
        f"{[round(t, 3) for t in ref['periodic_save_s']]} s (the step's "
        f"share), resume() {resumed['resume_s']:.2f} s to step "
        f"{resumed['start']} at cursor {resumed['data_start']}, gap "
        f"{resumed['gap']} batches, exact {resumed['exact']}; restored == "
        f"saved bitwise: {bad_restore is None} ({bad_restore}); losses "
        f"{losses} vs {ref['losses']}: bitwise {losses == ref['losses']}; "
        f"final params and AdamW state bitwise: {bad_final is None} "
        f"({bad_final})")
    if not (ref["native"] and killed["native"] and resumed["native"]):
        raise AssertionError("12c: the native data loader did not load")
    if resumed["start"] != RESUME_KILL_AT or resumed["gap"] != 0 \
            or not resumed["exact"] or resumed["fallbacks"]:
        raise AssertionError(f"12c: not an exact resume at step "
                             f"{RESUME_KILL_AT}: {info}")
    if bad_restore or bad_final or losses != ref["losses"]:
        raise AssertionError(f"12c: resumed run differs: restore "
                             f"{bad_restore}, final {bad_final}")
    del ref, killed, resumed
    torch.cuda.empty_cache()
    info["seconds"] = time.time() - t0
    return info


def run_phase12(tfa, dev):
    """Phase 12 (12a, 12b, 12c) in a temporary directory that is removed
    after it, whatever the outcome."""
    import shutil
    import tempfile
    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="hvd_phase12_")
    try:
        bwd = run_bwd256(tfa, dev, GEMMA_TRAIN_BATCH)
        gemma = run_gemma_training(tfa, dev, os.path.join(workdir, "gemma"))
        resume = run_resume(tfa, dev, os.path.join(workdir, "resume"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return dict(bwd256=bwd, gemma=gemma, resume=resume,
                seconds=time.time() - t0,
                runs={"gemma": gemma})


# Phase 13: elastic membership on the card. 13a: `SimulatedWorld` of
# ELASTIC_WORLD members, each a thread owning a full-width LM of the
# repo's config cut to ELASTIC_MODEL's 2 layers (the four f32 states and
# every committed checkpoint stay under 0.5 GB; the resize path does
# not depend on depth), fed by `ShardedDataset` over seeded token
# shards, averaging its gradients in float64 on the card.
ELASTIC_MODEL = dict(vocab=32768, layers=2, heads=8, head_dim=128,
                     max_len=2048)
ELASTIC_WORLD = 4
ELASTIC_RECORDS = 128
ELASTIC_SEQ = 513               # tokens a record: 512 next-token targets
ELASTIC_SHARDS = 4
ELASTIC_BATCH = 2
ELASTIC_EPOCHS = 2
ELASTIC_SAVE_EVERY = 4
ELASTIC_LR = 0.05               # plain SGD on the float64 average
ELASTIC_SEED = 13
# The heartbeat lease of 13a's worlds: HVD_LEASE_S's default. The
# members' heartbeat threads share the interpreter lock with four
# training threads; the control leg must see no death under it.
ELASTIC_LEASE_S = 2.0
ELASTIC_CHAOS = "rank_death:1,rank_join:1"
# 13b: the multi-process drill's wall-clock budget
# (HVD_ELASTIC_DRILL_TIMEOUT_S in its environment).
DRILL_TIMEOUT_S = 180.0


def elastic_corpus(workdir):
    """ELASTIC_RECORDS rows of ELASTIC_SEQ tokens packed
    (`write_token_shards`) from seeded Zipf documents, the last one cut
    so that the rows come out whole: the shard paths."""
    import numpy as np
    from horovod_tpu_torch import data as hd
    rs = np.random.RandomState(ELASTIC_SEED)
    need, docs = ELASTIC_RECORDS * ELASTIC_SEQ, []
    while need > 0:
        doc = np.minimum(rs.zipf(1.2, rs.randint(300, 1500)) + 1,
                         ELASTIC_MODEL["vocab"] - 1)[:need - 1]
        docs.append(doc)
        need -= len(doc) + 1
    paths = hd.write_token_shards(workdir, "elastic", docs, ELASTIC_SEQ,
                                  ELASTIC_SHARDS, eos_id=1)
    rows = len(hd.pack_tokens(docs, ELASTIC_SEQ, eos_id=1))
    if rows != ELASTIC_RECORDS:
        raise AssertionError(f"13a corpus packed {rows} rows")
    return paths


class member_models:
    """One `TransformerLM` a member thread, built on the card from the
    same seed before the world starts and handed out on a member's first
    step (`torch.func.functional_call` over one shared module would
    patch its attributes from four threads at once)."""

    def __init__(self, dev, n):
        import threading
        import torch
        from horovod_tpu_torch.models.transformer import TransformerLM
        c = ELASTIC_MODEL
        self.all = [TransformerLM(c["vocab"], c["layers"], c["heads"],
                                  c["head_dim"], max_len=c["max_len"],
                                  dtype=torch.bfloat16, attn_impl="flash",
                                  device=dev).init_weights(ELASTIC_SEED)
                    for _ in range(n)]
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        import threading
        self.free = list(self.all)
        self.local = threading.local()

    def get(self):
        model = getattr(self.local, "model", None)
        if model is None:
            with self.lock:
                model = self.local.model = self.free.pop()
        return model


class elastic_lm:
    """13a's `grad_fn` / `apply_fn`: the port's LM loss and autograd
    through the flash forward and both backward kernels on the member's
    own model, and plain SGD on the float64 average, cast back to f32.
    Counts the members' steps and stamps each member's applies."""

    def __init__(self, models, dev):
        import threading
        self.models, self.dev = models, dev
        self.lock = threading.Lock()
        self.steps = 0
        self.applied = {}

    def grad_fn(self, state, batch):
        import torch
        from horovod_tpu_torch.models.transformer import _lm_data_loss
        model = self.models.get()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n])
        model.zero_grad(set_to_none=True)
        tokens = torch.from_numpy(batch["tokens"]).to(self.dev)
        loss = _lm_data_loss(model, tokens, 512)
        loss.backward()
        with self.lock:
            self.steps += 1
        return ({n: p.grad for n, p in model.named_parameters()},
                float(loss.detach()))

    def apply_fn(self, state, avg):
        import threading
        out = {n: (state[n].double() - ELASTIC_LR * avg[n]).float()
               for n in state}
        with self.lock:
            self.applied.setdefault(threading.current_thread().name,
                                    []).append(time.perf_counter())
        return out


def check_elastic_kernels(tfa, dev):
    """The forward and both backward kernels against their plain
    versions at 13a's attention, [2, 513, 8, 128] causal (a ragged
    length), q/k/v as views of one fused projection, f32 and bf16."""
    import torch
    g = torch.Generator(device=dev).manual_seed(ELASTIC_SEED)
    H, D = ELASTIC_MODEL["heads"], ELASTIC_MODEL["head_dim"]
    shape = (ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_SEQ, H, H, D)
    name = f"13a [{ELASTIC_BATCH},{ELASTIC_SEQ},{H},{D}] fused causal"
    errs = {"flash_fwd": {"max_abs_err_f32": 0.0, "lse_max_abs_err": 0.0}}
    for dtype in ("float32", "bfloat16"):
        q, k, v = fused_qkv(ELASTIC_BATCH, ELASTIC_SEQ, H, D, dev,
                            getattr(torch, dtype), g)
        check_forward_case(tfa, q, k, v, dict(causal=True), dtype, name,
                           errs)
    errs.update(check_backward(
        tfa, dev, cases=[(name, shape, dict(causal=True), False, True)],
        seed=ELASTIC_SEED))
    return {k: {"max_abs_err": e["max_abs_err_other_cases"],
                "max_abs_err_f32": e["max_abs_err_f32"]}
            for k, e in errs.items()}


def elastic_leg(cls, lm, paths, ckpt_dir, state0, chaos_spec=None):
    """One run of a world of class ``cls`` (a `SimulatedWorld`) under
    ``chaos_spec`` when given: its report and wall time. Each world
    starts at generation 0: the process's generation, which
    `bootstrap.apply_resize` holds monotonic, is reset before it (an
    earlier leg's generation 2 would refuse this world's generation 1)."""
    from horovod_tpu_torch import data as hd
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.runtime import state as rt_state
    lm.models.reset()
    rt_state.global_state().world_generation = 0

    def make_ds(rank, world):
        return hd.ShardedDataset(paths, hd.lm_spec(ELASTIC_SEQ),
                                 ELASTIC_BATCH, shuffle=True,
                                 seed=ELASTIC_SEED, rank=rank, world=world)
    world = cls(world=ELASTIC_WORLD, make_dataset=make_ds, state0=state0,
                grad_fn=lm.grad_fn, apply_fn=lm.apply_fn,
                ckpt_dir=ckpt_dir, epochs=ELASTIC_EPOCHS,
                save_every=ELASTIC_SAVE_EVERY, lease_s=ELASTIC_LEASE_S)
    t0 = time.time()
    if chaos_spec:
        with chaos.armed(chaos_spec):
            report = world.run(timeout_s=600)
    else:
        report = world.run(timeout_s=600)
    return report, time.time() - t0


def wall_ms(fn, n=5):
    """The median wall of ``n`` calls of ``fn`` after one warm-up, each
    synchronized with the card (ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return sorted(out)[len(out) // 2]


def run_elastic_world(tfa, dev, workdir):
    """13a: an uninterrupted control leg, then the chaos leg under
    ELASTIC_CHAOS (one death, one join: a shrink to 3 and a grow back to
    4 at generation 2) whose union stream must equal the control's, then
    the chaos leg once more with the trainer's migration turned off (a
    planted fault: each resumed member falls back to an epoch boundary
    derived from the step count, replaying or skipping records of the
    interrupted epoch) which must run to its end and whose union must
    not. The flash forward, dQ and dK/dV kernels must each
    launch >= layers x the members' steps over the control and chaos
    legs."""
    import numpy as np
    import torch
    from horovod_tpu_torch.resilience import membership
    from horovod_tpu_torch.resilience.elastic import ElasticTrainer
    from horovod_tpu_torch.utils import checkpoint

    class unmigrated_world(membership.SimulatedWorld):
        """The planted fault: members resume without the trainer's
        world migration."""

        def _build_trainer(self, dec_rank, dec_world):
            ds = self.make_dataset(dec_rank, dec_world)
            trainer = ElasticTrainer(
                self.ckpt_dir,
                save_every=self.save_every if dec_rank == 0 else 0,
                keep=0, block=True, install_signals=False, dataset=ds,
                migrate_world=False)
            state, step = trainer.resume(like=self.state0)
            return ds, trainer, state, step

    t0 = time.time()
    paths = elastic_corpus(os.path.join(workdir, "data"))
    errs = check_elastic_kernels(tfa, dev)
    models = member_models(dev, ELASTIC_WORLD + 1)
    lm = elastic_lm(models, dev)
    state0 = {n: p.detach().clone()
              for n, p in models.all[0].named_parameters()}
    n_params = sum(t.numel() for t in state0.values())
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting(wrappers) as counted:
        control, control_s = elastic_leg(
            membership.SimulatedWorld, lm, paths,
            os.path.join(workdir, "control"), state0)
        step_walls = np.diff(lm.applied.get("hvd-sim-rank0", [0.0]))
        lm.applied = {}
        chaos_run, chaos_s = elastic_leg(
            membership.SimulatedWorld, lm, paths,
            os.path.join(workdir, "chaos"), state0, ELASTIC_CHAOS)
    launches, steps = counted.launches, lm.steps
    peak = torch.cuda.max_memory_allocated()
    planted, planted_s = elastic_leg(
        unmigrated_world, lm, paths, os.path.join(workdir, "planted"),
        state0, ELASTIC_CHAOS)
    # The parts of a lockstep step on one thread: the float64 average of
    # four members' gradients (CUDA events), and the walls of a member's
    # `grad_fn`, an apply and the leader's checkpoint save.
    models.reset()
    batch = {"tokens": np.zeros((ELASTIC_BATCH, ELASTIC_SEQ), np.int32)}
    grads, _ = lm.grad_fn(state0, batch)
    avg_ms = cuda_time_ms(lambda: membership.average([grads] * 4), iters=5)
    avg = membership.average([grads] * 4)
    parts = {"grad_fn": wall_ms(lambda: lm.grad_fn(state0, batch)),
             "apply": wall_ms(lambda: lm.apply_fn(state0, avg)),
             "save_step": wall_ms(lambda: checkpoint.save_step(
                 os.path.join(workdir, "parts"), 1, state0, keep=1), n=2)}
    del grads, avg
    cs, ps, pl = control.summary(), chaos_run.summary(), planted.summary()
    union = chaos_run.union_keys() == control.union_keys()
    planted_union = planted.union_keys() == control.union_keys()
    finite = all(bool(torch.isfinite(t).all())
                 for t in chaos_run.final_state.values())
    info = dict(
        params=n_params, layers=ELASTIC_MODEL["layers"],
        records=ELASTIC_RECORDS, seq=ELASTIC_SEQ, batch=ELASTIC_BATCH,
        epochs=ELASTIC_EPOCHS, save_every=ELASTIC_SAVE_EVERY,
        lease_s=ELASTIC_LEASE_S, chaos=ELASTIC_CHAOS, errs=errs,
        control=cs, chaos_leg=ps, planted=pl,
        control_s=control_s, chaos_s=chaos_s, planted_s=planted_s,
        union_match=union, planted_union_match=planted_union,
        planted_records=len(planted.union_keys()),
        control_records=len(control.union_keys()), finite=finite,
        member_steps=steps, launches=launches,
        step_wall_ms_median=float(np.median(step_walls)) * 1e3
        if len(step_walls) else None,
        average_ms=avg_ms, parts_ms=parts, max_memory_allocated=peak,
        resizes=chaos_run.resizes)
    log(f"13a elastic world of {ELASTIC_WORLD} ({n_params / 1e6:.1f} M "
        f"params a member, {ELASTIC_MODEL['layers']} layers at full width, "
        f"B = {ELASTIC_BATCH} x {ELASTIC_SEQ} a member, lease "
        f"{ELASTIC_LEASE_S} s): control {control_s:.1f} s, {cs['steps']} "
        f"steps, resizes {cs['resizes']}; chaos ({ELASTIC_CHAOS}) "
        f"{chaos_s:.1f} s: deaths {ps['deaths']}, joins {ps['joins']}, "
        f"resizes {[(r['generation'], r['world'], r['kind'],
                     r['committed_step']) for r in chaos_run.resizes]}, "
        f"final world {ps['final_world']} at generation "
        f"{ps['final_generation']}, detect_s {ps['detect_s']}, "
        f"time_to_resume_s {ps['time_to_resume_s']}, records reassigned "
        f"{ps['records_reassigned']}; union == control's "
        f"({len(control.union_keys())} records): {union}; every state "
        f"leaf finite: {finite}")
    log(f"13a lockstep step (rank0's apply to apply, control leg) median "
        f"{info['step_wall_ms_median']:.1f} ms; float64 average of 4 "
        f"members' gradients {avg_ms:.3f} ms (CUDA events); peak memory "
        f"{peak / 1e9:.2f} GB; member steps {steps}, launches {launches}")
    log(f"13a parts on one thread (median wall ms): grad_fn "
        f"{parts['grad_fn']:.2f}, apply {parts['apply']:.2f}, save_step "
        f"{parts['save_step']:.1f}; four members in turn "
        f"{4 * (parts['grad_fn'] + avg_ms + parts['apply']):.1f} ms + a "
        f"save every {ELASTIC_SAVE_EVERY} steps")
    log(f"13a planted fault (no migration) {planted_s:.1f} s: "
        f"{json.dumps(info['planted'])}; resizes "
        f"{[(r['generation'], r['world'], r['kind'], r['committed_step'])
            for r in planted.resizes]}; union "
        f"{len(planted.union_keys())} records, == control's: "
        f"{planted_union}")
    if not control.completed or control.resizes or cs["final_generation"]:
        raise AssertionError(f"13a control leg: {cs}")
    if not (chaos_run.completed and ps["deaths"] == 1 and ps["joins"] == 1
            and len(chaos_run.resizes) == 2 and ps["final_world"] == 4
            and ps["final_generation"] == 2):
        raise AssertionError(f"13a chaos leg: {ps}")
    if not union:
        raise AssertionError("13a: the chaos leg's union stream differs "
                             "from the control's")
    if not finite:
        raise AssertionError("13a: a state leaf is not finite")
    # The planted leg must run the whole chaos history to its end, so
    # that the union check is shown to catch a run that finished with
    # the wrong records (not one that stopped early).
    if not (planted.completed and pl["error"] is None
            and pl["deaths"] == 1 and pl["joins"] == 1
            and pl["resizes"] == 2 and pl["final_world"] == 4
            and pl["final_generation"] == 2):
        raise AssertionError(f"13a planted leg did not run to its end: "
                             f"{pl}")
    if planted_union:
        raise AssertionError("13a: the union check does not see the "
                             "trainer's migration turned off")
    for k, n in launches.items():
        if n < ELASTIC_MODEL["layers"] * steps:
            raise AssertionError(f"13a {k} launched {n} < "
                                 f"{ELASTIC_MODEL['layers']} x {steps}")
    info["seconds"] = time.time() - t0
    info["run"] = {"launches": launches}
    del models, lm, state0, control, chaos_run, planted
    torch.cuda.empty_cache()
    return info


def run_drill():
    """13b: ``python -m horovod_tpu_torch.resilience.drill --world 3
    --kill-rank 2`` (worker processes under ``hvdrun-torch --elastic``
    over the launcher's store, one SIGKILLed mid-epoch) in its own
    session, bounded by HVD_ELASTIC_DRILL_TIMEOUT_S; it must print its
    OK line: one death, one resize to world 2 at generation 1, every
    record once per epoch."""
    import signal
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="hvd_phase13b_")
    env = dict(os.environ, HVD_ELASTIC_DRILL_TIMEOUT_S=str(DRILL_TIMEOUT_S))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.resilience.drill",
           "--workdir", os.path.join(workdir, "mc"), "--world", "3",
           "--kill-rank", "2"]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DRILL_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("13b: the drill outlived its budget")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.time() - t0
    lines = out.splitlines()
    summary = next((json.loads(ln) for ln in lines if ln.startswith("{")),
                   None)
    ok_line = next((ln for ln in lines
                    if ln.startswith("resize equivalence OK")), None)
    log(f"13b drill (3 processes, rank 2 SIGKILLed): exit "
        f"{proc.returncode} in {seconds:.1f} s; {ok_line or lines[-3:]}")
    want = ("1 SIGKILL(s), 1 resize(s) to world 2 (generation 1)")
    if proc.returncode != 0 or not ok_line or want not in ok_line \
            or not summary or not summary["union_match"]:
        raise AssertionError(f"13b drill failed: exit {proc.returncode}; "
                             f"{out[-4000:]}")
    return dict(seconds=seconds, detect_s=summary["detect_s"],
                time_to_resume_s=summary["time_to_resume_s"],
                records=summary["records"],
                records_reassigned=summary["records_reassigned"],
                summary=summary)


def run_phase13(tfa, dev):
    """Phase 13 (13a in a temporary directory removed after it,
    whatever the outcome, then 13b)."""
    import shutil
    import tempfile
    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="hvd_phase13_")
    try:
        world = run_elastic_world(tfa, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    drill = run_drill()
    return dict(world=world, drill=drill, seconds=time.time() - t0,
                runs={"elastic": world["run"]})


# ---------------------------------------------------------------------------
# Phase 14: sequence parallelism on the card.
# ---------------------------------------------------------------------------

# 14a: a [2, 4096, 8, 128] causal attention cut into RING14_SP blocks;
# the last block's queries meet every rotation.
RING14 = dict(B=2, S=4096, H=8, D=128, sp=4, window=1536)
RING14_SEED = 14
# 14b: the repo's LM at full width (phase 13's member) with max_len 4096,
# cut to 2 layers; a seeded global [2, 4096] batch over a seq=2 mesh of
# two ranks sharing the card over gloo.
SP14_MODEL = dict(vocab=32768, layers=2, heads=8, head_dim=128,
                  max_len=4096)
SP14_BATCH, SP14_SEQ, SP14_SP = 2, 4096, 2
SP14_SEED = 14
SP14_LR = 3e-4
SP14_STEPS = 5          # the checked first step, then 4 more AdamW steps
SP14_CHUNK = 512
# The f32 twin's step against the single-process f32 step: the same
# arithmetic in another order (the ring's logsumexp merge or the
# all-to-alls' head split, the two ranks' halves summed by the
# allreduce) and the f32 kernels' own summation orders.
SP14_F32_GRAD_TOL = 1e-3
SP14_F32_LOSS_TOL = 1e-5
SP14_TIMEOUT_S = 420.0
SP14_TOL = {"bfloat16": (STEP_LOSS_TOL, STEP_GRAD_TOL),
            "float32": (SP14_F32_LOSS_TOL, SP14_F32_GRAD_TOL)}


def _ring_block(t, j, n):
    return t[:, j * n:(j + 1) * n]


def check_ring_rotations(tfa, dev):
    """14a: the forward (out, lse) and the backward (with a cotangent on
    lse) of every rotation the last of RING14's blocks meets, against
    their plain versions, f32 and bf16, causal and under the window;
    the masked-whole rotation out 0, lse -inf and zero, finite
    gradients; the logsumexp merge of the four kernel partials against
    one forward launch at the full length; and the planted faults (the
    merge without its -inf guard; the last rotation without its window)
    caught."""
    import torch
    from horovod_tpu_torch.parallel import sequence as sq
    c = RING14
    n, last = c["S"] // c["sp"], c["sp"] - 1
    g = torch.Generator(device=dev).manual_seed(RING14_SEED)
    out = {"flash_fwd": {"max_abs_err_f32": 0.0, "max_abs_err": 0.0},
           "flash_bwd_dq": {"max_abs_err_f32": 0.0, "max_abs_err": 0.0},
           "flash_bwd_dkv": {"max_abs_err_f32": 0.0, "max_abs_err": 0.0},
           "merge": {}, "faults": {}, "timing": {}}

    def note(kern, dtype, err):
        key = "max_abs_err_f32" if dtype == "float32" else "max_abs_err"
        out[kern][key] = max(out[kern][key], err)

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        shape = (c["B"], c["S"], c["H"], c["D"])
        q, k, v, go = (torch.randn(shape, device=dev, generator=g).to(dt)
                       for _ in range(4))
        qb, gob = _ring_block(q, last, n), _ring_block(go, last, n)
        for window in (None, c["window"]):
            parts = []
            for d in range(c["sp"]):
                kb = _ring_block(k, last - d, n)
                vb = _ring_block(v, last - d, n)
                kw = dict(causal=True, window=window, q_offset=d * n)
                name = f"rotation {d} window {window}"
                o, lse = tfa.flash_fwd_cuda(qb, kb, vb, **kw)
                ref, rlse = tfa.flash_attention_plain(qb, kb, vb, **kw)
                dlse = torch.randn(lse.shape, device=dev, generator=g)
                got = tfa.flash_backward(qb, kb, vb, o, lse, gob, dlse=dlse,
                                         **kw)
                want = tfa.flash_backward_plain(qb, kb, vb, o, lse, gob,
                                                dlse=dlse, **kw)
                torch.cuda.synchronize()
                err, ok = max_err(o, ref, TOL[dtype])
                lerr, lok = max_err(lse, rlse, (LSE_TOL, 0.0))
                res = [max_err(a, b, GRAD_TOL[dtype])
                       for a, b in zip(got, want)]
                masked = torch.isneginf(rlse)
                log(f"14a {dtype:8s} {name:24s} out {err:.3e} lse "
                    f"{lerr:.3e} dq {res[0][0]:.3e} dk {res[1][0]:.3e} dv "
                    f"{res[2][0]:.3e}; fully masked rows "
                    f"{int(masked.sum())} of {masked.numel()}")
                if not (ok and lok and all(r[1] for r in res)):
                    raise AssertionError(f"14a {dtype} {name}: out {err}, "
                                         f"lse {lerr}, grads {res}")
                if masked.any() and o[masked.transpose(1, 2)].any():
                    raise AssertionError(f"14a {dtype} {name}: a fully "
                                         f"masked row is not zero")
                if window is not None and d == last:
                    whole = (masked.all() and not o.any() and all(
                        bool(torch.isfinite(t).all()) and not t.any()
                        for t in got))
                    if not whole:
                        raise AssertionError(f"14a {dtype} {name}: the "
                                             f"rotation masked whole is not "
                                             f"out 0, lse -inf, gradients 0")
                if window is not None and d == 2 and not (
                        masked.any() and not masked.all()):
                    raise AssertionError(f"14a {name}: expected some fully "
                                         f"masked rows")
                note("flash_fwd", dtype, err)
                note("flash_bwd_dq", dtype, res[0][0])
                note("flash_bwd_dkv", dtype, max(res[1][0], res[2][0]))
                parts.append((o.float(), lse))
                del got, want, ref
            full, flse = tfa.flash_fwd_cuda(q, k, v, causal=True,
                                            window=window)
            full = _ring_block(full, last, n)
            flse = flse[..., last * n:]

            def merged(parts, merge=sq._merge_partials):
                acc = sq._empty_partial(qb)
                for o, lse in parts:
                    acc = merge(*acc, o, lse)
                return acc[0].to(dt), acc[1]
            mo, ml = merged(parts)
            err, ok = max_err(mo, full, TOL[dtype])
            lerr, lok = max_err(ml, flse, (LSE_TOL * 10, 0.0))
            log(f"14a {dtype} window {window}: merge of {c['sp']} partials "
                f"vs one forward at [{c['B']},{c['S']}]: out {err:.3e} "
                f"(tol {TOL[dtype]}), lse {lerr:.3e}")
            if not (ok and lok):
                raise AssertionError(f"14a {dtype} window {window}: the "
                                     f"merge differs ({err}, {lerr})")
            out["merge"][f"{dtype}_window_{window}"] = [err, lerr]
            if window is None:
                continue
            # Planted faults: the merge without its -inf guard, taking the
            # masked-whole rotation first; the last rotation without its
            # window.
            def unguarded(o1, l1, o2, l2):
                m = torch.maximum(l1, l2)
                w1, w2 = torch.exp(l1 - m), torch.exp(l2 - m)
                den = w1 + w2
                return ((o1 * (w1 / den).transpose(1, 2)[..., None]
                         + o2 * (w2 / den).transpose(1, 2)[..., None]),
                        m + torch.log(den))
            fo, _ = merged(parts[::-1], unguarded)
            ferr, fok = max_err(fo, full, TOL[dtype])
            kb, vb = _ring_block(k, 0, n), _ring_block(v, 0, n)
            lo, ll = tfa.flash_fwd_cuda(qb, kb, vb, causal=True,
                                        q_offset=last * n)
            go2, _ = merged(parts[:-1] + [(lo.float(), ll)])
            gerr, gok = max_err(go2, full, TOL[dtype])
            log(f"14a {dtype} planted faults: unguarded merge "
                f"{ferr:.3e} (caught {not fok}), rotation {last} without "
                f"its window {gerr:.3e} (caught {not gok})")
            if fok or gok:
                raise AssertionError("14a: a planted fault was not caught")
            out["faults"][dtype] = dict(unguarded_merge=ferr,
                                        unmasked_rotation=gerr)
            if dtype == "bfloat16":
                for d in (0, last):
                    kb = _ring_block(k, last - d, n)
                    vb = _ring_block(v, last - d, n)
                    out["timing"][f"rotation_{d}_fwd_ms"] = cuda_time_ms(
                        lambda: tfa.flash_fwd_cuda(
                            qb, kb, vb, causal=True, window=window,
                            q_offset=d * n))
                log(f"14a bf16 forward at [{c['B']},{n},{c['H']},"
                    f"{c['D']}] window {window}: live rotation 0 "
                    f"{out['timing']['rotation_0_fwd_ms']:.4f} ms, masked "
                    f"rotation {last} "
                    f"{out['timing'][f'rotation_{last}_fwd_ms']:.4f} ms")
        del q, k, v, go
    return out


def sp14_model(dev, dtype, attn_impl="flash"):
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    c = SP14_MODEL
    return TransformerLM(c["vocab"], c["layers"], c["heads"], c["head_dim"],
                         max_len=c["max_len"], dtype=getattr(torch, dtype),
                         attn_impl=attn_impl, device=dev)


def sp14_tokens():
    import numpy as np
    return np.random.RandomState(SP14_SEED).randint(
        0, SP14_MODEL["vocab"], (SP14_BATCH, SP14_SEQ))


def sp14_reference(dev, dtype, path):
    """The single-process flash step on the global [2, 4096] batch from
    the ranks' weights: its loss and every parameter's gradient, saved
    to ``path`` (float32, on the host)."""
    import torch
    from horovod_tpu_torch.models.transformer import _lm_data_loss
    model = sp14_model(dev, dtype).init_weights(SP14_SEED)
    tokens = torch.from_numpy(sp14_tokens()).to(dev)
    loss = _lm_data_loss(model, tokens, SP14_CHUNK)
    loss.backward()
    torch.save({"loss": float(loss.detach()),
                "grads": {n: p.grad.float().cpu()
                          for n, p in model.named_parameters()}}, path)
    del model
    torch.cuda.empty_cache()


def sp14_rank(rank, work):
    """One rank of 14b (a process of its own, ``chip_smoke.py --sp-rank
    R WORKDIR``): a gloo world of SP14_SP ranks on ``cuda:0``, a seq
    mesh, and per (attention, dtype) run the model from SP14_SEED on its
    block of the global batch through `make_lm_train_step(..., mesh)`;
    the first step's loss and averaged gradients held to the
    single-process step, then (bf16) the further AdamW steps; launch
    counts, host-staged bytes and step walls written to
    ``WORKDIR/rank<R>.json``."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import make_lm_train_step
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.parallel import mesh as pmesh
    from horovod_tpu_torch.parallel import sequence as sq
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    hvd.init(device="cpu", rank=rank, size=SP14_SP,
             init_method=f"file://{work}/store")
    mesh = pmesh.make_mesh(seq=SP14_SP, device_type="cuda")
    idx = pmesh.axis_index("seq", mesh)
    tokens = pmesh.shard_batch(mesh, torch.from_numpy(sp14_tokens()))
    tokens = tokens.to(dev)
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    refs = {d: torch.load(f"{work}/ref_{d}.pt") for d in SP14_TOL}
    runs = []
    live_ring = sq._ring_rotation_live
    for impl, dtype, fault in (("ring_flash", "bfloat16", False),
                               ("ring_flash", "float32", False),
                               ("ulysses_flash", "bfloat16", False),
                               ("ulysses_flash", "float32", False),
                               ("ring_flash", "bfloat16", True),
                               ("ring_flash", "float32", True)):
        model = sp14_model(dev, dtype, impl).init_weights(SP14_SEED)
        opt = torch.optim.AdamW(model.parameters(), lr=SP14_LR)
        step = make_lm_train_step(model, opt, mesh, loss_chunk=SP14_CHUNK)
        steps = SP14_STEPS if dtype == "bfloat16" and not fault else 1
        if fault:     # the wrapped-rank skip removed
            sq._ring_rotation_live = lambda idx, d, causal: True
        try:
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            collectives.reset_staged_bytes()
            losses, walls, check = [], [], None
            for i in range(steps):
                t0 = time.perf_counter()
                loss = float(step(tokens))
                walls.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss)
                if i == 0:
                    ref = refs[dtype]
                    per = {n: float((p.grad.float().cpu() - ref["grads"][n])
                                    .abs().max() / ref["grads"][n].abs()
                                    .max().clamp_min(1e-30))
                           for n, p in model.named_parameters()}
                    check = dict(loss_err=abs(loss - ref["loss"]),
                                 grad_err=max(per.values()),
                                 top=sorted(per.items(),
                                            key=lambda kv: -kv[1])[:3])
                    staged_first = collectives.staged_bytes()
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in wrappers.items()}
        finally:
            sq._ring_rotation_live = live_ring
        live = (idx + 1) if impl == "ring_flash" else 1
        runs.append(dict(impl=impl, dtype=dtype, fault=fault, rank=rank,
                         losses=losses, walls_ms=walls, check=check,
                         launches=launches, steps=steps,
                         need=live * model.num_layers * steps,
                         staged_bytes=collectives.staged_bytes(),
                         staged_bytes_first_step=staged_first,
                         peak=torch.cuda.max_memory_allocated()))
        del model, opt, step
        torch.cuda.empty_cache()
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(runs, f)
    hvd.shutdown()
    return 0


def run_sp_world(tfa, dev, work):
    """14b: the single-process references (bf16, f32), then SP14_SP
    rank processes sharing the card over gloo (`sp14_rank`); every
    checked step within SP14_TOL of its reference, the planted fault
    outside it, the bf16 losses finite and falling, each rank's launch
    counts at least its live rotations x layers x steps."""
    import signal
    import numpy as np
    for dtype in SP14_TOL:
        sp14_reference(dev, dtype, f"{work}/ref_{dtype}.pt")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sp-rank", str(r),
         work], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(SP14_SP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, SP14_TIMEOUT_S - (time.time() - t0)))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError("14b: the ranks outlived their budget")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    seconds = time.time() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"14b rank {r} exit {p.returncode}: "
                                 f"{text[-4000:]}")
    runs = [run for r in range(SP14_SP)
            for run in json.load(open(f"{work}/rank{r}.json"))]
    label = f"[{nvidia_smi_line()}]"
    main_runs = []
    for run in runs:
        ltol, gtol = SP14_TOL[run["dtype"]]
        chk = run["check"]
        ok = chk["loss_err"] <= ltol and chk["grad_err"] <= gtol
        what = (f"14b rank {run['rank']} {run['impl']} {run['dtype']}"
                + (" planted fault (wrapped-rank skip removed)"
                   if run["fault"] else ""))
        log(f"{what}: first step loss {run['losses'][0]:.6f} (|diff| "
            f"{chk['loss_err']:.2e}, tol {ltol}), worst per-parameter "
            f"gradient error {chk['grad_err']:.3e} (tol {gtol}; top "
            f"{chk['top']}); losses {[round(x, 4) for x in run['losses']]}, "
            f"step walls ms {[round(x, 1) for x in run['walls_ms']]}, "
            f"launches {run['launches']} (need >= {run['need']}), staged "
            f"{run['staged_bytes_first_step'] / 1e6:.1f} MB in the first "
            f"step, peak {run['peak'] / 1e9:.2f} GB {label}")
        if run["fault"]:
            if ok:
                raise AssertionError(f"{what}: not caught")
            continue
        if not ok:
            raise AssertionError(f"{what}: the step differs from the "
                                 f"single-process step")
        if min(run["launches"].values()) < run["need"]:
            raise AssertionError(f"{what}: launches {run['launches']} < "
                                 f"{run['need']}")
        losses = run["losses"]
        if not all(np.isfinite(losses)) or (
                len(losses) > 1 and not losses[-1] < losses[0]):
            raise AssertionError(f"{what}: losses not finite and falling: "
                                 f"{losses}")
        main_runs.append({"launches": run["launches"]})
    return dict(runs=runs, seconds=seconds, main_runs=main_runs)


def run_phase14(tfa, dev):
    """Phase 14 (14a, then 14b in a temporary directory removed after
    it, whatever the outcome)."""
    import shutil
    import tempfile
    t0 = time.time()
    rot = check_ring_rotations(tfa, dev)
    work = tempfile.mkdtemp(prefix="hvd_phase14_")
    try:
        world = run_sp_world(tfa, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(rotations=rot, world={k: v for k, v in world.items()
                                      if k != "main_runs"},
                seconds=time.time() - t0,
                runs={f"sp{i}": r for i, r in enumerate(world["main_runs"])})


# ---------------------------------------------------------------------------
# Phase 15: tensor parallelism on the card.
# ---------------------------------------------------------------------------

TP15 = 2                 # model ranks sharing cuda:0 over gloo
# 15a: the repo's LM at full width (phase 14b's member, max_len 2048),
# cut to 2 layers, over a model=2 mesh; a seeded [2, 2048] batch that
# both model ranks read whole.
TP15_MODEL = dict(vocab=32768, layers=2, heads=8, head_dim=128,
                  max_len=2048)
TP15_BATCH, TP15_SEQ = 2, 2048
TP15_SEED = 15
TP15_LR = 3e-4
TP15_STEPS = 5          # the checked first step, then 4 more AdamW steps
TP15_CHUNK = 512
# The f32 twin against the single-process f32 step: the same arithmetic
# with each row-parallel product summed from two halves, the vocab
# softmax from two halves, and the replicated kv gradients summed over
# the ranks; phase 14b's f32 limits.
TP15_TOL = {"bfloat16": (STEP_LOSS_TOL, STEP_GRAD_TOL),
            "float32": (SP14_F32_LOSS_TOL, SP14_F32_GRAD_TOL)}
# 15b: phase 11's models at full width and depth, sharded at the
# engine's door; B lanes of a seeded prompt, teacher forced 8 ticks.
TP15_LANES, TP15_PROMPT, TP15_TICKS = 2, 256, 8
TP15_BURST, TP15_BURST_NEW = 8, 32   # Gemma-2B's greedy burst, 8 slots
TP15_BURST_LENS = (64, 257)          # its prompt lengths, [lo, hi)
TP15_F32_LAYERS = 2                  # the f32 twin's depth
TP15_TIMEOUT_S = 600.0


def tp15_model(dev, dtype, mesh=None):
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    c = TP15_MODEL
    return TransformerLM(c["vocab"], c["layers"], c["heads"], c["head_dim"],
                         max_len=c["max_len"], dtype=getattr(torch, dtype),
                         attn_impl="flash", mesh=mesh, device=dev)


def tp15_tokens():
    import numpy as np
    return np.random.RandomState(TP15_SEED).randint(
        0, TP15_MODEL["vocab"], (TP15_BATCH, TP15_SEQ))


def tp15_reference(dev, dtype, path):
    """The single-process flash step of 15a's model on its batch: the
    loss and every parameter's gradient, saved to ``path``."""
    import torch
    from horovod_tpu_torch.models.transformer import _lm_data_loss
    model = tp15_model(dev, dtype).init_weights(TP15_SEED)
    tokens = torch.from_numpy(tp15_tokens()).to(dev)
    loss = _lm_data_loss(model, tokens, TP15_CHUNK)
    loss.backward()
    torch.save({"loss": float(loss.detach()),
                "grads": {n: p.grad.float().cpu()
                          for n, p in model.named_parameters()}}, path)
    del model
    torch.cuda.empty_cache()


def _no_g(self, x):
    """RowParallelDense.forward without g (planted fault (i)): each
    rank keeps its partial product."""
    from horovod_tpu_torch.parallel.tensor import f32_product
    dt = self.dtype or x.dtype
    y = f32_product(x.to(dt), self._weight(dt)).to(dt)
    if self.bias is not None:
        y = y + self.bias.to(dt)
    return y


def tp15a_rank(rank, work, mesh, dev):
    """15a in one rank: the first step of the tensor-parallel flash step
    against the single-process step (bf16 and f32), the bf16 AdamW
    steps after it, and the two planted faults."""
    import torch
    from horovod_tpu_torch.compat.from_jax import gather_state_dict
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.parallel import tensor as PT
    from horovod_tpu_torch.parallel.mesh import shard_batch
    tokens = shard_batch(mesh, torch.from_numpy(tp15_tokens())).to(dev)
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    refs = {d: torch.load(f"{work}/ref_{d}.pt") for d in TP15_TOL}
    runs = []
    row_forward, axes = PT.RowParallelDense.forward, tt._GRAD_AXES
    for dtype, fault in (("bfloat16", None), ("float32", None),
                         ("bfloat16", "no g"), ("bfloat16", "model avg")):
        model = tp15_model(dev, dtype, mesh).init_weights(TP15_SEED)
        opt = torch.optim.AdamW(model.parameters(), lr=TP15_LR)
        step = tt.make_lm_train_step(model, opt, mesh,
                                     loss_chunk=TP15_CHUNK)
        steps = TP15_STEPS if dtype == "bfloat16" and not fault else 1
        if fault == "no g":
            PT.RowParallelDense.forward = _no_g
        elif fault == "model avg":
            tt._GRAD_AXES = axes + ("model",)
        try:
            losses, walls, check = [], [], None
            with counting(wrappers) as c:
                for i in range(steps):
                    t0 = time.perf_counter()
                    loss = float(step(tokens))
                    walls.append((time.perf_counter() - t0) * 1e3)
                    losses.append(loss)
                    if i == 0:
                        grads = gather_state_dict(
                            model, {n: p.grad for n, p in
                                    model.named_parameters()}, mesh)
                        ref = refs[dtype]
                        per = {n: float((g.float().cpu() - ref["grads"][n])
                                        .abs().max() / ref["grads"][n]
                                        .abs().max().clamp_min(1e-30))
                               for n, g in grads.items()}
                        check = dict(loss_err=abs(loss - ref["loss"]),
                                     grad_err=max(per.values()),
                                     top=sorted(per.items(),
                                                key=lambda kv: -kv[1])[:3])
                        del grads
        finally:
            PT.RowParallelDense.forward = row_forward
            tt._GRAD_AXES = axes
        runs.append(dict(dtype=dtype, fault=fault, rank=rank, losses=losses,
                         walls_ms=walls, check=check, launches=c.launches,
                         steps=steps, need=model.num_layers * steps,
                         peak=torch.cuda.max_memory_allocated()))
        del model, opt, step
        torch.cuda.empty_cache()
    return runs


def tp15_prompt(vocab, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(TP15_SEED)
    prompt = torch.randint(0, vocab, (TP15_LANES, TP15_PROMPT), device=dev,
                           generator=g)
    forced = torch.randint(0, vocab, (TP15_LANES, TP15_TICKS), device=dev,
                           generator=g)
    return prompt, forced


def paged_lane_logits(model, prompt, forced):
    """Teacher-forced logits on the paged primitives with the paged
    kernel ("pallas" mode): each lane's prompt prefilled into its own
    contiguous chain of blocks of 16, then TP15_TICKS batched ticks.
    Returns the logits and the bytes a tick gave the ``model`` axis's
    collectives."""
    import torch
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import collectives
    dev = prompt.device
    B, P = prompt.shape
    spec = tt.paged_cache_spec(model, 16)
    T = spec.blocks_per_seq
    pools = tt.init_paged_pools(model, spec, B * T + 1)
    tables = (1 + torch.arange(B * T, device=dev)).reshape(B, T).int()
    fills = torch.zeros(B, dtype=torch.int32, device=dev)
    outs = [torch.stack([tt.paged_prefill_chunk(
        model, spec, pools, tables, fills, b, prompt[b],
        paged_kernel="pallas", fill=0) for b in range(B)])]
    live = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    collectives.reset_axis_bytes("model")
    for t in range(forced.shape[1]):
        outs.append(tt.paged_decode_logits(
            model, spec, pools, tables, fills, forced[:, t], live, done,
            paged_kernel="pallas", prefix_len=P + t + 1))
    tick_bytes = collectives.axis_bytes("model") / forced.shape[1]
    del pools
    return torch.stack(outs, 1), tick_bytes


def tp15_logits(model, dev):
    """(fixed, paged) teacher-forced logits of ``model`` with the decode
    kernels on (flash decode on the linear cache, paged decode on the
    paged pools), the launches of each, and the model-axis bytes of a
    paged tick."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.ops import paged_attention as tpa
    prompt, forced = tp15_prompt(model.vocab_size, dev)
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    with torch.no_grad():
        with counting(kernels) as cf:
            fixed = teacher_forced_logits(model, prompt, forced, TP15_TICKS)
        with counting(kernels) as cp:
            paged, tick_bytes = paged_lane_logits(model, prompt, forced)
    launches = {k: cf.launches[k] + cp.launches[k] for k in kernels}
    return fixed.cpu(), paged.cpu(), launches, tick_bytes


def tp15_burst(model, dev, **kw):
    """Gemma-2B's greedy burst: TP15_BURST prompts of 64..256 tokens,
    TP15_BURST_NEW new tokens each, through the paged engine (8 slots,
    the paged kernel); on a follower, `follow` until the leader stops.
    Returns the leader's streams, ticks, TPOT p50 and launches."""
    import numpy as np
    from horovod_tpu_torch.ops import paged_attention as tpa
    from horovod_tpu_torch.serving import ServingEngine
    rs = np.random.RandomState(TP15_SEED)
    prompts = [rs.randint(0, model.vocab_size, (int(n),))
               for n in rs.randint(*TP15_BURST_LENS, TP15_BURST)]
    kernels = {"paged_decode": tpa.paged_decode_cuda}
    eng = ServingEngine(model, num_slots=8, max_queue=TP15_BURST,
                        warmup=True, paged=True, paged_kernel="pallas",
                        kv_block_size=16, **kw)
    with counting(kernels) as c:
        if eng.is_follower:
            eng.follow()
            eng.shutdown()
            out = None
        else:
            t0 = time.time()
            hs = [eng.submit(p, TP15_BURST_NEW) for p in prompts]
            streams = [h.result(timeout=600).tokens.tolist() for h in hs]
            seconds = time.time() - t0
            snap = eng.metrics_snapshot()
            eng.shutdown()
            out = dict(streams=streams, ticks=snap["ticks"],
                       tpot_ms_p50=snap["tpot_ms"]["p50"],
                       ttft_ms_p50=snap["ttft_ms"]["p50"], seconds=seconds)
    if out is not None:
        out.update(launches=c.launches)
    return out, eng.model, c.launches


def tp15b_rank(rank, work, mesh, dev):
    """15b in one rank: Gemma-2B and Qwen2-0.5B sharded at the engine's
    door (each rank builds the whole bf16 model from the same seed);
    Gemma's greedy burst through the sharded paged engine; each model's
    teacher-forced logits on both pools; Qwen2 with its fused qkv cut
    contiguously (planted fault (iii)); the f32 twin's burst; and a
    follower that drops one free descriptor (planted fault (iv))."""
    import torch
    from horovod_tpu_torch.models.transformer import shard_model
    from horovod_tpu_torch.parallel import tensor as PT
    out = {}
    for what, _, family, cfg, seed, _ in HF_MODELS:
        full = build_hf(family, cfg, dev, seed, torch.bfloat16)
        t0 = time.time()
        if family == "gemma":
            burst, model, launches = tp15_burst(full, dev, mesh=mesh)
            out["gemma_burst"] = burst
            out["gemma_burst_launches"] = launches
        else:
            model = shard_model(full, mesh)
        fixed, paged, launches, tick_bytes = tp15_logits(model, dev)
        out[family] = dict(fixed=fixed if rank == 0 else None,
                           tick_bytes=tick_bytes,
                           paged=paged if rank == 0 else None,
                           launches=launches, ticks=TP15_TICKS,
                           layers=model.num_layers,
                           local_heads=model.blocks[0].attn.num_heads,
                           local_kv=model.local_kv,
                           vocab_rows=model.embed.shape[0],
                           seconds=time.time() - t0,
                           peak=torch.cuda.max_memory_allocated())
        if family == "qwen2":
            cols = PT.qkv_columns

            def contiguous(r, H, Hkv, D, tp):
                n = (H + 2 * Hkv) * D // tp
                return torch.arange(r * n, (r + 1) * n)
            PT.qkv_columns = contiguous
            try:
                bad = shard_model(full, mesh)
            finally:
                PT.qkv_columns = cols
            # Every rank runs it (its collectives pair up); rank 0 keeps
            # the logits.
            bad_logits = tp15_logits(bad, dev)[0]
            out["qwen2_contiguous_qkv"] = bad_logits if rank == 0 else None
            del bad, bad_logits
        del full, model
        torch.cuda.empty_cache()
    full = build_hf("gemma", dict(GEMMA_2B, num_hidden_layers=TP15_F32_LAYERS),
                    dev, 2, torch.float32)
    burst, _, launches = tp15_burst(full, dev, mesh=mesh)
    out["f32_burst"] = burst
    out["f32_burst_launches"] = launches
    torch.save(out, f"{work}/b_rank{rank}.pt")
    # (iv) last: the follower drops the first free descriptor; the next
    # descriptor's digest check must raise ShardDivergence.
    from horovod_tpu_torch.serving import ServingEngine, ShardDivergence
    eng = ServingEngine(full, num_slots=2, paged=True, kv_block_size=16,
                        mesh=mesh)
    try:
        if eng.is_follower:
            eng.follow(drop="free")
            got = "no error"
        else:
            for n in (64, 96):
                eng.submit(list(range(1, n)), 4).result(timeout=60)
            got = "no error"
    except ShardDivergence as e:
        got = f"ShardDivergence {e}"
    except Exception as e:
        got = f"{type(e).__name__} {str(e)[:300]}"
    with open(f"{work}/divergence{rank}.json", "w") as f:
        json.dump(got, f)
    return None


def tp15_rank(rank, work, part):
    """One rank of phase 15 (``chip_smoke.py --tp-rank R WORKDIR PART``):
    a gloo world of TP15 ranks on ``cuda:0`` and a model=TP15 mesh,
    then 15a or 15b; results land in WORKDIR."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.parallel import mesh as pmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    hvd.init(device="cpu", rank=rank, size=TP15,
             init_method=f"file://{work}/store_{part}")
    mesh = pmesh.make_mesh(model=TP15, device_type="cuda")
    if part == "a":
        runs = tp15a_rank(rank, work, mesh, dev)
        with open(f"{work}/a_rank{rank}.json", "w") as f:
            json.dump(runs, f)
        hvd.shutdown()
        return 0
    tp15b_rank(rank, work, mesh, dev)
    # The divergence leg leaves the world broken: no shutdown handshake.
    sys.stdout.flush()
    os._exit(0)


def tp15_world(work, part):
    """Start the TP15 rank processes of ``part`` in their own sessions
    and wait for them within TP15_TIMEOUT_S; every process is stopped
    when this returns."""
    import signal
    env = dict(os.environ, OMP_NUM_THREADS="2")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         work, part], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(TP15)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, TP15_TIMEOUT_S - (time.time() - t0)))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"15{part}: the ranks outlived their budget")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"15{part} rank {r} exit {p.returncode}: "
                                 f"{text[-4000:]}")
    return time.time() - t0


def run_tp15a(dev, work):
    """15a: the single-process references, the rank processes, then the
    checks: every checked step within TP15_TOL of its reference, each
    planted fault outside it, the bf16 losses finite and falling, each
    rank's forward, dQ and dK/dV launches >= layers x steps."""
    import numpy as np
    for dtype in TP15_TOL:
        tp15_reference(dev, dtype, f"{work}/ref_{dtype}.pt")
    seconds = tp15_world(work, "a")
    runs = [run for r in range(TP15)
            for run in json.load(open(f"{work}/a_rank{r}.json"))]
    label = f"[{nvidia_smi_line()}]"
    main_runs = []
    for run in runs:
        ltol, gtol = TP15_TOL[run["dtype"]]
        chk = run["check"]
        ok = chk["loss_err"] <= ltol and chk["grad_err"] <= gtol
        what = (f"15a rank {run['rank']} {run['dtype']}"
                + (f" planted fault ({run['fault']})" if run["fault"]
                   else ""))
        log(f"{what}: first step loss {run['losses'][0]:.6f} (|diff| "
            f"{chk['loss_err']:.2e}, tol {ltol}), worst per-parameter "
            f"gradient error {chk['grad_err']:.3e} (tol {gtol}; top "
            f"{chk['top']}); losses {[round(x, 4) for x in run['losses']]}, "
            f"step walls ms {[round(x, 1) for x in run['walls_ms']]}, "
            f"launches {run['launches']} (need >= {run['need']}), peak "
            f"{run['peak'] / 1e9:.2f} GB {label}")
        if run["fault"]:
            if ok:
                raise AssertionError(f"{what}: not caught")
            continue
        if not ok:
            raise AssertionError(f"{what}: the step differs from the "
                                 f"single-process step")
        if min(run["launches"].values()) < run["need"]:
            raise AssertionError(f"{what}: launches {run['launches']} < "
                                 f"{run['need']}")
        losses = run["losses"]
        if not all(np.isfinite(losses)) or (
                len(losses) > 1 and not losses[-1] < losses[0]):
            raise AssertionError(f"{what}: losses not finite and falling: "
                                 f"{losses}")
        main_runs.append({"launches": run["launches"]})
    return dict(runs=runs, seconds=seconds, main_runs=main_runs)


def tp15b_references(dev, work):
    """The unsharded side of 15b on the card: each model's teacher-forced
    logits on both pools, Gemma-2B's burst on the unsharded paged
    engine, and the f32 twin's burst."""
    import torch
    refs = {}
    for _, _, family, cfg, seed, _ in HF_MODELS:
        model = build_hf(family, cfg, dev, seed, torch.bfloat16)
        if family == "gemma":
            refs["gemma_burst"] = tp15_burst(model, dev)[0]
        fixed, paged, _, _ = tp15_logits(model, dev)
        refs[family] = dict(fixed=fixed, paged=paged)
        del model
        torch.cuda.empty_cache()
    model = build_hf("gemma", dict(GEMMA_2B,
                                   num_hidden_layers=TP15_F32_LAYERS),
                     dev, 2, torch.float32)
    refs["f32_burst"] = tp15_burst(model, dev)[0]
    del model
    torch.cuda.empty_cache()
    return refs


def stream_agreement(a, b):
    """Share of positions where two lists of streams agree, counted up
    to each stream's first difference (later tokens follow from it)."""
    same = total = 0
    for x, y in zip(a, b):
        n = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                 len(x))
        same, total = same + n, total + len(x)
    return same / total


def run_tp15b(dev, work):
    """15b: the unsharded references, the rank processes, then the
    checks (the module docstring's phase 15b)."""
    import torch
    t0 = time.time()
    refs = tp15b_references(dev, work)
    ref_s = time.time() - t0
    seconds = tp15_world(work, "b")
    ranks = [torch.load(f"{work}/b_rank{r}.pt", weights_only=False)
             for r in range(TP15)]
    label = f"[{nvidia_smi_line()}]"
    res = {"reference_seconds": ref_s, "seconds": seconds}
    main_runs = []
    for what, _, family, *_ in HF_MODELS:
        tol = HF_LOGIT_TOL[family]
        got, ref = ranks[0][family], refs[family]
        for pool in ("fixed", "paged"):
            err = float((got[pool] - ref[pool]).abs().max())
            agree = argmax_agreement(got[pool], ref[pool])
            log(f"15b {what} model=2 {pool} pool teacher-forced logits "
                f"(prefill {TP15_LANES} x {TP15_PROMPT} + {TP15_TICKS} "
                f"ticks) vs unsharded: max_abs_err {err:.4f} (tol {tol}), "
                f"argmax agreement {agree:.3f} at a logit scale of "
                f"{float(ref[pool].abs().max()):.3f}")
            if not bool(torch.isfinite(got[pool]).all()) or err > tol:
                raise AssertionError(f"15b {what} {pool}: {err} > {tol}")
            if agree < MIN_ARGMAX_AGREEMENT:
                raise AssertionError(f"15b {what} {pool} argmax {agree}")
            res[f"{family}_{pool}_err"] = err
            res[f"{family}_{pool}_argmax"] = agree
        for r, rk in enumerate(ranks):
            g = rk[family]
            need = g["ticks"] * g["layers"]
            log(f"15b {what} rank {r}: {g['local_heads']} query heads, "
                f"{g['local_kv']} kv head(s), {g['vocab_rows']} vocab rows, "
                f"launches {g['launches']} (decode kernels need >= {need})"
                f", model-axis collective bytes a paged tick of "
                f"{TP15_LANES} lanes {g['tick_bytes']:.0f}, peak "
                f"{g['peak'] / 1e9:.2f} GB {label}")
            res[f"{family}_tick_bytes"] = g["tick_bytes"]
            if min(g["launches"]["flash_decode"],
                   g["launches"]["paged_decode"]) < need:
                raise AssertionError(f"15b {what} rank {r} launches "
                                     f"{g['launches']} < {need}")
            main_runs.append({"launches": g["launches"]})
        if family == "qwen2":
            bad = float((ranks[0]["qwen2_contiguous_qkv"]
                         - ref["fixed"]).abs().max())
            log(f"15b planted fault (iii) Qwen2-0.5B's fused qkv cut "
                f"contiguously: max_abs_err {bad:.4f}, caught {bad > tol}")
            if not bad > tol:
                raise AssertionError("15b: a contiguous qkv cut passed")
            res["contiguous_qkv_err"] = bad
    for key, exact in (("gemma_burst", False), ("f32_burst", True)):
        got, ref = ranks[0][key], refs[key]
        agree = stream_agreement(got["streams"], ref["streams"])
        for r, rk in enumerate(ranks):
            launches = rk[f"{key}_launches"]
            if launches["paged_decode"] < got["ticks"] * (
                    GEMMA_2B["num_hidden_layers"] if key == "gemma_burst"
                    else TP15_F32_LAYERS):
                raise AssertionError(f"15b {key} rank {r} launches "
                                     f"{launches} < ticks x layers")
            main_runs.append({"launches": launches})
        log(f"15b {key}: {TP15_BURST} req x {TP15_BURST_NEW} new, model=2 "
            f"vs unsharded: stream agreement {agree:.4f}, TPOT p50 "
            f"{got['tpot_ms_p50']} ms (sharded) vs {ref['tpot_ms_p50']} ms "
            f"(unsharded), TTFT p50 {got['ttft_ms_p50']} vs "
            f"{ref['ttft_ms_p50']} ms, {got['ticks']} ticks {label}")
        if exact and got["streams"] != ref["streams"]:
            raise AssertionError(f"15b {key}: f32 streams differ")
        res[key] = dict(agreement=agree, tpot_ms_p50=got["tpot_ms_p50"],
                        unsharded_tpot_ms_p50=ref["tpot_ms_p50"],
                        ttft_ms_p50=got["ttft_ms_p50"],
                        unsharded_ttft_ms_p50=ref["ttft_ms_p50"],
                        ticks=got["ticks"], seconds=got["seconds"],
                        unsharded_seconds=ref["seconds"])
    div = json.load(open(f"{work}/divergence1.json"))
    log(f"15b planted fault (iv) a follower drops one free descriptor: "
        f"{div[:200]}")
    if not div.startswith("ShardDivergence"):
        raise AssertionError(f"15b: a dropped descriptor passed: {div}")
    res["divergence"] = div
    return dict(res, main_runs=main_runs)


def run_phase15(tfa, dev):
    """Phase 15 (15a, then 15b, in a temporary directory removed after
    it, whatever the outcome)."""
    import shutil
    import tempfile
    del tfa
    t0 = time.time()
    work = tempfile.mkdtemp(prefix="hvd_phase15_")
    try:
        a = run_tp15a(dev, work)
        b = run_tp15b(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(a={k: v for k, v in a.items() if k != "main_runs"},
                b={k: v for k, v in b.items() if k != "main_runs"},
                seconds=time.time() - t0,
                runs={f"tp{i}": r for i, r in
                      enumerate(a["main_runs"] + b["main_runs"])})


# -- phase 16: mixture of experts and expert parallelism --------------------

# The flagship at full width and depth with every second block a mixture
# of experts (`examples/transformer_lm.py --moe-every 2`, the JAX
# package's MoE defaults: 8 experts, the top 2 a token, capacity factor
# 1.25), random weights from MOE16_SEED. 8.0 is a drop-free factor (an
# expert's capacity holds every token of a call, as
# tests/test_decode.py's drop-free MoE case uses).
MOE16_MODEL = dict(vocab=32768, layers=12, heads=8, head_dim=128,
                   max_len=2048, moe_every=2, num_experts=8, moe_k=2)
MOE16_SEED = 16
MOE16_FACTOR = 1.25
MOE16_DROPFREE = 8.0
# The rule the bf16 MoE model's teacher-forced logits (prefill + 8
# ticks, kernels vs plain versions) are held to, written before its
# first card run. bf16 roundings move the router's input, and a token
# whose 2nd and 3rd expert scores lie within that noise goes to another
# expert: its own hidden state moves by O(1). So (i) at most
# MOE16_FLIP_MAX of the (token, MoE layer) routing decisions may change
# their top-k SET between the two runs; (ii) on the logits rows whose
# own token keeps its top-k sets in every MoE layer, max |k - p| <=
# MOE16_LOGIT_TOL and the tie-aware argmax agreement >=
# MIN_ARGMAX_AGREEMENT. MOE16_LOGIT_TOL is 2.5x phase 3's LOGIT_TOL: the
# dense model reads 0.0293 there, and a flip upstream of a row (in its
# prompt) reaches it through attention. That bf16 limit is too wide to
# see the decode one key short (0.0929 on the dense model), so the f32
# twin (MOE16_F32_LAYERS deep, the same rule at MOE16_F32_TOL, where
# the two runs differ by summation order only: phase 11's f32 readings
# are 6e-6 to 3.5e-5) must see that fault.
MOE16_FLIP_MAX = 0.01
MOE16_LOGIT_TOL = 0.15
MOE16_F32_TOL = 1e-3
MOE16_F32_LAYERS = 4
# The f32 twin's stream check at the drop-free factor: the fixed engine
# (8 slots), the paged engine (16 slots) and `generate` give the same
# greedy streams for the burst's first MOE16_F32_STREAMS prompts,
# MOE16_F32_NEW tokens each (a difference off a near tie within
# MOE16_F32_TOL of the row's top is the one exception, as phase 8's
# rule).
MOE16_F32_STREAMS, MOE16_F32_NEW = 8, 32
MOE16_BURST_SEED = 16          # the engine burst: 16 x 64..512 tokens
# 16b: the model trained at B = 2 x 2048 (f32 params, bf16 compute,
# flash attention, AdamW, moe_aux_weight 0.01, loss_chunk 512). The
# step through the kernels against the same step on the plain
# versions: loss within STEP_LOSS_TOL, and every parameter outside the
# MoE blocks within STEP_GRAD_TOL (a routing flip moves a token's
# gradient between experts, so the MoE blocks' gradients are printed
# beside the flip share); the f32 twin (MOE16_F32_LAYERS deep) holds
# every parameter, MoE blocks included, to phase 14b's f32 limits, and
# the plain dK/dV one query row short must fail it.
MOE16_BATCH, MOE16_SEQ = 2, 2048
MOE16_LR = 3e-4
MOE16_STEPS = 4
MOE16_CHUNK = 512
# 16c: expert=2 over two rank processes sharing cuda:0 over gloo, the
# model cut to 2 layers (one MoE block, 4 experts a rank) at B = 2 x
# 2048, MOE16_EP_STEPS AdamW steps against the same steps in one
# process: the first step's gradients gathered over the expert axis
# within STEP_GRAD_TOL (phase 15a's rule), every step's loss within
# STEP_LOSS_TOL, and the parameters after the last step within
# MOE16_EP_PARAM_TOL x lr x steps in mean |difference| (AdamW turns
# the bf16 gradients' rounding into sign-level steps where a gradient
# is near 0, so the bound is on the mean). The step with the experts'
# input gradients left unsummed over the axis (a planted fault) must
# fail the gradient rule.
# On the card (H100 80GB HBM3, 700 W) that fault read 0.0437 against
# the gradient rule's 0.05 (a token's experts carry half or less of its
# gradient, and most pairs drop at this router), so a second rule
# joins it: every parameter outside the experts has the same first-step
# gradient on both expert ranks (max |g0 - g1| / max |g0| <=
# MOE16_EP_REPLICA_TOL; both ranks run the same ops on the same inputs,
# and f sums the experts' parts into each), which the fault must fail.
MOE16_EP = 2
MOE16_EP_LAYERS = 2
MOE16_EP_STEPS = 4
MOE16_EP_PARAM_TOL = 0.05
MOE16_EP_REPLICA_TOL = 1e-6
MOE16_EP_TIMEOUT_S = 300.0


def moe16_model(dev, dtype, *, layers=None, factor=MOE16_FACTOR, mesh=None,
                **kw):
    import torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    c = MOE16_MODEL
    return TransformerLM(
        c["vocab"], layers or c["layers"], c["heads"], c["head_dim"],
        max_len=c["max_len"], dtype=getattr(torch, dtype),
        attn_impl="flash", moe_every=c["moe_every"],
        num_experts=c["num_experts"], moe_k=c["moe_k"],
        moe_capacity_factor=factor, mesh=mesh, device=dev, **kw)


def moe16_params(model):
    """(all parameters, expert parameters, active a token: k of the E
    experts of each MoE block plus everything else)."""
    n = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for name, p in model.named_parameters()
                  if name.endswith((".moe.w1", ".moe.w2")))
    c = MOE16_MODEL
    return n, experts, n - experts + experts * c["moe_k"] // c[
        "num_experts"]


def set_capacity_factor(model, factor):
    from horovod_tpu_torch.parallel.expert import moe_layers
    for m in moe_layers(model):
        m.capacity_factor = factor


class routing_record:
    """Context: the top-k expert SET (ids sorted) of every MoE layer call,
    in call order, recorded from `parallel.expert._top_k`."""

    def __enter__(self):
        from horovod_tpu_torch.parallel import expert as tex
        self.tex, self.saved, self.calls = tex, tex._top_k, []

        def rec(probs, k):
            vals, idx = self.saved(probs, k)
            self.calls.append(idx.sort(-1).values)
            return vals, idx
        tex._top_k = rec
        return self

    def __exit__(self, *exc):
        self.tex._top_k = self.saved


def routing_flips(a, b, n_moe, steps):
    """Two recordings of the same teacher-forced calls: (share of (token,
    layer) decisions whose top-k set differs, [lanes, steps] bool: the
    row's own token (the last position of the call) kept its sets in
    every MoE layer)."""
    import torch
    if len(a.calls) != len(b.calls) or len(a.calls) != n_moe * steps:
        raise AssertionError(f"recorded {len(a.calls)} / {len(b.calls)} "
                             f"MoE calls, expected {n_moe * steps}")
    changed = total = 0
    keep = []
    for s in range(steps):
        own = None
        for j in range(n_moe):
            x, y = a.calls[s * n_moe + j], b.calls[s * n_moe + j]
            diff = (x != y).any(-1)                    # [G, T]
            changed += int(diff.sum())
            total += diff.numel()
            last = ~diff[:, -1]
            own = last if own is None else own & last
        keep.append(own)
    return changed / total, torch.stack(keep, 1)


def moe_forced_rule(model, tfa, prompt, forced, tol, what):
    """16a's logits rule (see MOE16_FLIP_MAX): teacher-forced logits
    through the kernels and the plain versions, each run's routing
    recorded, then the plain decode one key short. Returns the
    readings; raises when the rule fails."""
    import torch
    n_moe = sum(model.is_moe_block(i) for i in range(model.num_layers))
    steps = forced.shape[1] + 1
    with torch.no_grad():
        with routing_record() as rk:
            k_logits = teacher_forced_logits(model, prompt, forced, steps - 1)
        with plain_attention(model, tfa), routing_record() as rp:
            p_logits = teacher_forced_logits(model, prompt, forced, steps - 1)
        with plain_attention(model, tfa, decode=one_key_short(tfa)), \
                routing_record() as rf:
            f_logits = teacher_forced_logits(model, prompt, forced, steps - 1)
    torch.cuda.synchronize()
    flips, keep = routing_flips(rk, rp, n_moe, steps)
    fflips, fkeep = routing_flips(rf, rp, n_moe, steps)
    rows = keep.reshape(-1)
    k2, p2 = k_logits.flatten(0, 1), p_logits.flatten(0, 1)
    err = float((k2[rows] - p2[rows]).abs().max()) if rows.any() else 0.0
    agree = argmax_agreement(k2[rows], p2[rows]) if rows.any() else 0.0
    frows = (fkeep & keep).reshape(-1)
    ferr = float((f_logits.flatten(0, 1)[frows] - p2[frows]).abs().max())
    info = dict(logits_max_abs_err=err, logits_tol=tol, flip_share=flips,
                rows_kept=int(rows.sum()), rows=int(rows.numel()),
                argmax_agreement=agree, planted_fault_logits_err=ferr,
                planted_fault_flip_share=fflips,
                all_rows_max_abs_err=float((k2 - p2).abs().max()),
                logit_scale=float(p2.abs().max()))
    log(f"16a {what} teacher-forced logits (prefill + {steps - 1} ticks), "
        f"kernels vs plain: routing flips {flips:.5f} of (token, MoE "
        f"layer) decisions (max {MOE16_FLIP_MAX}); {info['rows_kept']} of "
        f"{info['rows']} rows keep their own token's experts: max_abs_err "
        f"{err:.4g} (tol {tol}), argmax agreement {agree:.3f}; every row "
        f"{info['all_rows_max_abs_err']:.4g} at a logit scale of "
        f"{info['logit_scale']:.3f}; planted fault (decode one key short) "
        f"{ferr:.4g}, flips {fflips:.5f} [{nvidia_smi_line()}]")
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError(f"16a {what}: logits not finite")
    if flips > MOE16_FLIP_MAX:
        raise AssertionError(f"16a {what}: routing flips {flips}")
    if err > tol or agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"16a {what}: logits differ: {err}, argmax "
                             f"agreement {agree}")
    return info, k_logits


def moe_burst(model, prompts, new, kernels, *, paged, split=False):
    """One burst through the fixed (8 slots) or paged (16 slots over
    1025 blocks of 16, the paged kernel) engine, the MoE layers'
    (routed, dropped) pairs counted over it, split into prefill calls
    and ticks when ``split`` (a counting wrapper on the layers)."""
    from horovod_tpu_torch.parallel import expert as tex
    kw = (dict(num_slots=16, paged=True, paged_kernel="pallas",
               kv_block_size=16, kv_blocks=1025) if paged
          else dict(num_slots=8))
    tex.reset_moe_counts(model)
    acc = {"prefill": [], "tick": []}
    saved = tex.MoELayer.forward
    if split:
        def forward(self, x, route_rows=False):
            # A tick is one call over every lane, one token each.
            before = self.counts.clone()
            out = saved(self, x, route_rows)
            tick = x.shape[0] > 1 and x.shape[-2] == 1
            acc["tick" if tick else "prefill"].append(self.counts - before)
            return out
        tex.MoELayer.forward = forward
    try:
        info = serve_burst(model, prompts, new, kernels, **kw)
    finally:
        tex.MoELayer.forward = saved
    routed, dropped = tex.moe_counts(model)
    info.update(routed=routed, dropped=dropped,
                drop_share=dropped / max(routed, 1))
    if split:
        for key, deltas in acc.items():
            r, d = ([int(v) for v in sum(deltas).tolist()] if deltas
                    else (0, 0))
            info[f"{key}_routed"], info[f"{key}_dropped"] = r, d
            info[f"{key}_drop_share"] = d / max(r, 1)
    return info


def moe_stream_verdicts(model, prompts, ref, got, tol):
    """Each stream of ``got`` against ``ref`` under the tie-aware rule
    at ``tol``: (equal, near ties, faults)."""
    equal, ties, faults = 0, [], []
    for i, (p, a, b) in enumerate(zip(prompts, ref, got)):
        v = stream_verdict(model, p, a, b, tol=tol)
        if v is None:
            equal += 1
        elif v["near_tie"]:
            ties.append(dict(stream=i, **v))
        else:
            faults.append(dict(stream=i, **v))
    return equal, ties, faults


def run_moe16_f32(tfa, tpa, dev, prompt, gen, burst):
    """16a's f32 twin (MOE16_F32_LAYERS deep): the logits rule at
    MOE16_F32_TOL with the decode one key short refused, then at the
    drop-free factor the fixed engine, the paged engine and `generate`
    on the burst's first prompts, which must agree (the tie-aware rule
    at MOE16_F32_TOL)."""
    import torch
    from horovod_tpu_torch.models.transformer import generate_bucketed
    t0 = time.time()
    model = moe16_model(dev, "float32", layers=MOE16_F32_LAYERS,
                        decode_prefix_impl="pallas").init_weights(MOE16_SEED)
    model.eval()
    info, _ = moe_forced_rule(model, tfa, prompt, gen[:, :8], MOE16_F32_TOL,
                              f"f32 twin ({MOE16_F32_LAYERS} layers)")
    if info["planted_fault_logits_err"] <= MOE16_F32_TOL:
        raise AssertionError(f"16a f32: the logits rule does not see the "
                             f"decode one key short "
                             f"({info['planted_fault_logits_err']})")
    set_capacity_factor(model, MOE16_DROPFREE)
    prompts = burst[:MOE16_F32_STREAMS]
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    fixed = moe_burst(model, prompts, MOE16_F32_NEW, kernels, paged=False)
    paged = moe_burst(model, prompts, MOE16_F32_NEW, kernels, paged=True)
    with torch.no_grad():
        gen_streams = [g[len(p):].tolist() for p, g in zip(
            prompts, generate_bucketed(model, [torch.as_tensor(p)
                                               for p in prompts],
                                       MOE16_F32_NEW))]
    verdicts = {}
    for name, ref, got in (("paged vs fixed", fixed["streams"],
                            paged["streams"]),
                           ("generate vs fixed", fixed["streams"],
                            gen_streams)):
        equal, ties, faults = moe_stream_verdicts(model, prompts, ref, got,
                                                  MOE16_F32_TOL)
        verdicts[name] = dict(equal=equal, ties=ties, faults=faults)
        log(f"16a f32 twin streams at factor {MOE16_DROPFREE}, {name}: "
            f"{equal} of {len(prompts)} equal, near ties {ties}, faults "
            f"{faults} [{nvidia_smi_line()}]")
        if faults:
            raise AssertionError(f"16a f32 {name}: streams differ off a "
                                 f"near tie: {faults}")
    for run in (fixed, paged):
        if run["dropped"]:
            raise AssertionError(f"16a f32: {run['dropped']} pairs dropped "
                                 f"at the drop-free factor")
    del model
    torch.cuda.empty_cache()
    return dict(forced=info, streams=verdicts, seconds=time.time() - t0,
                runs={"fixed": fixed, "paged": paged})


def run_moe16a(tfa, tpa, dev):
    """16a: the MoE model served in bf16 at full width (see the phase
    docstring)."""
    import torch
    from horovod_tpu_torch.models.transformer import generate, serving_params
    t0 = time.time()
    model = moe16_model(dev, "bfloat16", decode_prefix_block=256,
                        decode_prefix_impl="pallas").init_weights(MOE16_SEED)
    serving_params(model)
    model.eval()
    n, experts, active = moe16_params(model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    label = f"[{nvidia_smi_line()}]"
    log(f"16a MoE model: {n / 1e6:.1f} M params ({experts / 1e6:.1f} M in "
        f"experts, {active / 1e6:.1f} M active a token), {nbytes / 1e9:.3f}"
        f" GB bf16, built in {time.time() - t0:.1f} s {label}")
    prompt = hf_prompt(model, dev, seed=MOE16_SEED)
    kernels = {"flash_fwd": tfa.flash_fwd_cuda,
               "flash_decode": tfa.flash_decode_cuda,
               "paged_decode": tpa.paged_decode_cuda}
    runs = {}
    with counting(kernels) as c:
        t1 = time.time()
        out = generate(model, prompt, 128)
        torch.cuda.synchronize()
        gen_s = time.time() - t1
    want = {"flash_fwd": model.num_layers,
            "flash_decode": 127 * model.num_layers, "paged_decode": 0}
    log(f"16a generate 4x512 -> 128 greedy at factor {MOE16_FACTOR}: "
        f"{gen_s:.3f} s wall, launches {c.launches} {label}")
    if out.shape != (4, 640) or not bool(((out >= 0)
                                         & (out < model.vocab_size)).all()):
        raise AssertionError("16a generate output invalid")
    if c.launches != want:
        raise AssertionError(f"16a generate launches {c.launches} != {want}")
    runs["generate"] = dict(seconds=gen_s, launches=c.launches)
    gen = out[:, 512:]
    forced, k_logits = moe_forced_rule(model, tfa, prompt, gen[:, :8],
                                       MOE16_LOGIT_TOL, "bf16")
    if not torch.equal(k_logits.argmax(-1)[:, :-1], gen[:, :8]):
        raise AssertionError("16a generate's greedy tokens are not the "
                             "argmax of its own teacher-forced logits")
    burst = hf_prompts(model.vocab_size, MOE16_BURST_SEED)
    bursts = {}
    for factor in (MOE16_DROPFREE, MOE16_FACTOR):
        set_capacity_factor(model, factor)
        for paged in (False, True):
            name = f"{'paged' if paged else 'fixed'}@{factor}"
            info = moe_burst(model, burst, 64, kernels, paged=paged,
                             split=factor == MOE16_FACTOR)
            kern = "paged_decode" if paged else "flash_decode"
            if info["launches"][kern] < info["ticks"] * model.num_layers:
                raise AssertionError(f"16a {name}: {kern} launches "
                                     f"{info['launches'][kern]} < ticks x "
                                     f"layers")
            bursts[name] = info
            runs[name] = info
            log(f"16a {name} engine, 16 req x 64 new: {info['seconds']:.2f}"
                f" s, {info['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                f"{info['ttft_ms_p50']} ms, TPOT p50 {info['tpot_ms_p50']} "
                f"ms, {info['ticks']} ticks, dropped {info['dropped']} of "
                f"{info['routed']} (token, choice) pairs"
                + (f" (prefill {info['prefill_drop_share']:.4f} of "
                   f"{info['prefill_routed']}, ticks "
                   f"{info['tick_drop_share']:.4f} of "
                   f"{info['tick_routed']})" if "tick_routed" in info
                   else "")
                + f", launches {info['launches']} {label}")
        if factor == MOE16_DROPFREE and any(
                bursts[f"{p}@{factor}"]["dropped"] for p in ("fixed",
                                                             "paged")):
            raise AssertionError("16a: tokens dropped at the drop-free "
                                 "factor")
    agreement = stream_agreement(bursts[f"fixed@{MOE16_DROPFREE}"]["streams"],
                                 bursts[f"paged@{MOE16_DROPFREE}"]["streams"])
    log(f"16a bf16 streams at factor {MOE16_DROPFREE}, paged vs fixed: "
        f"agreement {agreement:.4f} of positions up to each first "
        f"difference (bf16 near ties and routing flips; the f32 twin holds "
        f"them equal) {label}")
    if bursts[f"fixed@{MOE16_FACTOR}"]["tick_dropped"] or bursts[
            f"paged@{MOE16_FACTOR}"]["tick_dropped"]:
        raise AssertionError("16a: a one-lane tick dropped a token")
    cfg = dict(num_attention_heads=model.num_heads,
               num_key_value_heads=model.num_kv, head_dim=model.head_dim,
               max_position_embeddings=model.max_len,
               vocab_size=model.vocab_size)
    timing = time_coverage(tfa, tpa, dev, cfg, MOE16_BURST_SEED)
    del model
    torch.cuda.empty_cache()
    f32 = run_moe16_f32(tfa, tpa, dev, prompt, gen, burst)
    return dict(params=n, expert_params=experts, active_params=active,
                bf16_bytes=nbytes, generate=runs["generate"],
                forced=forced, bursts={k: {kk: vv for kk, vv in v.items()
                                           if kk != "streams"}
                                       for k, v in bursts.items()},
                stream_agreement=agreement, timing=timing, f32=f32,
                runs=runs, seconds=time.time() - t0)


def moe16_tokens(batch=MOE16_BATCH):
    import numpy as np
    return np.random.RandomState(MOE16_SEED).randint(
        0, MOE16_MODEL["vocab"], (batch, MOE16_SEQ))


def moe_step_errors(model, tfa, tokens):
    """One step's loss (with the aux term) and every parameter's gradient
    through the kernels against the plain versions, and against the
    plain dK/dV one query row short: per-parameter max |k - p| / max
    |p|, and the routing flip share of each run against the plain one."""
    import torch
    from horovod_tpu_torch.models.transformer import _lm_data_loss
    named = list(model.named_parameters())
    n_moe = sum(model.is_moe_block(i) for i in range(model.num_layers))

    def backward():
        model.zero_grad(set_to_none=True)
        with routing_record() as rec:
            loss = _lm_data_loss(model, tokens, MOE16_CHUNK, 0.01)
        loss.backward()
        return float(loss.detach()), rec

    with plain_training_attention(tfa):
        p_loss, p_rec = backward()
    p_grads = [p.grad for _, p in named]

    def errors():
        return {n: float((p.grad - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for (n, p), g in zip(named, p_grads)}

    k_loss, k_rec = backward()
    per = errors()
    with plain_training_attention(tfa, planted_short_backward(tfa)):
        f_loss, _ = backward()
    fper = errors()
    model.zero_grad(set_to_none=True)
    flips, _ = routing_flips(k_rec, p_rec, n_moe, 1)
    return dict(loss=k_loss, plain_loss=p_loss, fault_loss=f_loss,
                per=per, fault_per=fper, flip_share=flips)


def check_moe_step(model, tfa, tokens, what, loss_tol, grad_tol, *,
                   hold_moe):
    r = moe_step_errors(model, tfa, tokens)

    def worst(per, moe):
        vals = {n: e for n, e in per.items() if (".moe." in n) == moe}
        return max(vals.values()) if vals else 0.0
    dense, moe = worst(r["per"], False), worst(r["per"], True)
    held = max(dense, moe) if hold_moe else dense
    fault = max(r["fault_per"].values())
    log(f"16b {what} step, kernels vs plain: loss {r['loss']:.6f} vs "
        f"{r['plain_loss']:.6f} (|diff| {abs(r['loss'] - r['plain_loss']):.2e}"
        f", tol {loss_tol}), worst gradient error outside the MoE blocks "
        f"{dense:.3e}, in them {moe:.3e} (tol {grad_tol}"
        f"{'' if hold_moe else ' outside them'}), routing flips "
        f"{r['flip_share']:.5f}; planted fault (dK/dV one query row short) "
        f"{fault:.3e} [{nvidia_smi_line()}]")
    if abs(r["loss"] - r["plain_loss"]) > loss_tol or held > grad_tol:
        raise AssertionError(f"16b {what}: the step through the kernels "
                             f"differs: {r['loss']} vs {r['plain_loss']}, "
                             f"{dense} / {moe}")
    if r["flip_share"] > MOE16_FLIP_MAX:
        raise AssertionError(f"16b {what}: routing flips {r['flip_share']}")
    if fault <= grad_tol:
        raise AssertionError(f"16b {what}: the check does not see the dK/dV "
                             f"one query row short ({fault})")
    return dict(loss=r["loss"], plain_loss=r["plain_loss"], grad_err=dense,
                moe_grad_err=moe, flip_share=r["flip_share"],
                planted_fault_grad_err=fault)


def run_moe16b(tfa, dev):
    """16b: the MoE model trained at B = 2 x 2048 (see MOE16_BATCH)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models.transformer import make_lm_train_step
    from horovod_tpu_torch.parallel import expert as tex
    t0 = time.time()
    model = moe16_model(dev, "bfloat16").init_weights(MOE16_SEED)
    opt = torch.optim.AdamW(model.parameters(), lr=MOE16_LR,
                            weight_decay=1e-4)
    step = make_lm_train_step(model, opt, loss_chunk=MOE16_CHUNK)
    tokens = torch.from_numpy(moe16_tokens()).to(dev)
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tex.reset_moe_counts(model)
    losses, walls = [], []
    with counting(wrappers) as c:
        for _ in range(MOE16_STEPS):
            t1 = time.perf_counter()
            loss = float(step(tokens))
            walls.append(time.perf_counter() - t1)
            losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    routed, dropped = tex.moe_counts(model)
    with torch.no_grad():
        _, aux = model(tokens, return_aux=True)
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    n, experts, active = moe16_params(model)
    c_ = MOE16_MODEL
    d = c_["heads"] * c_["head_dim"]
    flops_tok = 6 * active + 6 * c_["layers"] * MOE16_SEQ * d
    ntok = MOE16_BATCH * MOE16_SEQ
    mfu = flops_tok * ntok / steady / PEAK_BF16_FLOPS
    label = f"[{nvidia_smi_line()}]"
    log(f"16b MoE training B={MOE16_BATCH} x {MOE16_SEQ}, {MOE16_STEPS} AdamW"
        f" steps: losses {[round(x, 4) for x in losses]}, step s "
        f"{[round(t, 4) for t in walls]}, median after the first "
        f"{steady * 1e3:.1f} ms = {ntok / steady:.0f} tokens/s, MFU "
        f"{mfu:.4f} of 989 TFLOP/s ({active / 1e6:.1f} M active params a "
        f"token), peak memory {peak / 1e9:.2f} GB, aux {float(aux):.4f}, "
        f"dropped {dropped} of {routed} (token, choice) pairs "
        f"({dropped / max(routed, 1):.4f}), launches {c.launches} {label}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"16b losses not finite and falling: {losses}")
    need = model.num_layers * MOE16_STEPS
    if min(c.launches.values()) < need:
        raise AssertionError(f"16b launches {c.launches} < {need}")
    check = check_moe_step(model, tfa, tokens, "bf16", STEP_LOSS_TOL,
                           STEP_GRAD_TOL, hold_moe=False)
    del model, opt, step
    torch.cuda.empty_cache()
    twin = moe16_model(dev, "float32", layers=MOE16_F32_LAYERS).init_weights(
        MOE16_SEED)
    f32 = check_moe_step(twin, tfa, tokens, f"f32 twin ({MOE16_F32_LAYERS} "
                         f"layers)", SP14_F32_LOSS_TOL, SP14_F32_GRAD_TOL,
                         hold_moe=True)
    del twin
    torch.cuda.empty_cache()
    return dict(losses=losses, step_s=walls,
                step_ms_median_after_first=steady * 1e3,
                tokens_per_s=ntok / steady, mfu=mfu, active_params=active,
                max_memory_allocated=peak, aux=float(aux), routed=routed,
                dropped=dropped, drop_share=dropped / max(routed, 1),
                launches=c.launches, check=check, f32_check=f32,
                seconds=time.time() - t0)


def moe16c_reference(dev, path):
    """16c's one-process side: the same steps of the same 2-layer model,
    the first step's gradients, every loss and the last parameters
    saved to ``path``."""
    import torch
    from horovod_tpu_torch.models.transformer import make_lm_train_step
    model = moe16_model(dev, "bfloat16", layers=MOE16_EP_LAYERS).init_weights(
        MOE16_SEED)
    opt = torch.optim.AdamW(model.parameters(), lr=MOE16_LR)
    step = make_lm_train_step(model, opt, loss_chunk=MOE16_CHUNK)
    tokens = torch.from_numpy(moe16_tokens()).to(dev)
    losses, grads = [], None
    for i in range(MOE16_EP_STEPS):
        losses.append(float(step(tokens)))
        if i == 0:
            grads = {n: p.grad.float().cpu()
                     for n, p in model.named_parameters()}
    torch.save({"losses": losses, "grads": grads,
                "params": {n: p.detach().float().cpu()
                           for n, p in model.named_parameters()}}, path)
    del model, opt, step
    torch.cuda.empty_cache()


def moe16c_rank(rank, work):
    """One rank of 16c (``chip_smoke.py --ep-rank R WORKDIR``): a gloo
    world of MOE16_EP ranks on cuda:0, an expert=MOE16_EP mesh, then
    `moe16c_steps`; results land in WORKDIR."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.parallel import mesh as pmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    hvd.init(device="cpu", rank=rank, size=MOE16_EP,
             init_method=f"file://{work}/store")
    mesh = pmesh.make_mesh(expert=MOE16_EP, device_type="cuda")
    runs = moe16c_steps(rank, work, mesh, dev)
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(runs, f)
    hvd.shutdown()
    return 0


def moe16c_steps(rank, work, mesh, dev):
    """16c in one rank: the 2-layer model built over ``mesh`` (its
    experts cut over the ranks), the AdamW steps against the
    one-process reference, then the planted fault."""
    import torch
    from horovod_tpu_torch.compat.from_jax import gather_state_dict
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.parallel.mesh import axis_group
    group = axis_group("expert", mesh)
    tokens = torch.from_numpy(moe16_tokens()).to(dev)
    wrappers = {"flash_fwd": tfa.flash_fwd_cuda,
                "flash_bwd_dq": tfa.flash_bwd_dq_cuda,
                "flash_bwd_dkv": tfa.flash_bwd_dkv_cuda}
    ref = torch.load(f"{work}/ref.pt")
    runs = []
    saved_f = collectives.copy_to_model
    for fault in (None, "unsummed"):
        model = moe16_model(dev, "bfloat16", layers=MOE16_EP_LAYERS,
                            mesh=mesh).init_weights(MOE16_SEED)
        opt = torch.optim.AdamW(model.parameters(), lr=MOE16_LR)
        step = tt.make_lm_train_step(model, opt, mesh, loss_chunk=MOE16_CHUNK)
        if fault:
            collectives.copy_to_model = lambda x, *a, **k: x
        steps = MOE16_EP_STEPS if not fault else 1
        try:
            losses, walls, nbytes, check = [], [], [], None
            with counting(wrappers) as c:
                for i in range(steps):
                    collectives.reset_axis_bytes("expert")
                    t0 = time.perf_counter()
                    losses.append(float(step(tokens)))
                    walls.append((time.perf_counter() - t0) * 1e3)
                    nbytes.append(collectives.axis_bytes("expert"))
                    if i == 0:
                        grads = gather_state_dict(
                            model, {n: p.grad for n, p in
                                    model.named_parameters()}, mesh)
                        per = {n: float((g.float().cpu() - ref["grads"][n])
                                        .abs().max() / ref["grads"][n]
                                        .abs().max().clamp_min(1e-30))
                               for n, g in grads.items()}
                        check = dict(grad_err=max(per.values()),
                                     top=sorted(per.items(),
                                                key=lambda kv: -kv[1])[:3])
                        del grads
                        # The replicated parameters' gradients on every
                        # expert rank.
                        check["replica_err"] = max(
                            float((parts[0] - parts[-1]).abs().max()
                                  / parts[0].abs().max().clamp_min(1e-30))
                            for parts in (collectives._gather(
                                p.grad.detach(), group)
                                for n, p in model.named_parameters()
                                if not n.endswith((".moe.w1", ".moe.w2"))))
        finally:
            collectives.copy_to_model = saved_f
        final = gather_state_dict(model, model.state_dict(), mesh)
        diff = [(final[n].float().cpu() - p).abs()
                for n, p in ref["params"].items()]
        runs.append(dict(rank=rank, fault=fault, losses=losses,
                         walls_ms=walls, expert_bytes=nbytes, check=check,
                         launches=c.launches, steps=steps,
                         local_experts=int(model.blocks[1].moe.w1.shape[0]),
                         # (the planted run stops after one step)
                         param_mean_abs_diff=None if fault else float(
                             sum(d.sum() for d in diff)
                             / sum(d.numel() for d in diff)),
                         param_max_abs_diff=None if fault else float(
                             max(d.max() for d in diff))))
        del model, opt, step
        torch.cuda.empty_cache()
    return runs


def moe16c_world(work):
    """Start the MOE16_EP rank processes in their own sessions and wait
    for them within MOE16_EP_TIMEOUT_S; every process is stopped when
    this returns."""
    import signal
    env = dict(os.environ, OMP_NUM_THREADS="2")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ep-rank", str(r),
         work], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(MOE16_EP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, MOE16_EP_TIMEOUT_S - (time.time() - t0)))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError("16c: the ranks outlived their budget")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"16c rank {r} exit {p.returncode}: "
                                 f"{text[-4000:]}")
    return time.time() - t0


def run_moe16c(dev):
    """16c: expert parallelism on the card (see MOE16_EP)."""
    import shutil
    import tempfile
    import numpy as np
    t0 = time.time()
    work = tempfile.mkdtemp(prefix="hvd_phase16_")
    try:
        moe16c_reference(dev, f"{work}/ref.pt")
        import torch
        ref_losses = torch.load(f"{work}/ref.pt")["losses"]
        seconds = moe16c_world(work)
        runs = [run for r in range(MOE16_EP)
                for run in json.load(open(f"{work}/rank{r}.json"))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    label = f"[{nvidia_smi_line()}]"
    bound = MOE16_EP_PARAM_TOL * MOE16_LR * MOE16_EP_STEPS
    main_runs = []
    for run in runs:
        chk = run["check"]
        loss_err = max(abs(a - b) for a, b in zip(run["losses"], ref_losses))
        what = (f"16c rank {run['rank']}"
                + (f" planted fault ({run['fault']})" if run["fault"] else ""))
        walls = run["walls_ms"][1:] or run["walls_ms"]
        median = sorted(walls)[len(walls) // 2]
        log(f"{what}: {run['local_experts']} experts a rank, losses "
            f"{[round(x, 4) for x in run['losses']]} vs one process "
            f"{[round(x, 4) for x in ref_losses[:run['steps']]]} (max "
            f"|diff| {loss_err:.2e}, tol {STEP_LOSS_TOL}), first-step "
            f"gradient error {chk['grad_err']:.3e} (tol {STEP_GRAD_TOL}; "
            f"top {chk['top']}), replicated gradients across the expert "
            f"ranks {chk['replica_err']:.3e} (tol {MOE16_EP_REPLICA_TOL}), "
            f"parameters after {run['steps']} steps: mean |diff| "
            f"{run['param_mean_abs_diff']} (tol {bound:.3e}), max "
            f"{run['param_max_abs_diff']}; step walls ms "
            f"{[round(x, 1) for x in run['walls_ms']]} (median {median:.1f})"
            f", expert-axis bytes a step {run['expert_bytes']}, launches "
            f"{run['launches']} {label}")
        ok = (chk["grad_err"] <= STEP_GRAD_TOL and loss_err <= STEP_LOSS_TOL
              and chk["replica_err"] <= MOE16_EP_REPLICA_TOL)
        if run["fault"]:
            if ok:
                raise AssertionError(f"{what}: not caught")
            continue
        if not ok or run["param_mean_abs_diff"] > bound:
            raise AssertionError(f"{what}: the expert-parallel steps differ "
                                 f"from the one-process steps")
        if not np.isfinite(run["losses"]).all():
            raise AssertionError(f"{what}: losses not finite")
        need = MOE16_EP_LAYERS * run["steps"]
        if min(run["launches"].values()) < need:
            raise AssertionError(f"{what}: launches {run['launches']} < "
                                 f"{need}")
        run["step_ms_median"] = median
        main_runs.append({"launches": run["launches"]})
    return dict(runs=runs, seconds=time.time() - t0, world_seconds=seconds,
                main_runs=main_runs)


def run_phase16(tfa, tpa, dev):
    """Phase 16 (16a, 16b, 16c)."""
    t0 = time.time()
    a = run_moe16a(tfa, tpa, dev)
    b = run_moe16b(tfa, dev)
    c = run_moe16c(dev)
    runs = dict(a.pop("runs"))
    runs["train"] = {"launches": b["launches"]}
    runs.update({f"ep{i}": r for i, r in enumerate(c.pop("main_runs"))})
    return dict(a=a, b=b, c=c, runs=runs, seconds=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every number to this JSON file")
    ap.add_argument("--sp-rank", nargs=2, metavar=("RANK", "WORKDIR"),
                    help=argparse.SUPPRESS)   # phase 14b's rank processes
    ap.add_argument("--tp-rank", nargs=3, metavar=("RANK", "WORKDIR",
                                                   "PART"),
                    help=argparse.SUPPRESS)   # phase 15's rank processes
    ap.add_argument("--ep-rank", nargs=2, metavar=("RANK", "WORKDIR"),
                    help=argparse.SUPPRESS)   # phase 16c's rank processes
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 2
    if args.sp_rank:
        return sp14_rank(int(args.sp_rank[0]), args.sp_rank[1])
    if args.tp_rank:
        return tp15_rank(int(args.tp_rank[0]), args.tp_rank[1],
                         args.tp_rank[2])
    if args.ep_rank:
        return moe16c_rank(int(args.ep_rank[0]), args.ep_rank[1])
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

    t0 = time.time()
    spec = run_speculative(model, tfa, eng, peng)
    log(f"speculative decoding (phase 8) in {time.time() - t0:.1f} s "
        f"{label}")
    variants = run_variants(model, tfa, tpa, dev, gen, eng, peng)
    log(f"int8 weights, int8 KV and the rolling window (phase 9) in "
        f"{variants['seconds']:.1f} s {label}")
    fleet = run_fleet(model, tfa, tpa, dev, peng)
    log(f"threefry sampling and the serving fleet (phase 10) in "
        f"{fleet['seconds']:.1f} s {label}")
    trace_tick = trace_paged_tick(model, tpa, dev)

    del model
    train = run_training(tfa, dev)
    log(f"training: {train['step_ms_median_after_first']:.1f} ms per step, "
        f"{train['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{train['max_memory_allocated'] / 1e9:.2f} GB {label}")

    t0 = time.time()
    surface = run_dp_surface(tfa, dev, train["step_ms_median_after_first"])
    psgd = surface["powersgd"]
    log(f"data-parallel surface (phase 7) in {time.time() - t0:.1f} s: "
        f"word2vec {surface['word2vec']['step_ms_median_after_first']:.2f} "
        f"ms a step; LM under PowerSGD "
        f"{psgd['step_ms_median_after_first']:.1f} ms a step vs "
        f"{psgd['uncompressed_step_ms']:.1f} ms uncompressed, wire ratio "
        f"{psgd['wire_ratio']:.5f} {label}")

    hf = run_hf(tfa, tpa, dev)
    log(f"HF families, coverage and traces (phase 11) in "
        f"{hf['seconds']:.1f} s {label}")
    p12 = run_phase12(tfa, dev)
    gt, rs = p12["gemma"], p12["resume"]
    log(f"Gemma-2B training, resumably (phase 12) in {p12['seconds']:.1f} "
        f"s: {gt['step_ms_median_after_first']:.1f} ms per step at B = "
        f"{gt['batch']} x {gt['seq']}, {gt['tokens_per_s']:.0f} tokens/s, "
        f"peak memory {gt['max_memory_allocated'] / 1e9:.2f} GB; resume: "
        f"emergency save {rs['emergency_save_s']:.2f} s, resume() "
        f"{rs['resume_s']:.2f} s, gap {rs['gap']} {label}")
    p13 = run_phase13(tfa, dev)
    ew, dr = p13["world"], p13["drill"]
    log(f"elastic membership (phase 13) in {p13['seconds']:.1f} s: 13a "
        f"world of {ELASTIC_WORLD}, lease {ew['lease_s']} s, detect_s "
        f"{ew['chaos_leg']['detect_s']}, time_to_resume_s "
        f"{ew['chaos_leg']['time_to_resume_s']}, records reassigned "
        f"{ew['chaos_leg']['records_reassigned']}, lockstep step "
        f"{ew['step_wall_ms_median']:.1f} ms, float64 average "
        f"{ew['average_ms']:.3f} ms, peak memory "
        f"{ew['max_memory_allocated'] / 1e9:.2f} GB; 13b drill "
        f"{dr['seconds']:.1f} s, detect_s {dr['detect_s']}, "
        f"time_to_resume_s {dr['time_to_resume_s']} {label}")

    p14 = run_phase14(tfa, dev)
    rot = p14["rotations"]
    walls = {(r["impl"], r["rank"]): r for r in p14["world"]["runs"]
             if r["dtype"] == "bfloat16" and not r["fault"]}
    log(f"sequence parallelism (phase 14) in {p14['seconds']:.1f} s: 14a "
        f"merges {rot['merge']}, forward of a live / masked rotation "
        f"{rot['timing']}; 14b two ranks over gloo on one card in "
        f"{p14['world']['seconds']:.1f} s, bf16 step walls (median of "
        f"steps 2-{SP14_STEPS}) "
        + ", ".join(f"{impl} rank {r}: "
                    f"{sorted(w['walls_ms'][1:])[len(w['walls_ms'][1:]) // 2]:.1f}"
                    f" ms, staged {w['staged_bytes_first_step'] / 1e6:.1f} "
                    f"MB a step" for (impl, r), w in sorted(walls.items()))
        + f" {label}")

    p15 = run_phase15(tfa, dev)
    b15 = p15["b"]
    log(f"tensor parallelism (phase 15) in {p15['seconds']:.1f} s: 15a two "
        f"ranks over gloo on one card in {p15['a']['seconds']:.1f} s; 15b "
        f"references {b15['reference_seconds']:.1f} s, ranks "
        f"{b15['seconds']:.1f} s; Gemma-2B burst TPOT p50 "
        f"{b15['gemma_burst']['tpot_ms_p50']} ms at model=2 vs "
        f"{b15['gemma_burst']['unsharded_tpot_ms_p50']} ms unsharded "
        f"{label}")

    p16 = run_phase16(tfa, tpa, dev)
    a16, b16, c16 = p16["a"], p16["b"], p16["c"]
    ep_ms = [r["step_ms_median"] for r in c16["runs"] if not r["fault"]]
    ep_bytes = [r["expert_bytes"][-1] for r in c16["runs"] if not r["fault"]]
    log(f"mixture of experts (phase 16) in {p16['seconds']:.1f} s: 16a "
        f"{a16['params'] / 1e6:.1f} M params in {a16['seconds']:.1f} s, "
        f"TPOT p50 at factor {MOE16_FACTOR} fixed "
        f"{a16['bursts'][f'fixed@{MOE16_FACTOR}']['tpot_ms_p50']} ms, paged "
        f"{a16['bursts'][f'paged@{MOE16_FACTOR}']['tpot_ms_p50']} ms; 16b "
        f"{b16['step_ms_median_after_first']:.1f} ms a step at B = "
        f"{MOE16_BATCH} x {MOE16_SEQ}, {b16['tokens_per_s']:.0f} tokens/s, "
        f"MFU {b16['mfu']:.4f}, peak {b16['max_memory_allocated'] / 1e9:.2f}"
        f" GB in {b16['seconds']:.1f} s; 16c expert={MOE16_EP} step median "
        f"{ep_ms} ms, {ep_bytes} expert-axis bytes a step, in "
        f"{c16['seconds']:.1f} s {label}")

    timing = time_kernels(tfa, dev)
    # 16b's and 16c's backward launches count into the backward rows
    # (their attention is the flagship's, 8 heads x 128).
    bwd16 = [{"launches": {k: r["launches"].get(k, 0)
                           for k in ("flash_bwd_dq", "flash_bwd_dkv")}}
             for r in p16["runs"].values()]
    main_runs = (gen, eng, peng, train, psgd, *spec["runs"].values(),
                 *variants["runs"].values(), *fleet["runs"].values(),
                 *p13["runs"].values(), *p14["runs"].values(),
                 *p15["runs"].values(), *bwd16)
    main_launches = {k: sum(run["launches"].get(k, 0) for run in main_runs)
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
    for _, tag, *_ in HF_MODELS:
        m = hf["models"][tag]
        runs = list(m["runs"].values())
        if tag == "gemma-2b":
            runs += list(p12["runs"].values())   # 12b's training forward
        for kern in ("flash_fwd", "flash_decode", "paged_decode"):
            t = m["timing"][kern]
            name = f"{kern}@{tag}"
            launches = sum(run["launches"].get(kern, 0) for run in runs)
            if launches <= 0:
                raise AssertionError(f"{name} never launched on the main "
                                     f"path")
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"horovod_tpu_torch/csrc/{kern}.cu",
                "replaces": REPLACES[kern], "launches": launches,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"],
                "planted_fault_err": t["planted_fault_err"],
                **{k: t[k] for k in ("splits", "bound_share") if k in t}})
            log(f"{name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
                f"plain, {t['library_ms']:.4f} ms library, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}) at {t['shape']}"
                f", max_abs_err {t['max_abs_err']:.3e} on these inputs, "
                f"launches {launches} {label}")
    # 16: the MoE model's forward, decode and paged rows (timed at its
    # own path's shapes), launched on 16a's serving runs and 16b's and
    # 16c's training forwards.
    for kern in ("flash_fwd", "flash_decode", "paged_decode"):
        t = a16["timing"][kern]
        name = f"{kern}@moe"
        launches = sum(run["launches"].get(kern, 0)
                       for run in p16["runs"].values())
        if launches <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{kern}.cu",
            "replaces": REPLACES[kern], "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "planted_fault_err": t["planted_fault_err"],
            **{k: t[k] for k in ("splits", "bound_share") if k in t}})
        log(f"{name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
            f"plain, {t['library_ms']:.4f} ms library, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) at {t['shape']}, "
            f"max_abs_err {t['max_abs_err']:.3e} on these inputs, launches "
            f"{launches} {label}")
    # 12a/12b: the backward kernels at D = 256, timed at Gemma-2B's
    # training attention, launched on 12b's path.
    for kern, name in zip(("flash_bwd_dq", "flash_bwd_dkv"), BWD256_NAMES):
        t = p12["bwd256"]["timing"][name]
        e = p12["bwd256"]["errs"][name]
        launches = gt["launches"][kern]
        if launches <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{kern}.cu",
            "replaces": REPLACES[kern], "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "hkv": t["hkv"],
            "max_abs_err_path_case": e["max_abs_err"],
            **{k: v for k, v in e.items() if k != "max_abs_err"},
            "resources": wgmma_report[f"{kern} bf16 D=256"]})
        log(f"{name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
            f"plain, {t['library_ms']:.4f} ms library, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) at {t['shape']} Hkv "
            f"1, launches {launches} {label}")
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
                  speculative=spec, variants=variants, fleet=fleet,
                  training=train, data_parallel_surface=surface,
                  hf=hf, trace_paged_tick=trace_tick,
                  phase12={k: v for k, v in p12.items() if k != "runs"},
                  phase13={k: v for k, v in p13.items() if k != "runs"},
                  phase14={k: v for k, v in p14.items() if k != "runs"},
                  phase15={k: v for k, v in p15.items() if k != "runs"},
                  phase16={k: v for k, v in p16.items() if k != "runs"},
                  wgmma_kernels=wgmma_report,
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
