#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, the CUDA
toolkit (`nvcc`) and PyTorch built for CUDA; it imports nothing of JAX
or of the JAX package. Phases, one line each, stopping at the first
failure with a non-zero exit:

  1. build   compile the seven kernel sources from flashy_tpu_torch/csrc
             with nvcc, one process per source, started together, and
             print ptxas's registers and spills per kernel; then
             `cuobjdump -sass` of the flash, ring and grouped libraries:
             every bf16 flash and ring kernel at head_dim 64 and 128 and
             every grouped wgmma kernel issues
             HGMMA (wgmma) and ptxas did not serialize it (fewer
             WARPGROUP.DEPBAR than HGMMA); the paged library's T >= 2
             bf16 kernels and the SSD library's bf16 kernel issue HMMA
             (mma.sync), and no paged or SSD kernel spills;
  2. kernel  the paged kernel against its plain PyTorch version on random
             pools (bf16, f32, int8 with f32 and bf16 q; T in {1, 4, 5
             (the speculative verify step), 16, 64}; block 16 over 512
             keys and blocks 4, 16 and 64 over 2048, which wrap its ring
             eight times; ragged,
             sentinel-padded, all-sentinel and parked slots): f32 within
             1e-5 of the plain version evaluated in f64, bf16 within
             2e-2 of it and against the entry-by-entry reference that
             rounds where the TPU kernel does: one bf16 ulp apart at
             most, and bit-equal almost everywhere; two launches on the
             same inputs bit-equal; a block size or head_dim it does not
             take raises;
  3. flash   the four flash-attention kernels at head_dim 64 (bf16: the
             Hopper wgmma/TMA forward step and backward pair step; f32:
             the general route, `flash_general.cu`) against their plain
             versions (f32 and bf16; causal and not;
             t_k equal to, above and below t_q, the last with empty rows;
             ragged T): forward against the dense path and, in bf16,
             within one ulp of the blockwise reference at the kernel's
             tile; split and fused backward against their plain versions
             (the fused dQ against the plain partials folded in k order);
             fused bit-equal to split on dQ, dK and dV;
  4. ssd kernel  the SSD chunked-scan kernel against its plain version
             at the serving widths (H 16, Dh 64, N 16; chunks 16, 64,
             256 and tails; T of 1, 7, 100 and 1024; a random carried
             state and a padded row; each case on projection slices
             and on contiguous inputs; also N 8 / Dh 32, N 128, Dh 128
             and an odd Dh): f32 within 1e-5 of max |plain|, bf16 y within one
             bf16 ulp; in both dtypes a SSD_LOG_RESET segment equal to
             the segment alone (f32 1e-5, bf16 one ulp), chaining and
             right-padding bit-equal, two launches bit-equal;
  4b. gmm kernels  the grouped-GEMM kernels (gmm, gmm_t, tgmm) against
             their plain versions (TF32 off): E in {1, 4, 8}, M in {1,
             100, 4133}, K and N in {64, 1024, 4096}, empty first, last
             and middle groups, a one-row group, all rows in one group,
             sum(group_sizes) < M; bf16 x bf16 -> f32, f32 x f32 -> f32
             and both mixed forms (the f32 operand as three bf16 planes)
             -> bf16 and -> f32, the mixed forms also against the split
             route's plain version: f32 within 1e-5 of max |plain|, bf16
             within one ulp, rows past the groups and empty tgmm groups
             exactly zero; the split kernel's planes bit-equal to
             `split_bf16` and summing back to the f32 operand;
  4c. ring kernel  the ring-attention kernel (bf16; f32 on the general
             route), one launch per rank, against its plain version (TF32
             off): n in {1, 2, 4, 8} ranks of t in {64, 100 (ragged),
             512} rows, B 2, H 16, D 64, causal and not, f32 and bf16:
             f32 out and lse within 1e-5 of max
             |plain|, bf16 out within one ulp with at most 1% not
             bit-equal, lse within 1e-5 relative; the global output
             against the scan ring and dense attention at the flash bars;
             one rank bit-equal to the flash forward;
  5. exact   the 235M TransformerLM in f32 (TF32 off) served through the
             paged engine and the continuous-batching scheduler, every
             step a replay of a CUDA graph `warmup()` captured, every
             stream token-exact against the port's dense-cache
             `generate` (a near tie, top-2 margin < 1e-5, is reported,
             not failed), the pool conserved, the kernel launched
             exactly num_layers x (decode steps + prefill chunks) times
             (each replay adds its graph's launches), and the compile
             cache's misses unchanged and recompiles 0 through the run
             (so in every serving phase);
  6. ssd exact  the same layout with every mixer an SSD layer, in f32,
             through `cache_layout='ssd'` with a 256 ceiling: 8 streams
             of mixed prompt lengths past the ceiling, token-exact
             against `generate` (the same near-tie rule), the SSD kernel
             launched num_layers x prefill slices times;
  7. serve   the serving layout in bf16 at the decode leg's shapes
             (8 slots, 16 requests, prompt 128, 128 new): tokens/s,
             decode-step ms, the kernel launched on every read (split by
             T=1 and T=16), and its device time at T=1 (decode) and T=16
             (a prefill chunk) three times (median and spread) beside its
             bandwidth bound, its plain version and SDPA on the gathered
             view, with the wrapper's host us a call; then a profiled
             serving window: the device's idle share and the kernels
             that take its time; then the first 8 prompts at 32 new
             tokens (PR 21's cut) through a twin engine with
             cuda_graphs=False and a fresh graph engine: streams
             bit-identical and prefixes of the phase's, launches equal,
             the eager
             run's tokens/s and decode-step p50, and the
             host us of one decode step with graphs and eager; then two
             replays of the captured decode step at temperature 1.0 on
             the same inputs draw differently (the engine's generator is
             registered with the graph);
  8. int8    a short bf16 run with int8 K/V pools through the int8
             kernel: pool conserved, kernel launched on every read,
             kernel timed as in phase 7, graphs against eager as there;
  8b. capture gc  a warmed engine dropped without a collection, then a
             second engine captures with a collection due at every
             allocation: every step captured (the collector is off in a
             capture, which freeing the dropped graphs would invalidate);
  9. ssd serve  the pure-SSD model in bf16 at the same shapes: tokens/s,
             decode-step ms, a profiled window, graphs against eager as
             in phase 7, and the main path's
             `ssd_chunked_scan` call (bf16 projection slices, a padding
             mask) at a prefill slice [1, 64] and at [8, 1024]: held
             to the plain version on those inputs (bf16 y within one
             ulp, state 1e-5), the kernels it launches (the profiler:
             the scan alone), its
             device time three times (median and spread) beside its
             bound and its plain version (no library call computes it),
             and its host us a call;
 9b. dense exact  the `exact` workload in f32 through the dense layout
             (`cache_layout='dense'`, the engine's default), once with
             the monolithic prefill (a graph a bucket) and once with
             chunk 16: every stream token-exact against `generate` (the
             same near-tie rule), no kernel launched (the dense read is
             plain einsums), no capture after `warmup()`;
 9c. serve dense bf16  `serve bf16`'s traffic through the dense layout's
             graphs, then eager: tokens/s, decode p50, the host us of a
             decode step, the captures after warm-up (0), streams
             bit-identical;
 9d. hybrid exact, hybrid serve bf16  the layout with the mixers
             alternating SSD and attention (6 of each, state dim 16,
             chunk 64) through `cache_layout='ssd'`: f32 token-exact
             against `generate`, then `serve bf16`'s traffic as graphs
             and eager; the scan kernel launched once per SSD layer per
             prefill slice; the state bytes a slot, and the device ms
             of a slice's slab copies (each attention slab of the slot
             out and back) beside the slice;
 9e. spec exact  speculative decoding in f32 on the reference demo's
             repetitive mix: the paged engine (the paged kernel) and the
             dense engine with NGramDraft(k=4), with drafts that are all
             rejected and all accepted, the paged engine with a
             ModelDraft (2 layers, dim 256): token-exact against
             `generate`, acceptance 0 and 1 where forced, the paged
             kernel launched once per layer per verify step at T=5;
             int8 pools (the int8 kernel at T=5) on the requests a
             plain int8 engine serves token-exact, token-exact under
             speculation;
 9f. spec serve bf16  the paged engine with NGramDraft(k=4) on 16
             prompts of period 2-4 tiled to 128 tokens, 128 new, in
             turns with the same engine without a draft: tokens/s, step
             p50, tokens a step, acceptance rate (no floor: random
             weights); an int8 pool with the draft (the int8 kernel at
             T=5, its streams checked for vocab only); the kernel at
             the verify shape (8 slots, T=5) timed
             as in phase 7; the verify step at temperature 1.0 as a
             captured graph (the same tokens from the same seed twice);
             `generate` with top_k and top_p on the card;
 9g. serve demo  `python -m flashy_tpu_torch.serve`'s six legs on the
             card (the `slo` leg: untraced, then traced at sampling 1.0
             with an SLOEngine), in this process after the phases above
             (a capture after other engines were dropped), with
             `--kernel fused` and the demo's default gates;
 10. step    the 235M model in f32 (TF32 off) at batch 2, seq 256: loss
             and gradients with attention='flash' (the general route)
             through the fused backward and through the split pair
             (bit-equal), and against attention='dense';
 10b. moe step  the same layout with every MLP 8 top-2 experts (889M
             parameters) in f32 at batch 2, seq 256 (a batch whose
             routing has no top-3 gap under 1e-6): loss and every
             gradient through the grouped-GEMM kernels ('dropless')
             against their plain versions (1e-5) and against 'einsum'
             at capacity factor 8.0, where nothing drops (1e-4 on the
             loss and each gradient's norm); launches 12 x 2 of each
             kernel;
 11. train   the 235M model in bf16 at batch 16, seq 1024 through the
             LM solver's `main` entry point in a fresh XP: 2 epochs of
             8 steps and 2 valid steps, the loss finite and falling,
             the forward kernel launched 12 x (train + valid steps)
             times and the fused backward 12 x train steps; a second
             call with 3 epochs restores and continues; tokens/s and
             step ms; then a profiled training window (idle share, top
             device kernels, the forward kernel's device ms a step, the
             tied head's products' device ms a step); then the head's
             three products at these shapes (bf16 operands, f32 output:
             `ops.losses.head_matmul`) held to the f32 product (1e-3 of
             max |value|) and timed beside their bound and the f32
             products they replace; then each flash kernel at these
             shapes, held against its plain version as in phase 3, two
             fused launches bit-equal (its ordered dQ chain) and a fused
             call's device memory,
             then timed three times (median and spread; the fused time
             is the whole gradient) beside its bound, its plain version
             and PyTorch's scaled_dot_product_attention; the same for the
             general route at `step`'s shapes (f32, head_dim 64);
 12. moe train  the MoE layout at 4 of its 12 layers (the time limit)
             in bf16 at batch 16, seq 1024 through
             `main` with moe_dispatch=dropless in a fresh XP: 6 steps
             and 2 valid steps, the step loss finite and falling, the
             aux loss finite, gmm launched 4 x 2 x (train + valid
             steps) and gmm_t, tgmm and the split kernel 4 x 2 x train
             steps; tokens/s, step ms, peak memory; a profiled window of
             3 steps (the grouped kernels' device ms a step); then each
             grouped kernel's two launches of a layer at the training
             shapes, held against the plain version and timed three
             times (median and spread, device time, the split pass
             inside the f32-operand launches) beside the bound, the
             plain version and torch._grouped_mm, with the wrapper's
             host us a call; the split kernel alone on dY;
 12b. ep step  queue A item 8d: `moe step`'s model and batch through
             `dropless_ep` on two ranks over gloo (`+mesh.expert=2`, 4 of
             every block's 8 experts a rank; started beside phases 43-44,
             read after 44): each rank's `dropless` loss bit-equal to
             `moe step`'s, the exchange's loss and every gradient,
             gathered, within 1e-5 of it; rows 9a/9b 2 a layer each;
 13. ring step  the 235M model in f32 (TF32 off) at batch 2, seq 256 on a
             4-rank ring: loss and every gradient with attention=
             'ring_fused' against 'ring' (1e-5 of max |value|: the same
             backward) and both against 'flash' (1e-4); launches: ring
             forward 12 x 4, split dQ and dK/dV 12 x 10 each (the
             visible (rank, step) pairs), the scan ring's flash forward
             12 x 10;
 14. ring train  the 235M model in bf16 with attention=ring_fused,
             mesh.seq=4, batch 8, seq 2048 (16384 tokens a step) through
             `main` in a fresh XP: 6 steps and 2 valid steps, the step
             loss finite and falling, the ring kernel launched 12 x 4 x
             (train + valid steps) times, the split pair 12 x 10 x train
             steps each, no other flash kernel; tokens/s, step ms, peak
             memory; a profiled window of 3 steps (the ring kernel's
             device ms a step); then the ring kernel at these shapes (4
             ranks of [8, 512, 16, 64], causal), held against its plain
             version and timed three times per rank and for the four
             together beside the bound, the plain version and one
             scaled_dot_product_attention call over the 2048 tokens,
             with the host cost of a launch's tensor maps.

The routes for the other widths (the shape picks the kernel; each route
has its own launch counter and its own row in the kernels line) are
checked in the phases above and driven at full width after them:

  2.  (kernel) also the paged read's general route (`paged_general.cu`:
             any head_dim and any block size) at head_dim 128 with blocks
             16, 12, 128, 200 and 256, head_dim 32, head_dim 64 with
             block 12 and head_dim 256 with blocks 16, 256 and one entry
             of 1024 keys (f32 at T 64 in groups of rows; an entry past 64
             keys in two passes of 64-key chunks); (block, head_dim) (12,
             64), (128, 64), (16, 32), (16, 128) route there, (16, 64) to
             `paged_decode.cu`;
  3.  (flash) also D in {128, 32, 65, 80, 96, 256, 320, 576}: bf16 at 128
             on the Hopper kernels built at 128, everything else on the
             general route (`flash_general.cu`, the head dim in slabs of
             up to 128 columns); its plan fits every D of 1..4096;
  4.  (ssd kernel) also N 128 at chunk 256 over T 1024 and N 256 with a
             ragged tail, on the FMA kernel;
  4b. (gmm kernels) also K and N in {12, 100, 1030}, on the padded route;
  4c. (ring kernel) also the same D: bf16 at 128 on the ring kernel
             built at 128, the others on the general route; one rank
             bit-equal to the flash forward of its route;
 15. exact d128  the 235M layout at 8 heads of 128 in f32 served at block
             16 (max_seq_len 512), 128 (512, prefill chunk 16) and 12
             (504), token-exact against `generate`, every read on the
             general route;
 16. serve d128 bf16, int8 d128 bf16  phase 7's and 8's windows at 8 heads
             of 128: tokens/s, decode p50, the general route's launches
             by T and its device time beside bound, plain and SDPA;
 17. ssd n128  the pure-SSD layout at ssd_state_dim 128, chunk 256, f32:
             one 1024-token prompt in one prefill slice (12 launches of
             the FMA kernel) and 16 new tokens token-exact against
             `generate`; that call timed;
 18. step d128, ring step d128  phases 10 and 13 at 8 heads of 128 (f32:
             the general flash and ring routes), at their bars;
 19. train d128  the d128 layout's width in bf16 at batch 16, seq 1024
             and 2 of its 12 layers (cut in depth only: the time limit) through
             `main` (8 steps, 2 valid, no resume): the loss falls, the
             forward and the fused backward on the Hopper kernels built
             at 128; tokens/s, step p50, peak memory;
 19b. ring train d128  phase 14 at 8 heads of 128 (4 steps, 1 valid):
             the ring kernel and the split pair built at 128; then phase
             11's kernel timing at `train d128`'s shapes, phase 14's ring
             and pair timing at `ring train d128`'s, the general route's
             at `step d128`'s (f32), at D 80 (bf16) and at D 576 (bf16, B
             2, H 8, T 512: five head-dim slabs), the ring's general route
             at `ring step d128`'s shapes and at D 576 (bf16, 4 ranks of
             128 rows); then the paged general route at one table entry of
             16384 keys (8 slots, 8 heads of 256, bf16, T=1) against its
             plain version, timed beside its bound and SDPA;
 20. step w260  the MoE layout at dim 260 (5 heads of 52, 8 top-2
             dropless experts, 2 layers) in f32: the grouped kernels'
             padded route (K = 260) and the general flash route (D 52;
             the odd D 65, which no rotary model takes, is phase 3's)
             against the plain grouped matmuls, `einsum` at capacity 8.0
             and dense, fused == split bitwise; then the padded route's
             six launches of a layer timed beside bound and plain (no
             library call takes those widths).

The LM trainer's switches and SSD training, after them:

 21. remat step  the 235M model in f32 (TF32 off) at batch 2, seq 256,
             attention='flash', dropout 0.1 with one seed: loss and every
             gradient without remat and with remat_policy 'full', 'dots'
             and 'dots_no_batch', held together at the JAX remat test's
             bars (loss rtol 1e-6; grads rtol 1e-5, atol 1e-6), the
             largest difference of each printed; the flash forward
             launched 12 times without remat and 24 with it (the
             recompute launches it again), the fused backward 12; then
             one bf16 AdamW step at `train`'s shapes under each policy
             and its peak memory;
 22. train ema  `train`'s run at 2 of its 12 layers (cut in depth only,
             the time limit) with ema_decay 0.999, model.remat=true and
             remat_policy=dots through `main` in a fresh XP: the loss
             falls, valid runs on the f32 EMA shadow, which is not the
             live params; a resume restores the shadow bit-equal; a
             resume with ema_decay=0 drops it with the reference's
             warning; the flash forward launched layers x (2 x train +
             valid steps), the fused backward layers x train steps;
             tokens/s, step
             p50, peak memory, and the EMA update's device ms beside its
             bound;
 23. ssd step  the pure-SSD layout in f32 (TF32 off) at batch 2, seq 256
             (chunk 256, `default_chunk`): loss and every gradient through
             the training Function (the scan kernel's forward, the plain
             chunked form's autograd in the backward) against plain
             autograd of the chunked form on the card, within 1e-5 of
             max |plain| per leaf; the scan kernel launched 12 times, the
             backward's recompute 12 times;
 24. ssd train  bf16 AdamW steps on the pure-SSD 235M layout at batch
             16, seq 1024 through `value_and_grad` and `train_step`: 6
             steps, the loss falling, the scan kernel launched and the
             backward recomputed 12 x steps times; tokens/s and step p50
             over steps 3..6, peak memory (a batch that does not fit is
             halved, and the line says so); then one layer's scan
             backward at these shapes (the plain chunked form recomputed
             and differentiated) timed beside its bound and the kernel's
             forward.

The model layouts of ROADMAP queue A item 3's L7 and L8, last:

 25. moe exact  the MoE layout (8 top-2 dropless experts, 889M) in f32
             on 4 slots, 8 requests of 100-128 prompt tokens, 32 new:
             the dense engine with its monolithic prefill (bucket 128:
             `_moe_forward`'s expert-stream order), the paged engine at
             chunk 16 (the token-gather order) and the paged engine with
             NGramDraft(k=4), token-exact against `generate` (near ties
             reported), the paged kernel on every read (T=5 in verify);
 26. moe serve bf16  the MoE layout through the paged engine's graphs
             (8 slots, 16 requests, prompt 128, 128 new): tokens/s,
             decode p50, captures after warm-up (0), memory after
             warm-up and at the peak (each graph its own pool), the same
             traffic eager (bit-identical); a profiled window of graph
             replays; the 12 MoE layers' and the paged reads' device ms
             a decode step (CUDA events) beside the bytes the gather
             order moves;
 27. scan exact  the scan-stacked 235M layout in f32: weights at seed 0
             and logits bit-equal to the per-layer model's; the `exact`
             workload through the dense and the paged engine (a
             copy-on-write fork through the stacked pool) token-exact
             against `generate`; the stacked pure-SSD layout on 'ssd'
             (four of `ssd exact`'s prompts), the scan kernel on every
             prefill slice;
 28. scan step  f32 b2 t256: the stacked model's loss and every gradient
             bit-equal to the per-layer model's (restacked), with flash
             (rows 1 and 4, general route), 8 top-2 dropless experts
             (rows 9a/9b) and remat dots; the launches equal;
 29. scan train  `train` with model.scan_layers=true through `main` (8
             steps, 2 valid, then a resume): the loss falls, the flash
             launches a step `train`'s; tokens/s, p50 beside `train`'s;
 30. int8w exact  int8 weights (`quantize_lm_params`) in f32: the first
             step's logits within the JAX package's cosine bar (0.999)
             of the f32 weights' on its own test cases, the 235M
             distance printed; the `exact` workload at 235M through the
             dense and paged engines (`params=`) token-exact against
             `generate(params=)`;
 31. int8w serve bf16  int8 weights over int8 pools (row 6) through the
             paged engine's graphs, in turns with bf16 weights over the
             same pools: tokens/s, decode p50, the resident weight bytes.

ROADMAP queue A item 3's L4-L6 and item 9's observability half, after
them (first `roofline graphs`: a one-matmul step through a CompileCache
with a roofline, its FLOPs counted before the capture and its replays
timed):

 32. serve traced  `serve bf16`'s traffic (8 slots, 16 requests, prompt
             128, 128 new) through two paged engines' captured graphs on
             one model, in turns, twice: one untraced, one with a Tracer,
             a RequestTracer at sampling 1.0, an SLOEngine and
             ServeMetrics(tracer=, slo=): streams identical, no capture
             after warm-up on either, every request's queued, prefill and
             decode phases in requests.jsonl and its async span in
             trace.json, serve.json's slo block present and quiet;
             tokens/s and decode p50 of both, their ratio, the host us a
             step tracing adds, row 5's launches; then one more traced
             run with each hook timed, by admission, decode and
             retirement steps;
 33. serve chaos  the `exact` workload in f32 through the paged engine
             under a strict FaultInjector: the third admission's
             reservation fails (`serve.pool`: shed, retried at the queue
             head), 12 decode steps stall 0.1 s (`serve.step`) against an
             ITL budget of 0.05 s, the second serve.json write fails
             between its temporary write and its rename (`fleet.status`):
             token-exact against `generate` (near ties reported), the
             budget alerting, the first serve.json whole and the next
             write healing it, `uninstall()` quiet; the injector's counts
             and what fired;
 34. train telemetry  `train`'s model and shapes at 2 of its 12 layers
             (the time limit) for 6 steps and 1 valid step with `enable_telemetry(roofline=True)` and
             `enable_profiling(stages=["train"])` in a fresh XP: a step
             record a step tiled by data wait, host and device,
             trace.json, heartbeats/, 0 recompiles, the roofline's MFU
             over the aten FLOPs and the steps' wall against the H100
             peak, in (0, 1], the profiler's trace, the split's device
             backlog at most the card's busy time in that trace and the
             busy time at most the steps' wall, `python -m
             flashy_tpu_torch.info` (heartbeats) and
             `--slo` exit 0; then the step p50 without and with
             telemetry, in turns. The demo's `slo` leg runs in phase 9g.
 35. train preempt  `train`'s model at full width and 2 of its 12
             layers (cut in depth only; what 35-38 check does not depend
             on depth; 2 train
             steps and 1 valid a epoch, 3 epochs) through `LMSolver.run`
             with `enable_preemption_guard()` installed: two clean runs
             (their histories without wall-clock keys and every parameter
             and AdamW moment compared bit for bit: the spread of the
             card); a run whose `batch_at` sends the process a real
             SIGTERM at train step 2 of epoch 3, which ends in
             SystemExit(75) at the boundary before `valid` with 2
             committed epochs and `preempted.json`; its resume in the same
             XP, held to the clean run (bit-identical, or within the clean
             runs' spread, printed beside it); single-file commit, sha256
             and restore seconds, checkpoint bytes;
 36. train slots  the same with `checkpoint_mode='sharded'`: preempted
             after 2 commits, so both slots hold a checkpoint;
             `corrupt_active_slot`, then a resume that falls back to the
             sibling with the WARN and is held to the clean run as in 35;
             `info.verify_checkpoint` restorable; slot commit, sha256,
             fallback restore seconds;
 37. train async  `checkpoint_async=True` over 3 epochs: the host-blocking
             seconds of each `commit()` (its wait for the previous save
             and its snapshot) and the background write's seconds beside
             the synchronous slot commits of 36; the final state equal to
             the clean run's bit for bit, and the epoch-2 slot (written
             while epoch 3 updated the parameters in place) equal to the
             epoch-2 checkpoint of 35; then a 2-epoch run whose first
             background write fails (`ckpt.write`, every retry): the next
             commit raises and rolls back the epoch it covered, in memory
             and in history.json;
 38. hang abort  (run beside 39, 40 and 42) a subprocess trains 2
             steps of 35's model with
             telemetry (heartbeats every 0.25 s), starts
             `enable_hang_watchdog(warn_after=2, abort_after=4,
             interval=0.5)`, runs 1 valid step, then blocks its main
             thread on the card (`torch.cuda._sleep` of ~20 s, then
             `torch.cuda.synchronize()`): it must exit with 70 within 8 s
             of blocking, the watchdog's WARN with a straggler report on
             its stderr;
 39. drill  `python -m flashy_tpu_torch.resilience` exits 0.

ROADMAP queue A entry 1 (the streaming datapipe) and item 9's chaos
campaign, last:

 40. datapipe drill  `python -m flashy_tpu_torch.datapipe` at its
             defaults on the card (the tiny LM, dense attention, f32,
             3 epochs x 6 steps of packed [4, 64] batches, killed in
             epoch 2): exit 0, so the kill + resume token stream and
             the final parameters equal the uninterrupted run's, the
             kill exits 75 at the boundary, the prefetch counters saw
             tokens and `data_wait_frac` is in the history;
 41. packed train  the pure-SSD 235M layout in bf16 (`ssd train`'s) at
             4 of its 12 layers (the time limit)
             through a BaseSolver with the model, AdamW, the step count
             and the pipe registered: a corpus of 8 jsonl and 8 .npy
             shards made from `--seed` (documents of 16-3072 tokens),
             two streams -> MixtureStream (0.7, 0.3) ->
             SequencePacker(16, 1024) -> prefetch(size=2), the
             segment-masked loss of the drill; two clean runs of 2 epochs
             x 3 steps (telemetry on: `data_wait_frac`), a run preempted
             through the `datapipe.batch` fault point at epoch 2 step 2
             ('abandon_stage': exit 75, the prefetch thread closed), its
             resume: the consumed token stream identical to the clean
             run's and the state bit-identical, or within the clean runs'
             spread; row 7 launched once a layer a step and recomputed as
             often; then row 7 on the first packed batch's layer-0 inputs
             (document resets as SSD_LOG_RESET, padding masked) against
             the plain chunked form at phase 9's bars, timed; packing
             efficiency, tokens/s over packed positions and over
             non-padding tokens, step p50 beside `ssd train`'s, peak
             memory, the prefetch's tokens/s, commit and restore seconds;
 42. campaign  `python -m flashy_tpu_torch.resilience --campaign
             --scenarios datapipe,serve,fleet --seed 0` on the card exits
             0: the calibration run and every schedule of the datapipe
             scenario (a kill and a stall at `datapipe.batch`) keep the
             consumed token stream and the losses; the serve and fleet
             scenarios' (the fleet's sites under every fault kind they
             declare, engine deaths, whole-fleet crashes recovered from the
             WAL, a torn WAL tail) keep every stream token-exact, one
             completion record a uid, the pools conserved and nothing
             built or captured after each fleet build's warm-up; then the
             fleet scenario under the seeded `wal_skip_dedup` defect exits
             1 with a reproducer naming it (its dedup oracle caught it).
             Phases 39, 40 and 42 (and the defect run) start together,
             after phase 41, each in a process of its own (PR 21).

ROADMAP queue A item 5, data parallelism across processes, last. The
card's machine has one H100 and NCCL refuses two ranks on one device, so
two ranks share cuda:0 over gloo, which stages CUDA tensors through the
host: its times are that staging's, not NCCL's. The ranks are processes
of this script (`--dp-rank`, `--dp-train`), each in a session of its own
under a deadline, rendezvousing through a `file://` path:

 43. dp collectives  `distrib.all_reduce` with every op on CUDA and host
             values, weighted `average_metrics`, `average_tensors` by
             'reduce' and 'allgather' on a tree above REDUCE_MIN_BYTES
             (f32 and bf16 CUDA leaves, a numpy leaf) bit-equal to the
             mean one process takes, `broadcast_model`,
             `broadcast_tensors`, `broadcast_object`, `barrier`, and a
             mismatched tree raising RuntimeError on both ranks;
 44. dp step  the 235M layout's width in f32 (TF32 off) at `step`'s
             shape and 2 layers (cut in depth only: the time limit),
             global batch 4 x t256, two ranks of 2 under `parallel.wrap`
             (DDP): the gradients after the first backward and the
             parameters after each of two clipped AdamW steps within 1e-5
             of max |value| of one process on the whole batch, the ranks'
             parameters bit-identical after every step, rows 1·g and 4·g
             launched 2 x 2 times on each rank;
 45. dp train  the default bf16 flash LM at full width and 2 layers
             (cut in depth only; 4 before PR 21) through `main --workers=2` (global b16
             t1024, b8 a rank, one warmup step): run A 2 epochs x
             2 steps + 1 valid step with a commit each; run B 1 epoch
             (run beside phase 44, untimed), then resumed to 2 (both
             ranks restore rank 0's file): final
             states bit-identical across ranks and runs, histories equal
             without wall-clock keys, rank 0 writing them; epoch 1's
             train loss (AdamW's first update has lr 0, so both steps
             see the initial weights) within 1e-4 relative of one
             process on the same global batches; rows 1 and 4 launched 4 x steps on
             each rank; step p50, global tokens/s and the gradient
             all-reduce's share of a step (gloo through the host);
 45b. zero bench  queue A item 8a: `python -m
             flashy_tpu_torch.parallel.zero --workers=2` at the 235M
             layout's width and 2 layers, bf16 flash, global b16 t1024
             (started beside phases 43-44): replicated (DDP), zero1 (`wrap(
             state_sharding=zero_sharding(...))`) and fsdp (`wrap(fsdp=
             True)`) in one start-up, four timed steps each: step p50,
             each rank's optimizer bytes and peak memory, the collectives
             a step; zero1's optimizer bytes a rank <= 0.55 of
             replicated's, fsdp's peak a rank below replicated's, zero1's
             all-gather bytes a step <= 1.5 x the params' bytes, zero1's
             params within 1e-4 of replicated's (0 reported);
 45c. fsdp train  phase 45's run with `mesh.data=1 mesh.fsdp=2` and
             `checkpoint_mode=sharded`: run A 2 epochs (beside phase 45's
             run A), run B 1 epoch (beside phases 43-44) then resumed
             from the slots in a second start-up (beside phase 45's run
             B2): each rank's shards and the
             full parameters bit-identical between A and the resumed B,
             histories equal, A's history within 1e-4 relative of phase
             45's run A (bit-equality reported), checkpoint_meta.json
             `fsdp(fsdp=2)`, the slot holding every rank's file; rows 1
             and 4 launched 4 x steps on each rank; step p50 and peak
             memory a rank beside phase 45's;
 45d. tp bench  queue A item 8b: `python -m
             flashy_tpu_torch.parallel.tensor --workers=2` at the
             reference's defaults (f32, dense attention, dim 128, 2
             layers, tensor widths 1 and 2; started beside phase 43):
             each width's step ms, optimizer bytes a rank, sharding
             summary, collectives a step and first-step gradients
             against a replicated one-process oracle (<= 1e-4);
             `flash_bwd_parity`: the fused f32 flash backward against the
             split dQ / dK,dV kernels (`flash_general.cu`) exactly 0.0;
             0 recompiles;
 45e. tp train  phase 45's run with `mesh.data=1 mesh.tensor=2`
             (Megatron: each rank 8 of the 16 heads, half the MLP width
             and of the vocabulary) and `checkpoint_mode=sharded`: run A
             2 epochs (beside phase 45's run A), run B 1 epoch (beside
             phase 44) then resumed from the slots in a second start-up
             (beside phase 45's run B2): each rank's slices and the
             gathered full parameters bit-identical between A and the
             resumed B, the full parameters equal across the ranks, every
             logged loss within 1e-3 of phase 45's run A (the order of
             the sums differs), the gradient of step 0's batch at the
             trained state, gathered, within 5e-2 of run A's, leaf by
             leaf relative to its norm, checkpoint_meta.json
             `tensor(tensor=2)`;
             rows 1 and 4 launched 4 x steps on each rank, every flash
             call at 8 heads; the collectives of one more step (two
             forward all-reduces a block); step p50 and peak memory a
             rank beside phase 45's;
 45f. pipe bench  queue A item 8c: `python -m
             flashy_tpu_torch.parallel.pipeline --workers=2` at the
             reference's defaults (dim 48, 8 layers, 4 heads, vocab 128,
             seq 24, batch 16, M 8, v 2, dense and MoE legs, pipe 2; one
             timed step a leg after the warm one; started beside phases
             46-54 and read after them; deterministic algorithms): 1F1B,
             interleaved and packed gradients within 1e-2 of the GPipe
             oracle, packed bit-identical to unpacked, the 1F1B stash
             flat in M while GPipe's grows, the interleaved bubble below
             GPipe's, the packed dead-compute fraction below unpacked's,
             the `pipeline/bubble` track, 0 recompiles; each schedule's
             step ms and packed's over unpacked's (printed, not gated:
             an idle lane costs the port's ranks no compute);
 45g. pipe train  the LM trainer at the 235M layout (12 layers, bf16,
             b16 t1024) with `mesh.data=1 mesh.pipe=2
             pipeline_schedule=1f1b pipeline_interleave=2
             pipeline_microbatches=4` and sharded slots, two ranks over
             gloo, each holding 6 of the 12 layers (chunks {0, 2} and {1,
             3} of 3 layers): run A 2 epochs (beside phase 45's run A),
             run B 1 epoch (beside phase 44) then resumed (beside phase
             45's run B2), and a one-process oracle of the same config
             (`mesh.pipe=1 model.scan_layers=true`, the same seed;
             beside phases 41-42; the checks run after phase 54): every
             logged loss within 1e-3 of the
             oracle's, the gradient of step 0's batch at the trained
             state, gathered to full shapes, within 5e-2 of the oracle's
             leaf by leaf relative to its norm, A and the resumed B
             bit-identical (each rank's chunks and the gathered
             parameters), the train stage's `bubble_frac` 0.111111, rows
             1 and 4 launched 48 and 24 a training step on each rank (24
             and 0 a valid step); one more step's hops and all-reduces,
             one activation hop timed alone, step p50 and peak memory a
             rank beside the oracle's;
 45h. ep train  queue A item 8d's expert half: the LM trainer at the MoE
             layout (8 top-2 experts, 4 of 12 layers, bf16, b16 t1024)
             with `mesh.data=1 +mesh.expert=2
             model.moe_dispatch=dropless_ep model.moe_capacity_factor=2.0`
             (nothing drops), sharded slots and deterministic algorithms,
             two ranks over gloo, each holding 4 of every block's 8
             experts: run A 2 epochs x 2 steps + 1 valid and run B 1
             epoch (beside phases 46-48), then B resumed and a
             one-process `dropless` oracle of the same config as soon
             as B's first epoch ends (beside phases 48-54), checked
             after phase 45g: every logged loss
             within 1e-3 of the oracle's, the gradient of step 0's batch
             at A's trained state, gathered, within 5e-2 of the
             oracle's at that state leaf by leaf relative to its norm
             (at the oracle's own trained state printed), A and the
             resumed B bit-identical, the parameters held whole
             bit-identical across the ranks, rows 9a/9b launched 2 gmm,
             2 gmm_t and 2 tgmm a layer a training step on each rank (as
             the oracle); one more step's exchanges (5 all-to-alls a
             layer), step p50 and peak memory a rank beside the
             oracle's (row 9a at the receiving slab's shape, [32768,
             1024], 4 local experts, half the rows empty slots after the
             groups, is held to its plain version, rows past the groups
             exactly 0, and timed beside the real rows alone after
             phase 12's kernel times);
 46. prefetch to device  `data.prefetch_to_device` over [16, 1024] int32
             batches on cuda:0: delivered batches bit-equal to the host's,
             an early stop rewinding a datapipe stage to the last batch
             delivered, the data wait a batch with and without the
             prefetch behind ~5 ms of device work, in turns.

ROADMAP queue A items 6 and 11, last: the vision models, the GAN loss,
seq2seq and their examples. They put rows 1 and 4 on shapes no earlier
path runs: non-causal, and T 64 as one tile, where the JAX package takes
dense attention:

 47. models step  f32, TF32 off: ResNet-18 (b8) and ResNet-50 (b4) at
             32x32 in train mode, their norms' scales drawn near 1,
             against the port's CPU run on the same weights computing in
             f64: logits, every gradient and the updated statistics of the
             card computing in f64 within 1e-5 of max |value|, and in f32
             within 1e-4 (ResNet-50's f32 gradients, ill-conditioned at
             batch 4, printed); vit_tiny (b8, 64 patches) with attention='flash'
             against 'dense' on the card: logits and gradients within
             1e-4, rows 1·g and 4·g launched 6 times each; the same in
             bf16: logits within 2e-2 of max |logit|, rows 1 and 4 6 each;
 48. cifar train  the cifar example's `main` (ResNet-18, bf16, batch 256)
             on the synthetic set at 12 train and 4 valid batches: stopped
             after its second commit, then resumed to epoch 3 (epochs 1-2
             of the history unchanged); images/s, step p50 from step 3,
             the data wait's share of each epoch, peak memory, valid acc,
             finite losses (no accuracy bar: synthetic data, few steps);
             then vit_tiny for 12 steps: images/s;
 49. adversarial  MLP generator and discriminator (width 256) through
             `AdversarialLoss`, 20 steps: `train_adv` moves D and leaves
             the generator, its grads and `fake.grad` untouched; the
             generator loss's backward leaves every D `.grad` None; after
             a `save_state` / `load_state` round trip the next D step is
             bit-identical to its twin's; the D step's p50;
 50. basic   the basic example stopped after its epoch-2 checkpoint and
             resumed to epoch 4: the four history entries and the weights
             bit-equal to an uninterrupted run in a fresh XP;
 51. mlm step  f32, TF32 off: the MLM width (dim 512, 8 heads of 64,
             vocab 32768) at 2 layers, b2 t512, the masked loss and every
             gradient with flash against dense within 1e-4; the last
             token moves position 0's logits; rows 1·g and 4·g 2 each;
 52. mlm train  the MLM config (8 layers, bf16, b16 t512) through `main`,
             8 steps and 2 valid: rows 1 and 4 launched 8 and 8 a training
             step; tokens/s, step p50, peak memory; then each flash kernel
             non-causal at [16, 512, 8, 64], held against its plain
             version and timed as in phase 11, beside its bound, its plain
             version and SDPA;
 53. translate step  f32, TF32 off: the translate width (dim 512, 8 heads,
             vocab 16384) at 2+2 layers, b4 src 64: loss and every
             gradient with flash against dense self-attention within 1e-4,
             rows 1·g and 4·g 4 each (2 encoder non-causal, 2 decoder
             causal); `cached_translate` token-exact against
             `greedy_translate` on 4 sequences of 64 tokens (a near tie,
             top-2 margin < 1e-5, reported);
 54. translate train  the translate config (6+6 layers, bf16, b32 src
             64) through `main`, 8 steps, 2 valid, translate_every 1: rows
             1 and 4 launched 12 and 12 a training step (6 encoder calls
             non-causal, 6 decoder calls causal, counted), tokens/s, step
             p50, tok_acc and seq_acc (no bar); then each flash kernel at
             [32, 64, 8, 64], causal and not, as in phase 52.

ROADMAP queue A item 10, the serving fleet, last:

 55. fleet demo  `python -m flashy_tpu_torch.serve.fleet --kernel fused`
             (`main`, in this process) with its five legs and default
             gates: handoff, sticky, preempt, drill and wal, the wal
             leg's SIGKILLed worker a second process on the card, which
             loads the kernel libraries this process built;
 56. fleet exact  the 235M layout in f32 (TF32 off) on the `exact`
             workload, 16 new tokens, through a fleet of 2 members x 4
             slots (one compile cache, sealed after both warmed) whose
             engine0 is killed at its 5th step (`fleet.engine_step`,
             strict), a DisaggregatedPair (2 prefill + 4 decode slots over
             one pool and one CacheBox) and a WAL recovery in this
             process: every stream token-exact against `generate` (near
             ties reported), the pools conserved, row 5 launched once a
             layer a step of every engine, nothing built or captured
             after each build's own warm-up, one completion record a uid;
 57. fleet serve bf16  the 235M layout in bf16, 32 requests of 128
             tokens (every second opening with a 64-token system prefix)
             x 128 new, in turns: (a) a sticky fleet of 2 x 8 slots,
             (a+wal) the same with a RequestWAL (the cost of durable
             admission), (b) round-robin, (c) one engine of 16 slots, (d)
             a DisaggregatedPair of 2 prefill + 8 decode slots: tokens/s,
             step p50s (a member's and the fleet's), TTFT p50 and p95,
             prefix hit rate, route reasons, the fleet step's host time
             outside its members, row 5 launches == reads; (d)'s handoff
             host us a request and its streams against (c)'s (a stream
             that differs is reported with its first differing position
             and the top-2 margin there).

The last two lines of standard output are the kernels' JSON record and
`{"ok": true, "device": {...}}`; the card's name and power limit come
before them. Each kernel's record also holds its launches on the model
layouts' paths (`layout_launches`, by phase).
"""
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STARTED = time.time()       # this process's start, for the dp phases' split
NEAR_TIE = 1e-5
D128_HEADS = 8                 # the d128 layout: 8 heads of 128
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8/float32": 1e-5,
       "int8/bfloat16": 2e-2}
# bf16 kernel vs the entry-by-entry reference: within one bf16 ulp of
# |want| (a floor of 2^-10 near zero), and at most this share of the
# outputs not bit-equal (a rounding point moved by a tile of four
# entries makes ~15% of them differ)
PLACEMENT_RTOL, PLACEMENT_ATOL, PLACEMENT_SHARE = 2 ** -7, 2 ** -10, 0.01
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def nonzero(counts):
    """The launch counts that are not zero."""
    return {key: value for key, value in counts.items() if value}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def model_config(torch, dtype, max_seq_len, attention="dense",
                 num_heads=16, num_layers=12, **kw):
    """The decode leg's 235M layout: vocab 32768, dim 1024, 12 layers,
    16 heads (head_dim 64), mlp_ratio 4; `num_heads=D128_HEADS` is the
    d128 layout (8 heads of 128, the same parameters)."""
    from flashy_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=32768, dim=1024,
                             num_layers=num_layers,
                             num_heads=num_heads, mlp_ratio=4,
                             max_seq_len=max_seq_len, dtype=dtype,
                             attention=attention, **kw)


def ssd_model_config(torch, dtype, max_seq_len):
    """The same layout with every mixer an SSD layer (state dim 16), its
    chunk pinned to the engine's prefill slice of 64 tokens: the
    equality that makes chunked prefill bit-equal to `generate`'s."""
    return model_config(torch, dtype, max_seq_len, mixer="ssd",
                        ssd_state_dim=16, ssd_chunk=SSD_CHUNK)


# ----------------------------------------------------------------------
# phase 2: kernel against plain version
# ----------------------------------------------------------------------
PAGED_SOURCE = "flashy_tpu_torch/csrc/paged_decode.cu"
PAGED_REPLACES = {"dense": "flashy_tpu/ops/paged_decode.py:207",
                  "quant": "flashy_tpu/ops/paged_decode.py:200"}


def random_case(torch, device, *, q_dtype, kv, T, B=8, H=16, Dh=64, bs=16,
                E=32, seed=0):
    """Random pool + tables + consecutive positions at the serving widths.

    Slots: ragged live lengths with sentinel-padded tables, one
    all-sentinel table, and one parked slot (base == E*bs, garbage in
    both versions, excluded from the comparison). Returns the kernel's
    arguments and the boolean [B] mask of live slots.
    """
    from flashy_tpu_torch.models.quantize import quantize_kv
    g = torch.Generator(device=device).manual_seed(seed)
    n = 1 + B * E
    shape = (n, bs, H, Dh)
    k = torch.randn(shape, generator=g, device=device)
    v = torch.randn(shape, generator=g, device=device)
    if kv == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        entry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        entry = {"k": k.to(q_dtype), "v": v.to(q_dtype)}
    max_len = E * bs
    table = torch.zeros((B, E), dtype=torch.int32)
    base = torch.zeros(B, dtype=torch.long)
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    lengths = torch.randint(1, max_len - T + 2, (B,),
                            generator=torch.Generator().manual_seed(seed + 1))
    for b in range(B):
        if b == B - 1:           # parked slot
            base[b] = max_len
            continue
        base[b] = lengths[b] - 1
        if b == B - 2:           # all-sentinel table
            continue
        live = (int(base[b]) + T - 1) // bs + 1
        table[b, :live] = perm[b * E:b * E + live].to(torch.int32)
    positions = (base[:, None] + torch.arange(T)[None]).to(device)
    q = torch.randn((B, T, H, Dh), generator=g, device=device).to(q_dtype)
    live = base + T <= max_len
    return q, entry, table.to(device), positions, live.to(device)


# (head_dim, block size, table entries) of the kernel checks. At head_dim
# 64 (paged_decode.cu): the engine's block 16 at the `exact` phase's width
# and blocks of 4, 16 and 64 over 2048 keys, which wrap the kernel's
# 4-stage ring of 64 keys eight times. On the general route
# (paged_general.cu): the d128 phases' head_dim 128 at the engine's block
# 16, at 12 and at 128 (blocks paged_decode.cu does not take), head_dim
# 32, head_dim 64 at block 12, and three shapes whose 64 query rows do
# not fit in one block's shared memory with f32 q (the kernel splits them
# into groups of rows): head_dim 256 at block 16 and block 256 at head_dim
# 128 and 256 (an entry's max over four 64-key chunks, then its scores
# again, exp, sums and P.V chunk by chunk); block 200 (a short last
# chunk), and one table entry of 1024 keys at head_dim 256 (16 chunks).
PAGED_CASES = ((64, 16, 32), (64, 4, 512), (64, 16, 128), (64, 64, 32),
               (128, 16, 32), (128, 12, 43), (128, 128, 4), (32, 16, 32),
               (64, 12, 43), (256, 16, 16), (128, 256, 2), (256, 256, 2),
               (128, 200, 3), (256, 1024, 1))
# the one-block read `time_paged_block` times: (slots, heads, head_dim,
# keys), one table entry of 16384 keys at head_dim 256
PAGED_BLOCK = (8, 8, 256, 16384)
SPEC_K = 4                     # drafts a verify step scores (T = 5)
# query rows a slot: decode, the speculative verify step (SPEC_K + 1),
# prefill slices
PAGED_T = (1, 4, SPEC_K + 1, 16, 64)


def check_kernels(torch, device, card=""):
    """Both routes of the paged read against the plain version on the
    card (and, in bf16, against the entry-by-entry reference) over
    PAGED_CASES x PAGED_T x the four variants; two launches on
    the same inputs bit-equal; every launch counted on the route its shape
    picks. Returns {launch counter name: max_abs_err against plain}."""
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.ops.paged_attention import paged_attention
    errors, shares = {}, {}
    for q_dtype, kv in ((torch.float32, "model"), (torch.bfloat16, "model"),
                        (torch.float32, "int8"), (torch.bfloat16, "int8")):
        name = str(q_dtype).split(".")[1]
        label = name if kv == "model" else f"int8/{name}"
        for dim, bs, entries in PAGED_CASES:
            route = paged_decode.kernel_route(dim, bs)
            counter = ("paged_decode" if kv == "model" else
                       "paged_decode_int8") + (
                           "" if route == "paged_decode" else "_general")
            for T in PAGED_T:
                q, entry, table, positions, live = random_case(
                    torch, device, q_dtype=q_dtype, kv=kv, T=T, bs=bs,
                    E=entries, Dh=dim, seed=T + bs + dim - 64)
                args = (q, entry, table, positions)
                kw = {"head_dim": dim, "dtype": q_dtype}
                where = f"kernel {label} Dh={dim} bs={bs} E={entries} T={T}"
                before = paged_decode.launch_counts[counter]
                full = paged_decode.fused_paged_attention(*args, **kw)
                again = paged_decode.fused_paged_attention(*args, **kw)
                if paged_decode.launch_counts[counter] != before + 2:
                    fail(f"{where}: not launched on {counter}")
                if not torch.equal(full, again):
                    fail(f"{where}: two launches on the same inputs differ")
                got = full[live].float()
                if q_dtype == torch.float32:
                    # the plain version in f64: its f32 sums drift by up
                    # to ~4e-5 on the card over 2048 repeated keys
                    want = paged_attention(q.double(), *args[1:],
                                           head_dim=dim,
                                           dtype=torch.float64)[live]
                    err = (got.double() - want).abs().max().item()
                else:
                    want = paged_attention(*args, **kw)[live].float()
                    err = (got - want).abs().max().item()
                if not math.isfinite(err) or err > TOL[label]:
                    fail(f"{where}: max abs err {err} > {TOL[label]}")
                errors[counter] = max(errors.get(counter, 0.0), err)
                if q_dtype == torch.bfloat16:
                    ref = paged_decode.entrywise_paged_attention(
                        *args, **kw)[live].float()
                    excess = ((got - ref).abs() - PLACEMENT_RTOL * ref.abs()
                              ).max().item()
                    share_t = (got != ref).float().mean().item()
                    if excess > PLACEMENT_ATOL or share_t > PLACEMENT_SHARE:
                        fail(f"{where}: against the entry-by-entry reference "
                             f"{excess:.3e} over one ulp (limit "
                             f"{PLACEMENT_ATOL}), {share_t:.4f} of outputs "
                             f"differ (limit {PLACEMENT_SHARE})")
                    shares[counter] = max(shares.get(counter, 0.0), share_t)
        plain = "plain in f64" if q_dtype == torch.float32 else "plain"
        for route in ("paged_decode", "general"):
            counter = ("paged_decode" if kv == "model" else
                       "paged_decode_int8") + (
                           "" if route == "paged_decode" else "_general")
            cases = [c for c in PAGED_CASES
                     if paged_decode.kernel_route(c[0], c[1]) == route]
            placement = (f"; vs entry-by-entry reference: "
                         f"{shares[counter]:.4f} of outputs differ (limit "
                         f"{PLACEMENT_SHARE}), each within one ulp"
                         if q_dtype == torch.bfloat16 else "")
            print(f"kernel {label} ({counter}): (Dh, bs, E) in {cases} x T "
                  f"in {PAGED_T} max_abs_err={errors[counter]:.3e} vs "
                  f"{plain} (tolerance {TOL[label]}){placement}; two "
                  f"launches bit-equal [{card}]", flush=True)
    # the shape picks the kernel: (block size, head_dim) -> route
    for (bs, dim), route in (((12, 64), "general"), ((128, 64), "general"),
                             ((16, 32), "general"), ((16, 128), "general"),
                             ((16, 64), "paged_decode")):
        if paged_decode.kernel_route(dim, bs) != route:
            fail(f"kernel: bs={bs} head_dim={dim} does not route to {route}")
    return errors


# ----------------------------------------------------------------------
# phase 4: token-exact serving in f32
# ----------------------------------------------------------------------
def exact_workload(rng, vocab):
    """12 prompts straddling 16-token block boundaries; the last six
    share a 48-token prefix. The first eight fill the 8 slots at once;
    the last four are admitted after retirements, when the prefix
    blocks of the 49- and 64-token prompts are indexed: full-block hits
    for all four, and copy-on-write forks for the two that share 8 and
    10 tokens of the 64-token prompt's fourth block."""
    import numpy as np
    prefix = rng.integers(1, vocab, 48)
    tail = rng.integers(1, vocab, 16)

    def shared(n_tail, n):
        return np.concatenate([prefix, tail[:n_tail],
                               rng.integers(1, vocab, n - 48 - n_tail)])

    prompts = [rng.integers(1, vocab, n) for n in (15, 16, 17, 31, 32, 33)]
    prompts += [shared(1, 49), shared(16, 64), shared(16, 65),
                shared(8, 97), shared(10, 100), shared(0, 200)]
    return prompts


def top2_margin(torch, model, stream, params=None):
    """f32 top-2 logit margin after `stream` (a prefill of the whole
    stream through the dense-cache step `generate` uses, on `params` when
    given)."""
    from flashy_tpu_torch.models.decoding import (_apply_step,
                                                  decode_params, init_cache)
    cfg = model.config
    device = model.device
    tokens = torch.as_tensor(stream, device=device)[None]
    cache = init_cache(cfg, 1, tokens.shape[1], device)
    positions = torch.arange(tokens.shape[1], device=device)[None]
    with torch.no_grad():
        logits, _ = _apply_step(decode_params(model, params=params), cfg,
                                tokens, positions, cache, 0)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def serve(torch, engine, prompts, max_new, draft=None, tracing=None,
          metrics=None):
    """Serve `prompts` (`max_new` new tokens each, or a list of them)
    through the scheduler, with `draft` speculative, `tracing` (a
    RequestTracer) and `metrics` (a ServeMetrics) when given, with every
    launch count and step count set to 0 just before; the engine's
    compile cache must make no new entry and no capture in the run (every
    step a replay of a graph `warmup()` captured, or, with
    cuda_graphs=False, an eager run of a warmed key). Returns (scheduler,
    requests, the launch counts of this run, seconds)."""
    from flashy_tpu_torch.ops import paged_decode, ssd_scan
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    scheduler = ContinuousBatchingScheduler(engine, draft=draft,
                                            tracing=tracing, metrics=metrics)
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    requests = [scheduler.submit(p, n) for p, n in zip(prompts, news)]
    engine.step_counts = dict.fromkeys(engine.step_counts, 0)
    before = engine.compile_cache.stats()
    paged_decode.reset_launch_counts()
    ssd_scan.reset_launch_counts()
    t0 = time.perf_counter()
    scheduler.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {**paged_decode.launch_counts, **ssd_scan.launch_counts}
    after = engine.compile_cache.stats()
    if after["misses"] != before["misses"] or after["recompiles"] != 0:
        fail(f"serve: the compile cache built or captured during traffic: "
             f"{before} -> {after}")
    if engine.pool is not None:
        engine.pool.check()
    return scheduler, requests, counts, seconds


def decode_host_us(torch, engine, calls=20):
    """Host microseconds of one decode step as enqueued (the graph's
    replay, or the eager step's ~170 launches), over parked slots (their
    writes land in the sentinel block), without the step's read of the
    tokens to the host."""
    step = engine.compile_cache.executables()[f"decode/{engine.slots}"]
    return host_us(torch, lambda: step(*engine._decode_args()), calls=calls)


# the eager twin's traffic: an eager step costs ~15 replays (`graphs vs
# eager` lines), so the twin runs the phase's first EAGER_REQUESTS
# prompts at EAGER_NEW new tokens each (the phase's own traffic cut in
# depth), beside a fresh graph engine on the same cut traffic
EAGER_REQUESTS, EAGER_NEW = 8, 32


def eager_twin(torch, model, engine, engine_kw, prompts, max_new, requests,
               counts, label, card, prompt_lengths=()):
    """The phase's first EAGER_REQUESTS prompts, at EAGER_NEW new tokens
    a request, through a twin engine with cuda_graphs=False (the steps
    eager) and a fresh graph engine on the same model: every stream
    bit-identical between the two and a prefix of the phase's own stream,
    the launch counts equal; prints the eager run's tokens/s and
    decode-step p50 and both engines' host us a decode step. Returns the
    eager run's metrics summary."""
    import numpy as np
    from flashy_tpu_torch.serve.engine import DecodeEngine
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    prompts, requests = prompts[:EAGER_REQUESTS], requests[:EAGER_REQUESTS]
    cut = [min(n, EAGER_NEW) for n in news[:EAGER_REQUESTS]]
    g_requests, g_counts = requests, counts
    if cut != news:
        twin = DecodeEngine(model, **engine_kw)
        twin.warmup(prompt_lengths)
        _, g_requests, g_counts, _ = serve(torch, twin, prompts, cut)
        for full, short, n in zip(requests, g_requests, cut):
            if not np.array_equal(full.output[:len(full.prompt) + n],
                                  short.output):
                fail(f"{label}: request {full.uid}'s stream at {n} new "
                     f"tokens is not a prefix of its stream at "
                     f"{full.max_new_tokens}")
        del twin
    eager = DecodeEngine(model, cuda_graphs=False, **engine_kw)
    eager.warmup(prompt_lengths)
    e_scheduler, e_requests, e_counts, _ = serve(torch, eager, prompts, cut)
    for got, want in zip(g_requests, e_requests):
        if not np.array_equal(got.output, want.output):
            fail(f"{label}: request {got.uid}'s stream differs between "
                 f"graphs and eager")
    if nonzero(g_counts) != nonzero(e_counts):
        fail(f"{label}: launches with graphs {nonzero(g_counts)}, eager "
             f"{nonzero(e_counts)}")
    graphs = engine.compile_cache
    if not all(getattr(fn, "captured", False)
               for fn in graphs.executables().values()):
        fail(f"{label}: a step of the graph engine was not captured")
    host = {what: decode_host_us(torch, eng)
            for what, eng in (("graphs", engine), ("eager", eager))}
    e_summary = e_scheduler.metrics.summary()
    print(f"{label}: graphs vs eager on {len(cut)} requests at {max(cut)} "
          f"new tokens: streams bit-identical (prefixes of the phase's "
          f"{max(news)}), launches equal {nonzero(e_counts)}; eager "
          f"tokens/s={e_summary['tokens_per_sec']:.1f}, decode step p50="
          f"{e_summary['itl_ms_p50']:.3f} ms; host us a decode step: graphs "
          f"{host['graphs']:.1f}, eager {host['eager']:.1f}; compile cache "
          f"{graphs.stats()} ({', '.join(graphs.executables())}), eager "
          f"{eager.compile_cache.stats()} [{card}]", flush=True)
    del eager
    return e_summary


def check_sampling(torch, device, card):
    """Two replays of the captured decode step at temperature 1.0 on the
    same inputs draw differently: the engine's generator is registered
    with the graph, so each replay advances it."""
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    model = TransformerLM(model_config(torch, torch.bfloat16, 256),
                          device=device, seed=1)
    generator = torch.Generator(device=device).manual_seed(0)
    engine = DecodeEngine(model, slots=8, block_size=16, max_seq_len=256,
                          temperature=1.0, generator=generator,
                          cache_layout="paged", device=device)
    engine.warmup()
    draws = []
    for _ in range(2):
        for slot in range(engine.slots):
            engine._set_slot(slot, 5, 3, True)   # writes land in sentinel
        draws.append(engine.decode())
    engine._reset_slot_state()
    stats = engine.compile_cache.stats()
    if (draws[0] == draws[1]).all() or stats["recompiles"]:
        fail(f"sampling: two replays at temperature 1.0 drew {draws} "
             f"(cache {stats})")
    print(f"sampling: two replays of the captured decode step at "
          f"temperature 1.0 on the same inputs drew {draws[0].tolist()} "
          f"and {draws[1].tolist()}; compile cache {stats} [{card}]",
          flush=True)


def check_capture_gc(torch, device, card):
    """A garbage collection due inside a capture does not run there: a
    warmed engine is dropped while no collection runs (its graphs are
    garbage, held by the cycle between each step and its cache), then a
    second engine warms with a collection due at every allocation from
    the moment its first capture begins. Were the collection to run, it
    would free the dropped graphs inside the capture, and `cudaFree`
    there invalidates it (cudaErrorStreamCaptureInvalidated)."""
    import gc
    from flashy_tpu_torch.serve.__main__ import _build_model
    from flashy_tpu_torch.serve.engine import DecodeEngine
    model = _build_model(64, 0, device)
    kw = dict(slots=4, cache_layout="paged", block_size=8, spec_k=SPEC_K,
              device=device)
    thresholds = gc.get_threshold()
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(graph, *args, **kwargs):
        begin(graph, *args, **kwargs)
        torch.cuda.CUDAGraph.capture_begin = begin
        gc.set_threshold(1, 1, 1)

    gc.collect()
    gc.set_threshold(1 << 30)    # no collection, nothing promoted
    try:
        dropped = DecodeEngine(model, cache_scope="dropped", **kw)
        dropped.warmup()
        graphs = len(dropped.compile_cache.executables())
        del dropped
        torch.cuda.CUDAGraph.capture_begin = capture_begin
        engine = DecodeEngine(model, **kw)
        engine.warmup()
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
        gc.set_threshold(*thresholds)
    if not all(getattr(fn, "captured", False)
               for fn in engine.compile_cache.executables().values()):
        fail("capture gc: a step of the second engine was not captured")
    print(f"capture gc: {graphs} graphs of a dropped engine left to the "
          f"collector, a collection due at every allocation from the "
          f"second engine's first capture on: its "
          f"{len(engine.compile_cache.executables())} steps captured "
          f"[{card}]", flush=True)


def reference_streams(torch, model, prompts, max_new, device, params=None):
    """The port's `generate` stream of each prompt (`max_new` new tokens
    each, or a list of them), on `params` when given."""
    from flashy_tpu_torch.models.decoding import generate
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    return [generate(model, p[None], max_new_tokens=n, params=params,
                     device=device)[0].cpu().numpy()
            for p, n in zip(prompts, news)]


def check_streams(torch, model, prompts, requests, max_new, device, label,
                  refs=None, params=None):
    """Every request's output against the port's `generate` (or against
    `refs`, longer streams of it, cut to the output), token-exact up to
    near ties (top-2 f32 margin < NEAR_TIE at the first divergence,
    reported); `params` as `generate`'s. Returns the near ties."""
    import numpy as np
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    if refs is None:
        refs = reference_streams(torch, model, prompts, news, device, params)
    ties = []
    for prompt, request, ref, n in zip(prompts, requests, refs, news):
        got = request.output
        ref = ref[:len(prompt) + n]
        if got.shape != ref.shape:
            fail(f"{label}: request {request.uid} output shape {got.shape} "
                 f"!= {ref.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            first = int(diff[0])
            margin = top2_margin(torch, model, ref[:first], params)
            if margin >= NEAR_TIE:
                fail(f"{label}: request {request.uid} (prompt {len(prompt)}) "
                     f"diverges at position {first} with top-2 margin "
                     f"{margin:.3e} >= {NEAR_TIE}")
            ties.append((request.uid, first, margin))
    return ties


def phase_exact(torch, device, card="", heads=16, block_size=16,
                max_seq_len=512, chunk=None, label="exact"):
    """The layout with `heads` heads in f32 served through the paged
    engine at `block_size`: every stream token-exact against `generate`,
    every read launched on the shape's route. The workload's prefix hits
    and copy-on-write forks are required at block 16, which it was made
    for. Returns the launches."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.float32, 512, num_heads=heads)
    model = TransformerLM(cfg, device=device, seed=0)
    engine = DecodeEngine(model, slots=8, block_size=block_size,
                          max_seq_len=max_seq_len, chunk=chunk,
                          cache_layout="paged", device=device)
    if device.type == "cuda" and engine.kernel != "fused":
        fail(f"engine resolved kernel={engine.kernel!r} on CUDA")
    engine.warmup()
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    max_new = 32
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    reads = cfg.num_layers * (engine.step_counts["decode"]
                              + engine.step_counts["prefill_chunk"])
    route = paged_decode.kernel_route(cfg.head_dim, block_size)
    name = "paged_decode" if route == "paged_decode" \
        else "paged_decode_general"
    launched = counts[name]
    if engine.kernel == "fused" and nonzero(counts) != {name: reads}:
        fail(f"{label}: launches {nonzero(counts)}, engine made {reads} "
             f"attention reads on {name}")
    ties = check_streams(torch, model, prompts, requests, max_new, device,
                         label)
    stats = engine.pool_stats()
    if block_size == 16 and (stats["cow_forks"] < 1
                             or stats["prefix_hit_rate"] <= 0):
        fail(f"{label}: workload made no prefix hit / COW fork: {stats}")
    print(f"{label}: {cfg.num_heads} heads of {cfg.head_dim}, block "
          f"{block_size}, max_seq_len {engine.max_seq_len}, chunk "
          f"{engine.chunk}: {len(requests)} requests token-exact vs generate "
          f"(near ties {ties}), launches {name}={launched} == reads={reads}, "
          f"decode steps={engine.step_counts['decode']}, prefill "
          f"chunks={engine.step_counts['prefill_chunk']}, prefix hit rate="
          f"{stats['prefix_hit_rate']:.3f}, cow forks={stats['cow_forks']}, "
          f"CUDA graphs {engine.compile_cache.stats()}, {seconds:.2f}s "
          f"[{card}]", flush=True)
    return launched


# ----------------------------------------------------------------------
# phases 5-6: bf16 serving and timing
# ----------------------------------------------------------------------
def time_ms(torch, fn, iters=50, device_only=False):
    """Mean ms per call over `iters` calls, CUDA events, after warm-up.
    With `device_only` a ~10 ms device sleep goes first, so the host
    enqueues the timed calls while the card sleeps and the events
    bracket their device time, however slow the wrapper's host side."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(20_000_000)     # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_runs(torch, fn, iters, runs=3):
    """`runs` device-time timings of `time_ms` in this call: {"ms": their
    median, "ms_runs": each, "spread": (max - min) / median}."""
    got = sorted(time_ms(torch, fn, iters=iters, device_only=True)
                 for _ in range(runs))
    median = got[len(got) // 2]
    return {"ms": median, "ms_runs": got,
            "spread": (got[-1] - got[0]) / median}


def spread_text(t):
    """'ms=... (runs a/b/c, spread x%)' of a `time_runs` result."""
    return (f"ms={t['ms']:.4f} (runs " + "/".join(
        f"{x:.4f}" for x in t["ms_runs"]) + f", spread "
        f"{100 * t['spread']:.1f}%)")


def time_kernel(torch, engine, context, queries=1):
    """Time one layer's paged read at the serving shapes: every slot's
    `queries` rows ending at `context` tokens, over the engine's own
    pool (layer 0). T=1 is a decode step, T=chunk a prefill chunk (the
    engine's own chunks are one slot's: the same per-slot work). Device
    time: the kernel three times (`time_runs`), its plain version and
    SDPA on the gathered view behind the same device sleep; the
    wrapper's host us a call apart."""
    import torch.nn.functional as F
    from flashy_tpu_torch.ops.paged_attention import (gather_kv,
                                                      paged_attention)
    from flashy_tpu_torch.ops.paged_decode import (
        decode_read_bytes_per_token, fused_paged_attention)
    cfg = engine._cfg
    entry = engine.cache_box.value["block_0"]
    slots, bs = engine.slots, engine.block_size
    live = -(-context // bs)
    entries = engine.pool.max_blocks
    table = torch.zeros((slots, entries), dtype=torch.int32)
    for b in range(slots):
        table[b, :live] = torch.arange(1 + b * live, 1 + (b + 1) * live)
    table = table.to(engine.device)
    g = torch.Generator(device=engine.device).manual_seed(0)
    q = torch.randn((slots, queries, cfg.num_heads, cfg.head_dim),
                    generator=g, device=engine.device).to(cfg.dtype)
    positions = (context - queries + torch.arange(
        queries, device=engine.device)).expand(slots, queries)
    args = (q, entry, table, positions)
    kw = {"head_dim": cfg.head_dim, "dtype": cfg.dtype}
    kernel = lambda: fused_paged_attention(*args, **kw)  # noqa: E731
    runs = time_runs(torch, kernel, iters=50)
    plain_ms = time_ms(torch, lambda: paged_attention(*args, **kw),
                       iters=10, device_only=True)
    k_view, v_view = gather_kv(entry, table, cfg.dtype)
    key_pos = torch.arange(k_view.shape[1], device=engine.device)
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, None]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k_view, v_view))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), device_only=True)
    per_layer = decode_read_bytes_per_token(cfg, context, engine.kv_dtype) \
        // cfg.num_layers
    nbytes = (slots * per_layer + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + slots * 4)
    # q.k and p.v over the visible keys of each query row
    visible = sum(context - queries + 1 + t for t in range(queries))
    flops = 4 * slots * cfg.num_heads * visible * cfg.head_dim
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / (BF16_FLOPS if cfg.dtype == torch.bfloat16
                       else F32_FLOPS) * 1e3
    return {**runs, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
            "bytes": nbytes, "host_us": host_us(torch, kernel)}


def time_paged_block(torch, device, card):
    """The paged read's general route at one table entry of many keys
    (PAGED_BLOCK: 8 slots, 8 heads of 256, one block of 16384 keys, bf16,
    T=1 at the last key, so every key is visible): held against the plain
    version (2e-2) and against the entry-by-entry reference within one
    ulp, two launches bit-equal, then timed three times beside its bound
    (bytes), its plain version and SDPA on the gathered view. The share
    of outputs not bit-equal to the reference is printed, not held to
    PLACEMENT_SHARE: over one entry of 16384 keys the kernel's sequential
    f32 chains (each lane's sum, each output's P.V) and the reference's
    torch sums round differently in ~1.5% of the bf16 outputs (measured,
    NVIDIA H100 80GB HBM3, 700.00 W), where a misplaced rounding point
    moves ~15%; check_kernels holds the rounding placement at one entry
    of 1024 keys. Returns (times, max abs err vs plain)."""
    import torch.nn.functional as F
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.ops.paged_attention import (gather_kv,
                                                      paged_attention)
    slots, heads, dim, keys = PAGED_BLOCK
    dtype = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(11)
    shape = (1 + slots, keys, heads, dim)
    entry = {name: torch.randn(shape, generator=g, device=device).to(dtype)
             for name in ("k", "v")}
    table = torch.arange(1, 1 + slots, dtype=torch.int32,
                         device=device)[:, None]
    positions = torch.full((slots, 1), keys - 1, dtype=torch.long,
                           device=device)
    q = torch.randn((slots, 1, heads, dim), generator=g, device=device
                    ).to(dtype)
    args = (q, entry, table, positions)
    kw = {"head_dim": dim, "dtype": dtype}
    where = (f"paged one block: {slots} slots, {heads} heads of {dim}, "
             f"{keys} keys")
    if paged_decode.kernel_route(dim, keys) != "general":
        fail(f"{where}: not on the general route")
    before = paged_decode.launch_counts["paged_decode_general"]
    got = paged_decode.fused_paged_attention(*args, **kw)
    again = paged_decode.fused_paged_attention(*args, **kw)
    if paged_decode.launch_counts["paged_decode_general"] != before + 2:
        fail(f"{where}: not launched on paged_decode_general")
    if not torch.equal(got, again):
        fail(f"{where}: two launches on the same inputs differ")
    ref = paged_decode.entrywise_paged_attention(*args, **kw).float()
    excess = ((got.float() - ref).abs() - PLACEMENT_RTOL * ref.abs()
              ).max().item()
    share = (got.float() != ref).float().mean().item()
    if excess > PLACEMENT_ATOL:
        fail(f"{where}: against the entry-by-entry reference {excess:.3e} "
             f"over one ulp ({share:.4f} of outputs differ)")
    plain = lambda: paged_attention(*args, **kw)  # noqa: E731
    err = (got.float() - plain().float()).abs().max().item()
    if not math.isfinite(err) or err > TOL["bfloat16"]:
        fail(f"{where}: max abs err vs plain {err} > {TOL['bfloat16']}")
    kernel = lambda: paged_decode.fused_paged_attention(*args, **kw)  # noqa
    k_view, v_view = gather_kv(entry, table, dtype)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k_view, v_view))
    nbytes = (2 * slots * keys * heads * dim * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + positions.numel() * 8)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = 4 * slots * heads * keys * dim / BF16_FLOPS * 1e3
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
    times = {**time_runs(torch, kernel, iters=5),
             "plain_ms": time_ms(torch, plain, iters=3, device_only=True),
             "library_ms": time_ms(torch, sdpa, iters=10, device_only=True),
             "bound_ms": max(byte_ms, flop_ms),
             "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
             "host_us": host_us(torch, kernel, calls=5)}
    print(f"{where} (T=1 at the last key, bf16): vs entry-by-entry "
          f"reference {share:.4f} of outputs differ (f32 sum order over "
          f"one entry), each within one ulp; vs plain max abs err "
          f"{err:.3e} (tolerance {TOL['bfloat16']}); two launches "
          f"bit-equal; device {spread_text(times)} bound_ms="
          f"{times['bound_ms']:.4f} ({times['bound_by']}, {nbytes} B) "
          f"plain_ms={times['plain_ms']:.4f} library_ms(sdpa on gathered "
          f"view)={times['library_ms']:.4f} host_us={times['host_us']:.1f} "
          f"[{card}]", flush=True)
    return times, err


def device_rows(torch, prof):
    """(device ms, launches, name) per CUDA kernel of a profile, largest
    first."""
    rows = []
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their kernels are listed on their own
        us = event.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    return rows


def profile_serve(torch, engine, vocab, n_requests, prompt_len, max_new,
                  card, prompts=None, make_draft=None, label="profile"):
    """Where the serving time goes: serve the same shape of work twice
    (fresh random prompts each time, so neither run hits the prefix
    cache; `prompts(rng)` makes them, by default uniform tokens), with a
    fresh `make_draft()` each time when given, once plainly for the wall
    time and once under torch.profiler for the device time by kernel.
    Idle share = 1 - device busy / plain wall (the profiler's own host
    overhead stays out of the wall)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    if prompts is None:
        def prompts(rng):
            return [rng.integers(1, vocab, prompt_len)
                    for _ in range(n_requests)]

    def run():
        return serve(torch, engine, prompts(rng), max_new,
                     draft=make_draft() if make_draft else None)

    *_, wall_s = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = device_rows(torch, prof)
    busy_ms = sum(ms for ms, _, _ in rows)
    wall_ms = wall_s * 1e3
    top = "; ".join(f"{key[:40]} {ms:.1f} ms x{n}" for ms, n, key in rows[:6])
    ours = "; ".join(f"{name} {ms:.2f} ms x{n} ({ms / busy_ms:.3f} of "
                     f"busy)" for ms, n, key in rows
                     for name in ("paged_decode_kernel", "ssd_bf16_kernel",
                                  "ssd_fma_kernel")
                     if name in key)
    print(f"{label}: {n_requests} requests x prompt {prompt_len} x "
          f"{max_new} new, plain wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"decode steps {engine.step_counts['decode']}, prefill chunks "
          f"{engine.step_counts['prefill_chunk']}, verify steps "
          f"{engine.step_counts['verify']}; top: {top}; the path's "
          f"own kernels: {ours} [{card}]", flush=True)


def phase_serve(torch, device, card, *, kv_dtype, requests_n, prompt_len,
                max_new, label, heads=16, compare_eager=False):
    """bf16 serving through the paged engine's captured decode and prefill
    steps: launches on every read, kernel times at T=1 and T=chunk, a
    profiled window (heads 16, model pools); with `compare_eager` the same
    traffic through an eager twin (`eager_twin`). Returns (launches, their
    split by T, the T=1 timing, the T=chunk timing)."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.bfloat16, 256, num_heads=heads)
    model = TransformerLM(cfg, device=device, seed=1)
    engine_kw = dict(slots=8, block_size=16, max_seq_len=256,
                     kv_dtype=kv_dtype, cache_layout="paged", device=device)
    engine = DecodeEngine(model, **engine_kw)
    if engine.kernel != "fused":
        fail(f"{label}: engine resolved kernel={engine.kernel!r} on CUDA")
    engine.warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    name = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    if paged_decode.kernel_route(cfg.head_dim, 16) == "general":
        name += "_general"
    steps = dict(engine.step_counts)
    split = {"T=1": cfg.num_layers * steps["decode"],
             f"prefill T<={engine.chunk}":
                 cfg.num_layers * steps["prefill_chunk"]}
    if counts[name] < 1 or nonzero(counts) != {name: sum(split.values())}:
        fail(f"{label}: launches {nonzero(counts)}, the engine made "
             f"{sum(split.values())} attention reads on {name}")
    for request in requests:
        out = request.output
        if out.shape != (prompt_len + max_new,) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            fail(f"{label}: request {request.uid} output malformed")
    summary = scheduler.metrics.summary()
    timing = time_kernel(torch, engine, prompt_len + max_new // 2)
    chunk = time_kernel(torch, engine, prompt_len, queries=engine.chunk)
    for what, t_ in ((f"T=1 context {prompt_len + max_new // 2}", timing),
                     (f"T={engine.chunk} context {prompt_len} (last "
                      f"prefill chunk)", chunk)):
        print(f"{label}: kernel {what}: device {spread_text(t_)} "
              f"bound_ms={t_['bound_ms']:.4f} ({t_['bound_by']}, "
              f"{t_['bytes']} B) plain_ms={t_['plain_ms']:.4f} "
              f"library_ms(sdpa on gathered view)={t_['library_ms']:.4f} "
              f"host_us={t_['host_us']:.1f} [{card}]", flush=True)
    if kv_dtype == "model" and heads == 16:
        profile_serve(torch, engine, cfg.vocab_size, 8, prompt_len, 32,
                      card)
    print(f"{label}: {requests_n} requests x {max_new} new, "
          f"tokens/s={summary['tokens_per_sec']:.1f}, decode step "
          f"p50={summary['itl_ms_p50']:.3f} ms, {seconds:.2f}s; "
          f"launches={counts[name]} == reads (" + ", ".join(
              f"{k} {v}" for k, v in split.items()) + f"); CUDA graphs "
          f"{engine.compile_cache.stats()} [{card}]", flush=True)
    if compare_eager:
        eager_twin(torch, model, engine, engine_kw, prompts, max_new,
                   requests, counts, label, card)
    return counts[name], split, timing, chunk


# ----------------------------------------------------------------------
# phase 3: flash kernels against plain versions
# ----------------------------------------------------------------------
FLASH_SOURCE = "flashy_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "flashy_tpu/ops/attention.py:113",
                  "flash_bwd_dq": "flashy_tpu/ops/attention.py:182",
                  "flash_bwd_dkv": "flashy_tpu/ops/attention.py:230",
                  "flash_bwd_fused": "flashy_tpu/ops/attention.py:279"}
# (B, H, t_q, t_k, causal): square, t_k above t_q, t_k below t_q (the
# first 192 query rows see no key), ragged T
FLASH_CASES = ((2, 4, 256, 256, True), (2, 4, 256, 256, False),
               (2, 4, 128, 320, True), (2, 4, 320, 128, True),
               (1, 4, 200, 200, True), (1, 4, 100, 164, False))
# forward against its plain version: max abs error; backward against the
# plain versions: max abs error over the largest |value| (bf16 grads and
# the bf16 roundings of P and dS inside move by an ulp where the f32
# sums in front of them are ordered differently)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

LSE_TOL = 1e-4                 # f32 logsumexp, either dtype's inputs
STEP_REL_TOL = 1e-4            # f32 step: flash vs dense, per leaf


def flash_inputs(torch, device, dtype, B, H, t_q, t_k, D=64, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(t):
        return torch.randn((B, t, H, D), generator=g, device=device
                           ).to(dtype)

    return draw(t_q), draw(t_k), draw(t_k), draw(t_q)


def rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max().item()
            / max(want.abs().max().item(), 1e-30))


def compare_flash(torch, q, k, v, do, causal, label):
    """The four flash kernels against their plain versions on one input:
    the forward within the dtype's tolerance (and, in bf16, within one
    ulp of the blockwise reference with at most PLACEMENT_SHARE of the
    outputs not bit-equal), the backward kernels within it relative to
    the largest |value| (the fused kernel's dQ against the plain fused
    version's partials folded in k order), and the fused backward
    bit-equal to the split pair on dQ, dK and dV. Fails on any miss;
    returns ({kernel: max abs error against plain}, the share of forward
    outputs not bit-equal, out, dq)."""
    from flashy_tpu_torch.ops import attention as A
    tol = FLASH_TOL[str(q.dtype).split(".")[1]]
    out, lse = A.flash_forward(q, k, v, causal)
    ref, ref_lse = A.flash_forward_blockwise(q, k, v, causal)
    blk_err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if not math.isfinite(blk_err) or blk_err > tol or lse_err > LSE_TOL:
        fail(f"{label}: forward max abs err {blk_err} (limit {tol}), lse "
             f"{lse_err} (limit {LSE_TOL})")
    share = 0.0
    if q.dtype == torch.bfloat16:
        excess = ((out.float() - ref.float()).abs()
                  - PLACEMENT_RTOL * ref.float().abs()).max().item()
        share = (out != ref).float().mean().item()
        if excess > PLACEMENT_ATOL or share > PLACEMENT_SHARE:
            fail(f"{label}: against the blockwise reference {excess:.3e} "
                 f"over one ulp, {share:.4f} of outputs differ (limit "
                 f"{PLACEMENT_SHARE})")
    del ref, ref_lse

    delta = A.flash_delta(do, out)
    args = (q, k, v, do, lse, delta, causal)
    dq, dk, dv = A.flash_backward_split(*args)
    fq, fk, fv = A.flash_backward_fused(*args)
    if not (torch.equal(fq, dq) and torch.equal(fk, dk)
            and torch.equal(fv, dv)):
        fail(f"{label}: fused backward not bit-equal to split (dq "
             f"{torch.equal(fq, dq)}, dk {torch.equal(fk, dk)}, dv "
             f"{torch.equal(fv, dv)})")
    del fk, fv
    want_dq = A.flash_backward_dq_blockwise(*args)
    want_dk, want_dv = A.flash_backward_dkv_blockwise(*args)
    rels = {"flash_bwd_dq": rel_err(dq, want_dq),
            "flash_bwd_dkv": max(rel_err(dk, want_dk), rel_err(dv, want_dv))}
    errors = {
        "flash_fwd": blk_err,
        "flash_bwd_dq": (dq.float() - want_dq.float()).abs().max().item(),
        "flash_bwd_dkv": max(
            (dk.float() - want_dk.float()).abs().max().item(),
            (dv.float() - want_dv.float()).abs().max().item())}
    del want_dq, want_dk, want_dv
    want_fq = A.fold_dq_partials(A.flash_backward_fused_blockwise(*args)[2],
                                 q.dtype)
    rels["flash_bwd_fused"] = rel_err(fq, want_fq)
    errors["flash_bwd_fused"] = (fq.float() - want_fq.float()).abs().max(
        ).item()
    del fq, want_fq
    for key, rel in rels.items():
        if not math.isfinite(rel) or rel > tol:
            fail(f"{label}: {key} relative err {rel} > {tol}")
    return errors, share, out, dq


FLASH_GENERAL_SOURCE = "flashy_tpu_torch/csrc/flash_general.cu"
PAGED_GENERAL_SOURCE = "flashy_tpu_torch/csrc/paged_general.cu"
# head dims of the flash checks: 64 (the Hopper kernels), 128 (the d128
# path: the bf16 forward on the Hopper kernel built at 128, the rest on
# the general route), an odd 65, and 32, 80, 96 (general, one head-dim
# slab), 256, 320 and 576 (general, two, three and five slabs of 128;
# 576 is sarvam-105b's head); at 64 and 128 every FLASH_CASES case, at
# the others three (square causal, empty rows, ragged and not causal)
FLASH_DIMS = (64, 128, 32, 65, 80, 96, 256, 320, 576)
# the general route's widest timed head dim: (B, H, T, D) of `time_flash`
FLASH_WIDE = (2, 8, 512, 576)


def check_flash_kernels(torch, device, card):
    """The four flash kernels against their plain versions on small
    cases at every head dim of FLASH_DIMS (`compare_flash`: fused ==
    split bitwise), the forward against the dense path, rows with no
    visible key zero, every launch counted on the route its head dim and
    dtype pick; the general route's plan keeps shared memory bounded at
    every head dim. Returns {dtype: {launch counter name: max abs error
    against plain}}."""
    from flashy_tpu_torch.ops import attention as A
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = FLASH_TOL[name]
        worst = {}
        dense_err = share = 0.0
        for D in FLASH_DIMS:
            cases = FLASH_CASES if D in (64, 128) else (
                FLASH_CASES[0], FLASH_CASES[3], FLASH_CASES[5])
            for seed, (B, H, t_q, t_k, causal) in enumerate(cases):
                label = (f"flash {name} D={D} B={B} H={H} t_q={t_q} "
                         f"t_k={t_k} causal={causal}")
                q, k, v, do = flash_inputs(torch, device, dtype, B, H, t_q,
                                           t_k, D=D, seed=seed + D - 64)
                before = dict(A.launch_counts)
                case, share_c, out, dq = compare_flash(torch, q, k, v, do,
                                                       causal, label)
                moved = {key for key in A.launch_counts
                         if A.launch_counts[key] != before[key]}
                want = {A.counter_name(key, D, dtype)
                        for key in FLASH_REPLACES}
                if moved != want:
                    fail(f"{label}: launched on {sorted(moved)}, expected "
                         f"{sorted(want)}")
                for key, value in case.items():
                    route = A.counter_name(key, D, dtype)
                    worst[route] = max(worst.get(route, 0.0), value)
                share = max(share, share_c)
                # the dense path rounds the normalized P over the whole row
                dense = A.dot_product_attention(q, k, v, causal=causal).float()
                err = (out.float() - dense).abs().max().item()
                if not math.isfinite(err) or err > tol:
                    fail(f"{label}: forward vs dense max abs err {err} > "
                         f"{tol}")
                dense_err = max(dense_err, err)
                if causal and t_k < t_q:
                    empty = t_q - t_k
                    if out[:, :empty].abs().max().item() != 0 or \
                            dq[:, :empty].abs().max().item() != 0:
                        fail(f"{label}: rows with no visible key are not "
                             f"zero")
        errors[name] = worst
        placement = (f"; vs blockwise reference: {share:.4f} of outputs "
                     f"differ (limit {PLACEMENT_SHARE}), each within one ulp"
                     if dtype == torch.bfloat16 else "")
        print(f"flash {name}: D in {FLASH_DIMS}, {len(FLASH_CASES)} cases at "
              f"64 and 128, 3 at the others, tolerance {tol}: forward vs "
              f"dense max_abs_err={dense_err:.3e}{placement}; max abs err vs "
              f"plain: " + ", ".join(
                  f"{key}={value:.3e}" for key, value in worst.items())
              + f"; fused == split bitwise [{card}]", flush=True)
    worst_plan = max((A.general_plan(D) for D in range(1, 4097)),
                     key=lambda plan: plan["backward_smem"])
    if worst_plan["backward_smem"] > A.SMEM_BYTES:
        fail(f"flash: the general route's plan {worst_plan} exceeds "
             f"{A.SMEM_BYTES} bytes")
    print(f"flash: general route at D 576: {A.general_plan(576)}; at every "
          f"D of 1..4096 at most {worst_plan['backward_smem']} bytes of "
          f"shared memory a block (limit {A.SMEM_BYTES})", flush=True)
    return errors


# ----------------------------------------------------------------------
# phase 7: one f32 training step, flash (fused, split) against dense
# ----------------------------------------------------------------------
def phase_step(torch, device, card, heads=16, label="step"):
    """Loss and grads of the full-width model (`heads` heads) at batch 2,
    seq 256 in f32 through the fused backward, the split pair and the
    dense path; the launches on the head dim's route."""
    import functools
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models import transformer
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    tokens = torch.from_numpy(synthetic_token_stream(32768)(2, 256, 0)
                              ).long().to(device)
    results, counts = {}, {}
    flash = transformer.flash_attention
    for run, kind in (("fused", "flash"), ("split", "flash"),
                      ("dense", "dense")):
        model = transformer.TransformerLM(
            model_config(torch, torch.float32, 256, kind, num_heads=heads),
            device=device, seed=3)
        if run == "split":
            transformer.flash_attention = functools.partial(
                flash, fused_backward=False)
        attention.reset_launch_counts()
        # the embedding's scatter-add in a fixed order, so that fused and
        # split can be held bit-equal on every gradient
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss = lm_next_token_loss(model, tokens)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention = flash
            torch.use_deterministic_algorithms(False)
        counts[run] = dict(attention.launch_counts)
        results[run] = (loss.item(), {name: p.grad for name, p in
                                      model.named_parameters()})
        del model
    layers, name = 12, functools.partial(attention.counter_name,
                                         head_dim=1024 // heads,
                                         dtype=torch.float32)
    want = {"fused": {name("flash_fwd"): layers,
                      name("flash_bwd_fused"): layers},
            "split": {name("flash_fwd"): layers, name("flash_bwd_dq"): layers,
                      name("flash_bwd_dkv"): layers}}
    for run, expected in want.items():
        got = nonzero(counts[run])
        if got != expected:
            fail(f"{label} {run}: launches {got}, expected {expected}")
    fused, split, dense = (results[k] for k in ("fused", "split", "dense"))
    unequal = [name for name, grad in fused[1].items()
               if not torch.equal(grad, split[1][name])]
    if fused[0] != split[0] or unequal:
        fail(f"{label}: fused and split differ (loss {fused[0]} vs "
             f"{split[0]}; grads {unequal[:4]})")
    worst = max(rel_err(grad, dense[1][name])
                for name, grad in fused[1].items())
    loss_err = abs(fused[0] - dense[0]) / abs(dense[0])
    if not math.isfinite(worst) or worst > STEP_REL_TOL or loss_err > 1e-5:
        fail(f"{label}: flash vs dense grads rel err {worst} (limit "
             f"{STEP_REL_TOL}), loss rel err {loss_err}")
    print(f"{label}: 235M ({heads} heads of {1024 // heads}) f32 b2 t256 "
          f"loss {fused[0]:.6f}, fused == split "
          f"bitwise (loss and all {len(fused[1])} grads), "
          f"flash vs dense: loss rel err {loss_err:.2e}, grads max rel err "
          f"{worst:.2e} (limit {STEP_REL_TOL}); launches fused "
          f"{want['fused']}, split {want['split']} [{card}]", flush=True)
    return counts["fused"]


# ----------------------------------------------------------------------
# phase 8: training through the LM solver, profile, kernel times
# ----------------------------------------------------------------------
TRAIN_ARGS = ["model.vocab_size=32768", "model.dim=1024",
              "model.num_layers=12", "model.num_heads=16",
              "model.mlp_ratio=4", "seq_len=1024", "batch_size=16",
              "steps_per_epoch=8", "valid_steps=2"]


def phase_train(torch, card, folder):
    """The 235M model through `main` in a fresh XP under `folder`;
    returns (launch counts of the first call, the resumed solver, the
    step p50 in ms)."""
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    args = TRAIN_ARGS + [f"dora.dir={folder}"]
    attention.reset_launch_counts()
    solver = lm_main(args + ["epochs=2"])
    torch.cuda.synchronize()
    counts = dict(attention.launch_counts)
    cfg = solver.cfg
    train_steps = cfg.epochs * cfg.steps_per_epoch
    valid_steps = cfg.epochs * cfg.valid_steps
    layers = cfg.model.num_layers
    want = {"flash_fwd": layers * (train_steps + valid_steps),
            "flash_bwd_fused": layers * train_steps}
    got = {key: value for key, value in counts.items() if value}
    if got != want:
        fail(f"train: launches {got}, expected {want}")
    losses = [entry["train"]["loss"] for entry in solver.history]
    if not all(math.isfinite(x) for x in losses) or losses[1] >= losses[0]:
        fail(f"train: epoch losses {losses} not finite and falling")
    seconds = solver.step_seconds[2:]
    tokens = cfg.batch_size * cfg.seq_len
    tok_s = tokens * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    history = [dict(entry) for entry in solver.history]
    del solver
    resumed = lm_main(args + ["epochs=3"])
    if not resumed.restored or len(resumed.history) != 3 \
            or resumed.history[:2] != history \
            or resumed.state["step"] != 3 * cfg.steps_per_epoch:
        fail(f"train: the second call did not resume (restored "
             f"{resumed.restored}, {len(resumed.history)} epochs, step "
             f"{resumed.state['step']})")
    print(f"train: 235M bf16 b16 t1024, {train_steps} steps + "
          f"{valid_steps} valid, epoch losses {losses[0]:.4f} -> "
          f"{losses[1]:.4f}, tokens/s={tok_s:.1f}, step p50={p50:.2f} ms "
          f"(steps 3..{train_steps}), peak memory {peak:.1f} GiB; "
          f"launches {got}; resumed: Restored: True, epoch 3 loss "
          f"{resumed.history[2]['train']['loss']:.4f} [{card}]", flush=True)
    return counts, resumed, p50


def head_gemm_ms(torch, prof, vocab):
    """Device ms and calls of the tied head's products in a profile taken
    with record_shapes: the aten::mm calls with the vocabulary as one of
    their operands' dimensions (the logits, dX and dEmbed)."""
    ms, calls = 0.0, 0
    for event in prof.key_averages(group_by_input_shape=True):
        if event.key == "aten::mm" and any(
                vocab in shape for shape in event.input_shapes if shape):
            ms += getattr(event, "device_time_total",
                          getattr(event, "cuda_time_total", 0.0)) / 1e3
            calls += event.count
    return ms, calls


def profile_train(torch, solver, card, steps=4, label="profile train",
                  watch=()):
    """Where the training time goes: `steps` train steps plainly for the
    wall time, the next `steps` under torch.profiler for the device time
    by kernel; each kernel named in `watch` gets its device ms a step
    and launches, and the tied head's products (`head_gemm_ms`) theirs."""
    from torch.profiler import ProfilerActivity, profile
    from flashy_tpu_torch.examples.lm.solver import train_step

    def run(first):
        t0 = time.perf_counter()
        for i in range(steps):
            metrics = train_step(solver.model, solver.optimizer,
                                 solver.schedule, solver.state["step"],
                                 solver.batch_at(first + i),
                                 lambda model, tokens: solver.loss(tokens))
            solver.state["step"] += 1
            float(metrics["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_ms = run(1000) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run(2000)
    rows = device_rows(torch, prof)
    head_ms, head_calls = head_gemm_ms(torch, prof,
                                       solver.cfg.model.vocab_size)
    busy_ms = sum(ms for ms, _, _ in rows)
    top = "; ".join(f"{key[:48]} {ms:.1f} ms x{n}" for ms, n, key in rows[:8])
    named = "".join(
        f"; {name}: {sum(ms for ms, _, key in rows if name in key) / steps:.2f}"
        f" ms a step ({sum(n for _, n, key in rows if name in key)} "
        f"launches)" for name in watch)
    print(f"{label}: {steps} steps, plain wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}); top: {top}{named}; the tied head's "
          f"products (aten::mm over the vocabulary): {head_ms / steps:.2f} ms "
          f"a step ({head_calls} calls) [{card}]", flush=True)


def time_head(torch, device, card, tokens=16384, dim=1024, vocab=32768):
    """The tied head's three products at the training shapes (`train`:
    16384 tokens, dim 1024, vocab 32768), bf16 operands: the logits, dX
    and dEmbed through `ops.losses.head_matmul` (the tensor cores, f32
    output), each held to the f32 product of the same operands (within
    1e-3 of its max |value|: the products are exact, the order of the f32
    sums and the tensor cores' accumulation differ) and timed three times
    beside its bound (operations at the bf16 peak) and the f32 product it
    replaces (the port's head before). Prints one line."""
    from flashy_tpu_torch.ops.losses import head_matmul
    g = torch.Generator(device=device).manual_seed(12)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).to(
            torch.bfloat16)

    x, embed, dl = draw(tokens, dim), draw(vocab, dim), draw(tokens, vocab)
    products = {"logits": (x, embed.t()), "dX": (dl, embed),
                "dEmbed": (x.t(), dl)}
    parts, total, f32_total = [], 0.0, 0.0
    for name, (a, b) in products.items():
        got = head_matmul(a, b)
        want = a.float() @ b.float()
        if got.dtype != torch.float32:
            fail(f"head {name}: {got.dtype} output")
        err = rel_err(got, want)
        if not err <= 1e-3:
            fail(f"head {name}: relative err {err} vs the f32 product")
        del got, want
        t = time_runs(torch, lambda: head_matmul(a, b), iters=5)
        f32_ms = time_ms(torch, lambda: a.float() @ b.float(), iters=3,
                         device_only=True)
        m, k = a.shape
        bound = 2 * m * k * b.shape[1] / BF16_FLOPS * 1e3
        total += t["ms"]
        f32_total += f32_ms
        parts.append(f"{name} [{m}x{k}]x[{k}x{b.shape[1]}] {spread_text(t)} "
                     f"bound_ms={bound:.4f} (operations) f32_ms={f32_ms:.4f} "
                     f"rel err {err:.2e}")
    print(f"head: bf16 operands, f32 output (head_matmul): " + "; ".join(parts)
          + f"; the three {total:.3f} ms a step, as f32 products "
          f"{f32_total:.3f} [{card}]", flush=True)


def flash_bounds(B, H, T, D, elem, causal=True):
    """{kernel: (bound ms, 'bytes' | 'operations')} at t_q = t_k = T,
    causal or not: operations over the bf16 peak (f32 inputs: the f32
    peak) for the visible q.k pairs, bytes
    (each input read once, each output written once) over 3.35 TB/s.
    The fused kernel is the whole backward as a function (q, k, v, dO,
    lse, D in; dQ, dK, dV out): in bf16 it folds dQ itself (the f32
    kernel's partials, not timed here, would add their bytes)."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    row = B * T * H * D * elem          # one [B, T, H, D] tensor
    stat = B * H * T * 4                # lse or D, f32
    spec = {"flash_fwd": (4, 4 * row + stat),
            "flash_bwd_dq": (6, 5 * row + 2 * stat),
            "flash_bwd_dkv": (8, 6 * row + 2 * stat),
            "flash_bwd_fused": (10, 7 * row + 2 * stat)}
    out = {}
    peak = BF16_FLOPS if elem == 2 else F32_FLOPS
    for name, (flops_per_pair, nbytes) in spec.items():
        flop_ms = flops_per_pair * D * pairs / peak * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(flop_ms, byte_ms),
                     "bytes" if byte_ms >= flop_ms else "operations")
    return out


def time_flash(torch, device, card, H=16, D=64, B=16, T=1024, dtype=None,
               causal=True):
    """Each flash kernel at [B, T, H, D] (`causal`; by default bf16 at the
    training shapes, B 16, H 16, T 1024, D 64) on the route its head dim
    and dtype pick, first held against its plain version there (as
    `compare_flash` does), the fused kernel's two launches bit-equal (a
    race in its ordered dQ chain would show) and its device memory beyond
    its outputs measured; then each timed three times beside its bound,
    its plain version and PyTorch's scaled_dot_product_attention
    (forward; its autograd backward for the backward kernels); the fused
    time is the whole gradient, dQ included. Returns ({launch counter
    name: times}, {launch counter name: max abs error against plain})."""
    import torch.nn.functional as F
    from flashy_tpu_torch.ops import attention as A
    dtype = dtype or torch.bfloat16
    name = str(dtype).split(".")[1]
    where = f"B={B} H={H} T={T} D={D}"
    q, k, v, do = flash_inputs(torch, device, dtype, B, H, T, T, D=D,
                               seed=7 if D == 64 else 8)
    mask = "causal" if causal else "non-causal"
    errors, share, out, _ = compare_flash(
        torch, q, k, v, do, causal, f"flash {name} {where} {mask}")
    routes = {key: A.counter_name(key, D, dtype) for key in FLASH_REPLACES}
    print(f"flash {name} {where} {mask}: max abs err vs plain "
          + ", ".join(f"{routes[key]}={value:.3e}"
                      for key, value in errors.items())
          + f" (tolerance {FLASH_TOL[name]}, backward relative); vs "
          f"blockwise reference {share:.4f} of outputs differ (limit "
          f"{PLACEMENT_SHARE}), each within one ulp; fused == split "
          f"bitwise [{card}]", flush=True)
    del out
    out, lse = A.flash_forward(q, k, v, causal)
    delta = A.flash_delta(do, out)
    args = (q, k, v, do, lse, delta, causal)
    first = A.flash_backward_fused(*args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    second = A.flash_backward_fused(*args)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    if not all(same):
        fail(f"flash {name} fused {where}: two launches differ (dq, dk, dv "
             f"bit-equal: {same})")
    print(f"flash {name} fused {where} ({routes['flash_bwd_fused']}): two "
          f"launches bit-equal on dq, dk and dv; device memory of a call "
          f"{extra:.1f} MiB, its three outputs "
          f"{3 * q.numel() * q.element_size() / 2 ** 20:.1f} [{card}]",
          flush=True)
    del first, second

    def plain_fused():
        dk, dv, partials = A.flash_backward_fused_blockwise(*args)
        return A.fold_dq_partials(partials, q.dtype), dk, dv

    qh, kh, vh, doh = (t.transpose(1, 2).contiguous().requires_grad_()
                       for t in (q, k, v, do))
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal))
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qh, kh, vh), doh, retain_graph=True))
    kernels = {
        "flash_fwd": (lambda: A.flash_forward(q, k, v, causal),
                      lambda: A.flash_forward_blockwise(q, k, v, causal),
                      sdpa_fwd),
        "flash_bwd_dq": (
            lambda: A._launch_backward(A._BWD_DQ, *args),
            lambda: A.flash_backward_dq_blockwise(*args), sdpa_bwd),
        "flash_bwd_dkv": (
            lambda: A._launch_backward(A._BWD_DKV, *args),
            lambda: A.flash_backward_dkv_blockwise(*args), sdpa_bwd),
        "flash_bwd_fused": (
            lambda: A.flash_backward_fused(*args), plain_fused, sdpa_bwd)}
    bounds = flash_bounds(B, H, T, D, q.element_size(), causal)
    # the Hopper kernels take ~0.1-0.5 ms a call, the general route up to
    # ~10 and more above one head-dim slab: fewer iterations there
    iters = 20 if D == 64 else (5 if D <= 128 else 2)
    times = {}
    for key, (kernel, plain, library) in kernels.items():
        bound, bound_by = bounds[key]
        times[routes[key]] = {
            **time_runs(torch, kernel, iters=iters),
            "plain_ms": time_ms(torch, plain, iters=5 if D == 64 else 2),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
            "host_us": host_us(torch, kernel, calls=5 if D <= 128 else 2)}
    print(f"flash times ({where} {mask} {name}): " + "; ".join(
        f"{key} {spread_text(t)} bound_ms={t['bound_ms']:.4f} "
        f"({t['bound_by']}) plain_ms={t['plain_ms']:.4f} "
        f"library_ms={t['library_ms']:.4f} host_us={t['host_us']:.1f}"
        for key, t in times.items())
        + " (flash_bwd_fused: the whole gradient, dQ folded in the kernel on "
        "the Hopper route and from the kernel's f32 partials on the general "
        "route; library: F.scaled_dot_product_attention forward, its "
        f"autograd backward for the backward kernels) [{card}]", flush=True)
    return times, {routes[key]: value for key, value in errors.items()}


# ----------------------------------------------------------------------
# ssd phases: the SSD scan kernel, pure-SSD serving
# ----------------------------------------------------------------------
SSD_SOURCE = "flashy_tpu_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "flashy_tpu/ops/ssd_scan.py:190"
SSD_CHUNK = 64                 # engine prefill slice == model ssd_chunk
SSD_STATE_RTOL = 1e-5          # f32 y and state, relative to max |plain|
# (B, T, chunk): chunks 16, 64 and 256, tails of every length class, T
# of 1, 7, 100 and 1024 (chunk is clipped to T, as the scan clips it)
SSD_CASES = ((2, 1, 64), (2, 7, 16), (2, 100, 16), (2, 100, 64),
             (1, 300, 256), (2, 1024, 64), (1, 1024, 256))
# (N, Dh) besides the serving 16, 64: the bf16 tile kernel's zero padding
# (8, 32), and the bf16 FMA kernel's widths (Mamba-2's d_state 128, Dh
# 128, odd Dh)
SSD_WIDTHS = ((8, 32), (128, 64), (16, 128), (16, 33))
# (B, T) the main path's call is timed at: a prefill slice, and a batched
# prompt of 1024 tokens
SSD_SHAPES = ((1, SSD_CHUNK), (8, 1024))
# (B, T, chunk, N, Dh) of the FMA kernel at chunk 256 past its old
# shared-memory cap: Mamba-2's N 128 over a 1024-token prompt (the chunk
# `default_chunk` picks), and N 256 with a ragged tail
SSD_WIDE_CASES = ((1, 1024, 256, 128, 64), (1, 1000, 256, 256, 64))


def ssd_inputs(torch, device, dtype, B, T, H=16, Dh=64, N=16, seed=0,
               proj=False):
    """Random scan inputs at the serving widths: c, b, v [B, T, H, *] in
    `dtype` (with `proj`, slices of one fused projection [B, T, H,
    2N+Dh+1], as the model hands them in), f32 log-decays, a random f32
    carried state, and a token mask whose last row pads its final T // 8
    tokens."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)

    if proj:
        p = draw(B, T, H, 2 * N + Dh + 1).to(dtype)
        c, b, v = p[..., :N], p[..., N:2 * N], p[..., 2 * N:2 * N + Dh]
    else:
        c, b = draw(B, T, H, N).to(dtype), draw(B, T, H, N).to(dtype)
        v = draw(B, T, H, Dh).to(dtype)
    log_a = -torch.nn.functional.softplus(draw(B, T, H))
    state = draw(B, H, Dh, N)
    mask = torch.ones((B, T), dtype=torch.bool, device=device)
    mask[-1, T - T // 8:] = False
    return c, b, v, log_a, state, mask


def ulp_excess(torch, got, want):
    """How far |got - want| exceeds one bf16 ulp of |want| (the
    PLACEMENT_RTOL bar with its PLACEMENT_ATOL floor); <= 0 holds."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - PLACEMENT_RTOL * want.abs()).max().item()


def ssd_against_plain(torch, got, want, mask, label):
    """Holds a kernel call's (y, state) to the plain version's on the
    same inputs: f32 y within SSD_STATE_RTOL of max |plain| (TF32 off),
    bf16 y within one bf16 ulp of plain (PLACEMENT_RTOL, with the
    PLACEMENT_ATOL floor near zero), the state within SSD_STATE_RTOL;
    only real tokens count. Fails otherwise; returns (y max abs err, its
    share of max |y|, state rel err)."""
    (y, s), (y_ref, s_ref) = got, want
    y, y_ref = y.float(), y_ref.float()
    real = mask[:, :, None, None].expand_as(y)
    err = (y - y_ref).abs()[real].max().item()
    scale = max(y_ref.abs()[real].max().item(), 1e-30)
    s_rel = rel_err(s, s_ref)
    if got[0].dtype == torch.float32:
        bad = err / scale > SSD_STATE_RTOL
    else:
        bad = ulp_excess(torch, y[real], y_ref[real]) > PLACEMENT_ATOL
    if not math.isfinite(err) or bad or not math.isfinite(s_rel) \
            or s_rel > SSD_STATE_RTOL:
        fail(f"{label}: y max abs err {err:.3e} (max |y| {scale:.3e}), "
             f"state rel err {s_rel:.3e}")
    return err, err / scale, s_rel


def check_ssd_kernel(torch, device, card):
    """The SSD scan kernel against its plain version on the card
    (`ssd_against_plain`), in f32 and bf16: every case of SSD_CASES at
    the serving widths and every width of SSD_WIDTHS, each on projection
    slices and on separate contiguous tensors. Then, in f32 and in bf16,
    `check_ssd_bits`. Returns {dtype: max abs err of y against plain}."""
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    from flashy_tpu_torch.ops import ssd_scan
    cases = ([(B, T, chunk, 16, 64) for B, T, chunk in SSD_CASES]
             + [(2, 130, SSD_CHUNK, N, Dh) for N, Dh in SSD_WIDTHS]
             + list(SSD_WIDE_CASES))
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst_y = worst_rel = worst_state = 0.0
        for seed, (B, T, chunk, N, Dh) in enumerate(cases):
            for proj in (True, False):
                c, b, v, log_a, state, mask = ssd_inputs(
                    torch, device, dtype, B, T, N=N, Dh=Dh, seed=seed,
                    proj=proj)
                kw = {"state": state, "chunk": chunk, "token_mask": mask}
                route = ssd_scan.kernel_route(dtype, N, Dh)
                before = ssd_scan.launch_counts[route]
                fused = ssd_chunked_scan(c, b, v, log_a, kernel="fused", **kw)
                if ssd_scan.launch_counts[route] != before + 1:
                    fail(f"ssd {name} N={N} Dh={Dh}: not launched on {route}")
                err, rel, s_rel = ssd_against_plain(
                    torch, fused,
                    ssd_chunked_scan(c, b, v, log_a, kernel="gather", **kw),
                    mask, f"ssd {name} B={B} T={T} chunk={chunk} N={N} "
                          f"Dh={Dh} {'projection' if proj else 'separate'}")
                worst_y, worst_rel = max(worst_y, err), max(worst_rel, rel)
                worst_state = max(worst_state, s_rel)
        errors[name] = worst_y
        bar = (f"relative {SSD_STATE_RTOL}" if dtype == torch.float32
               else "one bf16 ulp")
        print(f"ssd kernel {name}: {len(SSD_CASES)} cases (B, T, chunk) "
              f"{SSD_CASES} at N 16, Dh 64, (N, Dh) {SSD_WIDTHS} at "
              f"(2, 130, {SSD_CHUNK}) and (B, T, chunk, N, Dh) "
              f"{SSD_WIDE_CASES}, each on projection slices and on "
              f"separate tensors, carried state, padded row: y max abs err "
              f"{worst_y:.3e} ({worst_rel:.3e} of max |y|; bar {bar}), "
              f"state max rel err {worst_state:.3e} (bar {SSD_STATE_RTOL}) "
              f"[{card}]", flush=True)
        check_ssd_bits(torch, device, card, dtype)
    return errors


def check_ssd_bits(torch, device, card, dtype):
    """At the path's chunk on projection slices of [2, 1024]: a
    SSD_LOG_RESET position whose segment's outputs match the segment run
    alone (f32 within SSD_STATE_RTOL of max |y|; bf16 within one ulp, as
    the segment's chunks round elsewhere); splits at 4 and at 3 chunks
    bit-equal to one call; right-padded slices (100 of 128 tokens, 40 of
    64) bit-equal to the unpadded tail, outputs and state; two launches
    bit-equal."""
    from flashy_tpu_torch.ops.ssd_scan import SSD_LOG_RESET, ssd_chunked_scan
    name = str(dtype).split(".")[1]

    def scan(c, b, v, log_a, **kw):
        return ssd_chunked_scan(c, b, v, log_a, chunk=SSD_CHUNK,
                                kernel="fused", **kw)

    c, b, v, log_a, state, _ = ssd_inputs(torch, device, dtype, 2, 1024,
                                          seed=11, proj=True)
    cut = 37
    reset = log_a.clone()
    reset[:, cut] = SSD_LOG_RESET
    y, _ = scan(c, b, v, reset, state=state)
    y_alone, _ = scan(c[:, cut:], b[:, cut:], v[:, cut:], reset[:, cut:])
    if dtype == torch.float32:
        reset_err = rel_err(y[:, cut:], y_alone)
        reset_bad = reset_err > SSD_STATE_RTOL
        reset_text = f"rel err {reset_err:.3e}"
    else:
        reset_err = ulp_excess(torch, y[:, cut:], y_alone)
        reset_bad = reset_err > PLACEMENT_ATOL
        reset_text = (f"within one ulp (excess {reset_err:.3e} <= "
                      f"{PLACEMENT_ATOL})")
    if not torch.isfinite(y.float()).all() or reset_bad:
        fail(f"ssd {name} reset: the segment after SSD_LOG_RESET differs "
             f"from the segment alone: {reset_text}")
    y_all, s_all = scan(c, b, v, log_a, state=state)
    splits = (4 * SSD_CHUNK, 3 * SSD_CHUNK)
    for split in splits:
        y_a, s_a = scan(c[:, :split], b[:, :split], v[:, :split],
                        log_a[:, :split], state=state)
        y_b, s_b = scan(c[:, split:], b[:, split:], v[:, split:],
                        log_a[:, split:], state=s_a)
        if not (torch.equal(torch.cat([y_a, y_b], 1), y_all)
                and torch.equal(s_b, s_all)):
            fail(f"ssd {name} chaining: the kernel split at {split} is not "
                 f"bit-equal to one call")
    pads = ((100, 2 * SSD_CHUNK), (40, SSD_CHUNK))
    for used, width in pads:
        mask = torch.zeros((2, width), dtype=torch.bool, device=device)
        mask[:, :used] = True
        y_pad, s_pad = scan(c[:, :width], b[:, :width], v[:, :width],
                            log_a[:, :width], state=state, token_mask=mask)
        y_cut, s_cut = scan(c[:, :used], b[:, :used], v[:, :used],
                            log_a[:, :used], state=state)
        if not (torch.equal(y_pad[:, :used], y_cut)
                and torch.equal(s_pad, s_cut)):
            fail(f"ssd {name} padding: {used} of {width} tokens, padded, "
                 f"are not bit-equal to the unpadded tail")
    y_again, s_again = scan(c, b, v, log_a, state=state)
    if not (torch.equal(y_again, y_all) and torch.equal(s_again, s_all)):
        fail(f"ssd {name}: two launches on the same inputs differ")
    print(f"ssd kernel {name}: segment after SSD_LOG_RESET vs alone "
          f"{reset_text}; splits at {splits} of 1024 bit-equal to one call; "
          f"padded (used, width) {pads} bit-equal to the unpadded tail; two "
          f"launches bit-equal [{card}]", flush=True)


def ssd_bound(B, H, T, N, Dh, chunk, elem):
    """(bound ms, 'bytes' | 'operations', the peak named) of one scan:
    bytes (c, b, v, la, the mask and the state in, y and the state out,
    each once) over 3.35 TB/s against operations over the peak for their
    type: the four products (the causal halves of c.b^T and of
    scores.v, c.S^T, v^T.(b exp(suffix))) at the input dtype's peak, the
    C^2 decay sums at the f32 peak."""
    pairs = sum(min(chunk, T - lo) * (min(chunk, T - lo) + 1) // 2
                for lo in range(0, T, chunk))
    rows = B * H
    nbytes = (rows * T * ((2 * N + 2 * Dh) * elem + 4) + B * T
              + 2 * rows * Dh * N * 4)
    products = rows * (2 * pairs * (N + Dh) + 4 * T * N * Dh)
    peak = BF16_FLOPS if elem == 2 else F32_FLOPS
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = (products / peak + rows * pairs / F32_FLOPS) * 1e3
    peak_name = ("bf16 tensor-core peak for the products, f32 for the "
                 "decay sums" if elem == 2 else "f32 peak")
    return (max(byte_ms, op_ms),
            "bytes" if byte_ms >= op_ms else "operations", peak_name)


def ssd_call_kernels(torch, call):
    """(calls, [(name, launches)] of the CUDA kernels and copies the
    profiler saw, scan launches the wrapper counted) for a run of `call`.
    The profiler can drop kernel records of a short session, so a session
    that shows none is run again, longer; its counts are reported, and
    the wrapper's count says how many times the scan was launched."""
    from flashy_tpu_torch.ops import ssd_scan
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for calls in (50, 200):
        before = ssd_scan.launch_counts["ssd_scan"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        rows = [(key, n) for _, n, key in device_rows(torch, prof)]
        if rows:
            break
    return calls, rows, ssd_scan.launch_counts["ssd_scan"] - before


def time_ssd(torch, device, B, T, chunk):
    """The main path's call at [B, T] tokens on the engine's inputs: c, b,
    v slices of a bf16 projection [B, T, 16, 97], f32 log-decays, a
    carried state and a mask padding T // 8 tokens of the last row. The
    call is first held to the plain version on those inputs
    (`ssd_against_plain`), then timed: device time three times
    (`time_runs`), the wrapper's host us a call
    apart, the plain version's device time, the bound, and what the calls
    launch (`ssd_call_kernels`: the scan once a call, nothing else)."""
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    c, b, v, log_a, state, mask = ssd_inputs(torch, device, torch.bfloat16,
                                             B, T, seed=5, proj=True)
    kw = {"state": state, "chunk": chunk, "token_mask": mask}

    def call():
        return ssd_chunked_scan(c, b, v, log_a, kernel="fused", **kw)

    err, _, s_rel = ssd_against_plain(
        torch, call(), ssd_chunked_scan(c, b, v, log_a, kernel="gather", **kw),
        mask, f"ssd bf16 [{B}, {T}] main-path call")
    calls, launched, counted = ssd_call_kernels(torch, call)
    if counted != calls or not launched \
            or any("ssd_" not in name for name, _ in launched):
        fail(f"ssd [{B}, {T}]: {calls} main-path calls: the wrapper launched "
             f"the scan {counted} times, the profiler saw {launched}; one "
             f"scan launch a call and no other device work expected")
    H, N, Dh = c.shape[2], c.shape[3], v.shape[3]
    bound, bound_by, peak = ssd_bound(B, H, T, N, Dh, chunk,
                                      c.element_size())
    runs = time_runs(torch, call, iters=50 if B * T <= 256 else 20)
    plain_ms = time_ms(torch, lambda: ssd_chunked_scan(
        c, b, v, log_a, kernel="gather", **kw), iters=5, device_only=True)
    return {**runs, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "peak": peak, "library_ms": None,
            "host_us": host_us(torch, call), "max_abs_err": err,
            "state_rel_err": s_rel,
            "kernels": f"{calls} calls, {counted} scan launches; the "
                       f"profiler saw {launched}"}


def ssd_workload(rng, vocab):
    """8 prompts of mixed lengths (tails of every size against the 64
    slice, one shorter than a slice, one a multiple of it); max_new puts
    every final position past the 256 ceiling."""
    lengths = (5, 64, 70, 100, 131, 150, 200, 255)
    return [rng.integers(1, vocab, n) for n in lengths], 290


def phase_ssd_exact(torch, device, card):
    """The pure-SSD model in f32 through `cache_layout='ssd'`: streams past
    the 256 ceiling token-exact against `generate`, one kernel launch per
    layer per prefill slice."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = ssd_model_config(torch, torch.float32, 256)
    model = TransformerLM(cfg, device=device, seed=4)
    engine = DecodeEngine(model, slots=8, max_seq_len=256, chunk=SSD_CHUNK,
                          cache_layout="ssd", device=device)
    if not engine.unbounded or engine.tail_bucket < 2:
        fail(f"ssd exact: engine unbounded={engine.unbounded}, tail bucket "
             f"{engine.tail_bucket}")
    engine.warmup()
    prompts, max_new = ssd_workload(np.random.default_rng(4), cfg.vocab_size)
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    slices = engine.step_counts["prefill_chunk"]
    # f32: the FMA kernel's route
    launched = counts["ssd_scan_fma"]
    if launched != cfg.num_layers * slices or counts["ssd_scan"]:
        fail(f"ssd exact: kernel launched {launched} times for {slices} "
             f"multi-token prefill slices x {cfg.num_layers} layers")
    if min(len(p) for p in prompts) + max_new <= engine.max_seq_len:
        fail("ssd exact: a stream ends under the ceiling")
    ties = check_streams(torch, model, prompts, requests, max_new, device,
                         "ssd exact")
    print(f"ssd exact: {len(requests)} requests (prompts "
          f"{[len(p) for p in prompts]}, {max_new} new, ceiling "
          f"{engine.max_seq_len}) token-exact vs generate (near ties "
          f"{ties}), launches={launched} == {cfg.num_layers} x {slices} "
          f"prefill slices, decode steps={engine.step_counts['decode']}, "
          f"state bytes/slot={engine.state_bytes_per_slot()}, CUDA graphs "
          f"{engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
          flush=True)


def phase_ssd_serve(torch, device, card, *, requests_n=16, prompt_len=128,
                    max_new=128):
    """The pure-SSD model in bf16 at the decode leg's shapes: tokens/s,
    decode-step ms, a profiled window, and the kernel at a prefill slice
    [1, 64] and at [8, 1024] (`time_ssd`). Returns (launches, {(B, T):
    timing})."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = ssd_model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=5)
    engine_kw = dict(slots=8, max_seq_len=256, chunk=SSD_CHUNK,
                     cache_layout="ssd", device=device)
    engine = DecodeEngine(model, **engine_kw)
    engine.warmup()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    launched = counts["ssd_scan"]
    want = cfg.num_layers * engine.step_counts["prefill_chunk"]
    if launched != want or launched < 1:
        fail(f"ssd serve: kernel launched {launched} times, expected {want}")
    for request in requests:
        out = request.output
        if out.shape != (prompt_len + max_new,) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            fail(f"ssd serve: request {request.uid} output malformed")
    summary = scheduler.metrics.summary()
    print(f"ssd serve bf16: {requests_n} requests x prompt {prompt_len} x "
          f"{max_new} new, tokens/s={summary['tokens_per_sec']:.1f}, decode "
          f"step p50={summary['itl_ms_p50']:.3f} ms, ttft p50="
          f"{summary['ttft_ms_p50']:.1f} ms, {seconds:.2f}s, launches="
          f"{launched}; CUDA graphs {engine.compile_cache.stats()} [{card}]",
          flush=True)
    profile_serve(torch, engine, cfg.vocab_size, 8, prompt_len, 32, card)
    eager_twin(torch, model, engine, engine_kw, prompts, max_new, requests,
               counts, "ssd serve bf16", card)
    timings = {}
    for B, T in SSD_SHAPES:
        t = timings[(B, T)] = time_ssd(torch, device, B, T, SSD_CHUNK)
        print(f"ssd kernel bf16 [{B}, {T}] chunk {SSD_CHUNK}, the main "
              f"path's call (projection slices, mask; {t['kernels']}): "
              f"against plain y max abs err {t['max_abs_err']:.3e} (bar one "
              f"bf16 ulp), state rel err {t['state_rel_err']:.3e} (bar "
              f"{SSD_STATE_RTOL}); device {spread_text(t)} host_us="
              f"{t['host_us']:.1f} bound_ms={t['bound_ms']:.6f} "
              f"({t['bound_by']}; {t['peak']}) plain_ms="
              f"{t['plain_ms']:.4f} library: none (no single PyTorch call "
              f"computes the chunked scan) [{card}]", flush=True)
    return launched, timings


# ----------------------------------------------------------------------
# the dense layout, hybrid stacks and speculative decoding
# ----------------------------------------------------------------------


def hybrid_model_config(torch, dtype, max_seq_len):
    """The 235M layout with the mixers alternating SSD and attention (6 of
    each, state dim 16), the SSD chunk pinned to the engine's prefill
    slice of 64 tokens."""
    return model_config(torch, dtype, max_seq_len, mixer="ssd,attention",
                        ssd_state_dim=16, ssd_chunk=SSD_CHUNK)


def step_p50_ms(scheduler):
    """Median engine step in ms: the scheduler gives each live slot's first
    token of a step the step's latency and the rest of its span 0."""
    from flashy_tpu_torch.utils import percentile
    return percentile([g for g in scheduler.metrics.itl if g > 0], 50) * 1e3


def check_outputs(requests, lengths, vocab, label):
    """Every output has its expected length and only tokens of the vocab."""
    for request, n in zip(requests, lengths):
        out = request.output
        if out.shape != (n,) or out.min() < 0 or out.max() >= vocab:
            fail(f"{label}: request {request.uid} output malformed")


def phase_dense_exact(torch, device, card):
    """The `exact` workload in f32 through cache_layout='dense' (the
    default), once with the monolithic prefill (a graph a bucket) and once
    with chunk 16: every stream token-exact against `generate` (near ties
    reported), no kernel launched (the dense read is plain einsums) and no
    capture after `warmup()`."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.float32, 256)
    model = TransformerLM(cfg, device=device, seed=0)
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    max_new = 32
    refs = reference_streams(torch, model, prompts, max_new, device)
    for chunk in (None, 16):
        label = f"dense exact {'monolithic' if chunk is None else 'chunk 16'}"
        engine = DecodeEngine(model, slots=8, max_seq_len=256, chunk=chunk,
                              device=device)
        if engine.cache_layout != "dense" or engine.pool is not None:
            fail(f"{label}: the default layout is {engine.cache_layout}")
        engine.warmup(prompt_lengths=[len(p) for p in prompts])
        scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                     max_new)
        if nonzero(counts):
            fail(f"{label}: kernels launched on the dense layout: "
                 f"{nonzero(counts)}")
        ties = check_streams(torch, model, prompts, requests, max_new,
                             device, label, refs=refs)
        print(f"{label}: {len(requests)} requests token-exact vs generate "
              f"(near ties {ties}), steps {nonzero(engine.step_counts)}, "
              f"cache {engine.cache_bytes()} B, CUDA graphs "
              f"{engine.compile_cache.stats()} "
              f"({', '.join(engine.compile_cache.executables())}), "
              f"{seconds:.2f}s [{card}]", flush=True)
        del engine


def phase_serve_dense(torch, device, card, requests_n=16, prompt_len=128,
                      max_new=128):
    """`serve bf16`'s traffic through the dense layout's captured steps
    (monolithic prefill), then the same traffic eager (`eager_twin`):
    tokens/s, decode p50, host us a decode step, streams bit-identical.
    Returns the graphs run's summary."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "serve dense bf16"
    cfg = model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    engine_kw = dict(slots=8, max_seq_len=256, device=device)
    engine = DecodeEngine(model, **engine_kw)
    engine.warmup(prompt_lengths=[prompt_len])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    if nonzero(counts):
        fail(f"{label}: kernels launched on the dense layout: "
             f"{nonzero(counts)}")
    check_outputs(requests, [prompt_len + max_new] * requests_n,
                  cfg.vocab_size, label)
    summary = scheduler.metrics.summary()
    print(f"{label}: {requests_n} requests x prompt {prompt_len} x {max_new} "
          f"new, tokens/s={summary['tokens_per_sec']:.1f}, decode step "
          f"p50={summary['itl_ms_p50']:.3f} ms, ttft p50="
          f"{summary['ttft_ms_p50']:.1f} ms, {seconds:.2f}s, steps "
          f"{nonzero(engine.step_counts)}, captures after warm-up "
          f"{engine.compile_cache.recompiles()}, CUDA graphs "
          f"{engine.compile_cache.stats()} [{card}]", flush=True)
    eager_twin(torch, model, engine, engine_kw, prompts, max_new, requests,
               counts, label, card, prompt_lengths=[prompt_len])
    return summary


def phase_hybrid_exact(torch, device, card):
    """The hybrid layout in f32 through cache_layout='ssd' (chunk 64):
    the `exact` workload token-exact against `generate`, the SSD kernel
    launched once per SSD layer per prefill slice."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM, \
        mixer_pattern
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "hybrid exact"
    cfg = hybrid_model_config(torch, torch.float32, 256)
    ssd_layers = mixer_pattern(cfg).count("ssd")
    model = TransformerLM(cfg, device=device, seed=4)
    engine = DecodeEngine(model, slots=8, max_seq_len=256, chunk=SSD_CHUNK,
                          cache_layout="ssd", device=device)
    if engine.unbounded or ssd_layers != 6:
        fail(f"{label}: unbounded={engine.unbounded}, {ssd_layers} SSD "
             f"layers")
    engine.warmup()
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    max_new = 32
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    slices = engine.step_counts["prefill_chunk"]
    if nonzero(counts) != {"ssd_scan_fma": ssd_layers * slices}:
        fail(f"{label}: launches {nonzero(counts)}, expected ssd_scan_fma "
             f"= {ssd_layers} x {slices} prefill slices")
    ties = check_streams(torch, model, prompts, requests, max_new, device,
                         label)
    print(f"{label}: {len(requests)} requests token-exact vs generate (near "
          f"ties {ties}), launches ssd_scan_fma={ssd_layers * slices} == "
          f"{ssd_layers} SSD layers x {slices} prefill slices, decode steps="
          f"{engine.step_counts['decode']}, state bytes/slot="
          f"{engine.state_bytes_per_slot()}, CUDA graphs "
          f"{engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
          flush=True)


def time_slab_copies(torch, engine):
    """Device ms of what a hybrid prefill slice does to the slot's
    attention slabs besides the step: every K and V slab of the slot
    gathered (`index_select`, the spare row included) and scattered back
    (`index_copy_`); beside it the whole slice's graph replay. Slot 0,
    after the traffic."""
    from flashy_tpu_torch.models.decoding import with_spare_row
    slot = torch.zeros((1,), dtype=torch.long, device=engine.device)
    slabs = [with_spare_row(entry[leaf])
             for entry in engine.cache_box.value.values()
             for leaf in ("k", "v") if leaf in entry]

    def copies():
        for full in slabs:
            full.index_copy_(0, slot, full.index_select(0, slot))

    step = engine.compile_cache.executables()[f"prefill_chunk/{engine.chunk}"]
    bufs = engine._prefill_inputs[engine.chunk]
    bufs["slot"].zero_()
    bufs["fresh"].fill_(True)
    nbytes = 4 * sum(full[0].numel() * full.element_size() for full in slabs)
    return {"copies": time_runs(torch, copies, iters=50),
            "slice_ms": time_ms(torch, lambda: step(*bufs.values()),
                                iters=20, device_only=True),
            "slabs": len(slabs), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def phase_hybrid_serve(torch, device, card, requests_n=16, prompt_len=128,
                       max_new=128):
    """The hybrid layout in bf16 at `serve bf16`'s traffic as graphs, then
    eager: tokens/s, decode p50, the tile SSD kernel launched once per SSD
    layer per prefill slice, the state bytes a slot, and the device ms of
    a slice's slab copies. Returns (launches, the copies' timing)."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM, \
        mixer_pattern
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "hybrid serve bf16"
    cfg = hybrid_model_config(torch, torch.bfloat16, 256)
    ssd_layers = mixer_pattern(cfg).count("ssd")
    model = TransformerLM(cfg, device=device, seed=5)
    engine_kw = dict(slots=8, max_seq_len=256, chunk=SSD_CHUNK,
                     cache_layout="ssd", device=device)
    engine = DecodeEngine(model, **engine_kw)
    engine.warmup()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    slices = engine.step_counts["prefill_chunk"]
    launched = counts["ssd_scan"]
    if launched < 1 or nonzero(counts) != {"ssd_scan": ssd_layers * slices}:
        fail(f"{label}: launches {nonzero(counts)}, expected ssd_scan = "
             f"{ssd_layers} x {slices} prefill slices")
    check_outputs(requests, [prompt_len + max_new] * requests_n,
                  cfg.vocab_size, label)
    summary = scheduler.metrics.summary()
    copies = time_slab_copies(torch, engine)
    print(f"{label}: {requests_n} requests x prompt {prompt_len} x {max_new} "
          f"new, tokens/s={summary['tokens_per_sec']:.1f}, decode step "
          f"p50={summary['itl_ms_p50']:.3f} ms, ttft p50="
          f"{summary['ttft_ms_p50']:.1f} ms, {seconds:.2f}s, launches "
          f"ssd_scan={launched} == {ssd_layers} x {slices} prefill slices, "
          f"state bytes/slot={engine.state_bytes_per_slot()}; a slice's "
          f"slab copies ({copies['slabs']} slabs out and back, "
          f"{copies['bytes']} B): device {spread_text(copies['copies'])} "
          f"bound_ms={copies['bound_ms']:.4f}, the whole slice "
          f"{copies['slice_ms']:.4f} ms; CUDA graphs "
          f"{engine.compile_cache.stats()} [{card}]", flush=True)
    eager_twin(torch, model, engine, engine_kw, prompts, max_new, requests,
               counts, label, card)
    return launched, copies


class ScriptedDraft:
    """A draft provider proposing from `generate`'s own streams (`refs`,
    by prompt): the next k tokens (`accept`: every draft is accepted) or
    each of them plus one (`reject`: every draft is rejected)."""

    def __init__(self, slots, k, prompts, refs, vocab, mode):
        self.slots, self.k, self.vocab, self.mode = slots, k, vocab, mode
        self.refs = {tuple(p): r for p, r in zip(prompts, refs)}
        self.spans = {}           # slot -> [its stream, tokens so far]

    def warmup(self, prompt_lengths=()):
        pass

    def begin(self, slot, prompt, first_token):
        self.spans[slot] = [self.refs[tuple(prompt)], len(prompt) + 1]

    def propose(self):
        import numpy as np
        out = np.zeros((self.slots, self.k), np.int64)
        for slot, (ref, n) in self.spans.items():
            nxt = ref[n:n + self.k]
            out[slot] = nxt if self.mode == "accept" \
                else (nxt + 1) % self.vocab
        return out

    def observe(self, slot, tokens, position):
        self.spans[slot][1] += len(tokens)

    def retire(self, slot):
        self.spans.pop(slot, None)


def verify_launches(engine, counts, name, label):
    """The paged kernel launched once per layer per verify step (T = k+1)
    and per prefill slice, and on no other route; returns the split."""
    layers = engine._cfg.num_layers
    steps = engine.step_counts
    split = {f"T={engine.spec_k + 1} verify": layers * steps["verify"],
             f"prefill T<={engine.chunk}": layers * steps["prefill_chunk"]}
    if steps["decode"] or steps["verify"] < 1 \
            or nonzero(counts) != {name: sum(split.values())}:
        fail(f"{label}: launches {nonzero(counts)}, steps {steps}: expected "
             f"{name} = {layers} x (verify + prefill slices)")
    return split


def phase_spec_exact(torch, device, card):
    """Speculative decoding in f32 on the reference demo's repetitive mix
    (16 requests): the paged engine (the Hopper kernel) and the dense
    engine, each with NGramDraft(k=4), with drafts that are all rejected
    and with drafts that are all accepted (`ScriptedDraft`), and the paged
    engine with a ModelDraft (2 layers, dim 256, the same vocab): every
    stream token-exact against `generate` (near ties reported), the paged
    kernel launched once per layer per verify step at T=5, no capture
    after warm-up; then int8 pools (`check_spec_int8`). Returns the paged
    kernel's launches by T."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.serve.__main__ import _repetitive_mix
    from flashy_tpu_torch.serve.draft import ModelDraft, NGramDraft
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.float32, 256)
    model = TransformerLM(cfg, device=device, seed=0)
    mix = _repetitive_mix(16, cfg.vocab_size, 7)
    prompts = [p for p, _ in mix]
    news = [n for _, n in mix]
    # streams SPEC_K tokens longer than served: the accepting draft's
    refs = reference_streams(torch, model, prompts,
                             [n + SPEC_K for n in news], device)
    draft_model = TransformerLM(TransformerConfig(
        vocab_size=cfg.vocab_size, dim=256, num_layers=2, num_heads=4,
        mlp_ratio=4, max_seq_len=256, dtype=torch.float32,
        attention="dense"), device=device, seed=13)
    by_t = {}
    for layout in ("paged", "dense"):
        kw = dict(cache_layout="paged", kernel="fused", block_size=16) \
            if layout == "paged" else {}
        engine = DecodeEngine(model, slots=8, max_seq_len=256,
                              spec_k=SPEC_K, device=device, **kw)
        engine.warmup(prompt_lengths=[len(p) for p in prompts])
        drafts = {"ngram": lambda: NGramDraft(slots=8, k=SPEC_K, ngram=3),
                  "reject": lambda: ScriptedDraft(8, SPEC_K, prompts, refs,
                                                  cfg.vocab_size, "reject"),
                  "accept": lambda: ScriptedDraft(8, SPEC_K, prompts, refs,
                                                  cfg.vocab_size, "accept")}
        if layout == "paged":
            drafts["model"] = lambda: ModelDraft(draft_model, slots=8,
                                                 k=SPEC_K, device=device)
        for kind, make in drafts.items():
            label = f"spec exact {layout} {kind}"
            draft = make()
            draft.warmup(prompt_lengths=[len(p) for p in prompts])
            scheduler, requests, counts, seconds = serve(
                torch, engine, prompts, news, draft=draft)
            if layout == "paged":
                split = verify_launches(engine, counts, "paged_decode",
                                        label)
                if kind == "ngram":
                    by_t = split
            elif nonzero(counts):
                fail(f"{label}: kernels launched on the dense layout: "
                     f"{nonzero(counts)}")
            ties = check_streams(torch, model, prompts, requests, news,
                                 device, label, refs=refs)
            summary = scheduler.metrics.summary()
            rate = summary["acceptance_rate"]
            if kind == "reject" and rate != 0.0 \
                    or kind == "accept" and not ties and rate != 1.0:
                fail(f"{label}: acceptance rate {rate}")
            print(f"{label}: {len(requests)} requests token-exact vs "
                  f"generate (near ties {ties}), acceptance rate {rate:.3f} "
                  f"({summary['spec_drafted']} drafted, "
                  f"{summary['spec_emitted']} emitted), steps "
                  f"{nonzero(engine.step_counts)}, launches "
                  f"{nonzero(counts)}, CUDA graphs "
                  f"{engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
                  flush=True)
            del draft
        del engine
    check_spec_int8(torch, model, prompts, news, refs, card)
    return by_t


def check_spec_int8(torch, model, prompts, news, refs, card):
    """Row 6 at T=5 on the token streams (f32, int8 pools, `kernel=
    'fused'`), screened as the demo's paged leg screens: a plain int8
    engine serves every prompt, and the requests whose greedy stream
    survives int8 K/V (token-exact against `generate`) are kept, a
    quarter of them at least; the same engine settings with
    NGramDraft(k=4) then serve the kept requests token-exact against
    `generate`, the int8 kernel launched once per layer per verify step
    at T=5, no capture after warm-up."""
    import numpy as np
    from flashy_tpu_torch.serve.draft import NGramDraft
    from flashy_tpu_torch.serve.engine import DecodeEngine
    device = model.embed.device
    kw = dict(slots=8, max_seq_len=256, cache_layout="paged",
              kernel="fused", block_size=16, kv_dtype="int8", device=device)
    lengths = [len(p) for p in prompts]
    wants = [ref[:len(p) + n] for p, ref, n in zip(prompts, refs, news)]
    screen = DecodeEngine(model, **kw)
    screen.warmup(prompt_lengths=lengths)
    _, requests, _, _ = serve(torch, screen, prompts, news)
    del screen
    kept = [i for i, r in enumerate(requests)
            if np.array_equal(r.output, wants[i])]
    label = "spec exact paged int8 ngram"
    if 4 * len(kept) < len(prompts):
        fail(f"{label}: the plain int8 engine kept {len(kept)} of "
             f"{len(prompts)} greedy streams, under a quarter")
    engine = DecodeEngine(model, spec_k=SPEC_K, **kw)
    engine.warmup(prompt_lengths=lengths)
    scheduler, requests, counts, seconds = serve(
        torch, engine, [prompts[i] for i in kept], [news[i] for i in kept],
        draft=NGramDraft(slots=8, k=SPEC_K, ngram=3))
    split = verify_launches(engine, counts, "paged_decode_int8", label)
    for i, request in zip(kept, requests):
        if not np.array_equal(request.output, wants[i]):
            first = int(np.nonzero(request.output != wants[i])[0][0])
            fail(f"{label}: request {i} (prompt {lengths[i]}), which the "
                 f"plain int8 engine serves token-exact, diverges from "
                 f"generate at position {first} under speculation")
    summary = scheduler.metrics.summary()
    print(f"{label}: {len(kept)} of {len(prompts)} requests kept by the "
          f"plain int8 engine (token-exact vs generate), all token-exact "
          f"under speculation, acceptance rate "
          f"{summary['acceptance_rate']:.3f}, launches {split}, CUDA "
          f"graphs {engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
          flush=True)


def spec_prompts(rng, vocab, n, length):
    """`n` prompts, each a random pattern of period 2-4 tiled out to
    `length` tokens (the reference demo's `_repetitive_mix` at length)."""
    import numpy as np
    out = []
    for _ in range(n):
        pattern = rng.integers(1, vocab, int(rng.integers(2, 5)))
        out.append(np.tile(pattern, length // len(pattern) + 1)[:length])
    return out


def check_spec_sampling(torch, model, card):
    """The verify step at temperature 1.0 as a captured graph over the
    engine's registered generator: twice, on two engines whose generators
    start from the same seed, on the same inputs; the tokens lie in the
    vocab and the two runs agree."""
    import numpy as np
    from flashy_tpu_torch.serve.engine import DecodeEngine
    device = model.embed.device
    runs = []
    for _ in range(2):
        generator = torch.Generator(device=device).manual_seed(5)
        engine = DecodeEngine(model, slots=8, block_size=16, max_seq_len=256,
                              cache_layout="paged", spec_k=SPEC_K,
                              temperature=1.0, generator=generator,
                              device=device)
        engine.warmup()
        step = engine.compile_cache.executables()[f"verify/8/{SPEC_K}"]
        if not getattr(step, "captured", False):
            fail("spec sampling: the verify step is not a captured graph")
        for slot in range(engine.slots):
            engine._set_slot(slot, 5, 3, True)   # writes land in sentinel
        runs.append(engine.decode_speculative(np.full((8, SPEC_K), 7)))
        engine._reset_slot_state()
        if engine.compile_cache.recompiles():
            fail(f"spec sampling: captured after warm-up "
                 f"{engine.compile_cache.stats()}")
        del engine
    (out_a, acc_a), (out_b, acc_b) = runs
    vocab = model.config.vocab_size
    if not (np.array_equal(out_a, out_b) and np.array_equal(acc_a, acc_b)) \
            or out_a.min() < 0 or out_a.max() >= vocab:
        fail(f"spec sampling: runs from one seed drew {out_a.tolist()} and "
             f"{out_b.tolist()}")
    print(f"spec sampling: the captured verify step at temperature 1.0 "
          f"(k={SPEC_K}) drew the same tokens from the same seed twice, "
          f"accepted {acc_a.tolist()}, emitted {out_a[:, 0].tolist()} "
          f"[{card}]", flush=True)


def check_generate_filters(torch, model, card):
    """`generate(top_k=50, top_p=0.9)` at temperature 1.0 on the card:
    twice from one seed, the same tokens, all in the vocab."""
    import numpy as np
    from flashy_tpu_torch.models.decoding import generate
    device = model.embed.device
    prompt = np.random.default_rng(10).integers(1, model.config.vocab_size,
                                                (2, 16))
    runs = [generate(model, prompt, max_new_tokens=16, temperature=1.0,
                     top_k=50, top_p=0.9, device=device,
                     generator=torch.Generator(device=device).manual_seed(9))
            for _ in range(2)]
    if not torch.equal(*runs) or int(runs[0].max()) >= model.config.vocab_size:
        fail(f"generate top-k/top-p: runs from one seed differ: "
             f"{runs[0].tolist()} {runs[1].tolist()}")
    print(f"generate top_k=50 top_p=0.9: 2 x 16 new tokens, the same from "
          f"one seed twice: {runs[0][0, 16:].tolist()} [{card}]", flush=True)


def phase_spec_serve(torch, device, card, requests_n=16, prompt_len=128,
                     max_new=128):
    """Speculative serving in bf16: the paged engine with NGramDraft(k=4)
    on 16 repetitive requests, in turns with the same engine settings and
    no draft (spec, plain, spec, plain): tokens/s, step p50, tokens per
    step, acceptance rate; an int8 pool with the same draft on 8 requests
    (the int8 kernel at T=5; its bf16 streams are checked for shape and
    vocab only, `check_spec_int8` holds the f32 ones to `generate`); the
    verify kernel at the verify shape (8
    slots, 5 queries) beside bound, plain and SDPA; the verify step
    sampling as a captured graph; `generate`'s top-k/top-p. Returns
    ({kernel: (launches by T, timing)}, summaries by turn)."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.draft import NGramDraft
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    engine_kw = dict(slots=8, block_size=16, max_seq_len=256,
                     cache_layout="paged", device=device)
    engines = {"spec": DecodeEngine(model, spec_k=SPEC_K, **engine_kw),
               "plain": DecodeEngine(model, **engine_kw)}
    for engine in engines.values():
        engine.warmup()
    prompts = spec_prompts(np.random.default_rng(8), cfg.vocab_size,
                           requests_n, prompt_len)
    summaries = {}
    out = {}
    for turn, kind in enumerate(("spec", "plain", "spec", "plain")):
        engine = engines[kind]
        draft = NGramDraft(slots=8, k=SPEC_K, ngram=3) \
            if kind == "spec" else None
        scheduler, requests, counts, seconds = serve(
            torch, engine, prompts, max_new, draft=draft)
        label = f"spec serve bf16 {kind} (turn {turn + 1})"
        if kind == "spec":
            split = verify_launches(engine, counts, "paged_decode", label)
        elif nonzero(counts) != {"paged_decode": cfg.num_layers * (
                engine.step_counts["decode"]
                + engine.step_counts["prefill_chunk"])}:
            fail(f"{label}: launches {nonzero(counts)}")
        check_outputs(requests, [prompt_len + max_new] * requests_n,
                      cfg.vocab_size, label)
        summary = scheduler.metrics.summary()
        steps = engine.step_counts["verify"] + engine.step_counts["decode"]
        summary["tokens_per_step"] = (summary["tokens"] - requests_n) / steps
        summary["step_ms_p50"] = step_p50_ms(scheduler)
        summaries.setdefault(kind, []).append(summary)
        print(f"{label}: {requests_n} requests x prompt {prompt_len} "
              f"(period 2-4) x {max_new} new, tokens/s="
              f"{summary['tokens_per_sec']:.1f}, step p50="
              f"{summary['step_ms_p50']:.3f} ms, tokens/step="
              f"{summary['tokens_per_step']:.2f} over {steps} steps, "
              f"acceptance rate={summary.get('acceptance_rate', 0.0):.3f}, "
              f"launches {nonzero(counts)}, {seconds:.2f}s [{card}]",
              flush=True)
    profile_serve(torch, engines["spec"], cfg.vocab_size, 8, prompt_len, 32,
                  card, label="profile spec", make_draft=lambda: NGramDraft(
                      slots=8, k=SPEC_K, ngram=3),
                  prompts=lambda rng: spec_prompts(rng, cfg.vocab_size, 8,
                                                   prompt_len))
    out["paged_decode"] = (split, time_kernel(torch, engines["spec"],
                                              prompt_len + max_new // 2,
                                              queries=SPEC_K + 1))
    del engines
    int8 = DecodeEngine(model, spec_k=SPEC_K, kv_dtype="int8", **engine_kw)
    int8.warmup()
    label = "spec int8 bf16"
    scheduler, requests, counts, seconds = serve(
        torch, int8, prompts[:8], 32,
        draft=NGramDraft(slots=8, k=SPEC_K, ngram=3))
    split8 = verify_launches(int8, counts, "paged_decode_int8", label)
    check_outputs(requests, [prompt_len + 32] * 8, cfg.vocab_size, label)
    int8.pool.check()
    summary = scheduler.metrics.summary()
    print(f"{label}: 8 requests x prompt {prompt_len} x 32 new on int8 "
          f"pools, acceptance rate={summary['acceptance_rate']:.3f}, launches "
          f"{nonzero(counts)} {split8}, {seconds:.2f}s [{card}]", flush=True)
    out["paged_decode_int8"] = (split8, time_kernel(
        torch, int8, prompt_len + max_new // 2, queries=SPEC_K + 1))
    del int8
    for name, (split, t) in out.items():
        print(f"spec serve bf16: kernel {name} at the verify shape (8 slots, "
              f"T={SPEC_K + 1}, context {prompt_len + max_new // 2}): device "
              f"{spread_text(t)} bound_ms={t['bound_ms']:.4f} "
              f"({t['bound_by']}, {t['bytes']} B) plain_ms="
              f"{t['plain_ms']:.4f} library_ms(sdpa on gathered view)="
              f"{t['library_ms']:.4f} host_us={t['host_us']:.1f}; launches "
              f"{split} [{card}]", flush=True)
    check_spec_sampling(torch, model, card)
    check_generate_filters(torch, model, card)
    return out, summaries


def phase_serve_demo(card):
    """`python -m flashy_tpu_torch.serve`'s six legs on the card, as a
    user runs it (`main` with `--kernel fused`: f32 tiny models, the
    paged leg through the Hopper kernel, the slo leg untraced then traced
    at sampling 1.0) and with the demo's default gates, in this process:
    its engines capture their graphs after the phases above dropped
    theirs. Every gate passes."""
    import logging
    from flashy_tpu_torch.serve.__main__ import logger, main as serve_main
    legs = "batching,speculative,chunked,paged,ssd,slo"
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: records.append(record)
    logger.addHandler(handler)
    t0 = time.perf_counter()
    try:
        rc = serve_main(["--legs", legs, "--kernel", "fused"])
    finally:
        logger.removeHandler(handler)
    lines = [r.getMessage() for r in records]
    if rc:
        errors = [r.getMessage() for r in records
                  if r.levelno >= logging.ERROR]
        fail(f"serve demo: python -m flashy_tpu_torch.serve --legs {legs} "
             f"--kernel fused returned {rc}: " + " | ".join(errors))
    gates = [line for line in lines if "verified:" in line
             or "acceptance" in line or "itl p50" in line]
    print(f"serve demo: python -m flashy_tpu_torch.serve --legs {legs} "
          f"--kernel fused on cuda: exit 0 in "
          f"{time.perf_counter() - t0:.1f}s; " + " | ".join(
              line[:160] for line in gates) + f" [{card}]", flush=True)


# ----------------------------------------------------------------------
# moe phases: the grouped-GEMM kernels, a dropless MoE step, MoE training
# ----------------------------------------------------------------------
GMM_SOURCE = "flashy_tpu_torch/csrc/grouped_matmul.cu"
# megablox lives in the installed JAX, not in the repo (`gmm` :314, its
# pallas_call :526, also run with transpose_rhs=True; `tgmm` :573,
# :763), reached from flashy_tpu/parallel/moe_ep.py:73-78 and
# megablox/ops.py `_gmm_bwd`
MEGABLOX = "jax/experimental/pallas/ops/tpu/megablox/gmm.py"
GMM_REPLACES = {"gmm": f"{MEGABLOX}:314", "gmm_t": f"{MEGABLOX}:314",
                "tgmm": f"{MEGABLOX}:573"}
# and the split kernel, which writes the f32 operand of megablox's f32
# products (`gmm` with transpose_rhs and `tgmm` on dY) as three bf16
# planes for them: in the kernels line, held bit-equal to `split_bf16`
GMM_KERNELS = {**GMM_REPLACES, "split_bf16": f"{MEGABLOX}:314"}
GMM_RTOL = 1e-5          # f32 outputs, relative to max |plain|
BF16_ULP = 2 ** -7       # one bf16 ulp, relative (>= the ulp of |value|)
# (E, M, K, N, group sizes): one row; empty first and last groups, a
# one-row group and sum < M; ragged groups at M = 4096 + 37; all rows in
# one group; an empty middle group and sum < M
GMM_CASES = ((1, 1, 64, 64, (1,)),
             (4, 100, 1024, 64, (0, 1, 60, 0)),
             (8, 4133, 64, 4096, (0, 700, 1, 1200, 0, 900, 1332, 0)),
             (8, 4133, 4096, 1024, (0, 0, 0, 4133, 0, 0, 0, 0)),
             (4, 4133, 1024, 1024, (1000, 0, 2000, 1000)),
             (1, 100, 4096, 64, (100,)))
# (E, M, K, N, group sizes) with K or N that 8 does not divide: the
# wrappers' padded route (zero columns in, the output sliced back)
GMM_PADDED_CASES = ((4, 333, 12, 100, (100, 0, 133, 90)),
                    (8, 1000, 1030, 12, (0, 200, 1, 300, 0, 99, 400, 0)),
                    (2, 500, 100, 1030, (250, 250)),
                    (4, 257, 12, 1030, (0, 0, 257, 0)),
                    (3, 300, 1030, 100, (100, 100, 100)))
# the grouped kernels' names in a profile: every grouped kernel, then the
# split kernel alone
GMM_WATCH = ("grouped_", "split_bf16_kernel")
MOE_ARGS = ["model.moe_experts=8", "model.moe_top_k=2",
            "model.moe_dispatch=dropless"]
MOE_TRAIN_LAYERS = 4     # `moe train`'s depth, of 12 (the time limit)
MOE_STEP_TOL = 1e-4      # dropless vs einsum: loss and each grad's norm
MOE_PLAIN_TOL = 1e-5     # kernels vs plain grouped matmuls, per leaf
# smallest top-3 probability gap a `moe step` batch may route at: the
# three runs' router inputs differ by f32 reordering upstream (~1e-7
# relative, ~1e-8 in a probability), so a 1e-6 gap cannot flip; over 12
# layers x 512 tokens a gap under 1e-5 is common (min 6e-6 seen)
MOE_TIE_GAP = 1e-6


def gmm_dtypes(torch):
    """(lhs, rhs, out) dtype combinations: both bf16 (the tensor cores),
    both f32 (the FMA kernel), and each mixed form (the tensor cores on
    the f32 operand's three bf16 planes) with a bf16 output, as the
    backward takes it, and with an f32 output, which holds the split
    route to the f32 bar."""
    bf, f32 = torch.bfloat16, torch.float32
    return ((bf, bf, f32), (f32, f32, f32), (f32, bf, bf), (bf, f32, bf),
            (f32, bf, f32), (bf, f32, f32))


def gmm_check(torch, got, want, label):
    """Max abs error of `got` against the plain `want`; fails past the
    bar: f32 within GMM_RTOL of max |want|; bf16 within one bf16 ulp of
    each value (BF16_ULP of |want|), with a floor of GMM_RTOL of max
    |want| where the f32 sum cancels to near zero."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0
    scale = max(want.abs().max().item(), 1e-30)
    diff = (got - want).abs()
    err = diff.max().item()
    excess = ((diff - BF16_ULP * want.abs()).max().item() if bf16
              else err)
    if not math.isfinite(err) or excess > GMM_RTOL * scale:
        fail(f"{label}: max abs err {err:.3e} (max |plain| {scale:.3e}; "
             f"bar {'one bf16 ulp' if bf16 else 'relative'} "
             f"{GMM_RTOL})")
    return err


def check_split(torch, G, x, label):
    """The split kernel's planes of the f32 CUDA tensor x bit-equal to the
    plain `split_bf16`'s (every step is exact or one rounding to nearest
    even), and the planes summing back to x in f64 where |x| >= 2^-110."""
    got = G._split_planes(x)
    want = torch.stack(G.split_bf16(x))
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        fail(f"split kernel {label}: planes not bit-equal to split_bf16")
    back = got.double().sum(0)
    normal = x.double().abs() >= 2.0 ** -110
    if not torch.equal(back[normal], x.double()[normal]):
        fail(f"split kernel {label}: hi + mid + lo != x")


def check_gmm_kernels(torch, device, card):
    """gmm, gmm_t and tgmm against their plain versions on GMM_CASES in
    every dtype combination (TF32 off), the mixed forms also against the
    plain version of the split route; rows of gmm past the groups and
    empty tgmm groups exactly zero; the split kernel bit-equal to
    `split_bf16`. Returns {kernel: max abs err}."""
    from flashy_tpu_torch.ops import grouped_matmul as G
    worst = {name: 0.0 for name in GMM_REPLACES}
    split_worst = 0.0
    for seed, (E, M, K, N, sizes) in enumerate(GMM_CASES + GMM_PADDED_CASES):
        padded = K % G.ALIGN != 0 or N % G.ALIGN != 0
        g = torch.Generator(device=device).manual_seed(seed)

        def draw(*shape):
            return torch.randn(shape, generator=g, device=device)

        gs = torch.tensor(sizes, dtype=torch.int32, device=device)
        total = sum(sizes)
        base = (draw(M, K), draw(E, K, N), draw(E, N, K), draw(M, N))
        for i, t in enumerate(base):
            if t.numel() % 4 == 0:
                check_split(torch, G, t, f"case {seed} operand {i}")
        before = dict(G.launch_counts)
        for a_t, b_t, o_t in gmm_dtypes(torch):
            lhs, rhs, rhs_t, dy = (base[0].to(a_t), base[1].to(b_t),
                                   base[2].to(b_t), base[3].to(b_t))
            tag = (f"E={E} M={M} K={K} N={N} sizes={sizes} "
                   f"{str(a_t)[6:]}x{str(b_t)[6:]}->{str(o_t)[6:]}")
            runs = {
                "gmm": (G.gmm(lhs, rhs, gs, o_t),
                        G._gmm_reference(lhs, rhs, gs, o_t)),
                "gmm_t": (G.gmm(lhs, rhs_t, gs, o_t, transpose_rhs=True),
                          G._gmm_reference(lhs, rhs_t, gs, o_t, True)),
                "tgmm": (G.tgmm(lhs, dy, gs, o_t),
                         G._tgmm_reference(lhs, dy, gs, o_t))}
            torch.cuda.synchronize()
            if a_t != b_t:
                split = {
                    "gmm": G._gmm_split_reference(lhs, rhs, gs, o_t),
                    "gmm_t": G._gmm_split_reference(lhs, rhs_t, gs, o_t,
                                                    True),
                    "tgmm": G._tgmm_split_reference(lhs, dy, gs, o_t)}
                for name, want in split.items():
                    split_worst = max(split_worst, gmm_check(
                        torch, runs[name][0], want,
                        f"{name} {tag} vs the split plain version"))
            for name, (got, want) in runs.items():
                worst[name] = max(worst[name], gmm_check(
                    torch, got, want, f"{name} {tag}"))
                if name != "tgmm" and total < M \
                        and got[total:].abs().max().item() != 0:
                    fail(f"{name} {tag}: rows past the groups not zero")
            empty = [i for i, n in enumerate(sizes) if n == 0]
            if empty and runs["tgmm"][0][empty].abs().max().item() != 0:
                fail(f"tgmm {tag}: empty groups {empty} not exactly zero")
        for name in GMM_REPLACES:
            route = f"{name}_padded" if padded else name
            other = name if padded else f"{name}_padded"
            if G.launch_counts[route] == before[route] or \
                    G.launch_counts[other] != before[other]:
                fail(f"{name} E={E} M={M} K={K} N={N}: not launched on the "
                     f"{route} route alone")
    print(f"gmm kernels: {len(GMM_CASES)} cases and {len(GMM_PADDED_CASES)} "
          f"with K or N in (12, 100, 1030) (the padded route) x "
          f"{len(gmm_dtypes(torch))} dtype combinations (bf16 x bf16 -> "
          f"f32, f32 x f32 -> f32, f32 x bf16 and bf16 x f32 -> bf16 and "
          f"-> f32), empty first/last/middle groups, a one-row group, all "
          f"rows in one group, sum < M: max abs err vs plain " + ", ".join(
              f"{k}={v:.3e}" for k, v in worst.items())
          + f"; the mixed forms vs the split route's plain version "
          f"{split_worst:.3e} (bars: f32 {GMM_RTOL} of max |plain|, bf16 "
          f"one ulp); rows past the groups and empty tgmm groups exactly "
          f"zero; the split kernel's planes bit-equal to split_bf16 on "
          f"every case's operands [{card}]", flush=True)
    return worst


def router_margin(torch, model, tokens):
    """The smallest f32 top-3 probability gap (p1 - p2 or p2 - p3) any
    MoE layer of `model` sees on `tokens`: the routing decision closest
    to flipping."""
    from flashy_tpu_torch.models.moe import MoEMLP
    gaps = []

    def hook(module, args):
        x = args[0].reshape(-1, args[0].shape[-1]).float()
        top = torch.topk(torch.softmax(x @ module.router.kernel, -1), 3).values
        gaps.append(torch.minimum(top[:, 0] - top[:, 1],
                                  top[:, 1] - top[:, 2]).min())

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, MoEMLP)]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for handle in handles:
            handle.remove()
    return min(gap.item() for gap in gaps)


def phase_moe_step(torch, device, card):
    """The full-width MoE model (8 experts, top-2, every block) in f32 at
    batch 2, seq 256: loss and every gradient through the grouped-matmul
    kernels ('dropless'), through their plain versions (the reference
    functions called directly), and through 'einsum' at capacity factor
    8.0, where nothing drops. The batch is the first of the synthetic
    stream's whose routing has no top-3 gap under MOE_TIE_GAP."""
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import grouped_matmul as G
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.parallel import moe_ep

    def config(dispatch):
        return moe_step_config(torch, dispatch)

    stream = synthetic_token_stream(32768)
    model = TransformerLM(config("dropless"), device=device, seed=3)
    for step in range(32):
        tokens = torch.from_numpy(stream(2, 256, step)).long().to(device)
        margin = router_margin(torch, model, tokens)
        if margin > MOE_TIE_GAP:
            break
    else:
        fail(f"moe step: every candidate batch routes a token at a near "
             f"tie (last margin {margin:.2e})")
    del model
    results, counts = {}, {}
    reference = (moe_ep.gmm, moe_ep.tgmm)
    for label, dispatch in (("dropless", "dropless"), ("plain", "dropless"),
                            ("einsum", "einsum")):
        model = TransformerLM(config(dispatch), device=device, seed=3)
        if label == "plain":
            moe_ep.gmm, moe_ep.tgmm = G._gmm_reference, G._tgmm_reference
        G.reset_launch_counts()
        try:
            # the LM solver's MoE loss, at its default aux weight
            loss = lm_next_token_loss(model, tokens, aux_weight=0.01)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            moe_ep.gmm, moe_ep.tgmm = reference
        counts[label] = dict(G.launch_counts)
        results[label] = (loss.item(), {name: p.grad for name, p in
                                        model.named_parameters()})
        kern_params = sum(p.numel() for p in model.parameters())
        del model
    layers = 12
    want = {"gmm": 2 * layers, "gmm_t": 2 * layers, "tgmm": 2 * layers,
            "split_bf16": 0}
    if nonzero(counts["dropless"]) != nonzero(want) \
            or any(counts["plain"].values()) \
            or any(counts["einsum"].values()):
        fail(f"moe step: launches {counts}, expected {want} in the "
             f"dropless run only")
    kern, plain, einsum = (results[k] for k in ("dropless", "plain",
                                                 "einsum"))
    plain_loss = abs(kern[0] - plain[0]) / abs(plain[0])
    plain_worst = max(rel_err(grad, plain[1][name])
                      for name, grad in kern[1].items())
    if not math.isfinite(plain_worst) or plain_worst > MOE_PLAIN_TOL \
            or plain_loss > MOE_PLAIN_TOL:
        fail(f"moe step: kernels vs plain grouped matmuls: loss rel err "
             f"{plain_loss:.2e}, grads max rel err {plain_worst:.2e} "
             f"(limit {MOE_PLAIN_TOL})")
    ein_loss = abs(kern[0] - einsum[0]) / abs(einsum[0])
    ein_worst = max(abs(grad.norm().item() - einsum[1][name].norm().item())
                    / max(einsum[1][name].norm().item(), 1e-30)
                    for name, grad in kern[1].items())
    if not math.isfinite(ein_worst) or ein_worst > MOE_STEP_TOL \
            or ein_loss > MOE_STEP_TOL:
        fail(f"moe step: dropless vs einsum: loss rel err {ein_loss:.2e}, "
             f"grad norms max rel err {ein_worst:.2e} (limit "
             f"{MOE_STEP_TOL})")
    print(f"moe step: {kern_params / 1e6:.0f}M MoE (8 experts, top-2) "
          f"f32 b2 t256, batch "
          f"{step} of the stream (min routing gap {margin:.2e}), loss "
          f"{kern[0]:.6f}; kernels vs plain grouped matmuls: loss rel err "
          f"{plain_loss:.2e}, grads max rel err {plain_worst:.2e} (limit "
          f"{MOE_PLAIN_TOL}); dropless vs einsum (capacity 8.0): loss rel "
          f"err {ein_loss:.2e}, {len(kern[1])} grad norms max rel err "
          f"{ein_worst:.2e} (limit {MOE_STEP_TOL}); launches {want} "
          f"[{card}]", flush=True)
    return {"step": step, "loss": kern[0]}


def phase_moe_train(torch, card, folder):
    """The 235M layout with every MLP 8 top-2 dropless experts at
    MOE_TRAIN_LAYERS of its 12 layers, bf16, batch 16, seq 1024, through
    `main` in a fresh XP: 1 epoch of 6 steps and 2 valid steps. Returns
    (grouped-matmul launch counts, the solver)."""
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.models.moe import moe_aux_loss
    from flashy_tpu_torch.ops import attention, grouped_matmul
    from flashy_tpu_torch.utils import percentile
    args = [a for a in TRAIN_ARGS if not a.startswith(("steps_per_epoch",
                                                       "valid_steps"))]
    args += MOE_ARGS + [f"model.num_layers={MOE_TRAIN_LAYERS}",
                        "steps_per_epoch=6", "valid_steps=2", "epochs=1",
                        f"dora.dir={folder}"]
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    grouped_matmul.reset_launch_counts()
    solver = lm_main(args)
    torch.cuda.synchronize()
    counts = dict(grouped_matmul.launch_counts)
    flash = {k: v for k, v in attention.launch_counts.items() if v}
    cfg = solver.cfg
    train_steps, valid_steps = cfg.steps_per_epoch, cfg.valid_steps
    layers = cfg.model.num_layers
    # the split kernel: once in each of a layer's two backward launches
    # on the f32 dY (gmm_t dY.W_down^T and tgmm H^T.dY)
    want = {"gmm": 2 * layers * (train_steps + valid_steps),
            "gmm_t": 2 * layers * train_steps,
            "tgmm": 2 * layers * train_steps,
            "split_bf16": 2 * layers * train_steps}
    want_flash = {"flash_fwd": layers * (train_steps + valid_steps),
                  "flash_bwd_fused": layers * train_steps}
    if nonzero(counts) != want or flash != want_flash:
        fail(f"moe train: launches {counts} and {flash}, expected {want} "
             f"and {want_flash}")
    losses = solver.step_losses
    aux = moe_aux_loss(solver.model).item()
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0] \
            or not math.isfinite(aux):
        fail(f"moe train: step losses {losses} not finite and falling, or "
             f"aux {aux} not finite")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.seq_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params = sum(p.numel() for p in solver.model.parameters())
    print(f"moe train: {params / 1e6:.0f}M MoE (8 dropless experts, top-2)"
          f" {str(solver.model.config.dtype)[6:]} b{cfg.batch_size} "
          f"t{cfg.seq_len}, {train_steps} steps + {valid_steps} valid, "
          f"step losses {losses[0]:.4f} -> {losses[-1]:.4f}, last aux "
          f"{aux:.4f}, tokens/s={tok_s:.1f}, step p50={p50:.2f} ms (steps "
          f"3..{train_steps}), peak memory {peak:.1f} GiB; launches "
          f"{counts}, {flash} [{card}]", flush=True)
    return counts, solver


def gmm_bound(M, K, N, E, a_elem, b_elem, o_elem, tgmm):
    """(bound ms, 'bytes' | 'operations' | 'operations (split bf16)') of
    one grouped product over M routed rows, against each input read once
    and the output written once over 3.35 TB/s: 2 M K N operations at
    the bf16 tensor-core peak for two bf16 operands; with one f32
    operand the kernels compute the same function as three bf16
    products (its hi, mid and lo planes), so 3 x 2 M K N at the bf16
    peak (as f32 FMAs at the 67 TFLOP/s f32 peak the figure would be 5x
    higher and no bound on what the kernel does); two f32 operands at
    the f32 peak."""
    rhs = M * N * b_elem if tgmm else E * K * N * b_elem
    out = E * K * N * o_elem if tgmm else M * N * o_elem
    nbytes = M * K * a_elem + rhs + out + 4 * E
    f32_operands = (a_elem, b_elem).count(4)
    if f32_operands == 2:
        op_ms, by = 2 * M * K * N / F32_FLOPS * 1e3, "operations"
    else:
        products = 3 if f32_operands else 1
        op_ms = products * 2 * M * K * N / BF16_FLOPS * 1e3
        by = "operations (split bf16)" if f32_operands else "operations"
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "bytes" if byte_ms >= op_ms else by


def library_ms(torch, fn):
    """CUDA-event ms of one PyTorch call (device time), or (None, why)
    where this card's torch has no call that takes these operands."""
    try:
        fn()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError, TypeError, ValueError) as err:
        return None, str(err).splitlines()[0][:80]
    return time_ms(torch, fn, iters=20, device_only=True), ""


def host_us(torch, fn, calls=20):
    """Host microseconds of a wrapper call as enqueued: `calls` calls
    without a synchronize inside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def gmm_training_launches(torch, device):
    """The grouped kernels' six launches of a layer at the training shapes
    (32768 routed rows = 16 x 1024 tokens x top-2, dim 1024, hidden 4096,
    8 experts, group sizes of a seeded multinomial draw): (sizes, M, E,
    D, F, the launches as (kernel, label, kernel call, plain call,
    library call or None, (M, K, N), operand element sizes), dY, a dense
    product of the same size as a reference point)."""
    import numpy as np
    from flashy_tpu_torch.ops import grouped_matmul as G
    bf, f32 = torch.bfloat16, torch.float32
    E, D, F = 8, 1024, 4096
    sizes = np.random.default_rng(0).multinomial(32768, [1 / E] * E)
    M = int(sizes.sum())
    gs = torch.tensor(sizes, dtype=torch.int32, device=device)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    g = torch.Generator(device=device).manual_seed(9)

    def draw(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    x, h = draw(M, D), draw(M, F)
    dh, dy = draw(M, F), draw(M, D, dtype=f32)
    w_up, w_down = draw(E, D, F) * 0.02, draw(E, F, D) * 0.02
    grouped = getattr(torch, "_grouped_mm", None)

    def lib(fn):
        return None if grouped is None else fn

    launches = (
        ("gmm", "up X.W_up bf16xbf16->f32",
         lambda: G.gmm(x, w_up, gs, f32),
         lambda: G._gmm_reference(x, w_up, gs, f32),
         lib(lambda: grouped(x, w_up, offs=offs)), (M, D, F), (2, 2, 4)),
        ("gmm", "down H.W_down bf16xbf16->f32",
         lambda: G.gmm(h, w_down, gs, f32),
         lambda: G._gmm_reference(h, w_down, gs, f32),
         lib(lambda: grouped(h, w_down, offs=offs)), (M, F, D), (2, 2, 4)),
        ("gmm_t", "dH dY.W_down^T f32xbf16->bf16",
         lambda: G.gmm(dy, w_down, gs, bf, transpose_rhs=True),
         lambda: G._gmm_reference(dy, w_down, gs, bf, True), None,
         (M, D, F), (4, 2, 2)),
        ("gmm_t", "dX dH.W_up^T bf16xbf16->bf16",
         lambda: G.gmm(dh, w_up, gs, bf, transpose_rhs=True),
         lambda: G._gmm_reference(dh, w_up, gs, bf, True),
         lib(lambda: grouped(dh, w_up.transpose(-2, -1), offs=offs)),
         (M, F, D), (2, 2, 2)),
        ("tgmm", "dW_down H^T.dY bf16xf32->bf16",
         lambda: G.tgmm(h, dy, gs, bf),
         lambda: G._tgmm_reference(h, dy, gs, bf), None, (M, F, D),
         (2, 4, 2)),
        ("tgmm", "dW_up X^T.dH bf16xbf16->bf16",
         lambda: G.tgmm(x, dh, gs, bf),
         lambda: G._tgmm_reference(x, dh, gs, bf),
         lib(lambda: grouped(x.t(), dh, offs=offs)), (M, D, F), (2, 2, 2)))
    return (sizes, M, E, D, F, launches, dy,
            lambda: torch.matmul(x, w_up[0]))


def time_gmm(torch, device, card):
    """Each grouped kernel at the training shapes (`gmm_training_launches`),
    both of each kernel's launches in a layer, first held against the
    plain version there (as `check_gmm_kernels` does), then timed three
    times (`time_runs`: CUDA events, device time, median and spread)
    beside the bound, the plain version and torch._grouped_mm where it
    takes the operands, with the wrapper's host us a call; then the split
    kernel alone on dY. Returns ({kernel: per-launch means},
    {kernel: max abs err})."""
    from flashy_tpu_torch.ops import grouped_matmul as G
    sizes, M, E, D, F, launches, dy, dense_fn = gmm_training_launches(
        torch, device)
    grouped = getattr(torch, "_grouped_mm", None)
    rows, errors = [], {name: 0.0 for name in GMM_REPLACES}
    for name, label, kernel, plain, library, (m, k, n), elems in launches:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errors[name] = max(errors[name],
                           gmm_check(torch, got, want, f"{name} {label}"))
        del got, want
        bound, bound_by = gmm_bound(m, k, n, E, *elems, tgmm=name == "tgmm")
        lib_ms, why = (library_ms(torch, library) if library
                       else (None, "no library call takes an f32 operand"
                             if grouped else "torch._grouped_mm absent"))
        rows.append((name, label, time_runs(torch, kernel, iters=20),
                     time_ms(torch, plain, iters=3), bound, bound_by,
                     lib_ms, why, host_us(torch, kernel)))
    # the split kernel alone on dY (inside both f32-operand launches above)
    check_split(torch, G, dy, "dY at the training shapes")
    errors["split_bf16"] = 0.0   # bit-equal, or check_split failed
    n_dy = dy.numel()
    split_bound = n_dy * (4 + 3 * 2) / HBM_BYTES_PER_S * 1e3
    split = {**time_runs(torch, lambda: G._split_planes(dy), iters=20),
             "plain_ms": time_ms(torch, lambda: G.split_bf16(dy), iters=5),
             "bound_ms": split_bound, "bound_by": "bytes",
             "library_ms": None}
    dense = time_ms(torch, dense_fn, iters=20, device_only=True)
    print(f"gmm times ({M} routed rows, D {D}, F {F}, {E} experts, "
          f"sizes {sizes.tolist()}; device time, three runs): " + "; ".join(
              f"{name} {label} {spread_text(t_)} bound_ms={bound:.4f} "
              f"({bound_by}) plain_ms={plain_ms:.4f} library_ms="
              + (f"{lib_ms:.4f}" if lib_ms is not None else f"none ({why})")
              + f" host_us={us:.1f}"
              for name, label, t_, plain_ms, bound, bound_by, lib_ms, why, us
              in rows)
          + f"; split kernel on dY [{M}, {D}] {spread_text(split)} "
          f"bound_ms={split_bound:.4f} (bytes) plain_ms="
          f"{split['plain_ms']:.4f} (inside both f32-operand launches' "
          f"ms); reference point, not the same function: dense "
          f"torch.matmul [{M}, {D}] x [{D}, {F}] bf16 ms={dense:.4f}; max "
          f"abs err vs plain " + ", ".join(
              f"{k}={v:.3e}" for k, v in errors.items()) + "; host_us: a "
          f"wrapper call as enqueued (the tensor maps, the split launch); "
          f"library: torch._grouped_mm, whose output takes the operands' "
          f"dtype (bf16 where the kernel writes f32: half the output "
          f"bytes) [{card}]", flush=True)
    times = {}
    for name in GMM_REPLACES:
        mine = [r for r in rows if r[0] == name]
        libs = [r[6] for r in mine]
        times[name] = {
            "ms": sum(r[2]["ms"] for r in mine) / len(mine),
            "spread": max(r[2]["spread"] for r in mine),
            "plain_ms": sum(r[3] for r in mine) / len(mine),
            "bound_ms": sum(r[4] for r in mine) / len(mine),
            "bound_by": max(mine, key=lambda r: r[4])[5],
            "library_ms": (None if None in libs
                           else sum(libs) / len(libs))}
    times["split_bf16"] = split
    return times, errors


# ----------------------------------------------------------------------
# ring phases: the ring-attention kernel, the ring step, ring training
# ----------------------------------------------------------------------
RING_SOURCE = "flashy_tpu_torch/csrc/ring_attention.cu"
RING_REPLACES = "flashy_tpu/parallel/ring_fused.py:78"
RING_RTOL = 1e-5               # f32 out and lse, relative to max |plain|
RING_CASES = tuple((n, t, causal) for n in (1, 2, 4, 8)
                   for t in (64, 100, 512) for causal in (True, False))
RING_ARGS = ["model.attention=ring_fused", "mesh.seq=4", "seq_len=2048",
             "batch_size=8"]


def ring_inputs(torch, device, dtype, n, t, B=2, H=16, D=64, seed=0):
    """Global q, k, v [B, n t, H, D] in `dtype` and each one's n
    contiguous rank blocks."""
    g = torch.Generator(device=device).manual_seed(seed)
    full = [torch.randn((B, n * t, H, D), generator=g, device=device
                        ).to(dtype) for _ in range(3)]
    return full, [[x.contiguous() for x in y.split(t, dim=1)] for y in full]


def compare_ring(torch, qs, ks, vs, causal, label):
    """Each rank's kernel launch against the plain version on the same
    blocks: f32 out and lse within RING_RTOL of max |plain|; bf16 out
    within one ulp with at most PLACEMENT_SHARE of the outputs not
    bit-equal, lse within RING_RTOL relative. Fails on a miss; returns
    (max abs err of out, the largest share not bit-equal, the global
    output of the kernel)."""
    from flashy_tpu_torch.parallel.ring_fused import (ring_forward,
                                                      ring_forward_plain)
    err = share = 0.0
    outs = []
    for rank, q in enumerate(qs):
        out, lse = ring_forward(q, ks, vs, rank, causal)
        want, want_lse = ring_forward_plain(q, ks, vs, rank, causal)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        lse_rel = rel_err(lse, want_lse)
        if q.dtype == torch.float32:
            bad = rel_err(out, want) > RING_RTOL
        else:
            excess = (diff - PLACEMENT_RTOL * want.float().abs()).max().item()
            share = max(share, (out != want).float().mean().item())
            bad = excess > PLACEMENT_ATOL or share > PLACEMENT_SHARE
        if bad or lse_rel > RING_RTOL or not math.isfinite(diff.max().item()):
            fail(f"{label} rank {rank}: out max abs err {diff.max().item()}, "
                 f"{share:.4f} not bit-equal, lse rel err {lse_rel}")
        err = max(err, diff.max().item())
        outs.append(out)
    return err, share, torch.cat(outs, dim=1)


# (n ranks, t rows, causal) of the ring checks at the head dims other than
# 64 (every head dim of FLASH_DIMS; at 64 RING_CASES)
RING_WIDE_CASES = ((1, 64, True), (4, 100, True), (4, 128, False))


def check_ring_kernel(torch, device, card):
    """The ring forward against its plain version, one launch per rank:
    at head_dim 64 on RING_CASES (n ranks of t rows, B 2, H 16, causal
    and not), at the other head dims of FLASH_DIMS on RING_WIDE_CASES;
    f32 and bf16, each on the route its dtype and head dim pick (the ring
    kernel in bf16 at 64 and 128, else the flash forward's general route
    over the visible steps' blocks); the global output against the scan
    ring and dense attention over the gathered sequence at the flash bars;
    one rank bit-equal to the flash forward of its route (the same tile
    code). Returns {dtype: {launch counter name: max abs err}}."""
    from flashy_tpu_torch.ops import attention as A
    from flashy_tpu_torch.parallel import (make_mesh, ring_fused,
                                           ring_self_attention)
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = FLASH_TOL[name]
        worst, share, scan_err, dense_err = {}, 0.0, 0.0, 0.0
        for D in FLASH_DIMS:
            route = A.counter_name("ring_fwd", D, dtype)
            cases = RING_CASES if D == 64 else RING_WIDE_CASES
            for seed, (n, t, causal) in enumerate(cases):
                label = f"ring {name} D={D} n={n} t={t} causal={causal}"
                (q, k, v), (qs, ks, vs) = ring_inputs(
                    torch, device, dtype, n, t, D=D, seed=seed + D - 64)
                before = ring_fused.launch_counts[route]
                err, share_c, out = compare_ring(torch, qs, ks, vs, causal,
                                                 label)
                if ring_fused.launch_counts[route] != before + n:
                    fail(f"{label}: not launched on {route}")
                worst[route] = max(worst.get(route, 0.0), err)
                share = max(share, share_c)
                scan = ring_self_attention(q, k, v, mesh=make_mesh(
                    {"seq": n}), causal=causal, impl="scan")
                dense = A.dot_product_attention(q, k, v, causal=causal)
                e_scan = (out.float() - scan.float()).abs().max().item()
                e_dense = (out.float() - dense.float()).abs().max().item()
                if not e_scan <= tol or not e_dense <= tol:
                    fail(f"{label}: vs scan ring {e_scan}, vs dense "
                         f"{e_dense} (limit {tol})")
                scan_err = max(scan_err, e_scan)
                dense_err = max(dense_err, e_dense)
                if n == 1:
                    # the ring runs the flash forward's step on either route
                    got = ring_fused.ring_forward(qs[0], ks, vs, 0, causal)
                    want = A.flash_forward(q, k, v, causal)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        fail(f"{label}: one rank not bit-equal to the flash "
                             f"forward")
                del q, k, v, qs, ks, vs, out, scan, dense
        errors[name] = worst
        placement = (f", {share:.4f} of outputs not bit-equal (limit "
                     f"{PLACEMENT_SHARE}), each within one ulp"
                     if dtype == torch.bfloat16 else
                     f" (limit {RING_RTOL} of max |plain|)")
        print(f"ring kernel {name}: D 64 x {len(RING_CASES)} cases (n "
              f"1/2/4/8, t 64/100/512, causal and not), the other D of "
              f"{FLASH_DIMS} x {RING_WIDE_CASES}; vs plain max abs err "
              + ", ".join(f"{key}={value:.3e}" for key, value in worst.items())
              + f"{placement}; vs scan ring {scan_err:.3e}, vs dense "
              f"{dense_err:.3e} (limit {tol}); one rank == flash forward "
              f"bitwise [{card}]", flush=True)
    return errors


def phase_ring_step(torch, device, card, heads=16, label="ring step"):
    """Loss and grads of the full-width model (`heads` heads) in f32 at
    batch 2, seq 256 on a 4-rank ring: 'ring_fused' against 'ring' (the
    same backward: within RING_RTOL) and both against 'flash'
    (STEP_REL_TOL per leaf), each run's launches counted on the head
    dim's route. Returns the ring_fused run's launch counts."""
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.parallel import make_mesh, ring_fused
    tokens = torch.from_numpy(synthetic_token_stream(32768)(2, 256, 0)
                              ).long().to(device)
    results, counts = {}, {}
    mesh = make_mesh({"seq": 4}, devices=[device] * 4)
    for kind in ("ring_fused", "ring", "flash"):
        model = TransformerLM(model_config(torch, torch.float32, 256, kind,
                                           num_heads=heads),
                              device=device, seed=3, mesh=mesh)
        attention.reset_launch_counts()
        ring_fused.reset_launch_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss = lm_next_token_loss(model, tokens)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        counts[kind] = {key: value for key, value in
                        {**attention.launch_counts,
                         **ring_fused.launch_counts}.items() if value}
        results[kind] = (loss.item(), {name: p.grad for name, p in
                                       model.named_parameters()})
        del model
    layers, pairs = 12, 10                   # visible (rank, step) pairs
    name = lambda kernel: attention.counter_name(  # noqa: E731
        kernel, 1024 // heads, torch.float32)
    want = {"ring_fused": {name("ring_fwd"): layers * 4,
                           name("flash_bwd_dq"): layers * pairs,
                           name("flash_bwd_dkv"): layers * pairs},
            "ring": {name("flash_fwd"): layers * pairs,
                     name("flash_bwd_dq"): layers * pairs,
                     name("flash_bwd_dkv"): layers * pairs},
            "flash": {name("flash_fwd"): layers,
                      name("flash_bwd_fused"): layers}}
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    fused, scan, flash = (results[k] for k in ("ring_fused", "ring",
                                                "flash"))

    def worst(a, b):
        return max(abs(a[0] - b[0]) / abs(b[0]),
                   max(rel_err(grad, b[1][name])
                       for name, grad in a[1].items()))

    fused_scan, scan_flash, fused_flash = (worst(fused, scan),
                                           worst(scan, flash),
                                           worst(fused, flash))
    if not fused_scan <= RING_RTOL or not max(scan_flash, fused_flash) \
            <= STEP_REL_TOL:
        fail(f"{label}: ring_fused vs ring {fused_scan:.2e} (limit "
             f"{RING_RTOL}); ring vs flash {scan_flash:.2e}, ring_fused vs "
             f"flash {fused_flash:.2e} (limit {STEP_REL_TOL})")
    print(f"{label}: 235M ({heads} heads of {1024 // heads}) f32 b2 t256 "
          f"on 4 ring ranks, loss "
          f"{fused[0]:.6f}; loss and all {len(fused[1])} grads, max rel "
          f"err: ring_fused vs ring {fused_scan:.2e} (limit {RING_RTOL}), "
          f"ring vs flash {scan_flash:.2e}, ring_fused vs flash "
          f"{fused_flash:.2e} (limit {STEP_REL_TOL}); launches {counts} "
          f"[{card}]", flush=True)
    return counts["ring_fused"]


def phase_ring_train(torch, card, folder, heads=16, steps=6, valid=2,
                     label="ring train"):
    """The 235M layout (`heads` heads) in bf16 with attention=
    'ring_fused' on a 4-rank ring (batch 8, seq 2048: 16384 tokens a
    step, as `train`) through `main` in a fresh XP: 1 epoch of `steps`
    steps and `valid` valid steps; the launches on the head dim's routes.
    Returns (launch counts, the solver)."""
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.parallel import ring_fused
    from flashy_tpu_torch.utils import percentile
    args = [a for a in TRAIN_ARGS if not a.startswith(
        ("steps_per_epoch", "valid_steps", "seq_len", "batch_size",
         "model.num_heads"))]
    args += RING_ARGS + [f"model.num_heads={heads}",
                         f"steps_per_epoch={steps}", f"valid_steps={valid}",
                         "epochs=1", f"dora.dir={folder}"]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    attention.reset_launch_counts()
    ring_fused.reset_launch_counts()
    solver = lm_main(args)
    torch.cuda.synchronize()
    counts = {**attention.launch_counts, **ring_fused.launch_counts}
    cfg = solver.cfg
    train_steps, valid_steps = cfg.steps_per_epoch, cfg.valid_steps
    layers, ranks, pairs = cfg.model.num_layers, cfg.mesh.seq, 10
    name = lambda kernel: attention.counter_name(  # noqa: E731
        kernel, 1024 // heads, torch.bfloat16)
    want = {name("ring_fwd"): layers * ranks * (train_steps + valid_steps),
            name("flash_bwd_dq"): layers * pairs * train_steps,
            name("flash_bwd_dkv"): layers * pairs * train_steps}
    if nonzero(counts) != want:
        fail(f"{label}: launches {counts}, expected {want}")
    losses = solver.step_losses
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{label}: step losses {losses} not finite and falling")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.seq_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    print(f"{label}: 235M ({heads} heads of {1024 // heads}) bf16 "
          f"b{cfg.batch_size} t{cfg.seq_len} on "
          f"{ranks} ring ranks (attention=ring_fused), {train_steps} steps "
          f"+ {valid_steps} valid, step losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, tokens/s={tok_s:.1f}, step p50={p50:.2f} ms "
          f"(steps 3..{train_steps}), peak memory {peak:.1f} GiB above the "
          f"{held / 2 ** 30:.1f} GiB held before the phase; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]", flush=True)
    return counts, solver


def ring_bound(B, H, t, D, ranks, elem):
    """(bound ms, 'bytes' | 'operations') of the causal ring forward of
    `ranks` (each rank's visible blocks: r full and its own triangle):
    4 D operations per visible (query, key) pair at the bf16 peak against
    q, out and the visible K and V blocks in `elem` bytes and the f32
    lse, each once (f32 inputs: operations at the f32 peak). For every
    rank of the ring together the K and V inputs are the whole
    sequence's."""
    pairs = sum(r * t * t + t * (t + 1) // 2 for r in ranks)
    block = B * t * H * D * elem
    k_v = 2 * (max(ranks) + 1) * block   # owners 0..max(ranks) are visible
    nbytes = 2 * len(ranks) * block + k_v + len(ranks) * B * H * t * 4
    op_ms = 4 * D * B * H * pairs / (BF16_FLOPS if elem == 2
                                     else F32_FLOPS) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "bytes" if byte_ms >= op_ms else "operations"


def time_ring(torch, device, card, H=16, D=64):
    """The ring kernel at the training shapes (4 ranks of [8, 512, H, D],
    bf16, causal), held against its plain version as in `ring kernel`,
    then timed with CUDA events per rank's launch and for the four
    together, beside the bound, the plain version and one
    F.scaled_dot_product_attention(is_causal=True) call over the whole
    2048-token sequence; then the split backward pair on the same blocks
    (`time_ring_backward`). Returns (the four launches' times, max abs
    err, the split pair's times and errors)."""
    import torch.nn.functional as F
    from flashy_tpu_torch.parallel.ring_fused import (ring_forward,
                                                      ring_forward_plain,
                                                      tensor_map_us)
    B, t, n = 8, 512, 4
    (q, k, v), (qs, ks, vs) = ring_inputs(torch, device, torch.bfloat16, n,
                                          t, B=B, H=H, D=D, seed=11)
    err, share, _ = compare_ring(torch, qs, ks, vs, True,
                                 "ring bfloat16 at the training shapes")
    rows = []
    for rank in range(n):
        bound, by = ring_bound(B, H, t, D, [rank], 2)
        rows.append((rank, time_runs(torch, lambda: ring_forward(
            qs[rank], ks, vs, rank, True), iters=20), bound, by,
            time_ms(torch, lambda: ring_forward_plain(
                qs[rank], ks, vs, rank, True), iters=3)))

    def all_ranks():
        for rank in range(n):
            ring_forward(qs[rank], ks, vs, rank, True)

    def all_plain():
        for rank in range(n):
            ring_forward_plain(qs[rank], ks, vs, rank, True)

    # host cost of a launch: the tensor maps it encodes, and the whole
    # wrapper call as enqueued (no synchronize inside the loop)
    map_us = tensor_map_us(qs[0])
    all_ranks()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(25):
        all_ranks()
    host_us = (time.perf_counter() - t0) / (25 * n) * 1e6
    torch.cuda.synchronize()
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound, by = ring_bound(B, H, t, D, list(range(n)), 2)
    times = {**time_runs(torch, all_ranks, iters=20),
             "plain_ms": time_ms(torch, all_plain, iters=3),
             "bound_ms": bound, "bound_by": by,
             "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, is_causal=True), iters=20)}
    print(f"ring times ({n} ranks of B{B} H{H} t{t} D{D}, causal, bf16; vs "
          f"plain max abs err {err:.3e}, {share:.4f} not bit-equal): "
          + "; ".join(f"rank {r} {spread_text(ms)} bound_ms={b:.4f} ({by_}) "
                      f"plain_ms={p:.4f}" for r, ms, b, by_, p in rows)
          + f"; the four launches {spread_text(times)} bound_ms="
          f"{times['bound_ms']:.4f} ({times['bound_by']}) plain_ms="
          f"{times['plain_ms']:.4f} library_ms={times['library_ms']:.4f} "
          f"(F.scaled_dot_product_attention, is_causal, T 2048); host: "
          f"{map_us:.2f} us to encode a tensor map, {1 + 2 * n} a launch, "
          f"{host_us:.1f} us a wrapper call as enqueued [{card}]",
          flush=True)
    pair_times, pair_errors = time_ring_backward(torch, qs, ks, vs, card)
    return times, err, pair_times, pair_errors


def flash_library_backward(torch, q, k, v, do, out, lse, causal, scale):
    """aten's flash-attention backward (the kernel behind
    F.scaled_dot_product_attention's backward) on one block pair, handed
    the pair's GLOBAL out and lse: (dq, dk, dv) of the same function as
    the split pair's, in one call. Returns that call."""
    aten = torch.ops.aten
    qh, kh, vh, doh, oh = (x.transpose(1, 2) for x in (q, k, v, do, out))
    aux = aten._scaled_dot_product_flash_attention(
        qh, kh, vh, 0.0, causal, False, scale=scale)[2:8]
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        doh, qh, kh, vh, oh, lse, *aux[:4], 0.0, causal, *aux[4:],
        scale=scale)


def time_ring_backward(torch, qs, ks, vs, card):
    """The split backward pair on what `ring train`'s backward feeds it:
    every visible (rank, step) pair of the causal ring of `qs`, `ks`,
    `vs` with each rank's GLOBAL out and lse from the ring kernel and D =
    rowsum(dO.O). Each pair's dQ, dK and dV are held against the
    blockwise plain versions on the same arguments at FLASH_TOL relative
    to max |plain|, diagonal (causal) and off-diagonal pairs both. Then
    one pair of each kind is timed (CUDA events, device time only: the
    wrapper's host side can take longer than a pair) beside its bound, the
    plain versions and aten's flash-attention backward handed the same
    out and lse (its time only where it agrees at FLASH_TOL). Returns
    ({kernel: mean per launch over the ring's pairs}, {kernel: max abs
    err against plain})."""
    from flashy_tpu_torch.ops import attention as A
    from flashy_tpu_torch.parallel.ring import owner, visible_steps
    from flashy_tpu_torch.parallel.ring_fused import ring_forward
    n, (B, t, H, D) = len(qs), qs[0].shape
    tol = FLASH_TOL[str(qs[0].dtype).split(".")[1]]
    g = torch.Generator(device=qs[0].device).manual_seed(13)
    dos = [torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
           for q in qs]
    stats = [ring_forward(q, ks, vs, rank, True) for rank, q in enumerate(qs)]
    deltas = [A.flash_delta(do, out) for do, (out, _) in zip(dos, stats)]
    errors = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    kinds = {}                 # diag -> (pair count, rank, args, dq, dk, dv)
    for rank in range(n):
        for step in visible_steps(rank, n, True):
            j = owner(rank, step, n)
            args = (qs[rank], ks[j], vs[j], dos[rank], stats[rank][1],
                    deltas[rank], step == 0)
            dq, dk, dv = A.flash_backward_split(*args)
            want_dq = A.flash_backward_dq_blockwise(*args)
            want_dk, want_dv = A.flash_backward_dkv_blockwise(*args)
            rels = {"flash_bwd_dq": rel_err(dq, want_dq),
                    "flash_bwd_dkv": max(rel_err(dk, want_dk),
                                         rel_err(dv, want_dv))}
            for key, rel in rels.items():
                if not math.isfinite(rel) or rel > tol:
                    fail(f"ring backward rank {rank} step {step} (owner "
                         f"{j}): {key} relative err {rel} > {tol}")
            errors["flash_bwd_dq"] = max(
                errors["flash_bwd_dq"],
                (dq.float() - want_dq.float()).abs().max().item())
            errors["flash_bwd_dkv"] = max(
                errors["flash_bwd_dkv"],
                (dk.float() - want_dk.float()).abs().max().item(),
                (dv.float() - want_dv.float()).abs().max().item())
            count = kinds.get(step == 0, (0,))[0] + 1
            kinds[step == 0] = (count, rank, args, dq, dk, dv)
            del want_dq, want_dk, want_dv
    rows = {}
    for diag, (count, rank, args, dq, dk, dv) in kinds.items():
        bounds = flash_bounds(B, H, t, D, qs[0].element_size(), causal=diag)
        try:
            call = flash_library_backward(torch, *args[:4], stats[rank][0],
                                          args[4], diag, A.flash_scale(D))
            got = call()
            lib_rel = max(rel_err(a.transpose(1, 2), b)
                          for a, b in zip(got[:3], (dq, dk, dv)))
            lib_ms = time_ms(torch, call, iters=20, device_only=True) \
                if lib_rel <= tol else None
            why = "" if lib_ms is not None else \
                f"disagrees: rel err {lib_rel:.2e}"
        except (AttributeError, RuntimeError, TypeError, ValueError) as err:
            lib_ms, why = None, str(err).splitlines()[0][:80]
        rows[diag] = (count, {
            "flash_bwd_dq": (
                time_ms(torch, lambda: A._launch_backward(A._BWD_DQ, *args),
                        iters=20, device_only=True),
                time_ms(torch, lambda: A.flash_backward_dq_blockwise(*args),
                        iters=3), *bounds["flash_bwd_dq"]),
            "flash_bwd_dkv": (
                time_ms(torch, lambda: A._launch_backward(A._BWD_DKV, *args),
                        iters=20, device_only=True),
                time_ms(torch, lambda: A.flash_backward_dkv_blockwise(*args),
                        iters=3), *bounds["flash_bwd_dkv"])}, lib_ms, why)
    total = sum(count for count, _, _, _ in rows.values())
    times = {}
    for name in errors:
        def mean(i):
            return sum(count * per[name][i]
                       for count, per, _, _ in rows.values()) / total
        libs = [lib for _, _, lib, _ in rows.values()]
        times[name] = {
            "ms": mean(0), "plain_ms": mean(1), "bound_ms": mean(2),
            "bound_by": max((per[name] for _, per, _, _ in rows.values()),
                            key=lambda r: r[2])[3],
            "library_ms": (None if None in libs else sum(
                count * lib for count, _, lib, _ in rows.values()) / total)}
    print(f"ring backward ({n} ranks of B{B} H{H} t{t} D{D}, causal, bf16, "
          f"the ring kernel's global out and lse): {total} visible pairs vs "
          f"plain max abs err " + ", ".join(
              f"{k}={v:.3e}" for k, v in errors.items())
          + f" (tolerance {tol} relative); " + "; ".join(
              f"{'diagonal' if diag else 'off-diagonal'} pair (x{count}): "
              + ", ".join(f"{name} ms={ms:.4f} bound_ms={bound:.4f} ({by}) "
                          f"plain_ms={plain:.4f}"
                          for name, (ms, plain, bound, by) in per.items())
              + " library_ms=" + (f"{lib:.4f}" if lib is not None
                                  else f"none ({why})")
              for diag, (count, per, lib, why) in rows.items())
          + "; mean per launch over the pairs: " + "; ".join(
              f"{name} ms={t_['ms']:.4f} bound_ms={t_['bound_ms']:.4f} "
              f"plain_ms={t_['plain_ms']:.4f} library_ms="
              + (f"{t_['library_ms']:.4f}" if t_["library_ms"] is not None
                 else "none") for name, t_ in times.items())
          + f" (library: aten flash-attention backward with the same out "
          f"and lse, dq, dk and dv in one call) [{card}]", flush=True)
    return times, errors


# ----------------------------------------------------------------------
# the full-width paths of the other widths: d128 (8 heads of 128), the
# SSD scan at Mamba-2's N 128, the MoE layout at dim 260
# ----------------------------------------------------------------------
def phase_train_d128(torch, card, folder):
    """The d128 layout (8 heads of 128) in bf16 at batch 16, seq 1024,
    attention='flash', through `main` in a fresh XP: 1 epoch of 8 steps
    and 2 valid steps, no resume leg; the step loss finite and falling;
    the forward and the fused backward on the Hopper kernels built at
    head_dim 128. Returns the launch counts."""
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    args = [a for a in TRAIN_ARGS
            if not a.startswith(("model.num_heads", "model.num_layers"))]
    args += [f"model.num_heads={D128_HEADS}", f"model.num_layers={LAYERS}",
             "epochs=1", f"dora.dir={folder}"]
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    solver = lm_main(args)
    torch.cuda.synchronize()
    counts = dict(attention.launch_counts)
    cfg = solver.cfg
    train_steps, valid_steps = cfg.steps_per_epoch, cfg.valid_steps
    layers = cfg.model.num_layers
    want = {"flash_fwd_128": layers * (train_steps + valid_steps),
            "flash_bwd_fused_128": layers * train_steps}
    if nonzero(counts) != want:
        fail(f"train d128: launches {nonzero(counts)}, expected {want}")
    losses = solver.step_losses
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train d128: step losses {losses} not finite and falling")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.seq_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train d128: 235M width ({D128_HEADS} heads of "
          f"{1024 // D128_HEADS}) at {layers} layers, bf16 b{cfg.batch_size} "
          f"t{cfg.seq_len}, {train_steps} steps + "
          f"{valid_steps} valid, step losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, tokens/s={tok_s:.1f}, step p50={p50:.2f} ms "
          f"(steps 3..{train_steps}), peak memory {peak:.1f} GiB; launches "
          f"{nonzero(counts)} [{card}]", flush=True)
    del solver
    return counts


def time_ring_general(torch, device, card, H=D128_HEADS, D=128, B=2, t=64,
                      n=4, dtype=None):
    """The ring forward's general route, by default at the `ring step
    d128` shapes (n ranks of [B, t, H, D], causal, f32): held against its
    plain version, the four ranks' launches timed three times beside the
    bound, the plain version and one scaled_dot_product_attention over
    the n t tokens. Returns (times, max abs err)."""
    import torch.nn.functional as F
    from flashy_tpu_torch.parallel.ring_fused import (ring_forward,
                                                      ring_forward_plain)
    dtype = dtype or torch.float32
    name = str(dtype).split(".")[1]
    (q, k, v), (qs, ks, vs) = ring_inputs(torch, device, dtype, n, t, B=B,
                                          H=H, D=D, seed=9)
    err, _, _ = compare_ring(torch, qs, ks, vs, True,
                             f"ring general timed D={D} {name}")

    def kernel():
        for rank in range(n):
            ring_forward(qs[rank], ks, vs, rank, True)

    def plain():
        for rank in range(n):
            ring_forward_plain(qs[rank], ks, vs, rank, True)

    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    bound, bound_by = ring_bound(B, H, t, D, range(n), q.element_size())
    times = {**time_runs(torch, kernel, iters=20 if D <= 128 else 3),
             "plain_ms": time_ms(torch, plain, iters=5 if D <= 128 else 2),
             "bound_ms": bound, "bound_by": bound_by,
             "library_ms": time_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, is_causal=True), device_only=True),
             "host_us": host_us(torch, kernel, calls=5)}
    print(f"ring general times ({n} ranks of [{B}, {t}, {H}, {D}] causal "
          f"{name}, the four launches): {spread_text(times)} bound_ms="
          f"{bound:.4f} ({bound_by}) plain_ms={times['plain_ms']:.4f} "
          f"library_ms={times['library_ms']:.4f} (one SDPA over {n * t} "
          f"tokens, {name}) host_us={times['host_us']:.1f}; vs plain max abs "
          f"err {err:.3e} [{card}]", flush=True)
    return times, err


SSD_N128 = (1, 1024, 256, 128, 64)   # (B, T, chunk, N, Dh) of `ssd n128`


def phase_ssd_n128(torch, device, card):
    """The pure-SSD layout at Mamba-2's state width (ssd_state_dim 128,
    chunk 256) in f32: one 1024-token prompt prefilled in one slice
    through `cache_layout='ssd'` (the FMA kernel at N 128, chunk 256, T
    1024: 12 launches) and 16 tokens decoded, token-exact against
    `generate`; then that call timed beside its bound and plain version.
    Returns (launches, times, max abs err)."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import ssd_scan
    from flashy_tpu_torch.serve.engine import DecodeEngine
    B, T, chunk, N, Dh = SSD_N128
    cfg = model_config(torch, torch.float32, 2048, mixer="ssd",
                       ssd_state_dim=N, ssd_chunk=chunk)
    model = TransformerLM(cfg, device=device, seed=6)
    engine = DecodeEngine(model, slots=1, max_seq_len=T, chunk=T,
                          cache_layout="ssd", device=device)
    engine.warmup()
    prompts = [np.random.default_rng(7).integers(1, cfg.vocab_size, T)]
    max_new = 16
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    want = {"ssd_scan_fma": cfg.num_layers
            * engine.step_counts["prefill_chunk"]}
    if nonzero(counts) != want or engine.step_counts["prefill_chunk"] != 1:
        fail(f"ssd n128: launches {nonzero(counts)}, expected {want} (one "
             f"prefill slice)")
    ties = check_streams(torch, model, prompts, requests, max_new, device,
                         "ssd n128")
    launched = want["ssd_scan_fma"]
    del model, engine, scheduler
    times, err = time_ssd_route(torch, device, torch.float32, B, T, chunk,
                                N, Dh)
    print(f"ssd n128: pure-SSD 235M layout, ssd_state_dim {N}, chunk "
          f"{chunk}, f32: a {T}-token prompt in one prefill slice + "
          f"{max_new} new token-exact vs generate (near ties {ties}), "
          f"launches {want}, {seconds:.2f}s; the main path's call [{B}, {T}] "
          f"{spread_text(times)} bound_ms={times['bound_ms']:.6f} "
          f"({times['bound_by']}) plain_ms={times['plain_ms']:.4f} "
          f"host_us={times['host_us']:.1f}, vs plain y max abs err "
          f"{err:.3e} [{card}]", flush=True)
    return launched, times, err


def time_ssd_route(torch, device, dtype, B, T, chunk, N, Dh, H=16):
    """One `ssd_chunked_scan` call (projection slices, padding mask) at
    these widths, held to the plain version and timed three times beside
    its bound and plain version. Returns (times, y max abs err)."""
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    c, b, v, log_a, state, mask = ssd_inputs(torch, device, dtype, B, T,
                                             N=N, Dh=Dh, seed=11, proj=True)
    kw = {"state": state, "chunk": chunk, "token_mask": mask}
    kernel = lambda: ssd_chunked_scan(c, b, v, log_a, kernel="fused",  # noqa
                                      **kw)
    plain = lambda: ssd_chunked_scan(c, b, v, log_a, kernel="gather",  # noqa
                                     **kw)
    err, _, _ = ssd_against_plain(torch, kernel(), plain(), mask,
                                  f"ssd {dtype} [{B}, {T}] N={N} chunk={chunk}")
    bound, bound_by, _ = ssd_bound(B, H, T, N, Dh, chunk,
                                   torch.finfo(dtype).bits // 8)
    return {**time_runs(torch, kernel, iters=10),
            "plain_ms": time_ms(torch, plain, iters=3),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "host_us": host_us(torch, kernel, calls=5)}, err


# 5 heads of 52: the rotary embedding of both packages' TransformerLM
# takes even head dims only (each raises at an odd one, e.g. 4 heads of
# 65), so the odd D 65 is held at the kernel level (`check_flash_kernels`)
W260 = {"dim": 260, "num_layers": 2, "num_heads": 5}


def w260_config(torch, dispatch, attention="flash"):
    """The MoE layout at dim 260 (K = 260, which 8 does not divide; MLP
    width 1040), 2 layers, 5 heads of 52, 8 top-2 experts, f32."""
    from flashy_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=32768, mlp_ratio=4, max_seq_len=256,
                             dtype=torch.float32, attention=attention,
                             moe_experts=8, moe_top_k=2,
                             moe_capacity_factor=8.0, moe_dispatch=dispatch,
                             **W260)


def phase_step_w260(torch, device, card):
    """The w260 layout in f32 (TF32 off) at batch 2, seq 256: loss and
    every gradient through the grouped kernels' padded route (K = 260)
    and the flash general route (head_dim 52) against the plain grouped
    matmuls (MOE_PLAIN_TOL), against 'einsum' at capacity 8.0 where
    nothing drops (MOE_STEP_TOL on the loss and each gradient's norm),
    against the dense path (STEP_REL_TOL), and fused == split bitwise.
    Returns the kernels run's launch counts."""
    import functools
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models import transformer
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.ops import grouped_matmul as G
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.parallel import moe_ep
    stream = synthetic_token_stream(32768)
    model = transformer.TransformerLM(w260_config(torch, "dropless"),
                                      device=device, seed=3)
    for step in range(32):
        tokens = torch.from_numpy(stream(2, 256, step)).long().to(device)
        margin = router_margin(torch, model, tokens)
        if margin > MOE_TIE_GAP:
            break
    else:
        fail(f"step w260: every candidate batch routes a token at a near "
             f"tie (last margin {margin:.2e})")
    del model
    flash = transformer.flash_attention
    reference = (moe_ep.gmm, moe_ep.tgmm)
    results, counts = {}, {}
    runs = (("kernels", "dropless", "flash"), ("split", "dropless", "flash"),
            ("plain", "dropless", "flash"), ("einsum", "einsum", "flash"),
            ("dense", "dropless", "dense"))
    for label, dispatch, kind in runs:
        model = transformer.TransformerLM(w260_config(torch, dispatch, kind),
                                          device=device, seed=3)
        if label == "split":
            transformer.flash_attention = functools.partial(
                flash, fused_backward=False)
        if label == "plain":
            moe_ep.gmm, moe_ep.tgmm = G._gmm_reference, G._tgmm_reference
        G.reset_launch_counts()
        attention.reset_launch_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss = lm_next_token_loss(model, tokens, aux_weight=0.01)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention = flash
            moe_ep.gmm, moe_ep.tgmm = reference
            torch.use_deterministic_algorithms(False)
        counts[label] = nonzero({**G.launch_counts,
                                 **attention.launch_counts})
        results[label] = (loss.item(), {name: p.grad for name, p in
                                        model.named_parameters()})
        del model
    layers = W260["num_layers"]
    want = {"gmm_padded": 2 * layers, "gmm_t_padded": 2 * layers,
            "tgmm_padded": 2 * layers, "flash_fwd_general": layers,
            "flash_bwd_fused_general": layers}
    if counts["kernels"] != want:
        fail(f"step w260: launches {counts['kernels']}, expected {want}")
    kern, split, plain, einsum, dense = (results[k] for k in (
        "kernels", "split", "plain", "einsum", "dense"))
    unequal = [name for name, grad in kern[1].items()
               if not torch.equal(grad, split[1][name])]
    if kern[0] != split[0] or unequal:
        fail(f"step w260: fused and split differ (grads {unequal[:4]})")

    def worst(a, b):
        return max(abs(a[0] - b[0]) / abs(b[0]),
                   max(rel_err(grad, b[1][name])
                       for name, grad in a[1].items()))

    plain_err, dense_err = worst(kern, plain), worst(kern, dense)
    ein_err = max([abs(kern[0] - einsum[0]) / abs(einsum[0])] + [
        abs(grad.norm().item() - einsum[1][name].norm().item())
        / max(einsum[1][name].norm().item(), 1e-30)
        for name, grad in kern[1].items()])
    if not plain_err <= MOE_PLAIN_TOL or not ein_err <= MOE_STEP_TOL \
            or not dense_err <= STEP_REL_TOL:
        fail(f"step w260: vs plain grouped matmuls {plain_err:.2e} (limit "
             f"{MOE_PLAIN_TOL}), vs einsum {ein_err:.2e} (limit "
             f"{MOE_STEP_TOL}), flash vs dense {dense_err:.2e} (limit "
             f"{STEP_REL_TOL})")
    print(f"step w260: MoE dim 260 (5 heads of 52, 8 top-2 experts, "
          f"{W260['num_layers']} layers) f32 b2 t256, batch {step} (min "
          f"routing gap {margin:.2e}), loss {kern[0]:.6f}; kernels vs "
          f"plain grouped matmuls {plain_err:.2e} (limit {MOE_PLAIN_TOL}), "
          f"vs einsum (capacity 8.0) {ein_err:.2e} (limit {MOE_STEP_TOL}), "
          f"flash vs dense {dense_err:.2e} (limit {STEP_REL_TOL}), fused == "
          f"split bitwise (loss and all {len(kern[1])} grads); launches "
          f"{want} [{card}]", flush=True)
    return counts["kernels"]


def time_gmm_padded(torch, device, card):
    """The padded route's six launches of a `step w260` layer (f32 x f32:
    1024 routed rows, K 260, F 1040, 8 experts, the step's routing sizes
    drawn evenly): each held against its plain version and timed three
    times beside its bound and plain version; `torch._grouped_mm` takes
    no K or N that 8 does not divide, so no library time. Returns
    ({kernel: times}, {kernel: max abs err})."""
    from flashy_tpu_torch.ops import grouped_matmul as G
    M, D, F, E = 1024, W260["dim"], 4 * W260["dim"], 8
    g = torch.Generator(device=device).manual_seed(12)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)

    gs = torch.full((E,), M // E, dtype=torch.int32, device=device)
    x, w_up, w_down = draw(M, D), draw(E, D, F), draw(E, F, D)
    h, dy = draw(M, F), draw(M, D)
    f32 = torch.float32
    launches = {
        "gmm_padded": [
            (lambda: G.gmm(x, w_up, gs, f32),
             lambda: G._gmm_reference(x, w_up, gs, f32), (M, D, F, False)),
            (lambda: G.gmm(h, w_down, gs, f32),
             lambda: G._gmm_reference(h, w_down, gs, f32), (M, F, D, False))],
        "gmm_t_padded": [
            (lambda: G.gmm(dy, w_down, gs, f32, transpose_rhs=True),
             lambda: G._gmm_reference(dy, w_down, gs, f32, True),
             (M, D, F, False)),
            (lambda: G.gmm(h, w_up, gs, f32, transpose_rhs=True),
             lambda: G._gmm_reference(h, w_up, gs, f32, True),
             (M, F, D, False))],
        "tgmm_padded": [
            (lambda: G.tgmm(h, dy, gs, f32),
             lambda: G._tgmm_reference(h, dy, gs, f32), (M, F, D, True)),
            (lambda: G.tgmm(x, h, gs, f32),
             lambda: G._tgmm_reference(x, h, gs, f32), (M, D, F, True))]}
    times, errors = {}, {}
    for name, calls in launches.items():
        runs, errs = [], []
        for kernel, plain, (m, k, n, is_tgmm) in calls:
            errs.append(gmm_check(torch, kernel(), plain(), f"{name} w260"))
            bound, bound_by = gmm_bound(m, k, n, E, 4, 4, 4, is_tgmm)
            runs.append({**time_runs(torch, kernel, iters=20),
                         "plain_ms": time_ms(torch, plain, iters=5),
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": None,
                         "host_us": host_us(torch, kernel, calls=10)})
        errors[name] = max(errs)
        times[name] = {**runs[0], "second": runs[1]}
    print("gmm padded times (step w260 layer: M 1024, K 260, F 1040, E 8, "
          "f32; library: none, torch._grouped_mm takes no K or N that 8 "
          "does not divide): " + "; ".join(
              f"{name} {spread_text(t)} / {spread_text(t['second'])} "
              f"bound_ms={t['bound_ms']:.4f}/{t['second']['bound_ms']:.4f} "
              f"({t['bound_by']}) plain_ms={t['plain_ms']:.4f}/"
              f"{t['second']['plain_ms']:.4f} host_us={t['host_us']:.1f}; "
              f"vs plain {errors[name]:.3e}"
              for name, t in times.items()) + f" [{card}]", flush=True)
    return times, errors


def build_all():
    """nvcc for every kernel source at once; prints each build's
    register and spill lines."""
    from flashy_tpu_torch.ops import _build
    names = ("paged_decode", "paged_general", "flash_attention",
             "flash_general", "ssd_scan", "grouped_matmul", "ring_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for future in [pool.submit(_build.build, name) for name in names]:
            future.result()
    for name in names:
        info = _build.build_info.get(name)
        for kernel, regs, stores, loads in ptxas_kernels(
                info[1] if info else ""):
            print(f"  {name}: {kernel}: {regs} registers, {stores} bytes "
                  f"spill stores, {loads} bytes spill loads")
        for line in (info[1] if info else "").splitlines():
            if "error" in line or "C7510" in line or "C7520" in line:
                print(f"  {name}: {line.strip()}")
        built = f"built in {info[0]:.1f}s" if info else "cached"
        print(f"build: {name} {built}", flush=True)
    return time.perf_counter() - t0


def ptxas_kernels(text):
    """[(kernel name with its integer template arguments, registers,
    spill store bytes, spill load bytes)] from `ptxas -v` output."""
    import re
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            # the length-prefixed name ending in _kernel, then its template
            # arguments (I ... E, each an L<type><value>E)
            mangled, name = entry.group(1), entry.group(1)
            for at in range(len(mangled)):
                lengths = re.match(r"\d+", mangled[at:])
                if lengths is None or (at and mangled[at - 1].isdigit()):
                    continue
                digits = lengths.group()
                # a run of digits can end an identifier ("_N_1") before the
                # length: try each split of the run
                for cut in range(len(digits)):
                    start = at + len(digits)
                    end = start + int(digits[cut:])
                    if mangled[start:end].endswith("_kernel"):
                        args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end:])
                        name = mangled[start:end] + (
                            "<" + ", ".join(re.findall(r"L[a-z](\d+)E",
                                                       args.group(1))) + ">"
                            if args else "")
                        break
                if name != mangled:
                    break
        spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line)
        if spilled:
            spill = (int(spilled.group(1)), int(spilled.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and name is not None:
            rows.append((name, int(used.group(1))) + spill)
            name, spill = None, (0, 0)
    return rows


# the wgmma kernels whose SASS `check_sass` reads, by library and by the
# mangled name's template argument (`flash_bwd_hopper_kernel<MODE>`,
# `grouped_wgmma_kernel<L>`: 0 gmm, 1 gmm_t, 2 tgmm)
SASS_KERNELS = {
    "flash_attention": {
        **{f"flash_fwd{suffix}": f"flash_fwd_kernelILi{dim}E"
           for dim, suffix in ((64, ""), (128, "_128"))},
        **{f"flash_bwd_{kind}{suffix}":
           f"flash_bwd_hopper_kernelILi{dim}ELi{mode}E"
           for dim, suffix in ((64, ""), (128, "_128"))
           for mode, kind in enumerate(("dq", "dkv", "fused"))}},
    "ring_attention": {"ring_fwd": "ring_fwd_kernelILi64E",
                       "ring_fwd_128": "ring_fwd_kernelILi128E"},
    "grouped_matmul": {"gmm": "grouped_wgmma_kernelILi0E",
                       "gmm_t": "grouped_wgmma_kernelILi1E",
                       "tgmm": "grouped_wgmma_kernelILi2E"}}


def sass_counts(tool, library, words):
    """{function: [count of each of `words`]} in `cuobjdump -sass` of a
    built library."""
    from flashy_tpu_torch.ops import _build
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path(library))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0] * len(words)
        elif name is not None:
            for i, word in enumerate(words):
                if word in line:
                    counts[name][i] += 1
    return counts


def check_sass(card):
    """The bf16 flash kernels and the grouped kernels on the tensor
    cores' wgmma, not serialized: per kernel the HGMMA and
    WARPGROUP.DEPBAR instructions in `cuobjdump -sass` of the built
    libraries. ptxas serializes every wgmma behind a branch it cannot
    prove warp-uniform (info C7520): a DEPBAR then follows each HGMMA.
    Fails if a kernel has no HGMMA or as many DEPBARs as HGMMAs. Then
    the paged library: its T >= 2 bf16 kernels (MODE 2, mangled `Li2E`)
    issue HMMA (mma.sync), and ptxas spilled nothing in any of its
    kernels; the same for the SSD library's bf16 kernel. Says so and goes
    on where cuobjdump is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found, not checked", flush=True)
        return
    for library, kernels in SASS_KERNELS.items():
        counts = sass_counts(tool, library, ("HGMMA", "WARPGROUP.DEPBAR"))
        found = {}
        for label, key in kernels.items():
            hits = [c for n, c in counts.items() if key in n]
            if len(hits) != 1:
                fail(f"sass: {len(hits)} functions named like {key}")
            hgmma, depbar = found[label] = hits[0]
            if hgmma == 0 or depbar >= hgmma:
                fail(f"sass: {label} has {hgmma} HGMMA and {depbar} "
                     f"WARPGROUP.DEPBAR: not on wgmma, or serialized")
        print(f"sass (cuobjdump -sass of {library}): " + ", ".join(
            f"{label} {h} HGMMA / {d} WARPGROUP.DEPBAR"
            for label, (h, d) in found.items()) + f" [{card}]", flush=True)
    counts = sass_counts(tool, "paged_decode", ("HMMA",))
    paged = {n: c[0] for n, c in counts.items() if "paged_decode_kernel" in n}
    mma = [h for n, h in paged.items() if "Li2E" in n]
    if len(mma) != 2 or min(mma) == 0:
        fail(f"sass: paged_decode's T >= 2 bf16 kernels issue {mma} HMMA "
             f"(two kernels, each > 0 expected)")
    print(f"sass (cuobjdump -sass of paged_decode): {len(paged)} kernels, "
          f"the two T >= 2 bf16 ones {mma[0]} and {mma[1]} HMMA, the others "
          f"{sum(paged.values()) - sum(mma)}; {ptxas_usage('paged_decode')} "
          f"[{card}]", flush=True)
    counts = sass_counts(tool, "ssd_scan", ("HMMA",))
    ssd = {n: c[0] for n, c in counts.items() if "ssd_" in n}
    bf16 = [h for n, h in ssd.items() if "ssd_bf16_kernel" in n]
    if len(bf16) != 1 or bf16[0] == 0:
        fail(f"sass: ssd_scan's bf16 kernel issues {bf16} HMMA (one kernel, "
             f"> 0 expected)")
    print(f"sass (cuobjdump -sass of ssd_scan): the bf16 kernel {bf16[0]} "
          f"HMMA, the FMA kernels {sum(ssd.values()) - bf16[0]}; "
          f"{ptxas_usage('ssd_scan')} [{card}]", flush=True)


def ptxas_usage(library):
    """'<registers> registers in <n> kernels, 0 bytes spilled' from this
    process's build of `library`; fails if ptxas spilled."""
    import re
    from flashy_tpu_torch.ops import _build
    info = _build.build_info.get(library)
    if info is None:
        return "registers and spills not read (library was built before)"
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", info[1])]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", info[1])
    if not regs or any(int(a) or int(b) for a, b in spills):
        fail(f"sass: {library} spills ({spills}) or no register report")
    return (f"{min(regs)}-{max(regs)} registers in {len(regs)} kernels, 0 "
            f"bytes spilled")


# ----------------------------------------------------------------------
# phases 21-24: the LM trainer's switches (remat policies, dropout, EMA)
# and SSD training
# ----------------------------------------------------------------------
REMAT_POLICIES = (None, "full", "dots", "dots_no_batch")
DROPOUT_SEED = 1234
# tests/test_models.py's remat bars: loss rtol 1e-6, grads rtol 1e-5 /
# atol 1e-6 (elementwise |a - b| <= atol + rtol |b|)
REMAT_LOSS_RTOL, REMAT_RTOL, REMAT_ATOL = 1e-6, 1e-5, 1e-6
SSD_TRAIN_RTOL = 1e-5          # kernel-forward vs plain grads, of max |plain|
EMA_DECAY = 0.999


def remat_label(policy):
    return "none" if policy is None else policy


def remat_config(torch, dtype, policy, **kw):
    """The 235M layout with attention='flash', dropout 0.1 and `policy`
    (None: no remat)."""
    return model_config(torch, dtype, 1024, "flash", dropout=0.1,
                        remat=policy is not None,
                        remat_policy=policy or "full", **kw)


def allclose_excess(torch, got, want, rtol, atol):
    """The largest |got - want| - (atol + rtol |want|): <= 0 passes."""
    return ((got.double() - want.double()).abs()
            - (atol + rtol * want.double().abs())).max().item()


def phase_remat_step(torch, device, card):
    """Loss and every gradient of the full-width model in f32 (TF32 off)
    at batch 2, seq 256, attention='flash', dropout 0.1 with one seed:
    no remat, 'full', 'dots' and 'dots_no_batch', held together at the
    JAX remat test's bars; flash forward launches layers without remat
    and 2 x layers with it (the recompute launches it again), the fused
    backward layers. Then one bf16 AdamW step at `train`'s shapes under
    each policy: peak memory. Returns the flash launches by policy."""
    import functools
    from flashy_tpu_torch.examples.lm.solver import (build_optimizer,
                                                     synthetic_token_stream,
                                                     train_step)
    from flashy_tpu_torch.models import transformer
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    stream = synthetic_token_stream(32768)
    tokens = torch.from_numpy(stream(2, 256, 0)).long().to(device)
    loss_fn = functools.partial(lm_next_token_loss, train=True,
                                dropout_seed=DROPOUT_SEED)
    layers = 12
    name = functools.partial(attention.counter_name, head_dim=64,
                             dtype=torch.float32)
    results, counts, state = {}, {}, None
    for policy in REMAT_POLICIES:
        model = transformer.TransformerLM(
            remat_config(torch, torch.float32, policy), device=device,
            seed=3)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        attention.reset_launch_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss = loss_fn(model, tokens)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        counts[policy] = nonzero(attention.launch_counts)
        want = {name("flash_fwd"): layers * (1 if policy is None else 2),
                name("flash_bwd_fused"): layers}
        if counts[policy] != want:
            fail(f"remat step {remat_label(policy)}: launches "
                 f"{counts[policy]}, expected {want}")
        results[policy] = (loss.item(), {n: p.grad for n, p in
                                         model.named_parameters()})
        del model, loss
    base_loss, base_grads = results[None]
    notes = []
    for policy in REMAT_POLICIES[1:]:
        loss, grads = results[policy]
        loss_diff = abs(loss - base_loss)
        worst = max(allclose_excess(torch, grads[n], g, REMAT_RTOL,
                                    REMAT_ATOL) for n, g in base_grads.items())
        largest = max((grads[n].double() - g.double()).abs().max().item()
                      for n, g in base_grads.items())
        bitwise = loss == base_loss and all(
            torch.equal(grads[n], g) for n, g in base_grads.items())
        if loss_diff > REMAT_LOSS_RTOL * abs(base_loss) or worst > 0 \
                or not math.isfinite(largest):
            fail(f"remat step {policy}: loss {loss} vs {base_loss}, grads "
                 f"past rtol {REMAT_RTOL} / atol {REMAT_ATOL} by {worst}")
        notes.append(f"{policy}: loss diff {loss_diff:.3e}, largest grad "
                     f"diff {largest:.3e}"
                     f"{' (bitwise)' if bitwise else ''}")
    del results, base_grads
    # peak memory of one bf16 step at train's shapes under each policy
    release_memory(torch)
    batch = torch.from_numpy(stream(16, 1024, 1)).long().to(device)
    cfg = {"epochs": 2, "steps_per_epoch": 8, "warmup_steps": 100,
           "lr": 3e-4, "weight_decay": 0.1}
    peaks = {}
    for policy in REMAT_POLICIES:
        model = transformer.TransformerLM(
            remat_config(torch, torch.bfloat16, policy), device=device,
            seed=3)
        optimizer, schedule = build_optimizer(model, cfg)
        for step in range(2):   # the first allocates AdamW's moments
            if step == 1:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            metrics = train_step(model, optimizer, schedule, step, batch,
                                 loss_fn)
            float(metrics["loss"])
        peaks[policy] = (torch.cuda.max_memory_allocated() / 2 ** 30,
                         (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        del model, optimizer, metrics
        torch.cuda.empty_cache()
    order = sorted(REMAT_POLICIES, key=lambda p: -peaks[p][0])
    if peaks[None][0] <= peaks["full"][0]:
        fail(f"remat step: peak memory without remat {peaks[None][0]:.2f} "
             f"GiB not above full remat's {peaks['full'][0]:.2f}")
    print(f"remat step: 235M f32 b2 t256 flash dropout 0.1 (seed "
          f"{DROPOUT_SEED}), every policy against no remat at rtol "
          f"{REMAT_RTOL} / atol {REMAT_ATOL} (loss rtol {REMAT_LOSS_RTOL}): "
          + "; ".join(notes) + f"; flash launches "
          + ", ".join(f"{remat_label(p)} {counts[p]}" for p in REMAT_POLICIES)
          + "; one bf16 step b16 t1024, peak memory (above the step's "
          "start) " + ", ".join(f"{remat_label(p)} {peaks[p][0]:.2f} GiB "
                                f"({peaks[p][1]:.2f})"
                                for p in REMAT_POLICIES)
          + " (order " + " > ".join(remat_label(p) for p in order)
          + f") [{card}]", flush=True)
    return counts


def release_memory(torch):
    """Collect what earlier phases dropped and hand the allocator's cached
    blocks back, so that a phase's step times and peak memory do not
    depend on the phases before it."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


class LogRecords:
    """A logging handler that keeps the records it is given."""

    def __init__(self):
        import logging
        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append

    def text(self) -> str:
        return "\n".join(r.getMessage() for r in self.records)


def phase_train_ema(torch, card, folder):
    """`train`'s run with ema_decay 0.999 and model.remat=true,
    remat_policy=dots through `main` in a fresh XP: the loss falls, valid
    runs on the EMA shadow and the shadow is not the live params; a
    resume restores the shadow bit-equal; a resume with ema_decay=0
    drops it with the reference's warning. Launches: flash forward
    layers x (2 x train + valid steps), fused backward layers x train
    steps. tokens/s, step p50, peak memory, and the EMA update's device
    ms a step beside its bound. Returns the launch counts."""
    import logging
    from flashy_tpu_torch.ema import ema_update
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    # ema_decay out of the signature, so that the run without EMA resumes
    # the same XP
    args = [a for a in TRAIN_ARGS if not a.startswith("model.num_layers")]
    args += [f"model.num_layers={LAYERS}", f"dora.dir={folder}",
             "model.remat=true", "model.remat_policy=dots", "epochs=2",
                         "dora.exclude=[steps_per_epoch,epochs,"
                         "generate_every,valid_steps,device,ema_decay]"]
    release_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    solver = lm_main(args + [f"ema_decay={EMA_DECAY}"])
    torch.cuda.synchronize()
    counts = nonzero(attention.launch_counts)
    cfg = solver.cfg
    train_steps = cfg.epochs * cfg.steps_per_epoch
    valid_steps = cfg.epochs * cfg.valid_steps
    layers = cfg.model.num_layers
    want = {"flash_fwd": layers * (2 * train_steps + valid_steps),
            "flash_bwd_fused": layers * train_steps}
    if counts != want:
        fail(f"train ema: launches {counts}, expected {want}")
    losses = [entry["train"]["loss"] for entry in solver.history]
    if not all(math.isfinite(x) for x in losses) or losses[1] >= losses[0]:
        fail(f"train ema: epoch losses {losses} not finite and falling")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.seq_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shadow = solver.state["ema"]
    params = dict(solver.model.named_parameters())
    same = [n for n in shadow if torch.equal(shadow[n], params[n].detach())]
    if same or any(t.dtype != torch.float32 for t in shadow.values()):
        fail(f"train ema: the shadow equals the live params at {same[:4]} "
             f"or is not f32")
    with torch.no_grad():
        batches = [solver.batch_at(i, eval_set=True)
                   for i in range(cfg.valid_steps)]
        on_shadow = sum(float(solver.loss(t, params=shadow))
                        for t in batches) / len(batches)
        on_live = sum(float(solver.loss(t)) for t in batches) / len(batches)
    logged = solver.history[-1]["valid"]["loss"]
    if abs(on_shadow - logged) > 1e-5 * abs(logged) or on_shadow == on_live:
        fail(f"train ema: valid logged {logged}, on the shadow {on_shadow}, "
             f"on the live params {on_live}: valid did not run on the shadow")
    # the update alone, on a copy of the shadow: device ms beside the
    # bound (the shadow and the params read, the shadow written)
    copy = {n: t.clone() for n, t in shadow.items()}
    live = list(params.values())
    ema = time_runs(torch, lambda: ema_update(copy, live, EMA_DECAY,
                                              step=1000), iters=10)
    numel = sum(t.numel() for t in shadow.values())
    ema_bytes = numel * (4 + 4 + params[next(iter(params))].element_size())
    ema_bound = ema_bytes / HBM_BYTES_PER_S * 1e3
    saved = {n: t.clone() for n, t in shadow.items()}
    del solver, copy, live, params, shadow
    resumed = lm_main(args + [f"ema_decay={EMA_DECAY}"])
    if not resumed.restored or resumed.state["step"] != train_steps \
            or list(resumed.state["ema"]) != list(saved) or any(
                not torch.equal(resumed.state["ema"][n], t)
                for n, t in saved.items()):
        fail("train ema: the resume did not restore the shadow bit-equal")
    del resumed, saved
    records = LogRecords()
    solver_log = logging.getLogger("flashy_tpu_torch.solver")
    solver_log.addHandler(records.handler)
    try:
        dropped = lm_main(args + ["ema_decay=0"])
    finally:
        solver_log.removeHandler(records.handler)
    warning = "ema_decay=0 but the checkpoint carries an EMA shadow"
    if not dropped.restored or "ema" in dropped.state \
            or warning not in records.text():
        fail(f"train ema: the resume with ema_decay=0 kept the shadow or "
             f"did not warn ({records.text()!r})")
    del dropped
    print(f"train ema: 235M width at {layers} layers, bf16 b16 t1024 "
          f"ema_decay {EMA_DECAY}, remat "
          f"dots, {train_steps} steps + {valid_steps} valid, epoch losses "
          f"{losses[0]:.4f} -> {losses[1]:.4f}, tokens/s={tok_s:.1f}, step "
          f"p50={p50:.2f} ms (steps 3..{train_steps}), peak memory "
          f"{peak:.1f} GiB; valid on the shadow {on_shadow:.4f} (live params "
          f"{on_live:.4f}); resume: shadow bit-equal; ema_decay=0: dropped "
          f"with the warning; launches {counts}; EMA update {numel / 1e6:.1f}M"
          f" f32 {spread_text(ema)}, bound {ema_bound:.4f} ms "
          f"({ema_bytes / 1e9:.2f} GB at 3.35 TB/s) [{card}]", flush=True)
    return counts


def ssd_train_config(torch, dtype, num_layers=12):
    """The pure-SSD 235M layout (state dim 16) as training takes it: the
    chunk `default_chunk(T)` picks (256 at T 256 and 1024)."""
    return model_config(torch, dtype, 1024, mixer="ssd", ssd_state_dim=16,
                        ssd_chunk=0, num_layers=num_layers)


def phase_ssd_step(torch, device, card):
    """Loss and every gradient of the pure-SSD layout in f32 (TF32 off) at
    batch 2, seq 256: through the training Function (the scan kernel's
    forward, the plain chunked form's autograd in the backward) and
    through plain autograd of the chunked form on the card, within 1e-5
    of max |plain| per leaf; the scan kernel launches layers times and
    the backward recomputes layers times. Returns the kernel's counts."""
    import dataclasses
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import ssd_scan
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    tokens = torch.from_numpy(synthetic_token_stream(32768)(2, 256, 0)
                              ).long().to(device)
    cfg = ssd_train_config(torch, torch.float32)
    results, counts, state = {}, {}, None
    for kernel in ("auto", "gather"):
        model = TransformerLM(dataclasses.replace(cfg, ssd_kernel=kernel),
                              device=device, seed=3)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        ssd_scan.reset_launch_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss = lm_next_token_loss(model, tokens)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        counts[kernel] = {**nonzero(ssd_scan.launch_counts),
                          **nonzero(ssd_scan.backward_counts)}
        results[kernel] = (loss.item(), {n: p.grad for n, p in
                                         model.named_parameters()})
        del model, loss
    layers = cfg.num_layers
    want = {"auto": {"ssd_scan_fma": layers, "ssd_scan_backward": layers},
            "gather": {}}
    if counts != want:
        fail(f"ssd step: launches {counts}, expected {want}")
    (loss, grads), (plain_loss, plain_grads) = results["auto"], \
        results["gather"]
    worst = max(rel_err(grads[n], g) for n, g in plain_grads.items())
    loss_err = abs(loss - plain_loss) / abs(plain_loss)
    if not math.isfinite(worst) or worst > SSD_TRAIN_RTOL \
            or loss_err > SSD_TRAIN_RTOL:
        fail(f"ssd step: kernel vs plain grads rel err {worst}, loss rel err "
             f"{loss_err} (limit {SSD_TRAIN_RTOL})")
    print(f"ssd step: pure-SSD 235M f32 b2 t256 chunk "
          f"{ssd_scan.default_chunk(256)}, loss {loss:.6f}; the training "
          f"Function (kernel forward) vs plain autograd of the chunked form: "
          f"loss rel err {loss_err:.2e}, grads max rel err {worst:.2e} "
          f"(limit {SSD_TRAIN_RTOL}); launches {counts['auto']} [{card}]",
          flush=True)
    return counts["auto"]


def ssd_backward_bound(B, H, T, N, Dh, chunk, elem):
    """(bound ms, 'bytes' | 'operations') of one layer's scan backward:
    c, b, v, la and dy read once, dc, db, dv and dla written once, over
    3.35 TB/s, against twice the forward's operations (each product's
    gradient with respect to both its operands) at `ssd_bound`'s
    peaks."""
    pairs = sum(min(chunk, T - lo) * (min(chunk, T - lo) + 1) // 2
                for lo in range(0, T, chunk))
    rows = B * H
    nbytes = rows * T * (2 * (2 * N + Dh) * elem + Dh * elem + 8)
    products = rows * (2 * pairs * (N + Dh) + 4 * T * N * Dh)
    peak = BF16_FLOPS if elem == 2 else F32_FLOPS
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * (products / peak + rows * pairs / F32_FLOPS) * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def time_ssd_backward(torch, device, card, B=16, T=1024, H=16, N=16,
                      Dh=64):
    """One layer's scan backward at `ssd train`'s shapes (bf16 c, b, v
    slices of a projection, f32 log-decays, the training chunk): the
    training Function's backward (the plain chunked form recomputed and
    differentiated, plain PyTorch: no backward kernel exists to port)
    timed as device time three times beside its bound, and the kernel's
    forward on the same inputs."""
    from flashy_tpu_torch.ops import ssd_scan
    chunk = ssd_scan.default_chunk(T)
    gen = torch.Generator(device=device).manual_seed(11)
    proj = torch.randn(B, T, H, 2 * N + Dh + 1, generator=gen,
                       device=device).to(torch.bfloat16).requires_grad_()
    dy = torch.randn(B, T, H, Dh, generator=gen, device=device).to(
        torch.bfloat16)
    c, b, v = proj[..., :N], proj[..., N:2 * N], proj[..., 2 * N:-1]
    la = -torch.nn.functional.softplus(proj[..., -1].float())
    y, _ = ssd_scan.ssd_chunked_scan(c, b, v, la, chunk=chunk)
    backward = time_runs(torch, lambda: torch.autograd.grad(
        y, proj, dy, retain_graph=True), iters=3)
    with torch.no_grad():
        forward = time_runs(torch, lambda: ssd_scan.ssd_chunked_scan(
            c, b, v, la, chunk=chunk), iters=20)
    bound, bound_by = ssd_backward_bound(B, H, T, N, Dh, chunk, 2)
    print(f"ssd backward: one layer [{B}, {T}] bf16 chunk {chunk}, the "
          f"plain chunked form recomputed and differentiated "
          f"{spread_text(backward)}, bound {bound:.4f} ms ({bound_by}); "
          f"the kernel's forward on the same inputs {spread_text(forward)} "
          f"[{card}]", flush=True)
    return {"shape": [B, T, H, N, Dh], "ms": backward["ms"],
            "ms_runs": backward["ms_runs"], "bound_ms": bound,
            "bound_by": bound_by, "forward_ms": forward["ms"]}


def phase_ssd_train(torch, device, card, batch=16, steps=6):
    """bf16 AdamW steps on the pure-SSD 235M layout at batch 16, seq 1024
    through the port's `value_and_grad` and `train_step` (the JAX LM
    solver takes no `mixer`: a user's own loop): the loss falls, the
    scan kernel launches once per layer per step, the backward
    recomputes as often; tokens/s and step p50 over steps 3..6, peak
    memory. A batch that does not fit is halved, and the line says so.
    Returns (the launch counts, the step p50 in ms)."""
    from flashy_tpu_torch.examples.lm.solver import (build_optimizer,
                                                     synthetic_token_stream,
                                                     train_step)
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import ssd_scan
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.utils import percentile
    stream = synthetic_token_stream(32768)
    cfg = {"epochs": 1, "steps_per_epoch": steps, "warmup_steps": 2,
           "lr": 3e-4, "weight_decay": 0.1}
    note = ""
    release_memory(torch)
    while True:
        model = TransformerLM(ssd_train_config(torch, torch.bfloat16),
                              device=device, seed=0)
        optimizer, schedule = build_optimizer(model, cfg)
        torch.cuda.reset_peak_memory_stats()
        ssd_scan.reset_launch_counts()
        losses, seconds = [], []
        try:
            for step in range(steps):
                tokens = torch.from_numpy(stream(batch, 1024, step)).long() \
                    .to(device)
                t0 = time.perf_counter()
                metrics = train_step(model, optimizer, schedule, step,
                                     tokens, lm_next_token_loss)
                losses.append(float(metrics["loss"]))
                seconds.append(time.perf_counter() - t0)
            break
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            del model, optimizer
            torch.cuda.empty_cache()
            note += f" batch {batch} did not fit, halved;"
            batch //= 2
    counts = {**nonzero(ssd_scan.launch_counts),
              **nonzero(ssd_scan.backward_counts)}
    layers = model.config.num_layers
    want = {"ssd_scan": layers * steps, "ssd_scan_backward": layers * steps}
    if counts != want:
        fail(f"ssd train: launches {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"ssd train: step losses {losses} not finite and falling")
    timed = seconds[2:]
    tok_s = batch * 1024 * len(timed) / sum(timed)
    p50 = percentile(timed, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params = sum(p.numel() for p in model.parameters())
    del model, optimizer
    print(f"ssd train: pure-SSD {params / 1e6:.0f}M bf16 b{batch} t1024 "
          f"chunk {ssd_scan.default_chunk(1024)},{note} {steps} steps, step "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, tokens/s="
          f"{tok_s:.1f}, step p50={p50:.2f} ms (steps 3..{steps}), peak "
          f"memory {peak:.1f} GiB; launches {counts} [{card}]", flush=True)
    return counts, p50


# ----------------------------------------------------------------------
# phases 25-31: the model layouts of ROADMAP queue A item 3's L7 and L8
# (MoE blocks, scan-stacked stacks, int8 weights) in the serving engine,
# `generate` and the trainer
# ----------------------------------------------------------------------
MOE_LAYOUT = dict(moe_experts=8, moe_top_k=2, moe_dispatch="dropless")
INT8W_COS = 0.999     # flashy_tpu's test_quantized_decode_tracks_full_precision


def moe_model_config(torch, dtype, max_seq_len, **kw):
    """The 235M layout with every MLP 8 top-2 dropless experts (889M
    parameters), as `moe train` trains it."""
    return model_config(torch, dtype, max_seq_len, **MOE_LAYOUT, **kw)


def paged_reads(engine, counts, name, label):
    """The paged kernel launched on `name` once per layer per decode step,
    prefill slice and verify step, and nothing else; returns the count."""
    steps = engine.step_counts
    reads = engine._cfg.num_layers * (steps["decode"] + steps["prefill_chunk"]
                                      + steps["verify"])
    if reads < 1 or nonzero(counts) != {name: reads}:
        fail(f"{label}: launches {nonzero(counts)}, the engine made {reads} "
             f"attention reads on {name} (steps {nonzero(steps)})")
    return reads


def tree_bytes(tree):
    """Device bytes of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(child) for child in tree.values())
    return tree.numel() * tree.element_size()


def restacked(torch, state, layers):
    """A per-layer state dict (or grads by name) with its block leaves
    stacked into a scan-stacked model's `blocks.block.<leaf>` names."""
    out = {k: v for k, v in state.items() if not k.startswith("block_")}
    for name in state:
        if name.startswith("block_0."):
            leaf = name[len("block_0."):]
            out[f"blocks.block.{leaf}"] = torch.stack(
                [state[f"block_{i}.{leaf}"] for i in range(layers)])
    return out


def check_restacked(torch, per_layer, stacked, layers, label):
    """Every stacked leaf bit-equal to the per-layer leaves stacked."""
    want = restacked(torch, per_layer, layers)
    if set(want) != set(stacked):
        fail(f"{label}: names differ: {sorted(set(want) ^ set(stacked))[:4]}")
    unequal = [k for k, v in stacked.items() if not torch.equal(v, want[k])]
    if unequal:
        fail(f"{label}: stacked != restacked per-layer at {unequal[:4]}")
    return len(want)


def phase_moe_exact(torch, device, card):
    """The MoE 235M layout in f32 (TF32 off) on 4 slots, 8 requests of
    100-128 prompt tokens, 32 new: the dense engine with its monolithic
    prefill (bucket 128: `_moe_forward`'s expert-stream order), the paged
    engine at chunk 16 (the gather order; row 5 at `kernel='fused'`) and
    the paged engine with NGramDraft(k=4) (row 5 at T=5), every stream
    token-exact against `generate` (near ties reported). Returns the
    paged kernel's launches."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.draft import NGramDraft
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = moe_model_config(torch, torch.float32, 256)
    model = TransformerLM(cfg, device=device, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, int(n))
               for n in rng.integers(100, 129, 8)]
    max_new = 32
    refs = reference_streams(torch, model, prompts, max_new, device)
    paged = dict(cache_layout="paged", kernel="fused", block_size=16)
    launched = 0
    for name, kw, ngram in (("dense monolithic", {}, False),
                            ("paged chunk 16", paged, False),
                            ("paged ngram k=4", dict(paged, spec_k=SPEC_K),
                             True)):
        label = f"moe exact {name}"
        engine = DecodeEngine(model, slots=4, max_seq_len=256, device=device,
                              **kw)
        engine.warmup(prompt_lengths=[len(p) for p in prompts])
        draft = NGramDraft(slots=4, k=SPEC_K) if ngram else None
        scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                     max_new, draft=draft)
        if engine.pool is None:
            if nonzero(counts):
                fail(f"{label}: kernels launched on the dense layout: "
                     f"{nonzero(counts)}")
            reads = 0
        else:
            reads = paged_reads(engine, counts, "paged_decode", label)
            launched += reads
        ties = check_streams(torch, model, prompts, requests, max_new,
                             device, label, refs=refs)
        summary = scheduler.metrics.summary()
        print(f"{label}: {len(requests)} requests (prompts "
              f"{[len(p) for p in prompts]}) token-exact vs generate (near "
              f"ties {ties}), steps {nonzero(engine.step_counts)}, paged "
              f"launches {reads}, acceptance "
              f"{summary.get('acceptance_rate', 0.0):.3f}, CUDA graphs "
              f"{engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
              flush=True)
        del engine
    return launched


def graph_ms(torch, fn, iters=20):
    """`time_runs` of `fn` captured as one CUDA graph (warmed on a side
    stream first): device time of its kernels as a replayed step runs
    them, without the host's launch cost."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = time_runs(torch, graph.replay, iters=iters)
    del graph
    return times


def moe_decode_times(torch, engine, card, label, steps=16):
    """Where a decode step of the MoE engine goes: `steps` replays of the
    captured decode step over 8 live slots plainly for the wall time,
    then `steps` more under torch.profiler (device busy, so the idle
    share against the plain wall; the expert-slab gathers' and the paged
    kernel's device ms a step, the top kernels); then CUDA
    events (`graph_ms`) on the step's 12 MoE layers (`_moe_forward` on
    each layer's weights at [S, 1, D], captured as one graph), beside the
    bytes the token-gather order moves (each routed slab read, written as
    a copy, read again) and the least the step must read (each expert a
    token routes to, once). Returns the MoE layers' ms a decode step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from flashy_tpu_torch.models.decoding import _blocks, _moe_forward
    cfg = engine._cfg
    rng = np.random.default_rng(7)
    for _ in range(engine.slots):
        slot = engine.acquire_slot()
        prompt = rng.integers(1, cfg.vocab_size, 128)
        start, first = engine.admit(slot, prompt, 2 * steps + 1), None
        while first is None:
            start, first = engine.prefill_chunk(slot, prompt, start)
    engine.decode()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.decode()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.decode()
    for slot in sorted(engine.allocator.live):
        engine.retire(slot)
    rows = device_rows(torch, prof)
    busy = sum(ms for ms, _, _ in rows)
    gathers = sum(ms for ms, _, key in rows if "gather" in key)
    paged = sum(ms for ms, _, key in rows if "paged_decode_kernel" in key)
    top = "; ".join(f"{key[:36]} {ms / steps:.3f} x{n // steps}"
                    for ms, n, key in rows[:5])
    g = torch.Generator(device=engine.device).manual_seed(0)
    x = torch.randn((engine.slots, 1, cfg.dim), generator=g,
                    device=engine.device).to(cfg.dtype)
    layers = [bp["moe"] for bp in _blocks(cfg, engine._params)]

    def moe():
        for mp in layers:
            _moe_forward(cfg, mp, x)

    moe_t = graph_ms(torch, moe)
    slab = cfg.dim * cfg.dim * cfg.mlp_ratio * cfg.dtype.itemsize
    routed = [torch.topk(x[:, 0].float() @ mp["router"]["kernel"].float(),
                         cfg.moe_top_k).indices.unique().numel()
              for mp in layers]
    pairs = engine.slots * cfg.moe_top_k
    gathered = 3 * 2 * slab * pairs * cfg.num_layers
    least = 2 * slab * sum(routed)
    print(f"{label}: {steps} decode-step replays (8 live slots, context "
          f"130-{129 + 2 * steps}), the second {steps} profiled: device busy "
          f"{busy / steps:.3f} ms a step of {wall_ms / steps:.3f} plain wall "
          f"(idle share {1 - busy / wall_ms:.3f}); the expert-slab gathers "
          f"{gathers / steps:.3f} ms a step, the paged kernel "
          f"{paged / steps:.3f}; top a step: {top}; the 12 MoE layers "
          f"captured as one graph at [{engine.slots}, 1, {cfg.dim}]: "
          f"{spread_text(moe_t)}; the gather order moves "
          f"{gathered / 2 ** 30:.2f} GiB a step ({pairs} token-expert "
          f"pairs a layer, up and down slabs of {slab / 2 ** 20:.0f} MiB "
          f"read, copied, read again: "
          f"{gathered / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s) where "
          f"reading each routed expert once ({sum(routed)} over 12 layers) "
          f"needs {least / 2 ** 30:.2f} GiB "
          f"({least / HBM_BYTES_PER_S * 1e3:.3f} ms) [{card}]", flush=True)
    return moe_t["ms"]


def phase_moe_serve(torch, device, card, requests_n=16, prompt_len=128,
                    max_new=128):
    """The MoE layout in bf16 through the paged engine's captured steps
    (8 slots, 16 requests, prompt 128, 128 new): tokens/s, decode p50,
    the engine's memory after warm-up and at its peak, then the same
    traffic eager (`eager_twin`: bit-identical), then where a decode
    step goes (`moe_decode_times`). Returns the paged launches."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "moe serve bf16"
    release_memory(torch)
    cfg = moe_model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    engine_kw = dict(slots=8, block_size=16, max_seq_len=256,
                     cache_layout="paged", device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    engine = DecodeEngine(model, **engine_kw)
    engine.warmup()
    torch.cuda.synchronize()
    gib = 2 ** 30
    warm = {"allocated": (torch.cuda.memory_allocated() - base) / gib,
            "reserved": (torch.cuda.memory_reserved() - base_reserved) / gib,
            "peak": (torch.cuda.max_memory_allocated() - base) / gib}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    reads = paged_reads(engine, counts, "paged_decode", label)
    check_outputs(requests, [prompt_len + max_new] * requests_n,
                  cfg.vocab_size, label)
    peak = (torch.cuda.max_memory_allocated() - base) / gib
    summary = scheduler.metrics.summary()
    graphs = engine.compile_cache.executables()
    print(f"{label}: 889M MoE, {requests_n} requests x prompt {prompt_len} "
          f"x {max_new} new, tokens/s={summary['tokens_per_sec']:.1f}, "
          f"decode step p50={summary['itl_ms_p50']:.3f} ms, {seconds:.2f}s; "
          f"launches {reads} == reads; captures after warm-up "
          f"{engine.compile_cache.recompiles()}; memory over the model's "
          f"f32 weights after warm-up: allocated {warm['allocated']:.2f} "
          f"GiB (bf16 weights {tree_bytes(engine._params) / gib:.2f}, pool "
          f"{engine.cache_bytes() / gib:.2f}), reserved "
          f"{warm['reserved']:.2f} GiB, peak in warm-up {warm['peak']:.2f} "
          f"GiB, peak through traffic {peak:.2f} GiB; {len(graphs)} graphs "
          f"({', '.join(graphs)}), each captured in its own private memory "
          f"pool (no pool shared) [{card}]", flush=True)
    eager_twin(torch, model, engine, engine_kw, prompts, max_new, requests,
               counts, label, card)
    moe_decode_times(torch, engine, card, label)
    return reads


def phase_scan_exact(torch, device, card):
    """The scan-stacked 235M layout in f32 (TF32 off): its weights at seed
    0 bit-equal to the per-layer model's restacked and its logits
    (attention='flash') bit-equal to the per-layer model's; the `exact`
    workload through the dense engine (monolithic prefill) and the paged
    engine (block 16: prefix hits and a copy-on-write fork through the
    stacked pool) token-exact against `generate`; then the stacked
    pure-SSD layout on 'ssd' (`ssd exact`'s workload, row 7 on every
    prefill slice). Returns (paged launches, SSD launches)."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "scan exact"
    cfg = model_config(torch, torch.float32, 256, "flash", scan_layers=True)
    model = TransformerLM(cfg, device=device, seed=0)
    per_layer = TransformerLM(model_config(torch, torch.float32, 256,
                                           "flash"), device=device, seed=0)
    leaves = check_restacked(torch, per_layer.state_dict(),
                             model.state_dict(), cfg.num_layers, label)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 256))).to(device)
    with torch.no_grad():
        want, got = per_layer(tokens), model(tokens)
    if not torch.equal(want, got):
        fail(f"{label}: stacked logits != per-layer logits (max diff "
             f"{(want - got).abs().max().item():.3e})")
    del per_layer, want, got
    print(f"{label}: stacked weights at seed 0 == per-layer restacked "
          f"({leaves} leaves), logits [2, 256] (flash) bit-equal [{card}]",
          flush=True)
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    max_new = 32
    refs = reference_streams(torch, model, prompts, max_new, device)
    paged_launches = 0
    for name, kw in (("dense", {}),
                     ("paged", dict(cache_layout="paged", kernel="fused",
                                    block_size=16))):
        engine = DecodeEngine(model, slots=8, max_seq_len=256, device=device,
                              **kw)
        engine.warmup(prompt_lengths=[len(p) for p in prompts])
        scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                     max_new)
        stats = {}
        if engine.pool is None:
            if nonzero(counts):
                fail(f"{label} {name}: kernels launched on the dense layout:"
                     f" {nonzero(counts)}")
        else:
            paged_launches = paged_reads(engine, counts, "paged_decode",
                                         f"{label} {name}")
            stats = engine.pool_stats()
            if stats["cow_forks"] < 1 or stats["prefix_hit_rate"] <= 0:
                fail(f"{label} {name}: no prefix hit / COW fork: {stats}")
        ties = check_streams(torch, model, prompts, requests, max_new,
                             device, f"{label} {name}", refs=refs)
        leaf_shapes = {k: tuple(v.shape)
                       for k, v in engine.cache_box.value.items()}
        print(f"{label} {name}: {len(requests)} requests token-exact vs "
              f"generate (near ties {ties}), stacked cache {leaf_shapes}, "
              f"steps {nonzero(engine.step_counts)}, paged launches "
              f"{paged_launches if engine.pool is not None else 0}, cow "
              f"forks {stats.get('cow_forks', 0)}, CUDA graphs "
              f"{engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
              flush=True)
        del engine
    del model
    ssd = TransformerLM(model_config(torch, torch.float32, 256, mixer="ssd",
                                     ssd_state_dim=16, ssd_chunk=SSD_CHUNK,
                                     scan_layers=True),
                        device=device, seed=4)
    engine = DecodeEngine(ssd, slots=8, max_seq_len=256, chunk=SSD_CHUNK,
                          cache_layout="ssd", device=device)
    engine.warmup()
    # four of `ssd exact`'s prompts: a short tail, a slice and a tail,
    # two slices and a tail, three and a tail
    prompts, max_new = ssd_workload(np.random.default_rng(4), 32768)
    prompts = [p for p in prompts if len(p) in (5, 70, 131, 200)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    slices = engine.step_counts["prefill_chunk"]
    ssd_launches = counts["ssd_scan_fma"]
    if nonzero(counts) != {"ssd_scan_fma": 12 * slices}:
        fail(f"{label} ssd: launches {nonzero(counts)} for {slices} prefill "
             f"slices x 12 layers")
    ties = check_streams(torch, ssd, prompts, requests, max_new, device,
                         f"{label} ssd")
    print(f"{label} ssd: stacked pure-SSD, {len(requests)} requests past "
          f"the 256 ceiling token-exact vs generate (near ties {ties}), "
          f"state {tuple(engine.cache_box.value['ssd'].shape)}, launches "
          f"ssd_scan_fma={ssd_launches} == 12 x {slices} slices, "
          f"{seconds:.2f}s [{card}]", flush=True)
    return paged_launches, ssd_launches


def phase_scan_step(torch, device, card):
    """The 235M layout in f32 (TF32 off) at batch 2, seq 256, per-layer
    and scan-stacked at the same seed: the stacked weights, loss and every
    gradient bit-equal to the per-layer model's restacked, with flash
    attention (rows 1 and 4 on the general route), with 8 top-2 dropless
    experts (rows 9a and 9b) and with remat_policy='dots'; the launches
    equal. Returns the stacked runs' launches by case."""
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import attention, grouped_matmul
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    tokens = torch.from_numpy(synthetic_token_stream(32768)(2, 256, 0)
                              ).long().to(device)
    launches = {}
    for name, kw in (("flash", {}), ("moe dropless", MOE_LAYOUT),
                     ("remat dots", dict(remat=True, remat_policy="dots"))):
        label = f"scan step {name}"
        runs = {}
        for scan in (False, True):
            model = TransformerLM(model_config(
                torch, torch.float32, 256, "flash", scan_layers=scan, **kw),
                device=device, seed=3)
            attention.reset_launch_counts()
            grouped_matmul.reset_launch_counts()
            # the embedding's scatter-add in a fixed order
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                loss = lm_next_token_loss(
                    model, tokens,
                    aux_weight=0.01 if "moe_experts" in kw else None)
                loss.backward()
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            runs[scan] = (loss.item(), model.state_dict(),
                          {n: p.grad for n, p in model.named_parameters()},
                          nonzero({**attention.launch_counts,
                                   **grouped_matmul.launch_counts}))
            del model, loss
        (loss_a, state_a, grads_a, counts_a), \
            (loss_b, state_b, grads_b, counts_b) = runs[False], runs[True]
        check_restacked(torch, state_a, state_b, 12, f"{label} weights")
        leaves = check_restacked(torch, grads_a, grads_b, 12,
                                 f"{label} grads")
        if loss_a != loss_b or counts_a != counts_b or not counts_b:
            fail(f"{label}: loss {loss_a} vs {loss_b}, launches {counts_a} "
                 f"vs {counts_b}")
        launches[name] = counts_b
        print(f"{label}: loss {loss_b:.6f} and all {leaves} gradients of "
              f"the stacked model bit-equal to the per-layer model's "
              f"(restacked); launches {counts_b} in both [{card}]",
              flush=True)
        del runs, state_a, state_b, grads_a, grads_b
        release_memory(torch)
    return launches


def phase_scan_train(torch, card, folder, train_p50):
    """`train`'s run with model.scan_layers=true through `main` in a fresh
    XP: 8 steps and 2 valid steps, the step loss finite and falling, the
    flash launches a step `train`'s; a second call resumes it; tokens/s
    and step p50 beside `train`'s p50 of the same call. Returns the
    launches."""
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    label = "scan train"
    release_memory(torch)
    args = TRAIN_ARGS + ["model.scan_layers=true", f"dora.dir={folder}"]
    attention.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    solver = lm_main(args + ["epochs=1"])
    torch.cuda.synchronize()
    counts = nonzero(attention.launch_counts)
    cfg = solver.cfg
    layers, steps, valid = 12, cfg.steps_per_epoch, cfg.valid_steps
    want = {"flash_fwd": layers * (steps + valid),
            "flash_bwd_fused": layers * steps}
    if counts != want:
        fail(f"{label}: launches {counts}, expected `train`'s {want}")
    if "blocks.block.attn.qkv.kernel" not in solver.model.state_dict():
        fail(f"{label}: the model is not stacked")
    losses = solver.step_losses
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{label}: step losses {losses} not finite and falling")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.seq_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del solver
    resumed = lm_main(args + ["epochs=2"])
    if not resumed.restored or resumed.state["step"] != 2 * steps \
            or len(resumed.history) != 2:
        fail(f"{label}: the second call did not resume (restored "
             f"{resumed.restored}, step {resumed.state['step']})")
    print(f"{label}: 235M stacked bf16 b16 t1024, {steps} steps + {valid} "
          f"valid, step losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"tokens/s={tok_s:.1f}, step p50={p50:.2f} ms (steps 3..{steps}) "
          f"vs train's {train_p50:.2f} ms (ratio {p50 / train_p50:.3f}), "
          f"peak memory {peak:.1f} GiB; launches {counts} == train's a "
          f"step; resumed: Restored: True, epoch 2 loss "
          f"{resumed.history[1]['train']['loss']:.4f}, valid "
          f"{resumed.history[1]['valid']['loss']:.4f} [{card}]", flush=True)
    del resumed
    return counts


def int8_logits_cosine(torch, model, tokens, **quantize_kw):
    """Cosine (f64) of the first step's logits on int8 weights
    (`quantize_lm_params` of the model's f32 weights) to those on the f32
    weights, and the largest difference, on `tokens` [B, T]."""
    from flashy_tpu_torch.models.decoding import (_apply_step,
                                                  decode_params, init_cache,
                                                  lm_params)
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    cfg = model.config
    qp = quantize_lm_params(lm_params(model), **quantize_kw)
    batch, length = tokens.shape
    positions = torch.arange(length, device=tokens.device).expand(batch,
                                                                 length)
    logits = []
    with torch.no_grad():
        for params in (None, qp):
            out, _ = _apply_step(decode_params(model, params=params), cfg,
                                 tokens, positions,
                                 init_cache(cfg, batch, length, tokens.device),
                                 0)
            logits.append(out.double().flatten())
    a, b = logits
    return (float(a @ b / (a.norm() * b.norm())), float((a - b).abs().max()),
            float(a.abs().max()))


def phase_int8w_exact(torch, device, card):
    """int8 weights (`quantize_lm_params` of the f32 weights), f32 (TF32
    off): the first step's logits hold the JAX package's bar (cosine to
    the f32 weights' logits above INT8W_COS) on its own three cases
    (flashy_tpu's tests/test_quantize.py `_model`: vocab 128, dim 64, 2
    layers of 2 heads; per-layer, scan-stacked, 2 experts); at the 235M
    layout the same distance is printed, with and without
    keep_embed_dense; then the `exact` workload at 235M through the dense
    and the paged engine (`params=`) token-exact against
    `generate(params=)`. Returns the paged launches."""
    import numpy as np
    from flashy_tpu_torch.models.decoding import lm_params
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "int8w exact"
    small = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 16))).to(device)
    bars = {}
    for name, kw in (("per-layer", {}), ("scan", dict(scan_layers=True)),
                     ("moe 2", dict(moe_experts=2))):
        cfg = TransformerConfig(vocab_size=128, dim=64, num_layers=2,
                                num_heads=2, attention="dense",
                                max_seq_len=64, dtype=torch.float32, **kw)
        cos, _, _ = int8_logits_cosine(
            torch, TransformerLM(cfg, device=device, seed=1), small)
        bars[name] = round(cos, 6)
        if not cos > INT8W_COS:
            fail(f"{label}: the reference's case {name}: first-step logits "
                 f"cosine {cos} <= {INT8W_COS}")
    cfg = model_config(torch, torch.float32, 256)
    model = TransformerLM(cfg, device=device, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (2, 128))).to(device)
    full = int8_logits_cosine(torch, model, tokens)
    dense_embed = int8_logits_cosine(torch, model, tokens,
                                     keep_embed_dense=True)
    qp = quantize_lm_params(lm_params(model))
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    max_new = 32
    refs = reference_streams(torch, model, prompts, max_new, device, qp)
    launched = 0
    for name, kw in (("dense", {}),
                     ("paged", dict(cache_layout="paged", kernel="fused",
                                    block_size=16))):
        engine = DecodeEngine(model, slots=8, max_seq_len=256, params=qp,
                              device=device, **kw)
        engine.warmup(prompt_lengths=[len(p) for p in prompts])
        scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                     max_new)
        if engine.pool is not None:
            launched = paged_reads(engine, counts, "paged_decode",
                                   f"{label} {name}")
        elif nonzero(counts):
            fail(f"{label} {name}: kernels launched on the dense layout: "
                 f"{nonzero(counts)}")
        ties = check_streams(torch, model, prompts, requests, max_new,
                             device, f"{label} {name}", refs=refs, params=qp)
        print(f"{label} {name}: {len(requests)} requests token-exact vs "
              f"generate(params=int8) (near ties {ties}), steps "
              f"{nonzero(engine.step_counts)}, paged launches "
              f"{launched if engine.pool is not None else 0}, CUDA graphs "
              f"{engine.compile_cache.stats()}, {seconds:.2f}s [{card}]",
              flush=True)
        del engine
    print(f"{label}: first-step logits, int8 vs f32 weights: cosine on the "
          f"reference's cases {bars} (bar {INT8W_COS}); 235M [2, 128]: "
          f"cosine {full[0]:.6f}, max |diff| {full[1]:.4f} of max |logit| "
          f"{full[2]:.4f}; with keep_embed_dense cosine "
          f"{dense_embed[0]:.6f}, max |diff| {dense_embed[1]:.4f} [{card}]",
          flush=True)
    return launched


def phase_int8w_serve(torch, device, card, requests_n=16, prompt_len=128,
                      max_new=128):
    """The 235M layout in bf16 with int8 weights and int8 K/V pools (row
    6) through the paged engine's captured steps (8 slots, 16 requests,
    prompt 128, 128 new), in turns with the same traffic on bf16 weights
    over int8 pools: tokens/s, decode p50, the int8 kernel on every read,
    and the resident weight bytes (int8 payloads + f32 scales + dense
    leaves against the bf16 tree). Returns the int8-weight run's paged
    launches."""
    import numpy as np
    from flashy_tpu_torch.models.decoding import lm_params
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    label = "int8w serve bf16"
    release_memory(torch)
    cfg = model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    qp = quantize_lm_params(lm_params(model))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    results, launched = {}, 0
    for weights in ("int8", "bf16", "int8", "bf16"):
        engine = DecodeEngine(model, slots=8, block_size=16, max_seq_len=256,
                              kv_dtype="int8", cache_layout="paged",
                              params=qp if weights == "int8" else None,
                              device=device)
        engine.warmup()
        scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                     max_new)
        reads = paged_reads(engine, counts, "paged_decode_int8",
                            f"{label} {weights} weights")
        if weights == "int8":
            launched = reads
        check_outputs(requests, [prompt_len + max_new] * requests_n,
                      cfg.vocab_size, label)
        summary = scheduler.metrics.summary()
        results.setdefault(weights, []).append(
            (summary["tokens_per_sec"], summary["itl_ms_p50"]))
        bytes_ = tree_bytes(engine._params)
        results[f"{weights} bytes"] = bytes_
        del engine
    runs = {w: "; ".join(f"tokens/s={t:.1f} p50={p:.3f} ms"
                         for t, p in results[w]) for w in ("int8", "bf16")}
    print(f"{label}: {requests_n} requests x prompt {prompt_len} x {max_new} "
          f"new over int8 pools, in turns: int8 weights {runs['int8']}; "
          f"bf16 weights {runs['bf16']}; launches paged_decode_int8="
          f"{launched} == reads; resident weights: int8 tree "
          f"{results['int8 bytes'] / 2 ** 30:.3f} GiB vs bf16 tree "
          f"{results['bf16 bytes'] / 2 ** 30:.3f} GiB [{card}]", flush=True)
    return launched


# ----------------------------------------------------------------------
# observability and chaos: request tracing, the SLO engine, the chaos
# fault points, the serve status file, training telemetry
# ----------------------------------------------------------------------
def read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def phase_serve_traced(torch, device, card, requests_n=16, prompt_len=128,
                       max_new=128, turns=2):
    """`serve bf16`'s traffic through two paged engines' captured graphs
    on one model, in turns: one untraced, one with a Tracer, a
    RequestTracer at sampling 1.0, an SLOEngine and ServeMetrics(tracer=,
    slo=). The streams must be identical, neither engine may build or
    capture in traffic, every request's queued, prefill and decode phases
    must be in requests.jsonl and its async spans in trace.json, and
    serve.json's slo block must not alert. The traced engine has one
    Tracer for the phase, exported after each turn. Then one more traced
    run with every hook timed (`time_hooks`). Returns the traced runs' row
    5 launches."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.observability import SLOEngine, Tracer
    from flashy_tpu_torch.serve import RequestTracer, ServeMetrics
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.utils import percentile
    cfg = model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    kw = dict(slots=8, block_size=16, max_seq_len=256, cache_layout="paged",
              device=device)
    plain = DecodeEngine(model, cache_scope="plain", **kw)
    tracer = Tracer()
    traced = DecodeEngine(model, cache_scope="traced", tracer=tracer, **kw)
    for engine in (plain, traced):
        engine.warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    runs = {"untraced": [], "traced": []}
    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        for turn in range(turns):
            for what in ("untraced", "traced"):
                if what == "untraced":
                    scheduler, requests, counts, seconds = serve(
                        torch, plain, prompts, max_new)
                    steps = sum(plain.step_counts.values())
                else:
                    folder = Path(tmp) / f"turn{turn}"
                    tracing = RequestTracer(
                        tracer=tracer, sample_rate=1.0,
                        journal_path=folder / "requests.jsonl")
                    metrics = ServeMetrics(tracer=tracer,
                                           slo=SLOEngine(tracer=tracer))
                    scheduler, requests, counts, seconds = serve(
                        torch, traced, prompts, max_new, tracing=tracing,
                        metrics=metrics)
                    steps = sum(traced.step_counts.values())
                    metrics.write_status(folder)
                    tracing.close()
                    tracer.export_chrome_trace(folder / "trace.json")
                    launches.append(counts["paged_decode"])
                    # the phase's tracer holds every turn so far
                    check_traced_run(folder, requests, f"serve traced turn "
                                     f"{turn}", spans_each=turn + 1)
                if counts["paged_decode"] < 1:
                    fail(f"serve traced: the {what} run launched no paged "
                         f"kernel: {nonzero(counts)}")
                runs[what].append((requests, scheduler.metrics.summary(),
                                   seconds, steps))
        hooks, timed_requests = time_hooks(
            torch, traced, prompts, max_new, RequestTracer(
                tracer=tracer, sample_rate=1.0,
                journal_path=Path(tmp) / "timed" / "requests.jsonl"),
            ServeMetrics(tracer=tracer, slo=SLOEngine(tracer=tracer)))
    for (got, *_), (want, *_) in zip(
            runs["traced"] + [(timed_requests,)],
            runs["untraced"] + runs["untraced"][-1:]):
        for a, b in zip(got, want):
            if not np.array_equal(a.output, b.output):
                fail(f"serve traced: request {a.uid}'s stream differs "
                     f"between the traced and the untraced engine")
    for engine in (plain, traced):
        stats = engine.compile_cache.stats()
        if stats["recompiles"] or stats["misses"] != len(
                engine.compile_cache):
            fail(f"serve traced: compile cache {stats}")
    if len(set(launches)) != 1:
        fail(f"serve traced: row 5 launches differ between turns "
             f"{launches}")

    def medians(what):
        summaries = [summary for _, summary, _, _ in runs[what]]
        return (percentile([s["tokens_per_sec"] for s in summaries], 50),
                percentile([s["itl_ms_p50"] for s in summaries], 50))

    (tok_u, p50_u), (tok_t, p50_t) = medians("untraced"), medians("traced")
    # the host time tracing adds to a step: the runs' wall seconds apart,
    # over the steps of a run, turn by turn
    extra_us = percentile([
        (t[2] - u[2]) / t[3] * 1e6
        for t, u in zip(runs["traced"], runs["untraced"])], 50)
    print(f"serve traced: 235M bf16 paged, {requests_n} requests x "
          f"{max_new} new, {turns} turns: streams identical, no capture "
          f"after warm-up; untraced tokens/s={tok_u:.1f} decode p50="
          f"{p50_u:.3f} ms; traced (sampling 1.0, SLO engine) tokens/s="
          f"{tok_t:.1f} decode p50={p50_t:.3f} ms; ratio traced/untraced "
          f"p50 {p50_t / p50_u:.4f}, tokens/s {tok_t / tok_u:.4f}; host us "
          f"a step added by tracing {extra_us:.1f} (median over turns of "
          f"(traced s - untraced s) / steps); row 5 launches per run "
          f"{launches[0]}; the spans time each step to completion (they "
          f"hold the read of its tokens) [{card}]", flush=True)
    print(f"serve traced hooks: host us a step in each hook of one more "
          f"traced run (top-level calls; metrics.* include their SLO and "
          f"counter calls; each timed call adds ~0.3 us of timing): "
          f"{json.dumps(hooks)}", flush=True)
    return launches[0]


def check_roofline_graphs(torch, device, card, m=256, n=512, k=128):
    """A CompileCache with an enabled RooflineProfiler on the card: a
    one-matmul step's FLOPs counted on the eager run before its capture
    (2 M N K), the graph captured, each replay timed to completion and
    equal to the product."""
    from flashy_tpu_torch.observability import RooflineProfiler
    from flashy_tpu_torch.serve.compile_cache import CompileCache
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(m, k, device=device, generator=gen)
    b = torch.randn(k, n, device=device, generator=gen)
    roofline = RooflineProfiler(peak_flops=989e12)
    cache = CompileCache(roofline=roofline, device=device)
    cache.warm(("mm",), lambda: torch.mm, a, b)
    step = cache.get(("mm",), lambda: None)
    outs = [step(a, b).clone() for _ in range(3)]
    profile = roofline.profiles.get("mm")
    captured = getattr(step, "captured", False)
    if captured != (device.type == "cuda") or profile is None \
            or profile.flops != 2 * m * n * k or profile.calls != 3 \
            or not all(w > 0 for w in profile.wall) \
            or cache.stats()["recompiles"]:
        fail(f"roofline graphs: captured {captured}, profile "
             f"{vars(profile) if profile else None}, {cache.stats()}")
    want = a @ b
    if not all(torch.allclose(o, want, rtol=1e-5, atol=1e-4) for o in outs):
        fail("roofline graphs: a timed replay differs from the product")
    print(f"roofline graphs: a [{m}, {k}] x [{k}, {n}] f32 step through a "
          f"CompileCache with a roofline: FLOPs {profile.flops:.0f} == "
          f"2MNK counted before the capture, 3 replays timed, p50 "
          f"{roofline.summarize('mm')['wall_ms_p50']:.4f} ms [{card}]",
          flush=True)


def time_hooks(torch, engine, prompts, max_new, tracing, metrics):
    """One traced run of `prompts` with each of `tracing`'s and
    `metrics`' `on_*` hooks, the SLO engine's `observe` and the engine
    tracer's calls (a span's enter and exit, not its body) timed on the
    host, top-level calls only. Each scheduler step is classed as an
    admission step (an admission or a prefill chunk in it), a retirement
    step (a request finished) or a decode step. Returns ({class: {"steps":
    n, "all hooks": us a step, hook: us a step, ...}}, the requests)."""
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    step_hooks = {}
    depth = [0]

    def charge(name, seconds):
        step_hooks[name] = step_hooks.get(name, 0.0) + seconds

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            depth[0] += 1
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0 or name == "slo.observe":
                    charge(name, time.perf_counter() - start)
        return wrapped

    class TimedSpan:
        def __init__(self, cm):
            self.cm = cm

        def __enter__(self):
            return self.timed(self.cm.__enter__)

        def __exit__(self, *exc):
            return self.timed(self.cm.__exit__, *exc)

        @staticmethod
        def timed(fn, *args):
            depth[0] += 1
            start = time.perf_counter()
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
                charge("engine span", time.perf_counter() - start)

    for obj, prefix in ((tracing, "tracing"), (metrics, "metrics")):
        for name in dir(obj):
            if name.startswith("on_") and callable(getattr(obj, name)):
                setattr(obj, name, timed(f"{prefix}.{name}",
                                         getattr(obj, name)))
    metrics.slo.observe = timed("slo.observe", metrics.slo.observe)
    tracer = engine.tracer
    span = tracer.span
    tracer.span = lambda *a, **k: TimedSpan(span(*a, **k))
    for name in ("instant", "counter", "complete", "record"):
        setattr(tracer, name, timed(f"tracer.{name}", getattr(tracer, name)))
    classes = {}
    scheduler = ContinuousBatchingScheduler(engine, tracing=tracing,
                                            metrics=metrics)
    step = scheduler.step

    def classed_step():
        step_hooks.clear()
        out = step()
        if "tracing.on_admit" in step_hooks \
                or "tracing.on_prefill_chunk" in step_hooks:
            kind = "admission"
        elif "tracing.on_finish" in step_hooks:
            kind = "retirement"
        else:
            kind = "decode"
        entry = classes.setdefault(kind, {"steps": 0})
        entry["steps"] += 1
        for name, seconds in step_hooks.items():
            entry[name] = entry.get(name, 0.0) + seconds
        return out

    scheduler.step = classed_step
    requests = [scheduler.submit(p, max_new) for p in prompts]
    try:
        scheduler.run()
    finally:
        for name in ("span", "instant", "counter", "complete", "record"):
            delattr(tracer, name)
        tracing.close()
    out = {}
    for kind, entry in classes.items():
        n = entry.pop("steps")
        own = {k: v for k, v in entry.items() if k != "slo.observe"}
        row = {"steps": n, "all hooks": round(sum(own.values()) / n * 1e6,
                                              2)}
        for name, seconds in sorted(entry.items(), key=lambda kv: -kv[1]):
            row[name] = round(seconds / n * 1e6, 2)
        out[kind] = row
    return out, requests


def check_traced_run(folder, requests, label, spans_each=1):
    """requests.jsonl names every request's queued, prefill and decode
    phases, trace.json loads and opens and closes each request's async
    span `spans_each` times (a tracer kept over that many runs of the
    same uids), serve.json carries an slo block that does not alert."""
    from flashy_tpu_torch.observability import format_slo_report
    finished = {r["uid"]: r for r in read_jsonl(folder / "requests.jsonl")
                if r["event"] == "finished"}
    for request in requests:
        record = finished.get(request.uid)
        if record is None or not {"queue_wait_s", "prefill_s",
                                  "decode_s"} <= set(record):
            fail(f"{label}: request {request.uid} has no phases in "
                 f"requests.jsonl: {record}")
        if record["tokens"] != len(request.generated):
            fail(f"{label}: request {request.uid} journal tokens "
                 f"{record['tokens']} != {len(request.generated)}")
    events = json.loads((folder / "trace.json").read_text())["traceEvents"]
    spans = {}
    for event in events:
        if event.get("ph") in ("b", "e"):
            key = (event["name"], event["id"], event["ph"])
            spans[key] = spans.get(key, 0) + 1
    for request in requests:
        for ph in ("b", "e"):
            if spans.get(("serve/request", f"0x{request.uid:x}",
                          ph)) != spans_each:
                fail(f"{label}: request {request.uid}'s async span is not "
                     f"opened and closed {spans_each} time(s) in "
                     f"trace.json")
    status = json.loads((folder / "serve.json").read_text())
    report = status.get("slo")
    if not report or not report.get("budgets") or report["alerting"]:
        fail(f"{label}: serve.json slo block missing or alerting:\n"
             + (format_slo_report(report) if report else "none"))


def phase_serve_chaos(torch, device, card):
    """The `exact` workload in f32 through the paged engine under a strict
    FaultInjector: the third admission's block reservation fails
    (`serve.pool`: shed, retried), 12 decode steps stall 0.1 s each
    (`serve.step`) against an ITL budget of 0.05 s, and the second
    serve.json write fails between its temporary write and its rename
    (`fleet.status`). Every stream token-exact against `generate` (near
    ties reported), the ITL budget alerting, the first serve.json whole
    after the failed write and healed by the next, `uninstall()` quiet.
    Returns the run's row 5 launches."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.observability import SLOBudget, SLOEngine
    from flashy_tpu_torch.resilience import InjectedFault, chaos
    from flashy_tpu_torch.serve import POOL_FAULT_SITE, ServeMetrics
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.float32, 512)
    model = TransformerLM(cfg, device=device, seed=0)
    engine = DecodeEngine(model, slots=8, block_size=16, max_seq_len=512,
                          cache_layout="paged", device=device)
    engine.warmup()
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    max_new = 32
    delay, budget = 0.1, 0.05
    slo = SLOEngine(budgets=(SLOBudget("itl", threshold=budget),),
                    min_samples=8)
    metrics = ServeMetrics(slo=slo)
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        metrics.write_status(folder)
        first = (folder / "serve.json").read_text()
        injector = chaos.install(strict=True)
        try:
            injector.fail_at(POOL_FAULT_SITE, 3)
            injector.delay_at("serve.step", 5, seconds=delay, times=12)
            injector.fail_at("fleet.status", 1)
            scheduler, requests, counts, seconds = serve(
                torch, engine, prompts, max_new, metrics=metrics)
            try:
                metrics.write_status(folder)
                fail("serve chaos: the injected serve.json failure did not "
                     "raise")
            except InjectedFault:
                pass
            torn = (folder / "serve.json").read_text()
            metrics.write_status(folder)
        except BaseException:
            chaos.uninstall(verify=False)
            raise
        chaos.uninstall()          # strict: raises if a rule never fired
        healed = json.loads((folder / "serve.json").read_text())
    if torn != first:
        fail("serve chaos: the failed write changed serve.json")
    if healed.get("requests") != len(prompts) or "slo" not in healed:
        fail(f"serve chaos: the next write did not heal serve.json: "
             f"{healed.get('requests')} requests")
    hits = {(f["site"], f["kind"]) for f in injector.fired}
    if injector.hits(POOL_FAULT_SITE, "fail") != 1 \
            or injector.hits("serve.step", "delay") != 12 \
            or injector.hits("fleet.status", "fail") != 1:
        fail(f"serve chaos: faults fired {injector.fired}")
    if scheduler.admitted_order != [r.uid for r in requests]:
        fail(f"serve chaos: the shed admission did not retry at the queue "
             f"head: {scheduler.admitted_order}")
    ties = check_streams(torch, model, prompts, requests, max_new, device,
                         "serve chaos")
    report = slo.evaluate()
    if slo.alerts() != ["itl"]:
        fail(f"serve chaos: the ITL budget of {budget} s did not alert "
             f"under {delay} s stalls: {report}")
    reads = cfg.num_layers * (engine.step_counts["decode"]
                              + engine.step_counts["prefill_chunk"])
    if nonzero(counts) != {"paged_decode": reads}:
        fail(f"serve chaos: launches {nonzero(counts)}, {reads} reads")
    engine.pool.check()
    itl = report["budgets"]["itl"]
    print(f"serve chaos: 235M f32 paged, {len(requests)} requests x "
          f"{max_new} new under a strict FaultInjector: token-exact vs "
          f"generate (near ties {ties}); fired {sorted(hits)}; counts "
          f"{injector.counts}; admission 3 shed and retried at the head; "
          f"ITL budget p95 <= {budget * 1e3:.0f} ms alerting (p95 "
          f"{itl['value'] * 1e3:.1f} ms, burn fast {itl['burn_fast']:.2f} "
          f"slow {itl['burn_slow']:.2f}, {itl['samples']} samples) under "
          f"12 stalls of {delay * 1e3:.0f} ms; serve.json whole after the "
          f"failed write, healed by the next; uninstall() quiet; row 5 "
          f"launches {counts['paged_decode']}, {seconds:.2f}s [{card}]",
          flush=True)
    return counts["paged_decode"]


# 2 of the layout's 12 layers (the script's time limit): the harness's
# cost is a step's host share, and the launches follow the depth
TELEMETRY_LAYERS = 2
TELEMETRY_ARGS = [a for a in TRAIN_ARGS[:-2]
                  if not a.startswith("model.num_layers=")] + [
    f"model.num_layers={TELEMETRY_LAYERS}", "steps_per_epoch=6",
    "valid_steps=1", "epochs=1"]


def telemetry_run(torch, device, folder, telemetry, profile=False):
    """The LM solver's train and valid stages at `train`'s shapes (6
    steps, 1 valid; no commit, so no checkpoint is written) in a fresh XP
    under `folder`, with telemetry (roofline on) and, with `profile`,
    torch.profiler on the train stage. Returns (solver, the train stage's
    metrics, the flash launches, the step p50 ms over steps 3..6)."""
    from flashy_tpu_torch import observability
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    xp = lm_main.get_xp(TELEMETRY_ARGS + [f"dora.dir={folder}"])
    attention.reset_launch_counts()
    with xp.enter():
        solver = LMSolver(xp.cfg, device=device)
        if telemetry:
            solver.enable_telemetry(roofline=True)
        if profile:
            solver.enable_profiling(stages=["train"])
        try:
            train = solver.run_stage("train", solver.train)
            solver.run_stage("valid", solver.valid)
        finally:
            observability.disable_telemetry()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (solver, train, nonzero(attention.launch_counts),
            percentile(solver.step_seconds[2:], 50) * 1e3)


def device_busy_seconds(events):
    """Seconds in which the card ran a kernel, a copy or a memset in a
    torch.profiler Chrome trace: the union of those events' intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e.get("ph") == "X")
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy * 1e-6


def phase_train_telemetry(torch, device, card, root, turns=2):
    """`train`'s model and shapes (bf16 b16 t1024, flash) for 6 steps and
    1 valid step with `enable_telemetry(roofline=True)` and
    `enable_profiling(stages=["train"])` in a fresh XP: one step record a
    step whose data wait, host and device tile it, trace.json and
    heartbeats/, 0 recompiles, the roofline's MFU in the stage metrics
    against the H100 peak in (0, 1], the profiler's trace, the split's
    device backlog at most the card's busy time there (the busy time at
    most the steps' wall), and `python -m
    flashy_tpu_torch.info <root>` (the heartbeat view) and `--slo` exit
    0. Then the same run without and with telemetry (no profiler), in
    turns: the step p50s. Returns the first run's flash launches."""
    from flashy_tpu_torch.observability import device_peaks
    from flashy_tpu_torch.utils import percentile
    root = Path(root)
    solver, train, launches, _ = telemetry_run(
        torch, device, root / "first", True, profile=True)
    folder = solver.folder
    cfg = solver.cfg
    layers = cfg.model.num_layers
    want = {"flash_fwd": layers * (cfg.steps_per_epoch + cfg.valid_steps),
            "flash_bwd_fused": layers * cfg.steps_per_epoch}
    if launches != want:
        fail(f"train telemetry: launches {launches}, expected {want}")
    records = read_jsonl(folder / "telemetry.jsonl")
    steps = [r for r in records if r["type"] == "step"]
    by_stage = {stage: [r["step"] for r in steps if r["stage"] == stage]
                for stage in ("train", "valid")}
    if by_stage != {"train": list(range(cfg.steps_per_epoch)),
                    "valid": list(range(cfg.valid_steps))}:
        fail(f"train telemetry: step records {by_stage}")
    worst = max(abs(r["data_wait"] + r["host"] + r["device"] - r["total"])
                for r in steps)
    if worst > 1e-9:
        fail(f"train telemetry: a step's split does not tile it ({worst})")
    if not (folder / "trace.json").is_file() \
            or not (folder / "heartbeats" / "rank0.json").is_file():
        fail("train telemetry: trace.json or heartbeats/ missing")
    trace = json.loads((folder / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in trace if e.get("ph") == "X"}
    if not {"stage/train", "step/host", "step/device"} <= spans:
        fail(f"train telemetry: trace.json spans {sorted(spans)}")
    recompiles = [r for r in records if r["type"] == "recompile"]
    if recompiles or "recompiles" in train:
        fail(f"train telemetry: recompiles {recompiles}")
    peak, _ = device_peaks()
    roofline = next(r for r in records if r["type"] == "roofline")
    if peak != 989e12 or roofline["peak_flops"] != peak \
            or "roofline_mfu" not in train:
        fail(f"train telemetry: no roofline summary against the H100 peak "
             f"({peak}, {roofline['peak_flops']}, {sorted(train)})")
    profiles = sorted((folder / "profiles").glob("*.json"))
    if [p.name for p in profiles] != ["train-epoch1.json"]:
        fail(f"train telemetry: profiler traces {profiles}")
    profile = json.loads(profiles[0].read_text())["traceEvents"]
    kernels = sum(1 for e in profile if e.get("cat") == "kernel")
    # the split against the card's busy time in the profile: the port
    # launches op by op, so the card works through the host phase and
    # `device` is the backlog at each step's end (observability.
    # steptimer); that backlog is at most the card's busy time, which is
    # at most the steps' wall clock. The MFU is over that wall clock.
    busy = device_busy_seconds(profile)
    train_steps = [r for r in steps if r["stage"] == "train"]
    wall = sum(r["total"] for r in train_steps)
    backlog = sum(r["device"] for r in train_steps)
    if not backlog <= busy + 1e-3 or not busy <= wall * 1.01:
        fail(f"train telemetry: the split disagrees with the profile: "
             f"backlog {backlog:.4f} s, busy {busy:.4f} s, wall {wall:.4f} s")
    if not 0.0 < train["roofline_mfu"] <= 1.0:
        fail(f"train telemetry: roofline MFU {train['roofline_mfu']} "
             f"outside (0, 1]")
    busy_mfu = (roofline["executables"]["lm/train_step"]["flops_per_call"]
                * len(train_steps) / max(busy, 1e-9) / peak)
    # the host's waits for the card in the profile: one per step in
    # observe(), one per step in the batch's upload (a pageable copy)
    syncs = [e["dur"] for e in profile if e.get("ph") == "X"
             and e.get("name", "").endswith("Synchronize")]
    for argv in ([str(root / "first")], [str(root / "first"), "--slo"]):
        out = subprocess.run(
            [sys.executable, "-m", "flashy_tpu_torch.info", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        if out.returncode != 0 or (len(argv) == 1
                                   and "heartbeats: 1/1 ranks"
                                   not in out.stdout):
            fail(f"train telemetry: python -m flashy_tpu_torch.info "
                 f"{' '.join(argv[1:])} exit {out.returncode}: "
                 f"{out.stdout[-400:]} {out.stderr[-400:]}")
    step_cost = roofline["executables"]["lm/train_step"]
    del solver
    release_memory(torch)
    p50 = {"plain": [], "telemetry": []}
    splits = []
    for turn in range(turns):
        for what in ("plain", "telemetry"):
            run, stage, _, ms = telemetry_run(
                torch, device, root / f"{what}{turn}", what == "telemetry")
            p50[what].append(ms)
            if what == "telemetry":
                splits.append([round(stage[f"{key}_frac"], 4) for key in
                               ("data_wait", "host", "device")])
            del run
            release_memory(torch)
    plain = percentile(p50["plain"], 50)
    traced = percentile(p50["telemetry"], 50)
    print(f"train telemetry: the 235M layout's width at {layers} layers, "
          f"bf16 b16 t1024 flash, "
          f"{cfg.steps_per_epoch} steps + {cfg.valid_steps} valid with "
          f"telemetry, roofline and torch.profiler: one step record a step "
          f"(data_wait + host + device == total), trace.json, heartbeats/, "
          f"0 recompiles, info and info --slo exit 0; train stage "
          f"step_p50={train['step_p50'] * 1e3:.2f} ms, "
          f"data_wait/host/device frac {train['data_wait_frac']:.4f}/"
          f"{train['host_frac']:.4f}/{train['device_frac']:.4f} (device: "
          f"the backlog at each step's end), the card busy "
          f"{busy / wall:.4f} of the steps in the profile, "
          f"{len(syncs)} synchronize calls there taking "
          f"{sum(syncs) / 1e3:.2f} ms, the split of the unprofiled "
          f"telemetry turns {splits}; roofline: "
          f"aten FLOPs a step {step_cost['flops_per_call']:.4e} (the flash "
          f"kernels uncounted), {train['roofline_tflops_per_sec']:.1f} "
          f"TFLOP/s over the steps' wall, MFU {train['roofline_mfu']:.4f} "
          f"({busy_mfu:.4f} over the card's busy time) against "
          f"{peak:.3e}; profiler trace {profiles[0].name} with "
          f"{kernels} kernel events; launches {launches}; step p50 in "
          f"turns (steps 3..6): plain {p50['plain']} ms, telemetry "
          f"{p50['telemetry']} ms, ratio of the medians "
          f"{traced / plain:.4f} [{card}]", flush=True)
    return launches


# ----------------------------------------------------------------------
# item 9's resilience half: preemption, slots, async saves, hangs
# ----------------------------------------------------------------------
# `train`'s width at 2 of its 12 layers: what the fault-tolerance phases
# check (bit-identical resumes, slots, asynchronous commits, the abort's
# latency) does not depend on depth, and at 12 layers the four phases took
# 142.8-152.9 s of the script's limit, at 4 86.7-98.9 s (root PERF.md)
LAYERS = 2
FT_ARGS = [arg for arg in TRAIN_ARGS
           if not arg.startswith(("model.num_layers=", "steps_per_epoch=",
                                  "valid_steps="))
           ] + [f"model.num_layers={LAYERS}", "steps_per_epoch=2",
                "valid_steps=1"]
FT_SECONDS_AT_12_LAYERS = "142.8-152.9"
RESILIENCE_ARGS = FT_ARGS + ["epochs=3"]
WALL_CLOCK_KEYS = ("duration", "tokens_per_sec")
HANG_WARN, HANG_ABORT, HANG_INTERVAL = 2.0, 4.0, 0.5
HANG_BOUND = 8.0          # seconds from blocking to the exit, at most
HANG_CYCLES = 40_000_000_000   # ~20 s of spin at the H100's ~2 GHz


def stripped(history):
    """A history without its wall-clock keys."""
    return [{stage: {k: v for k, v in metrics.items()
                     if k not in WALL_CLOCK_KEYS}
             for stage, metrics in epoch.items()} for epoch in history]


def history_spread(got, want):
    """The largest difference between two stripped histories' metrics
    (inf when their epochs, stages or keys differ)."""
    if [{s: sorted(m) for s, m in e.items()} for e in got] != \
            [{s: sorted(m) for s, m in e.items()} for e in want]:
        return math.inf
    return max([abs(g[s][k] - w[s][k]) for g, w in zip(got, want)
                for s in w for k in w[s]], default=0.0)


def solver_state(torch, state):
    """The parameters and AdamW moments of a solver state dict (live or
    loaded), keyed `model.<name>` and `adamw.<index>.<moment>`."""
    out = {f"model.{k}": v.detach() for k, v in state["model"].items()}
    for index, moments in state["optimizer"]["state"].items():
        for key, value in moments.items():
            if torch.is_tensor(value):
                out[f"adamw.{index}.{key}"] = value.detach()
    return out


def host_state(torch, solver):
    return {k: v.cpu().clone() for k, v in solver_state(
        torch, {"model": solver.model.state_dict(),
                "optimizer": solver.optimizer.state_dict()}).items()}


def state_spread(torch, got, want):
    """(leaves not bit-equal, the largest absolute difference)."""
    if set(got) != set(want):
        fail(f"state leaves differ: {sorted(set(got) ^ set(want))[:4]}")
    differ, worst = 0, 0.0
    for key, value in want.items():
        other = got[key].to(value.device)
        if not torch.equal(other, value):
            differ += 1
            worst = max(worst, float((other.double() - value.double())
                                     .abs().max()))
    return differ, worst


def timed_method(solver, name, log):
    """Record the seconds of each call of `solver.<name>` in `log`."""
    method = getattr(solver, name)

    def wrapper(*args, **kwargs):
        begin = time.perf_counter()
        try:
            return method(*args, **kwargs)
        finally:
            log.append(time.perf_counter() - begin)

    setattr(solver, name, wrapper)


def resilience_run(torch, folder, mode="single", use_async=False,
                   sigterm_at=None, save=True, setup=None):
    """`train`'s model through `LMSolver.run` in the XP of
    RESILIENCE_ARGS under `folder`, with `enable_preemption_guard()`
    installed; `sigterm_at` (a global train step) makes `batch_at` send
    this process a real SIGTERM there. Returns (solver, exit code or None,
    commit seconds, restore seconds, train steps, valid steps)."""
    import os
    import signal
    from flashy_tpu_torch import resilience
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    xp = lm_main.get_xp(RESILIENCE_ARGS + [f"dora.dir={folder}"])
    commits, restores, valid = [], [], [0]
    code = None
    with xp.enter():
        solver = LMSolver(xp.cfg, device=torch.device("cuda"))
        solver.checkpoint_mode = mode
        solver.checkpoint_async = use_async
        if not save:
            base = solver.commit
            solver.commit = lambda: base(save_checkpoint=False)
        timed_method(solver, "commit", commits)
        timed_method(solver, "restore", restores)
        batch_at = solver.batch_at

        def counted(step, eval_set=False):
            valid[0] += bool(eval_set)
            if not eval_set and step == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return batch_at(step, eval_set=eval_set)

        solver.batch_at = counted
        if setup is not None:
            setup(solver)
        solver.enable_preemption_guard()
        try:
            solver.run()
        except SystemExit as exit_:
            code = exit_.code
        finally:
            resilience.disable_preemption_guard()
    torch.cuda.synchronize()
    return (solver, code, commits, restores, len(solver.step_seconds),
            valid[0])


def flash_want(layers, runs):
    """Row 1 and row 4 launches of runs of (train steps, valid steps)."""
    return {"flash_fwd": layers * sum(t + v for t, v in runs),
            "flash_bwd_fused": layers * sum(t for t, _ in runs)}


def resume_verdict(torch, label, got, want, clean_spread):
    """Hold a resumed run (history, state) to the clean run: bit-equal
    when the two clean runs were, else within their spread."""
    history = history_spread(stripped(got[0]), stripped(want[0]))
    differ, worst = state_spread(torch, got[1], want[1])
    bound_history, bound_state = clean_spread
    if history > bound_history or worst > bound_state:
        fail(f"{label}: the resumed run differs from the clean run: "
             f"history by {history}, {differ} state leaves by up to "
             f"{worst} (clean runs' spread: history {bound_history}, "
             f"state {bound_state})")
    return (f"history off by {history}, {differ} of {len(want[1])} "
            f"leaves not bit-equal (max {worst}; the clean runs' spread: "
            f"{bound_history}, {bound_state})")


def phase_train_preempt(torch, card, root):
    """Phase 35. Returns (the clean run's (history, host state), the
    clean runs' spread, row 1 and 4 launches)."""
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.resilience import file_digest
    root = Path(root)
    attention.reset_launch_counts()
    runs, clean = [], []
    for name in ("clean_a", "clean_b"):
        solver, code, _, _, steps, valid = resilience_run(
            torch, root / name, save=False)
        if code is not None or len(solver.history) != 3:
            fail(f"train preempt: clean run exit {code}, "
                 f"{len(solver.history)} epochs")
        runs.append((steps, valid))
        clean.append((solver.history, host_state(torch, solver)))
        del solver
        release_memory(torch)
    spread = (history_spread(stripped(clean[1][0]), stripped(clean[0][0])),
              state_spread(torch, clean[1][1], clean[0][1])[1])
    clean_differ = state_spread(torch, clean[1][1], clean[0][1])[0]
    folder = root / "preempt"
    solver, code, commits, _, steps, valid = resilience_run(
        torch, folder, sigterm_at=2 * 2 + 1)
    runs.append((steps, valid))
    marker_path = solver.folder / "preempted.json"
    marker = json.loads(marker_path.read_text()) \
        if marker_path.exists() else {}
    if code != 75 or len(solver.history) != 2 \
            or marker.get("committed_epochs") != 2 \
            or marker.get("signal") != "SIGTERM" \
            or marker.get("where") != "boundary before stage 'valid' " \
                                      "(epoch 3)":
        fail(f"train preempt: exit {code}, {len(solver.history)} epochs, "
             f"preempted.json {marker}")
    path = solver.checkpoint_path
    nbytes = path.stat().st_size
    begin = time.perf_counter()
    file_digest(path)
    sha_s = time.perf_counter() - begin
    del solver
    release_memory(torch)
    resumed, code, resume_commits, restores, steps, valid = resilience_run(
        torch, folder)
    runs.append((steps, valid))
    if code is not None or not resumed.restored \
            or len(resumed.history) != 3 or steps != 2:
        fail(f"train preempt: the resume exit {code}, restored "
             f"{resumed.restored}, {len(resumed.history)} epochs, "
             f"{steps} steps")
    verdict = resume_verdict(torch, "train preempt",
                             (resumed.history, host_state(torch, resumed)),
                             clean[0], spread)
    launches = nonzero(attention.launch_counts)
    want = flash_want(LAYERS, runs)
    if launches != want:
        fail(f"train preempt: launches {launches}, expected {want}")
    del resumed
    release_memory(torch)
    print(f"train preempt: the 235M width at {LAYERS} layers, bf16 b16 "
          f"t1024, 3 epochs of 2 steps + 1 "
          f"valid; two clean runs: {clean_differ} of {len(clean[0][1])} "
          f"parameter and moment leaves not bit-equal, history spread "
          f"{spread[0]}, state spread {spread[1]}; a real SIGTERM at "
          f"train step 2 of epoch 3 -> SystemExit(75) at {marker['where']}"
          f", 2 committed epochs, preempted.json; resumed: {verdict}; "
          f"checkpoint.th {nbytes} bytes, single-file commits "
          f"{[round(x, 3) for x in commits + resume_commits]} s, sha256 "
          f"{sha_s:.3f} s ({nbytes / sha_s / 1e9:.2f} GB/s, warm), "
          f"restore {restores[0]:.3f} s; launches {launches} "
          f"[{card}]", flush=True)
    return clean[0], spread, launches


def phase_train_slots(torch, card, root, clean, spread):
    """Phase 36: `checkpoint_mode='sharded'`. Returns (row 1 and 4
    launches, the slot commits' seconds)."""
    import logging
    from flashy_tpu_torch import info
    from flashy_tpu_torch.checkpoint import ARRAYS_NAME, read_slot_pointer
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.resilience import chaos, file_digest
    attention.reset_launch_counts()
    folder = Path(root) / "slots"
    runs = []
    solver, code, commits, _, steps, valid = resilience_run(
        torch, folder, mode="sharded", sigterm_at=5)
    runs.append((steps, valid))
    directory = solver.sharded_checkpoint_path
    if code != 75 or len(solver.history) != 2 \
            or solver.checkpoint_path.exists() \
            or not all((directory / s / "state.pkl").exists()
                       for s in ("slot0", "slot1")):
        fail(f"train slots: exit {code}, {len(solver.history)} epochs, "
             f"slots {sorted(p.name for p in directory.iterdir())}")
    active = read_slot_pointer(directory)
    nbytes = sum(p.stat().st_size for p in (directory / active).iterdir())
    begin = time.perf_counter()
    file_digest(directory / active / ARRAYS_NAME)
    sha_s = time.perf_counter() - begin
    del solver
    release_memory(torch)
    corrupted = chaos.corrupt_active_slot(directory)
    records = LogRecords()
    logger = logging.getLogger("flashy_tpu_torch.checkpoint")
    logger.addHandler(records.handler)
    try:
        resumed, code, resume_commits, restores, steps, valid = \
            resilience_run(torch, folder, mode="sharded")
    finally:
        logger.removeHandler(records.handler)
    runs.append((steps, valid))
    text = records.text()
    if code is not None or not resumed.restored \
            or len(resumed.history) != 3 or steps != 4 \
            or "RESTORED FROM FALLBACK SLOT" not in text \
            or f"the active slot {corrupted!r} was corrupt" not in text:
        fail(f"train slots: the resume exit {code}, restored "
             f"{resumed.restored}, {len(resumed.history)} epochs, {steps} "
             f"steps, log {text[-300:]!r}")
    verdict = resume_verdict(torch, "train slots",
                             (resumed.history, host_state(torch, resumed)),
                             clean, spread)
    report = info.verify_checkpoint(resumed.folder)
    if not report["restorable"] or report["single"] is not None \
            or any(report["slots"].values()):
        fail(f"train slots: verify_checkpoint {report}")
    launches = nonzero(attention.launch_counts)
    want = flash_want(LAYERS, runs)
    if launches != want:
        fail(f"train slots: launches {launches}, expected {want}")
    del resumed
    release_memory(torch)
    print(f"train slots: checkpoint_mode='sharded', preempted after 2 "
          f"commits, active slot {corrupted} corrupted; the resume fell "
          f"back to the sibling with the WARN, re-ran epochs 2-3: "
          f"{verdict}; verify_checkpoint {report['slots']} active "
          f"{report['active']} restorable; slot {nbytes} bytes, slot "
          f"commits {[round(x, 3) for x in commits + resume_commits]} s, "
          f"sha256 of arrays.pt {sha_s:.3f} s, restore with the fallback "
          f"{restores[0]:.3f} s; launches {launches} [{card}]", flush=True)
    return launches, commits + resume_commits


def phase_train_async(torch, card, root, clean, spread, slot_commits):
    """Phase 37: `checkpoint_async=True`. Returns row 1 and 4 launches."""
    import atexit
    from flashy_tpu_torch.checkpoint import _load_slot, read_slot_pointer
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.resilience import chaos
    attention.reset_launch_counts()
    runs = []
    finalizes, waits, background, epoch2 = [], [], [], {}

    def setup(solver):
        commit = solver.commit

        def commit_and_keep(*args, **kwargs):
            before = len(finalizes)
            out = commit(*args, **kwargs)
            waits.append(sum(finalizes[before:]))
            saver = solver._async_checkpointer
            background.append(saver.last_background_seconds)
            if len(solver.history) == 2:
                # the live state at the epoch-2 commit, cloned on the
                # card behind the snapshot's copies (no host wait)
                epoch2.update({k: v.clone() for k, v in solver_state(
                    torch, {"model": solver.model.state_dict(),
                            "optimizer": solver.optimizer.state_dict()})
                    .items()})
            return out

        solver.commit = commit_and_keep
        timed_method(solver, "_finalize_async_attributed", finalizes)

    solver, code, commits, _, steps, valid = resilience_run(
        torch, Path(root) / "async", mode="sharded", use_async=True,
        setup=setup)
    runs.append((steps, valid))
    begin = time.perf_counter()
    solver.finalize_checkpoints()
    final_s = time.perf_counter() - begin
    background.append(solver._async_checkpointer.last_background_seconds)
    atexit.unregister(solver.finalize_checkpoints)
    if code is not None or len(solver.history) != 3:
        fail(f"train async: exit {code}, {len(solver.history)} epochs")
    verdict = resume_verdict(torch, "train async",
                             (solver.history, host_state(torch, solver)),
                             clean, spread)
    directory = solver.sharded_checkpoint_path
    sibling = {"slot0": "slot1", "slot1": "slot0"}[
        read_slot_pointer(directory)]
    written = solver_state(torch, _load_slot(directory, sibling))
    differ, worst = state_spread(torch, written, epoch2)
    if differ:
        fail(f"train async: the epoch-2 slot differs from the state at "
             f"its commit in {differ} leaves (max {worst}): the snapshot "
             f"was not taken before the next in-place update")
    solver._async_checkpointer.close()
    del solver, written
    epoch2.clear()
    release_memory(torch)
    # the first background write fails on every retry: the next commit
    # raises and rolls back the epoch it covered
    injector = chaos.install(strict=True)
    injector.fail_at("ckpt.write", call=1, times=4)
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    xp = lm_main.get_xp(RESILIENCE_ARGS + [f"dora.dir={Path(root) / 'fault'}"])
    with xp.enter():
        faulty = LMSolver(xp.cfg, device=torch.device("cuda"))
        faulty.checkpoint_mode = "sharded"
        faulty.checkpoint_async = True
        faulty.run_stage("train", faulty.train)
        faulty.run_stage("valid", faulty.valid)
        faulty.commit()
        faulty.run_stage("train", faulty.train)
        faulty.run_stage("valid", faulty.valid)
        raised = None
        try:
            faulty.commit()
        except OSError as error:
            raised = error
        on_disk = json.loads((faulty.folder / "history.json").read_text())
        atexit.unregister(faulty.finalize_checkpoints)
    chaos.uninstall()
    runs.append((len(faulty.step_seconds), 2))
    if raised is None or faulty.history != [] or on_disk != [] \
            or not faulty._pending_metrics \
            or injector.hits("ckpt.write") != 4:
        fail(f"train async: the failed background write: raised "
             f"{raised!r}, history {len(faulty.history)} epochs, "
             f"history.json {on_disk}, ckpt.write hits "
             f"{injector.hits('ckpt.write')}")
    launches = nonzero(attention.launch_counts)
    want = flash_want(LAYERS, runs)
    if launches != want:
        fail(f"train async: launches {launches}, expected {want}")
    del faulty
    release_memory(torch)
    snapshots = [c - w for c, w in zip(commits, waits)]
    print(f"train async: checkpoint_async=True, 3 epochs: final state "
          f"against the clean run: {verdict}; the epoch-2 slot (written "
          f"while epoch 3 updated in place) bit-equal to the state at its "
          f"commit; commit() host-blocking {[round(x, 3) for x in commits]}"
          f" s, of which waiting for the previous save "
          f"{[round(x, 3) for x in waits]} s and snapshot + start "
          f"{[round(x, 3) for x in snapshots]} s, the last save's finalize "
          f"{final_s:.3f} s; background writes "
          f"{[round(x, 3) for x in background if x is not None]} s; "
          f"synchronous slot commits (train slots) "
          f"{[round(x, 3) for x in slot_commits]} s; a failed background "
          f"write (ckpt.write x4) raised {type(raised).__name__} at the "
          f"next commit and rolled epoch 1 back (history [] in memory and "
          f"in history.json); launches {launches} [{card}]", flush=True)
    return launches


HANG_ARGS = FT_ARGS + ["epochs=1"]


def hang_child(folder):
    """The hang abort phase's subprocess: train 2 steps of `train`'s model
    with telemetry, start the hang watchdog, run 1 valid step, print the
    launches and the time, then block the main thread on the card."""
    import torch
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.logging import setup_logging
    from flashy_tpu_torch.ops import attention
    setup_logging(with_file_log=False)
    xp = lm_main.get_xp(HANG_ARGS + [f"dora.dir={folder}"])
    with xp.enter():
        solver = LMSolver(xp.cfg, device=torch.device("cuda"))
        solver.enable_telemetry(heartbeat_interval=0.25,
                                with_device_stats=False)
        solver.run_stage("train", solver.train)
        solver.enable_hang_watchdog(warn_after=HANG_WARN,
                                    abort_after=HANG_ABORT,
                                    interval=HANG_INTERVAL)
        solver.run_stage("valid", solver.valid)
        torch.cuda.synchronize()
        print(json.dumps({"launches": nonzero(attention.launch_counts),
                          "blocking": time.time()}), flush=True)
        torch.cuda._sleep(HANG_CYCLES)
        torch.cuda.synchronize()
    print(json.dumps({"returned": time.time()}), flush=True)


def start_hang_abort(root):
    """Start phase 38's child (`hang_child`) in `root`. A thread waits for
    it and notes when it ended, so that the phase runs beside others;
    `phase_hang_abort` reads what it returns."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.hang_child(sys.argv[2])")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT),
                             str(root)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return None
        return proc.returncode, out, err, time.time()

    pool = ThreadPoolExecutor(1)
    future = pool.submit(wait)
    pool.shutdown(wait=False)
    return future


def phase_hang_abort(card, started):
    """Phase 38, started by `start_hang_abort`. Returns the child's row 1
    and 4 launches."""
    waited = started.result()
    if waited is None:
        fail("hang abort: the child did not end within 300 s")
    returncode, out, err, ended = waited
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    blocking = next((line for line in lines if "blocking" in line), None)
    if returncode != 70 or blocking is None \
            or any("returned" in line for line in lines):
        fail(f"hang abort: exit {returncode}, stdout {out[-400:]!r}, "
             f"stderr {err[-1200:]!r}")
    latency = ended - blocking["blocking"]
    warn = f"hang watchdog: rank(s) [0] heartbeat stalled past " \
           f"{HANG_WARN:.0f}s — 1/1 ranks"
    abort = f"hang watchdog: aborting (exit 70): rank(s) [0] stalled past " \
            f"{HANG_ABORT:.0f}s"
    if not HANG_ABORT - 0.5 <= latency <= HANG_BOUND or warn not in err \
            or abort not in err:
        fail(f"hang abort: exit 70 after {latency:.2f} s (bound "
             f"{HANG_BOUND} s), stderr {err[-1200:]!r}")
    launches = blocking["launches"]
    want = flash_want(LAYERS, [(2, 1)])
    if launches != want:
        fail(f"hang abort: the child's launches {launches}, expected {want}")
    line = next(x for x in err.splitlines() if warn in x)
    print(f"hang abort: the child trained 2 steps + 1 valid with "
          f"telemetry, blocked its main thread in torch.cuda.synchronize() "
          f"behind a ~20 s device sleep, and the watchdog thread (warn "
          f"{HANG_WARN} s, abort {HANG_ABORT} s, poll {HANG_INTERVAL} s) "
          f"exited it with 70 after {latency:.3f} s (bound {HANG_BOUND} "
          f"s); WARN on stderr: {line.split('hang watchdog:', 1)[1][:160]!r}"
          f"; launches {launches} [{card}]", flush=True)
    return launches


# ----------------------------------------------------------------------
# phases 40-42: queue A entry 1, the streaming datapipe (the drill and
# packed SSD training at full width), and item 9's chaos campaign
# ----------------------------------------------------------------------
PACKED_BATCH, PACKED_LEN = 16, 1024
PACKED_EPOCHS, PACKED_STEPS = 2, 3
PACKED_KILL_STEP = 2        # the epoch-2 step whose batch takes the SIGTERM
PACKED_DOC_LENGTHS = (16, 3072)   # log-uniform document lengths
PACKED_SHARDS = 8           # jsonl shards and .npy shards, each
PACKED_VOCAB = 32768
PACKED_ROUNDS = 4           # packed, unpacked, unpacked, packed: in turns
PACKED_LAYERS = 4           # of the layout's 12 (the script's time limit)


def make_packed_corpus(root, seed):
    """The packed-train corpus from `seed` with numpy: PACKED_SHARDS jsonl
    shards of 12 token documents and PACKED_SHARDS .npy shards of 8
    (right-padded with -1), token ids below PACKED_VOCAB, lengths
    log-uniform over PACKED_DOC_LENGTHS: documents past 1024 tokens
    split across rows, and most rows hold several documents."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = (math.log(x) for x in PACKED_DOC_LENGTHS)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)

    def length():
        return int(math.exp(rng.uniform(lo, hi)))

    corpus = {"jsonl": [], "npy": []}
    for shard in range(PACKED_SHARDS):
        path = root / f"web.{shard:02d}.jsonl"
        with open(path, "w") as f:
            for _ in range(12):
                tokens = rng.integers(0, PACKED_VOCAB, length())
                f.write(json.dumps({"tokens": tokens.tolist()}) + "\n")
        corpus["jsonl"].append(path)
        docs = np.full((8, PACKED_DOC_LENGTHS[1]), -1, dtype=np.int32)
        for row in docs:
            n = length()
            row[:n] = rng.integers(0, PACKED_VOCAB, n)
        path = root / f"code.{shard:02d}.npy"
        np.save(path, docs)
        corpus["npy"].append(path)
    return corpus


def packed_solver_class(torch):
    """The datapipe drill's DatapipeSolver (its loop, fault point,
    consumed log and commit / restore) training the pure-SSD 235M layout
    (bf16) on packed [16, 1024] batches with the drill's segment-masked
    loss (`packed_next_token_loss`), AdamW through `train_step`. The
    model, the optimizer, the step count and the outermost pipe (two
    streams -> MixtureStream (0.7, 0.3) -> SequencePacker(16, 1024) ->
    prefetch(size=2)) are stateful. Every step is timed twice: the step
    alone (`step_seconds`: the update to the loss on the host, as `ssd
    train` times it) and its whole turn of the loop (`step_wall`: from
    the end of the previous step, or the stage's start, so the data wait,
    the fault point and the upload count); in 'abandon_stage' mode each
    step ends in `check_preemption()`."""
    from flashy_tpu_torch.datapipe.__main__ import (_solver_class,
                                                    packed_next_token_loss)
    from flashy_tpu_torch.examples.lm.solver import build_optimizer, \
        train_step
    from flashy_tpu_torch.models.transformer import TransformerLM

    class PackedSolver(_solver_class()):
        def __init__(self, corpus, device, save=True):
            super().__init__(corpus, PACKED_EPOCHS, PACKED_STEPS,
                             PACKED_BATCH, PACKED_LEN, device=device)
            self.save = save
            self.optimizer, self.schedule = build_optimizer(self.model, {
                "epochs": PACKED_EPOCHS, "steps_per_epoch": PACKED_STEPS,
                "warmup_steps": 2, "lr": 3e-4, "weight_decay": 0.1})
            self.step = 0
            self.step_seconds, self.step_wall = [], []
            self.register_stateful("optimizer", "step")

        def build_model(self, seq_len):
            return TransformerLM(ssd_train_config(torch, torch.bfloat16,
                                                  PACKED_LAYERS),
                                 device=self.device, seed=0)

        def train_stage(self):
            self.turn_start = time.perf_counter()
            return super().train_stage()

        def train_step(self, batch):
            begin = time.perf_counter()
            metrics = train_step(
                self.model, self.optimizer, self.schedule, self.step,
                batch["tokens"], lambda model, tokens: packed_next_token_loss(
                    model, tokens, batch["segment_ids"],
                    batch["positions"]))
            loss = metrics["loss"]
            float(loss)       # the step ends with its loss on the host
            end = time.perf_counter()
            self.step_seconds.append(end - begin)
            self.step_wall.append(end - self.turn_start)
            self.turn_start = end
            self.step += 1
            self.check_preemption()
            return loss

        def commit(self, save_checkpoint=True):
            super().commit(save_checkpoint=save_checkpoint and self.save)

    return PackedSolver


def packed_run(torch, device, corpus, folder, kill_at=None, save=True):
    """One PackedSolver run in the XP of `folder` with telemetry on and a
    preemption guard ('abandon_stage', no signal handlers); `kill_at`
    arms a strict FaultInjector's preemption at that `datapipe.batch`
    occurrence. Returns (solver, exit code or None, commit seconds,
    restore seconds)."""
    from flashy_tpu_torch import resilience
    from flashy_tpu_torch.observability import disable_telemetry
    from flashy_tpu_torch.resilience import chaos
    from flashy_tpu_torch.xp import Config, create_xp
    PackedSolver = packed_solver_class(torch)
    commits, restores, code = [], [], None
    injector = None
    if kill_at is not None:
        injector = chaos.install(strict=True)
        injector.preempt_at("datapipe.batch", call=kill_at)
    try:
        with create_xp(Config({"packed": "train"}), root=folder).enter():
            solver = PackedSolver(corpus, device, save=save)
            timed_method(solver, "commit", commits)
            timed_method(solver, "restore", restores)
            solver.enable_telemetry()
            solver.enable_preemption_guard(mode="abandon_stage",
                                           install=False)
            try:
                solver.run()
            except SystemExit as exit_:
                code = exit_.code
        if injector is not None:
            chaos.uninstall()      # strict: the armed kill fired
    finally:
        chaos.uninstall(verify=False)
        resilience.disable_preemption_guard()
        disable_telemetry()
    torch.cuda.synchronize()
    return solver, code, commits, restores


def packed_scan_check(torch, device, batch):
    """Row 7 on the first packed batch's real inputs to the first layer's
    scan (the seed-0 model before any update): c, b, v and the log
    decays from the layer's projection, SSD_LOG_RESET at every document
    start, padding as token_mask False. The kernel held to the plain
    chunked form (`_chunked_reference`) at `ssd_against_plain`'s bars and
    timed beside its bound. Returns the record for the kernels line."""
    from flashy_tpu_torch.datapipe.__main__ import upload
    from flashy_tpu_torch.models.ssd import (ssd_projections,
                                             ssd_segment_log_decay)
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops.ssd_scan import (SSD_LOG_RESET, default_chunk,
                                               ssd_chunked_scan)
    cfg = ssd_train_config(torch, torch.bfloat16)
    model = TransformerLM(cfg, device=device, seed=0)
    captured = {}
    mixer = model.block_0.ssd

    def capture(module, args):
        captured["x"] = args[0].detach()      # the normed block input

    hook = mixer.register_forward_pre_hook(capture)
    dev = upload(batch, device)
    with torch.no_grad():
        model(dev["tokens"], positions=dev["positions"],
              segment_ids=dev["segment_ids"])
        hook.remove()
        c, b, v, log_a = ssd_projections(
            cfg, captured["x"].to(cfg.dtype), mixer.cbv.kernel.to(cfg.dtype),
            mixer.dt_bias)
        log_a, mask = ssd_segment_log_decay(log_a, dev["segment_ids"])
        chunk = default_chunk(PACKED_LEN)
        kw = {"chunk": chunk, "token_mask": mask}

        def call():
            return ssd_chunked_scan(c, b, v, log_a, kernel="fused", **kw)

        err, share, s_rel = ssd_against_plain(
            torch, call(),
            ssd_chunked_scan(c, b, v, log_a, kernel="gather", **kw), mask,
            "packed train: row 7 on the first packed batch")
        runs = time_runs(torch, call, iters=20)
    resets = int((log_a[..., 0] == SSD_LOG_RESET).sum())
    padded = int((~mask).sum())
    B, T, H, N = c.shape
    bound, bound_by, _ = ssd_bound(B, H, T, N, v.shape[-1], chunk,
                                   c.element_size())
    del model
    return {"shape": [B, T], "resets": resets, "padded": padded,
            "max_abs_err": err, "err_share": share, "state_rel_err": s_rel,
            **runs, "bound_ms": bound, "bound_by": bound_by}


def packed_turns(torch, solver, batches, rounds=PACKED_ROUNDS):
    """The packed step against `ssd train`'s unpacked one, in turns on
    one model and optimizer (`solver`'s, after its run): each step timed
    as both phases time theirs, from `train_step` to the loss on the
    host, packed on `batches` (segment-masked loss), unpacked on
    `synthetic_token_stream` [16, 1024] batches (`lm_next_token_loss`).
    One untimed step of each, then `rounds` of packed, unpacked,
    unpacked, packed. Returns {"packed": [s, ...], "unpacked": [...]}.
    The schedule is past its end, so the learning rate is 0: the same
    work, the model unchanged."""
    from flashy_tpu_torch.datapipe.__main__ import (packed_next_token_loss,
                                                    upload)
    from flashy_tpu_torch.examples.lm.solver import (synthetic_token_stream,
                                                     train_step)
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    stream = synthetic_token_stream(32768)
    times = {"packed": [], "unpacked": []}

    def step(kind, i):
        if kind == "packed":
            batch = upload(batches[i % len(batches)], solver.device)
            tokens = batch["tokens"]

            def loss_fn(model, tokens):
                return packed_next_token_loss(model, tokens,
                                              batch["segment_ids"],
                                              batch["positions"])
        else:
            tokens = torch.from_numpy(stream(PACKED_BATCH, PACKED_LEN, i)) \
                .long().to(solver.device)
            loss_fn = lm_next_token_loss
        begin = time.perf_counter()
        metrics = train_step(solver.model, solver.optimizer,
                             solver.schedule, solver.step, tokens, loss_fn)
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - begin
        solver.step += 1
        if not math.isfinite(loss):
            fail(f"packed train: a {kind} step in turns gave loss {loss}")
        return seconds

    step("packed", 0)
    step("unpacked", 0)
    order = ["packed", "unpacked", "unpacked", "packed"] * rounds
    for i, kind in enumerate(order, 1):
        times[kind].append(step(kind, i))
    return times


def phase_packed_train(torch, device, card, root, seed, ssd_p50):
    """Phase 41. Returns row 7's record on this path (launches, the
    backward's recomputes, the packed check)."""
    import numpy as np
    from flashy_tpu_torch.datapipe.__main__ import same_batch
    from flashy_tpu_torch.ops import ssd_scan
    from flashy_tpu_torch.utils import percentile
    root = Path(root)
    corpus = make_packed_corpus(root / "corpus", seed)
    release_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.reset_launch_counts()
    clean, steps_run = [], 0
    for name in ("clean_a", "clean_b"):
        solver, code, _, _ = packed_run(torch, device, corpus, root / name,
                                        save=False)
        if code is not None or len(solver.history) != PACKED_EPOCHS:
            fail(f"packed train: clean run exit {code}, "
                 f"{len(solver.history)} epochs")
        steps_run += len(solver.step_seconds)
        clean.append(solver)
        if name == "clean_a":
            state_a = host_state(torch, solver)
            solver.model = solver.optimizer = None
            release_memory(torch)
    b = clean[1]
    state_b = host_state(torch, b)
    differ, state_worst = state_spread(torch, state_b, state_a)
    losses = [[e["train"]["loss"] for e in s.history] for s in clean]
    loss_spread = max(abs(x - y) for x, y in zip(*losses))
    same_stream = all(same_batch(x, y)
                      for x, y in zip(*(s.consumed for s in clean)))
    if not same_stream:
        fail("packed train: the two clean runs consumed different batches")
    timed, wall = b.step_seconds[2:], b.step_wall[2:]
    tokens = PACKED_BATCH * PACKED_LEN
    real = [int((x["segment_ids"] > 0).sum()) for x in b.consumed]
    efficiency = sum(real) / (tokens * len(b.consumed))
    tok_s = tokens * len(wall) / sum(wall)
    real_tok_s = sum(real[2:]) / sum(wall)
    p50 = percentile(timed, 50) * 1e3
    wall_p50 = percentile(wall, 50) * 1e3
    wait = [e["train"].get("data_wait_frac") for e in b.history]
    prefetch_stats = b.pipe.stats()
    rows_docs = [int(np.unique(row[row > 0]).size)
                 for x in b.consumed for row in x["segment_ids"]]
    if not all(math.isfinite(x) for x in losses[0]) or None in wait:
        fail(f"packed train: losses {losses[0]}, data_wait_frac {wait}")
    first_batch = clean[0].consumed[0]
    base_consumed = clean[0].consumed
    clean_history = [{"train": {"loss": x}} for x in losses[0]]
    del clean, solver, b
    release_memory(torch)
    folder = root / "preempt"
    kill_at = PACKED_STEPS + PACKED_KILL_STEP
    killed, code, commits, _ = packed_run(torch, device, corpus, folder,
                                          kill_at=kill_at)
    steps_run += len(killed.step_seconds)
    if code != 75 or len(killed.history) != 1 \
            or len(killed.consumed) != kill_at \
            or killed.pipe._thread is not None:
        fail(f"packed train: the killed run exit {code}, "
             f"{len(killed.history)} epochs, {len(killed.consumed)} "
             f"batches, prefetch thread {killed.pipe._thread}")
    killed_consumed = killed.consumed
    del killed
    release_memory(torch)
    resumed, code, resume_commits, restores = packed_run(torch, device,
                                                         corpus, folder)
    steps_run += len(resumed.step_seconds)
    if code is not None or len(resumed.history) != PACKED_EPOCHS \
            or len(resumed.consumed) != PACKED_STEPS:
        fail(f"packed train: the resume exit {code}, "
             f"{len(resumed.history)} epochs, {len(resumed.consumed)} "
             f"batches")
    replayed = killed_consumed[:PACKED_STEPS] + resumed.consumed
    streams_equal = len(replayed) == len(base_consumed) and all(
        same_batch(x, y) for x, y in zip(replayed, base_consumed)) and all(
        same_batch(x, y) for x, y in zip(killed_consumed, base_consumed))
    if not streams_equal:
        fail("packed train: kill + resume consumed a different token "
             "stream than the clean run")
    got_losses = [e["train"]["loss"] for e in resumed.history]
    history_off = history_spread(
        [{"train": {"loss": x}} for x in got_losses], clean_history)
    resumed_state = host_state(torch, resumed)
    r_differ, r_worst = state_spread(torch, resumed_state, state_a)
    if history_off > loss_spread or r_worst > state_worst:
        fail(f"packed train: the resumed run differs from the clean run: "
             f"losses by {history_off}, {r_differ} state leaves by up to "
             f"{r_worst} (the clean runs' spread: {loss_spread}, "
             f"{state_worst})")
    counts = {**nonzero(ssd_scan.launch_counts),
              **nonzero(ssd_scan.backward_counts)}
    layers = resumed.model.config.num_layers
    params = sum(p.numel() for p in resumed.model.parameters())
    want = {"ssd_scan": layers * steps_run,
            "ssd_scan_backward": layers * steps_run}
    if counts != want:
        fail(f"packed train: launches {counts}, expected {want} "
             f"({layers} layers x {steps_run} steps)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    turns = packed_turns(torch, resumed, resumed.consumed)
    turn_p50 = {kind: percentile(x, 50) * 1e3 for kind, x in turns.items()}
    del resumed
    release_memory(torch)
    check = packed_scan_check(torch, device, first_batch)
    print(f"packed train: pure-SSD {params / 1e6:.0f}M ({layers} layers) "
          f"bf16 [{PACKED_BATCH}, "
          f"{PACKED_LEN}] packed from {2 * PACKED_SHARDS} shards (seed "
          f"{seed}; docs {PACKED_DOC_LENGTHS[0]}-{PACKED_DOC_LENGTHS[1]} "
          f"tokens, mixture {(0.7, 0.3)}), {PACKED_EPOCHS} epochs x "
          f"{PACKED_STEPS} steps; packing efficiency {efficiency:.4f}, "
          f"documents a row median {percentile(rows_docs, 50):.0f} (max "
          f"{max(rows_docs)}); step p50 {p50:.2f} ms (the step alone; "
          f"`ssd train` p50 {ssd_p50:.2f} ms at 12 layers earlier in this "
          f"call); in "
          f"turns on one model (packed, unpacked, unpacked, packed x "
          f"{PACKED_ROUNDS}): "
          f"packed p50 {turn_p50['packed']:.2f} ms, unpacked p50 "
          f"{turn_p50['unpacked']:.2f} ms, ratio "
          f"{turn_p50['packed'] / turn_p50['unpacked']:.4f} (packed "
          f"{[round(x * 1e3, 2) for x in turns['packed']]}, unpacked "
          f"{[round(x * 1e3, 2) for x in turns['unpacked']]} ms); over the "
          f"loop's wall clock (data wait, fault point, upload and step; "
          f"p50 {wall_p50:.2f} ms) tokens/s {tok_s:.1f} (packed "
          f"positions) / {real_tok_s:.1f} (non-padding), peak memory "
          f"{peak:.1f} GiB, data_wait_frac {wait}, prefetch "
          f"{prefetch_stats['tokens_per_s']:.1f} tokens/s yielded "
          f"(queue depth {prefetch_stats['queue_depth']:.0f}); two clean "
          f"runs: {differ} of {len(state_a)} leaves not bit-equal, losses "
          f"spread {loss_spread}, state spread {state_worst}; preempted "
          f"at epoch-2 step {PACKED_KILL_STEP} -> SystemExit(75), 1 "
          f"committed epoch, prefetch thread closed; resumed: the token "
          f"stream identical, losses off by {history_off}, {r_differ} "
          f"leaves not bit-equal (max {r_worst}); commit "
          f"{[round(x, 3) for x in commits + resume_commits]} s, restore "
          f"{[round(x, 3) for x in restores]} s; row 7 on the first "
          f"packed batch's layer-0 inputs ({check['resets']} resets, "
          f"{check['padded']} padded of {PACKED_BATCH * PACKED_LEN}): max "
          f"abs err {check['max_abs_err']:.3e} (one bf16 ulp bar), "
          f"{spread_text(check)}, bound {check['bound_ms']:.4f} ms "
          f"({check['bound_by']}); launches {counts} [{card}]", flush=True)
    return {"launches": counts["ssd_scan"],
            "backward_recomputes": counts["ssd_scan_backward"],
            "check": check}


def run_modules(commands):
    """Start every `python -m` command of `commands` ({label: (args,
    timeout)}) at once, each in a process of its own from the checkout's
    root, its output in a file; wait for all, killing every one still
    running at the first deadline. Returns {label: (exit code, seconds,
    stderr)}."""
    started, ended = {}, {}
    for label, (args, timeout) in commands.items():
        err = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                                stdout=subprocess.DEVNULL, stderr=err,
                                text=True)
        started[label] = (proc, err, time.perf_counter(), timeout)
    late = None
    while len(ended) < len(started) and late is None:
        time.sleep(0.2)
        now = time.perf_counter()
        for label, (proc, _, begin, timeout) in started.items():
            if label not in ended and proc.poll() is not None:
                ended[label] = now - begin
            elif label not in ended and now - begin > timeout:
                late = label
    results = {}
    for label, (proc, err, begin, _) in started.items():
        if label not in ended:
            proc.kill()
            proc.wait()
        err.seek(0)
        results[label] = (proc.returncode,
                          ended.get(label, time.perf_counter() - begin),
                          err.read())
        err.close()
    if late is not None:
        fail(f"{late}: no exit within its deadline; every module process "
             f"stopped")
    return results


def check_module(label, result, marker, code=0):
    """Exit `code`, `marker` and "on cuda" in the log, or the phase
    fails. Returns (seconds, stderr)."""
    returncode, seconds, log = result
    if returncode != code or marker not in log or "on cuda" not in log:
        fail(f"{label}: exit {returncode}: {log[-1500:]}")
    return seconds, log


CAMPAIGN_SCENARIOS = "datapipe,serve,fleet"


def phase_modules(card):
    """Phases 39, 40 and 42 in processes of their own, started together
    (none of them is timed beyond its seconds): the chaos drill, the
    datapipe drill, the chaos campaign's datapipe, serve and fleet
    scenarios, and the fleet scenario under the seeded `wal_skip_dedup`
    defect, which its dedup oracle must catch (exit 1 and a reproducer
    naming it)."""
    import re
    with tempfile.TemporaryDirectory() as tmp:
        artifact = Path(tmp) / "repro.json"
        results = run_modules({
            "drill": (["flashy_tpu_torch.resilience"], 300),
            "datapipe drill": (["flashy_tpu_torch.datapipe"], 300),
            "campaign": (["flashy_tpu_torch.resilience", "--campaign",
                          "--scenarios", CAMPAIGN_SCENARIOS, "--seed", "0"],
                         600),
            "defect": (["flashy_tpu_torch.resilience", "--campaign",
                        "--scenarios", "fleet", "--seed", "0",
                        "--seeded-defect", "wal_skip_dedup", "--artifact",
                        str(artifact)], 300)})
        payload = json.loads(artifact.read_text()) \
            if artifact.exists() else {}
    # the drill touches no device
    returncode, seconds, log = results["drill"]
    if returncode != 0 or "chaos drill passed" not in log:
        fail(f"drill: exit {returncode}: {log[-800:]}")
    print(f"drill: python -m flashy_tpu_torch.resilience exit 0, "
          f"{log.count('PASS:')} checks passed in {seconds:.1f} s [{card}]",
          flush=True)
    seconds, log = check_module("datapipe drill", results["datapipe drill"],
                                "datapipe drill passed")
    print(f"datapipe drill: python -m flashy_tpu_torch.datapipe exit 0 on "
          f"cuda (3 epochs x 6 steps of [4, 64], killed in epoch 2), "
          f"{log.count('PASS:')} checks passed in {seconds:.1f} s [{card}]",
          flush=True)
    seconds, log = check_module("campaign", results["campaign"],
                                "campaign passed")
    found = re.search(r"campaign passed: (\d+) fault schedules", log)
    schedules = [line.split("— ", 1)[-1] for line in log.splitlines()
                 if "campaign: run " in line]
    defect_seconds, defect_log = check_module(
        "campaign (wal_skip_dedup)", results["defect"], "dedup broken",
        code=1)
    caught = " ".join(payload.get("failure", []))
    if payload.get("defect") != "wal_skip_dedup" \
            or "dedup broken" not in caught:
        fail(f"campaign: the seeded wal_skip_dedup defect's reproducer "
             f"{payload}: {defect_log[-1500:]}")
    print(f"campaign: python -m flashy_tpu_torch.resilience --campaign "
          f"--scenarios {CAMPAIGN_SCENARIOS} --seed 0 exit 0 on cuda, "
          f"{found.group(1) if found else '?'} fault schedules ({schedules})"
          f" and a calibration run a scenario in {seconds:.1f} s; the "
          f"seeded wal_skip_dedup defect caught by the fleet scenario "
          f"(exit 1, reproducer faults {payload['faults']}: {caught[:160]}) "
          f"in {defect_seconds:.1f} s; the drill, the datapipe drill and "
          f"both campaigns started together [{card}]", flush=True)


# ----------------------------------------------------------------------
# queue A item 5: data parallelism across processes, two ranks on the card
# ----------------------------------------------------------------------
DP_RANKS = 2
GLOO_LABEL = ("gloo through the host, two ranks sharing one card; not an "
              "NCCL figure")
# `dp train` at full width and 2 of the 12 layers (4 before the fleet's
# phases joined): its three runs write three checkpoints and start six
# ranks, and the four dp phases keep to ~2 minutes. One warmup step: the schedule is sized by epochs x steps,
# and with one warmup step a 1-epoch run's schedule is the 2-epoch run's
# first epoch, so the stopped-and-resumed run repeats the whole run.
DP_LAYERS = 2
DP_TRAIN_ARGS = [arg for arg in TRAIN_ARGS
                 if not arg.startswith(("model.num_layers=",
                                        "steps_per_epoch=", "valid_steps="))
                 ] + [f"model.num_layers={DP_LAYERS}", "steps_per_epoch=2",
                      "valid_steps=1", "warmup_steps=1"]
DP_STEP_SHAPE = (4, 256)       # dp step: global batch 4 x t256, 2 a rank
DP_STEP_OPTIM = {"epochs": 1, "steps_per_epoch": 2, "warmup_steps": 1,
                 "lr": 3e-4, "weight_decay": 0.1}
DP_RESULT = "FLASHY_SMOKE_DP_RESULT"   # env: where a rank writes its result


def dp_env(folder, tag, rank=None):
    """The environment of a dp process: a `file://` rendezvous in
    `folder` named by `tag` (no port) and, for a rank spawned here, its
    launcher variables (two local ranks on one card: `distrib` picks
    gloo)."""
    import os
    env = dict(os.environ)
    env["FLASHY_TPU_COORDINATOR"] = f"file://{folder}/rendezvous-{tag}"
    env[DP_RESULT] = dp_result_prefix(folder, tag)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    if rank is not None:
        env.update({"FLASHY_TPU_NUM_PROCESSES": str(DP_RANKS),
                    "FLASHY_TPU_PROCESS_ID": str(rank),
                    "LOCAL_RANK": str(rank),
                    "LOCAL_WORLD_SIZE": str(DP_RANKS)})
    return env


def dp_result_prefix(folder, tag):
    """Where the ranks of a dp run tagged `tag` write their results: one
    file a rank, not stdout, which the workers of `--workers` share (under
    unbuffered stdio a line and its newline are two writes, and another
    rank's output lands between them)."""
    return f"{folder}/result-{tag}"


def write_dp_result(result):
    """Write a rank's result where `dp_env` said (`DP_RESULT`)."""
    import os
    path = Path(f"{os.environ[DP_RESULT]}-{result['rank']}.json")
    path.with_suffix(".tmp").write_text(json.dumps(result))
    path.with_suffix(".tmp").replace(path)


def start_sessions(commands, folder, timeout, label):
    """Start (argv, env) commands, each in a session of its own, with one
    deadline `timeout` seconds from now; `finish_sessions` waits."""
    import subprocess as sp
    procs = []
    for index, (argv, env) in enumerate(commands):
        out = open(Path(folder) / f"{label}-{index}.out", "w+")
        err = open(Path(folder) / f"{label}-{index}.err", "w+")
        procs.append((sp.Popen(argv, env=env, cwd=folder, stdout=out,
                               stderr=err, start_new_session=True), out, err))
    return {"procs": procs, "deadline": time.perf_counter() + timeout,
            "timeout": timeout, "label": label}


def finish_sessions(started, codes=(0,)):
    """Wait for `start_sessions`' commands; past the deadline every
    process group is killed and the phase fails (a hang fails the phase,
    not the run). Returns each command's (stdout, stderr); an exit code
    outside `codes` fails the phase."""
    import os
    import signal
    procs, label = started["procs"], started["label"]
    timed_out = False
    for proc, _, _ in procs:
        try:
            proc.wait(timeout=max(started["deadline"] - time.perf_counter(),
                                  0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    for proc, _, _ in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    logs = []
    for proc, out, err in procs:
        out.seek(0)
        err.seek(0)
        logs.append((out.read(), err.read()))
        out.close()
        err.close()
    if timed_out:
        fail(f"{label}: killed after {started['timeout']} s: "
             f"{[e[-800:] for _, e in logs]}")
    for (proc, _, _), (_, err) in zip(procs, logs):
        if proc.returncode not in codes:
            fail(f"{label}: exit {proc.returncode}: {err[-2000:]}")
    return logs


def clear_dp_results(folder, tag):
    """Remove the results an earlier run tagged `tag` left in `folder`."""
    for path in Path(folder).glob(f"result-{tag}-*.json"):
        path.unlink()


def dp_results(folder, tag):
    """The results the ranks of the dp run tagged `tag` wrote, by rank."""
    prefix = dp_result_prefix(folder, tag)
    return [json.loads(Path(f"{prefix}-{rank}.json").read_text())
            for rank in range(DP_RANKS)
            if Path(f"{prefix}-{rank}.json").exists()]


def start_dp_ranks(mode, folder, timeout):
    """Start `python3 chip_smoke.py --dp-rank <mode>` as two ranks;
    `finish_dp_ranks` waits for them."""
    clear_dp_results(folder, mode)
    started = start_sessions(
        [([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", mode],
          dp_env(folder, mode, rank)) for rank in range(DP_RANKS)],
        folder, timeout, f"dp {mode}")
    started.update(begin=time.perf_counter(), folder=folder, mode=mode)
    return started


def finish_dp_ranks(started):
    """The results of `start_dp_ranks`' two ranks, and the wall seconds."""
    logs = finish_sessions(started)
    mode = started["mode"]
    results = dp_results(started["folder"], mode)
    if len(results) != DP_RANKS:
        fail(f"dp {mode}: {len(results)} of {DP_RANKS} ranks reported: "
             f"{[err[-800:] for _, err in logs]}")
    return results, time.perf_counter() - started["begin"]


def spawn_dp_ranks(mode, folder, timeout):
    """`python3 chip_smoke.py --dp-rank <mode>` as two ranks; returns
    their results and the wall seconds."""
    return finish_dp_ranks(start_dp_ranks(mode, folder, timeout))


def state_digest(torch, tensors):
    """sha256 of the tensors' bytes in order: equal digests are
    bit-identical states."""
    import hashlib
    digest = hashlib.sha256()
    for tensor in tensors:
        digest.update(tensor.detach().reshape(-1).contiguous()
                      .view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def write_full_grads(torch, solver):
    """`--dp-grads`: the gradient of the loss of step 0's global batch at
    the solver's trained state (no update), each sliced parameter's
    gathered to its full shape; rank 0 writes it (f32, on the host)
    beside its result. Returns the file's path."""
    import os
    from flashy_tpu_torch import distrib
    solver.optimizer.zero_grad(set_to_none=True)
    if solver.pipe_stages > 1:
        # the pipelined schedule's gradients (the rank's chunks)
        solver.pipe_grads(solver.train_model, solver.batch_at(0))
    else:
        solver.loss(solver.batch_at(0), model=solver.train_model).backward()
    grads = {}
    for name, param in solver.model.named_parameters():
        sharding = getattr(param, "sharding", None)
        grad = param.grad if sharding is None or sharding.is_replicated \
            else sharding.gather(param.grad)
        grads[name] = grad.float().cpu()
    solver.optimizer.zero_grad(set_to_none=True)
    path = f"{os.environ[DP_RESULT]}-grads.pt"
    if distrib.rank() == 0:
        torch.save(grads, path)
    return path


def solver_tensors(torch, model, optimizer):
    """A model's parameters and buffers, then its optimizer's state
    tensors, in a fixed order."""
    tensors = [value for _, value in sorted(model.state_dict().items())]
    for state in optimizer.state_dict()["state"].values():
        tensors += [state[key] for key in sorted(state)
                    if isinstance(state[key], torch.Tensor)]
    return tensors


def dp_collectives_rank(torch, device):
    """Phase 43, one rank: the collectives on CUDA and host values."""
    import numpy as np
    from flashy_tpu_torch import distrib
    rank, world = distrib.rank(), distrib.world_size()
    out = {"backend": torch.distributed.get_backend()}
    x = torch.arange(4, dtype=torch.float32, device=device) + 10 * rank
    out["all_reduce"] = {op: distrib.all_reduce(x, op).tolist()
                         for op in ("sum", "mean", "max", "min")}
    out["all_reduce_device"] = str(distrib.all_reduce(x).device)
    out["all_reduce_host"] = {op: distrib.all_reduce(
        np.array([1.5, rank], np.float64), op).tolist()
        for op in ("sum", "mean", "max", "min")}
    out["metrics"] = distrib.average_metrics(
        {"loss": 1.0 + rank, "acc": 0.5}, count=1 + 3 * rank)
    # a tree above REDUCE_MIN_BYTES, held to the mean one process takes
    trees = []
    for r in range(world):
        gen = torch.Generator(device=device).manual_seed(r)
        trees.append({"w": torch.randn(512, 1024, generator=gen,
                                       device=device),
                      "h": torch.randn(64, generator=gen, device=device
                                       ).to(torch.bfloat16),
                      "b": np.random.default_rng(10 + r).normal(size=5),
                      "step": torch.tensor(rank, device=device)})
    want = {key: sum(t[key] for t in trees) / world for key in ("w", "b")}
    want["h"] = (sum(t["h"] for t in trees) / world)
    timings = {}
    for method in ("reduce", "allgather"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = distrib.average_tensors(trees[rank], method=method)
        torch.cuda.synchronize()
        timings[method] = (time.perf_counter() - t0) * 1e3
        out[f"average_{method}"] = {
            "w": bool(torch.equal(got["w"], want["w"])),
            "w_max_err": float((got["w"] - want["w"]).abs().max()),
            "h": bool(torch.equal(got["h"], want["h"])),
            "b": bool(np.array_equal(got["b"], want["b"])),
            "step": int(got["step"]) == rank,
            "device": str(got["w"].device)}
    out["average_ms"] = timings
    model = torch.nn.Linear(3, 2).to(device)
    torch.nn.init.constant_(model.weight, float(rank + 1))
    distrib.broadcast_model(model)
    out["broadcast_model"] = model.weight.flatten().tolist()
    tree = distrib.broadcast_tensors(
        {"v": torch.full((3,), float(rank), device=device)}, src=1)
    out["broadcast_tensors"] = tree["v"].tolist()
    out["broadcast_object"] = distrib.broadcast_object(
        {"from": rank} if rank == 1 else None, src=1)
    t0 = time.perf_counter()
    distrib.barrier()
    out["barrier_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    try:
        distrib.average_tensors({"w": torch.ones(2 + rank, device=device)})
        out["mismatch"] = "no error"
    except RuntimeError as exc:
        out["mismatch"] = str(exc)
    out["mismatch_ms"] = (time.perf_counter() - t0) * 1e3
    distrib.barrier()
    return out


def dp_step_batches(torch, device):
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    stream = synthetic_token_stream(32768)
    batch, seq = DP_STEP_SHAPE
    return [torch.from_numpy(stream(batch, seq, step)).long().to(device)
            for step in range(2)]


def dp_step_run(torch, device, model, batches, rows, accumulate=1,
                digest=True):
    """Two clipped AdamW steps of `model` (a DDP module or the plain one)
    on `rows` of each global batch in `accumulate` microbatches; returns
    the grads after the first backward (as the step clipped them), the
    parameters after each step, their digests (with `digest`) and the
    losses."""
    from flashy_tpu_torch.examples.lm.solver import (build_optimizer,
                                                     train_step)
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    module = getattr(model, "module", model)
    optimizer, schedule = build_optimizer(module, DP_STEP_OPTIM)
    grads, params, digests, losses = None, [], [], []
    for step, batch in enumerate(batches):
        metrics = train_step(model, optimizer, schedule, step, batch[rows],
                             lambda m, t: lm_next_token_loss(m, t),
                             accumulate=accumulate)
        losses.append(float(metrics["loss"]))
        if grads is None:
            grads = {name: p.grad.detach().clone()
                     for name, p in module.named_parameters()}
        params.append({name: p.detach().clone()
                       for name, p in module.named_parameters()})
        if digest:
            digests.append(state_digest(torch, list(params[-1].values())))
    return grads, params, digests, losses


def dp_step_rank(torch, device):
    """Phase 44, one rank: the 235M layout in f32 under DDP, each rank on
    its rows of the global batch; rank 0 then holds its grads and
    parameters to one process: bit for bit where that process runs the
    ranks' rows as two microbatches (the same sums in another place),
    and at the bar on the whole batch in one piece."""
    from flashy_tpu_torch import distrib
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.parallel import wrap
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the embedding's scatter-add in a fixed order, so that a run repeats
    # bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    rank, world = distrib.rank(), distrib.world_size()
    batches = dp_step_batches(torch, device)
    per = DP_STEP_SHAPE[0] // world
    config = model_config(torch, torch.float32, 256, "flash",
                          num_layers=DP_LAYERS)
    begin = time.perf_counter()
    model = wrap(TransformerLM(config, device=device, seed=3))
    attention.reset_launch_counts()
    grads, params, digests, losses = dp_step_run(
        torch, device, model, batches, slice(rank * per, (rank + 1) * per))
    torch.cuda.synchronize()
    out = {"ddp_s": time.perf_counter() - begin,
           "launches": nonzero(attention.launch_counts), "digests": digests,
           "losses": losses, "ddp": type(model).__name__,
           "calls": model.compile_stats()}
    del model
    if rank == 0:
        def worst(got, want):
            return max(float((got[k] - want[k]).abs().max()
                             / want[k].abs().max().clamp_min(1e-30))
                       for k in want)

        t0 = time.perf_counter()
        micro = dp_step_run(torch, device, TransformerLM(
            config, device=device, seed=3), batches, slice(None),
            accumulate=world, digest=False)
        out["microbatched"] = {
            "grads_equal": all(torch.equal(grads[k], v)
                               for k, v in micro[0].items()),
            "params_equal": [all(torch.equal(p[k], v) for k, v in q.items())
                             for p, q in zip(params, micro[1])]}
        t1 = time.perf_counter()
        whole = dp_step_run(torch, device, TransformerLM(
            config, device=device, seed=3), batches, slice(None),
            digest=False)
        out["one_process"] = {
            "grads": worst(grads, whole[0]),
            "params": [worst(p, q) for p, q in zip(params, whole[1])],
            "losses": whole[3]}
        out["seconds"] = {"microbatched": t1 - t0,
                          "whole": time.perf_counter() - t1}
    return out


def dp_rank_main(torch, mode):
    """A rank of `--dp-rank <mode>`: join the group, run the mode, write
    the result (`write_dp_result`)."""
    from flashy_tpu_torch import distrib
    distrib.init()
    device = torch.device("cuda")
    result = {"collectives": dp_collectives_rank,
              "step": dp_step_rank, "ep_step": ep_step_rank}[mode](
        torch, device)
    result["rank"] = distrib.rank()
    write_dp_result(result)


def dp_train_main(torch, argv):
    """`--dp-train`: as the launcher, `main(argv)` with `--workers=2`
    spawns two workers running this script; as a worker, train through
    `main(argv)` and write the rank's launches, steps, state digest and
    clock marks (`write_dp_result`)."""
    import os
    from flashy_tpu_torch import distrib
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.ops import attention, grouped_matmul
    if "FLASHY_TPU_PROCESS_ID" not in os.environ and "--dp-solo" not in argv:
        lm_main(argv)
        return
    if "--dp-sharded" in argv:
        from flashy_tpu_torch.examples.lm.solver import LMSolver
        LMSolver.checkpoint_mode = "sharded"
    heads = set()
    if "--dp-heads" in argv:
        # the head count of every flash call: a tensor rank's own heads
        from flashy_tpu_torch.models import transformer
        flash = transformer.flash_attention

        def counting_flash(q, *args, **kwargs):
            heads.add(int(q.shape[2]))
            return flash(q, *args, **kwargs)

        transformer.flash_attention = counting_flash
    attention.reset_launch_counts()
    grouped_matmul.reset_launch_counts()
    begin, main_at = time.perf_counter(), time.time()
    solver = lm_main(argv)
    torch.cuda.synchronize()
    result = {"rank": distrib.rank(), "main_s": time.perf_counter() - begin,
              "clock": {"started": STARTED, "main": main_at,
                        "main_end": time.time()},
              "backend": torch.distributed.get_backend()
              if torch.distributed.is_initialized() else None,
              "launches": nonzero(attention.launch_counts),
              "gmm_launches": nonzero(grouped_matmul.launch_counts),
              "restored": solver.restored, "epochs": len(solver.history),
              "step_seconds": solver.step_seconds,
              "step_losses": solver.step_losses,
              "ddp": type(solver.train_model).__name__,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    sharded = getattr(solver.model, "_sharded", None)
    result["sharded"] = None if sharded is None else sharded.mode
    if "--dp-digest" in argv:
        # a rank's own state: its shards under FSDP
        result["digest"] = state_digest(torch, solver_tensors(
            torch, solver.model, solver.optimizer))
        # the parameters the rank holds whole
        result["whole_digest"] = state_digest(torch, [
            value for _, value in sorted(solver.model.named_parameters())
            if getattr(value, "sharding", None) is None])
        if sharded is not None:
            with solver.model.summon_full_params():
                result["full_digest"] = state_digest(torch, [
                    value for _, value in sorted(
                        solver.model.state_dict().items())])
    if "--dp-grads" in argv:
        result["grads"] = write_full_grads(torch, solver)
    if "--dp-params" in argv:
        # the trained state's full parameters (rank 0 writes them), where
        # an oracle takes its gradient
        with solver.model.summon_full_params():
            params = {name: value.detach().cpu() for name, value
                      in solver.model.state_dict().items()}
        result["params"] = f"{os.environ[DP_RESULT]}-params.pt"
        if distrib.rank() == 0:
            torch.save(params, result["params"])
    if "--dp-time-all-reduce" in argv:
        # the gradient all-reduce's volume (every parameter's f32 grad)
        # alone, timed on every rank together
        numel = sum(p.numel() for p in solver.model.parameters())
        flat = torch.ones(numel, device="cuda")
        times = []
        for _ in range(2):
            distrib.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.distributed.all_reduce(flat)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        result["all_reduce_ms"] = times
        result["all_reduce_bytes"] = numel * 4
    if "--dp-heads" in argv:
        result["heads"] = sorted(heads)
    if "--dp-blocks" in argv:
        # the layers this rank holds: a block leaf's leading dim
        result["block_rows"] = int(
            solver.model.blocks.block.norm1.scale.shape[0])
    if "--dp-time-hop" in argv:
        # one activation hop of a microbatch ([4, 1024, 1024] bf16) alone,
        # rank 0 to rank 1 and back, timed on both ranks together
        mesh = solver.mesh
        peer = mesh.pipe_peers()[0]
        hop = torch.ones((4, 1024, 1024), dtype=torch.bfloat16,
                         device="cuda")
        times = []
        for _ in range(3):
            distrib.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if distrib.rank() == 0:
                distrib.send(hop, peer, mesh.group("pipe"), 7)
                distrib.recv(hop, peer, mesh.group("pipe"), 8)
            else:
                got = distrib.recv(hop, peer, mesh.group("pipe"), 7)
                distrib.send(got, peer, mesh.group("pipe"), 8)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / 2)
        result["hop_ms"] = times
        result["hop_bytes"] = hop.numel() * hop.element_size()
    if "--dp-time-exchange" in argv:
        # one all-to-all of a receiving slab's size ([32768, 1024] bf16:
        # 2 sources x 16384 slots) over the expert ranks alone, timed on
        # both together
        slab = torch.ones((32768, 1024), dtype=torch.bfloat16,
                          device="cuda")
        group = solver.mesh.group("expert")
        times = []
        for _ in range(3):
            distrib.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distrib.all_to_all(slab, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        result["exchange_ms"] = times
        result["exchange_bytes"] = slab.numel() * slab.element_size()
    if "--dp-collectives" in argv:
        # one more step, counted (after the digests and launch counts)
        from flashy_tpu_torch.examples.lm import solver as lm
        from flashy_tpu_torch.parallel import (collective_stats,
                                               count_collectives)
        with count_collectives() as record:
            lm.train_step(solver.train_model, solver.optimizer,
                          solver.schedule, solver.state["step"],
                          solver.batch_at(0),
                          lambda m, t: solver.loss(t, model=m),
                          mesh=solver.mesh,
                          grad_fn=solver.pipe_grads
                          if solver.pipe_stages > 1 else None)
            torch.cuda.synchronize()
        result["collectives"] = {op: entry for op, entry in
                                 collective_stats(record).items()
                                 if entry["count"]}
    result["clock"]["written"] = time.time()
    write_dp_result(result)


def phase_dp_collectives(torch, card, folder):
    """Phase 43: the collectives of two ranks on cuda:0 over gloo."""
    results, seconds = spawn_dp_ranks("collectives", folder, timeout=120)
    want_all = {"sum": [10.0, 12.0, 14.0, 16.0], "mean": [5.0, 6.0, 7.0, 8.0],
                "max": [10.0, 11.0, 12.0, 13.0], "min": [0.0, 1.0, 2.0, 3.0]}
    want_host = {"sum": [3.0, 1.0], "mean": [1.5, 0.5], "max": [1.5, 1.0],
                 "min": [1.5, 0.0]}
    for out in results:
        problems = []
        if out["backend"] != "gloo":
            problems.append(f"backend {out['backend']}")
        if out["all_reduce"] != want_all \
                or out["all_reduce_device"] != "cuda:0":
            problems.append(f"all_reduce {out['all_reduce']} on "
                            f"{out['all_reduce_device']}")
        if out["all_reduce_host"] != want_host:
            problems.append(f"host all_reduce {out['all_reduce_host']}")
        if abs(out["metrics"]["loss"] - 1.8) > 1e-12 \
                or out["metrics"]["acc"] != 0.5:
            problems.append(f"average_metrics {out['metrics']}")
        for method in ("reduce", "allgather"):
            check = out[f"average_{method}"]
            if not (check["w"] and check["h"] and check["b"]
                    and check["step"] and check["device"] == "cuda:0"):
                problems.append(f"average_tensors {method}: {check}")
        if out["broadcast_model"] != [1.0] * 6 \
                or out["broadcast_tensors"] != [1.0] * 3 \
                or out["broadcast_object"] != {"from": 1}:
            problems.append("broadcasts")
        if "Mismatch in synced tree" not in out["mismatch"]:
            problems.append(f"mismatched tree: {out['mismatch']}")
        if problems:
            fail(f"dp collectives rank {out['rank']}: {problems}")
    timing = {method: [round(out["average_ms"][method], 2)
                       for out in results] for method in ("reduce",
                                                          "allgather")}
    print(f"dp collectives: 2 ranks on cuda:0 over gloo: all_reduce "
          f"sum/mean/max/min on CUDA and host values, weighted "
          f"average_metrics, average_tensors by reduce and allgather on a "
          f"2 MiB f32 + bf16 + numpy tree bit-equal to the one-process mean "
          f"(ms by rank {timing}, {GLOO_LABEL}), broadcast_model / "
          f"broadcast_tensors / broadcast_object / barrier, a mismatched "
          f"tree RuntimeError on both ranks in "
          f"{[round(out['mismatch_ms'], 1) for out in results]} ms; "
          f"{seconds:.1f} s with the spawns [{card}]", flush=True)


def phase_dp_step(torch, card, folder):
    """Phase 44: the 235M layout in f32 on two ranks against one process;
    returns a rank's launches."""
    results, seconds = spawn_dp_ranks("step", folder, timeout=240)
    layers, steps = DP_LAYERS, 2
    want = {"flash_fwd_general": layers * steps,
            "flash_bwd_fused_general": layers * steps}
    for out in results:
        if out["launches"] != want or out["ddp"] != \
                "DistributedDataParallel" or out["calls"]["calls"] != steps:
            fail(f"dp step rank {out['rank']}: launches {out['launches']} "
                 f"(expected {want}), {out['ddp']}, {out['calls']}")
    if results[0]["digests"] != results[1]["digests"]:
        fail(f"dp step: the ranks' parameters differ after a step "
             f"({results[0]['digests']} vs {results[1]['digests']})")
    micro, one = results[0]["microbatched"], results[0]["one_process"]
    if not (micro["grads_equal"] and all(micro["params_equal"])):
        fail(f"dp step: not bit-equal to one process running the ranks' "
             f"rows as two microbatches (grads equal: "
             f"{micro['grads_equal']}; parameters equal after each step: "
             f"{micro['params_equal']})")
    if not math.isfinite(one["grads"]) or one["grads"] > 1e-5:
        fail(f"dp step: grads {one['grads']:.2e} of max |value| from one "
             f"process on the whole batch (limit 1e-5)")
    losses = [sum(out["losses"][i] for out in results) / DP_RANKS
              for i in range(steps)]
    print(f"dp step: 235M f32 (TF32 off, deterministic) global b4 t256 on 2 "
          f"ranks of b2 (DDP over gloo on one card), {DP_LAYERS} layers, 2 "
          f"clipped AdamW steps: "
          f"ranks' parameters bit-identical after every step and bit-equal "
          f"to one process running the ranks' rows as 2 microbatches "
          f"(gradients and parameters); against one process on the whole "
          f"batch in one piece: grads after the first backward within "
          f"{one['grads']:.2e} of max |value| (limit 1e-5), parameters "
          f"after each step within "
          f"{[float(f'{x:.2e}') for x in one['params']]}"
          f" (AdamW's first update, lr 3e-4 at step 2, normalizes the "
          f"gradients' summation-order noise); losses by step (rank mean) "
          f"{[round(x, 6) for x in losses]} against one process's "
          f"{[round(x, 6) for x in one['losses']]}; launches a rank {want}; "
          f"{seconds:.1f} s with the spawns (the DDP run "
          f"{results[0]['ddp_s']:.1f} s, rank 0's references "
          f"{ {k: round(v, 1) for k, v in results[0]['seconds'].items()} } s)"
          f" [{card}]", flush=True)
    return results[0]["launches"]


def start_dp_train_run(folder, epochs, label, *flags, args=None,
                       ranks=DP_RANKS):
    """Start `python3 chip_smoke.py --dp-train ... --workers=2` (of
    `args`, default DP_TRAIN_ARGS) in `folder`, or with `ranks=1` one
    process (`--dp-solo`); `finish_dp_train_run` waits for it."""
    Path(folder).mkdir(exist_ok=True)
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-train",
            *(DP_TRAIN_ARGS if args is None else args), f"dora.dir={folder}",
            f"epochs={epochs}", *flags,
            "--workers=2" if ranks > 1 else "--dp-solo"]
    tag = label.replace(" ", "-")
    clear_dp_results(folder, tag)
    started = start_sessions([(argv, dp_env(folder, tag))], folder, 300,
                             label)
    started.update(begin=time.perf_counter(), folder=folder, tag=tag,
                   launched=time.time(), ranks=ranks)
    return started


def finish_dp_train_run(started):
    """The ranks' results of a started `dp train` run, and its wall
    seconds."""
    logs = finish_sessions(started)
    ended = time.time()
    results = dp_results(started["folder"], started["tag"])[
        :started["ranks"]]
    if len(results) != started["ranks"]:
        fail(f"{started['label']}: {len(results)} of {started['ranks']} "
             f"ranks reported: {logs[0][1][-1500:]}")
    for out in results:
        # where a run's wall goes: the launch to the worker's start, its
        # start to main, main, main's end to its result, and to the
        # launcher's exit
        clock = out["clock"]
        marks = [started["launched"], clock["started"], clock["main"],
                 clock["main_end"], clock["written"], ended]
        out["split_s"] = [round(b - a, 2) for a, b in zip(marks, marks[1:])]
    return results, time.perf_counter() - started["begin"]


def dp_reference_loss(torch, device):
    """One process's train loss of the `dp train` run's first epoch: the
    seed-0 model on the two global batches (AdamW's first update has lr
    0, so both steps see these weights)."""
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    # the LM solver's model: its config's keys, its seed
    model = TransformerLM(TransformerConfig(
        vocab_size=32768, dim=1024, num_layers=DP_LAYERS, num_heads=16,
        mlp_ratio=4, attention="flash"), device=device, seed=0)
    stream = synthetic_token_stream(32768)
    with torch.no_grad():
        losses = [float(lm_next_token_loss(model, torch.from_numpy(
            stream(16, 1024, step)).long().to(device))) for step in range(2)]
    del model
    return sum(losses) / len(losses)


def phase_dp_train(torch, device, card, folder, b1, beside_a, beside_b2):
    """Phase 45: `main` with --workers=2 at full width on the card; `b1`
    is run B's first epoch, started in `folder`/b while `dp step` ran
    (`start_dp_train_run`); `beside_a()` and `beside_b2()` start what
    runs beside runs A and B2. Returns a rank's launches, run A's
    history, step p50 and peaks, and what the two callbacks started."""
    from flashy_tpu_torch.utils import percentile
    a_dir, b_dir = Path(folder) / "a", Path(folder) / "b"
    run_b1, b1_seconds = finish_dp_train_run(b1)
    started_a = start_dp_train_run(a_dir, 2, "dp train A", "--dp-digest",
                                   "--dp-time-all-reduce", "--dp-grads")
    beside = [beside_a()]
    run_a, a_seconds = finish_dp_train_run(started_a)
    started_b2 = start_dp_train_run(b_dir, 2, "dp train B2", "--dp-digest")
    beside.append(beside_b2())
    run_b2, b2_seconds = finish_dp_train_run(started_b2)
    print(f"dp train runs: wall A {a_seconds:.1f}, B1 {b1_seconds:.1f}, B2 "
          f"{b2_seconds:.1f} s; rank 0's seconds in main "
          f"{[round(r[0]['main_s'], 1) for r in (run_a, run_b1, run_b2)]}, "
          f"its steps {[round(x * 1e3, 1) for x in run_a[0]['step_seconds']]}"
          f" ms (A), the all-reduce alone "
          f"{[round(x, 1) for x in run_a[0]['all_reduce_ms']]} ms; rank 0's "
          f"wall split (launch to worker start, to main, main, to result, "
          f"to the launcher's exit) A {run_a[0]['split_s']}, B1 "
          f"{run_b1[0]['split_s']}, B2 {run_b2[0]['split_s']} s [{card}]",
          flush=True)
    want_a = flash_want(DP_LAYERS, [(2, 1)] * 2)
    want_b2 = flash_want(DP_LAYERS, [(2, 1)])
    for runs, want, restored in ((run_a, want_a, False),
                                 (run_b2, want_b2, True)):
        for out in runs:
            if out["launches"] != want or out["backend"] != "gloo" \
                    or out["restored"] != restored or out["epochs"] != 2 \
                    or out["ddp"] != "DistributedDataParallel":
                fail(f"dp train rank {out['rank']}: launches "
                     f"{out['launches']} (expected {want}), backend "
                     f"{out['backend']}, restored {out['restored']}, "
                     f"{out['epochs']} epochs, {out['ddp']}")
    digests = {out["digest"] for out in run_a + run_b2}
    if len(digests) != 1:
        fail(f"dp train: ranks or runs differ: A "
             f"{[o['digest'][:12] for o in run_a]}, B "
             f"{[o['digest'][:12] for o in run_b2]}")
    (a_xp,) = (a_dir / "xps").iterdir()
    (b_xp,) = (b_dir / "xps").iterdir()
    history_a = json.loads((a_xp / "history.json").read_text())
    history_b = json.loads((b_xp / "history.json").read_text())
    clocks = ("duration", "tokens_per_sec")

    def stripped_history(history):
        return [{stage: {k: v for k, v in metrics.items()
                         if k not in clocks}
                 for stage, metrics in epoch.items()} for epoch in history]

    if len(history_a) != 2 or stripped_history(history_a) != \
            stripped_history(history_b):
        fail(f"dp train: histories differ: {history_a} vs {history_b}")
    files = sorted(p.name for p in a_xp.iterdir())
    if "checkpoint.th" not in files or any(".tmp" in f for f in files):
        fail(f"dp train: rank 0's files {files}")
    reference = dp_reference_loss(torch, device)
    error = abs(history_a[0]["train"]["loss"] - reference) / reference
    if not error <= 1e-4:
        fail(f"dp train: epoch 1's train loss {history_a[0]['train']} "
             f"against one process {reference} (limit 1e-4 relative)")
    seconds = run_a[0]["step_seconds"][1:]
    p50 = percentile(seconds, 50) * 1e3
    tokens = 16 * 1024
    tok_s = tokens * len(seconds) / sum(seconds)
    reduce_ms = percentile(run_a[0]["all_reduce_ms"], 50)
    print(f"dp train: the 235M layout's width at {DP_LAYERS} layers, bf16, "
          f"global b16 t1024 through main --workers=2 "
          f"(2 ranks of b8 on cuda:0, gloo): run A 2 epochs x 2 steps + 1 "
          f"valid with a commit each, run B 1 epoch then resumed to 2 (both "
          f"ranks Restored: True from rank 0's file): final states "
          f"bit-identical across ranks and runs (sha256 of parameters and "
          f"AdamW moments), histories equal without wall-clock keys, "
          f"history.json and checkpoint.th by rank 0; epoch 1's train loss "
          f"{history_a[0]['train']['loss']:.7f} against one process "
          f"{reference:.7f} (rel {error:.1e}, limit 1e-4); "
          f"launches a rank {want_a} (A), {want_b2} (B resumed); step p50 "
          f"{p50:.2f} ms (steps 2..4, rank 0), global tokens/s "
          f"{tok_s:.1f}, the gradient all-reduce alone "
          f"({run_a[0]['all_reduce_bytes'] / 2 ** 20:.0f} MiB f32) "
          f"{reduce_ms:.1f} ms = {reduce_ms / p50:.3f} of a step "
          f"({GLOO_LABEL});"
          f" peak {max(o['peak_gib'] for o in run_a):.1f} GiB a rank; runs "
          f"A {a_seconds:.1f} (beside fsdp train A), B1 {b1_seconds:.1f} "
          f"(beside dp step), B2 {b2_seconds:.1f} s (beside fsdp train B2) "
          f"[{card}]", flush=True)
    summary = {"history": history_a, "p50": p50,
               "peaks": [o["peak_gib"] for o in run_a],
               "grads": run_a[0]["grads"]}
    return (run_a[0]["launches"], summary) + tuple(beside)


# ----------------------------------------------------------------------
# queue A item 8a: ZeRO-1 and FSDP over the process axes, two ranks on
# the card (gloo through the host: every reduce-scatter and all-gather is
# staged there, so these step times are that staging's, not NCCL's)
# ----------------------------------------------------------------------
ZERO_BENCH_ARGS = ["--workers=2", "--dim", "1024", "--layers",
                   str(DP_LAYERS), "--heads", "16", "--vocab", "32768",
                   "--seq", "1024", "--batch", "16", "--attention", "flash",
                   "--dtype", "bfloat16", "--steps", "4"]
FSDP_FLAGS = ("mesh.data=1", "mesh.fsdp=2", "--dp-sharded", "--dp-digest")


def start_zero_bench(folder):
    """Start `python -m flashy_tpu_torch.parallel.zero --workers=2` at
    the 235M layout's width in `folder`; `phase_zero_bench` waits."""
    Path(folder).mkdir(exist_ok=True)
    path = Path(folder) / "zero.json"
    argv = [sys.executable, "-m", "flashy_tpu_torch.parallel.zero",
            *ZERO_BENCH_ARGS, "--json", str(path)]
    started = start_sessions([(argv, dp_env(folder, "zero"))], folder, 300,
                             "zero bench")
    started.update(begin=time.perf_counter(), path=path)
    return started


def phase_zero_bench(card, started):
    """Phase 45b: the three weight-update layouts over two ranks."""
    finish_sessions(started)
    seconds = time.perf_counter() - started["begin"]
    record = json.loads(Path(started["path"]).read_text())
    modes = ("replicated", "zero1", "fsdp")
    opt, peak = record["opt_state_bytes_by_rank"], record["peak_bytes_by_rank"]
    gathered = record["collectives"]["zero1"].get("all-gather", {})
    problems = []
    for rank in range(DP_RANKS):
        if not opt["zero1"][rank] <= 0.55 * opt["replicated"][rank]:
            problems.append(f"rank {rank}: zero1 optimizer bytes "
                            f"{opt['zero1'][rank]:.0f} above 0.55 x "
                            f"replicated's {opt['replicated'][rank]:.0f}")
        if not peak["fsdp"][rank] < peak["replicated"][rank]:
            problems.append(f"rank {rank}: fsdp peak {peak['fsdp'][rank]:.0f}"
                            f" not below replicated's "
                            f"{peak['replicated'][rank]:.0f}")
    if not 0 < gathered.get("bytes", 0) <= 1.5 * record["params_bytes"]:
        problems.append(f"zero1 all-gathers {gathered} a step against "
                        f"{record['params_bytes']} params bytes (limit 1.5x)")
    if not record["max_param_delta"] <= 1e-4:
        problems.append(f"zero1 params {record['max_param_delta']:.2e} "
                        f"from replicated's (limit 1e-4)")
    if record["sharding"] != {"replicated": "replicated",
                              "zero1": "zero1(data=2)",
                              "fsdp": "fsdp(fsdp=2)"}:
        problems.append(f"layouts {record['sharding']}")
    if problems:
        fail(f"zero bench: {problems}")
    gib = 2 ** 30

    def per_op(stats):
        return {op: f"{e['count']}x {e['bytes'] / 2 ** 20:.1f} MiB"
                for op, e in stats.items()}

    print(f"zero bench: `python -m flashy_tpu_torch.parallel.zero "
          f"--workers=2`, the 235M layout's width at {DP_LAYERS} layers, "
          f"bf16 flash, global b16 t1024 (b8 a rank; beside dp "
          f"collectives and dp step), 4 timed AdamW steps a layout in one "
          f"start-up: step p50 ms "
          f"{ {m: round(record['step_ms'][m], 2) for m in modes} }; "
          f"optimizer MiB by rank "
          f"{ {m: [round(b / 2 ** 20, 1) for b in opt[m]] for m in modes} }"
          f" (zero1/replicated {record['opt_bytes_ratio_zero1']}, limit "
          f"0.55); peak GiB by rank "
          f"{ {m: [round(b / gib, 2) for b in peak[m]] for m in modes} } "
          f"(fsdp below replicated); collectives a step "
          f"{ {m: per_op(record['collectives'][m]) for m in modes} } "
          f"(zero1's all-gather {gathered.get('bytes', 0) / 2 ** 20:.1f} MiB"
          f" against {record['params_bytes'] / 2 ** 20:.1f} MiB of params, "
          f"limit 1.5x); each collective alone at the params' f32 bytes "
          f"{ {k: round(v, 1) for k, v in record['collective_ms'].items()} }"
          f" ms; zero1 params against replicated "
          f"{record['max_param_delta']:.2e} (limit 1e-4; "
          f"{'bit-equal' if record['max_param_delta'] == 0 else 'not 0'}); "
          f"layouts {record['sharding']}; {seconds:.1f} s with the spawn "
          f"({GLOO_LABEL}) [{card}]", flush=True)
    return record


def start_fsdp_b1(folder):
    """Run B's first epoch of `fsdp train` (`start_dp_train_run`)."""
    return start_dp_train_run(Path(folder) / "fsdp-b", 1, "fsdp train B1",
                              *FSDP_FLAGS)


def start_fsdp_b2(folder, b1):
    """Wait for run B's first epoch, then start its resumed second
    epoch; returns the first epoch's wall seconds and the start."""
    _, b1_seconds = finish_dp_train_run(b1)
    return b1_seconds, start_dp_train_run(Path(folder) / "fsdp-b", 2,
                                          "fsdp train B2", *FSDP_FLAGS)


def start_fsdp_a(folder):
    """Run A of `fsdp train` (`start_dp_train_run`)."""
    return start_dp_train_run(Path(folder) / "fsdp-a", 2, "fsdp train A",
                              *FSDP_FLAGS)


def phase_fsdp_train(torch, card, folder, started, dp):
    """Phase 45c: `main --workers=2` with `mesh.fsdp=2` and sharded
    slots. `started` holds run A (started beside phase 45's run A) and
    run B (its first epoch beside phases 43-44, its resumed second
    beside phase 45's run B2: `start_fsdp_b2`); `dp` is phase 45's
    summary. Returns a rank's launches."""
    from flashy_tpu_torch.utils import percentile
    a_dir, b_dir = Path(folder) / "fsdp-a", Path(folder) / "fsdp-b"
    started_a, (b1_seconds, started_b2) = started
    run_a, a_seconds = finish_dp_train_run(started_a)
    run_b2, b2_seconds = finish_dp_train_run(started_b2)
    want_a = flash_want(DP_LAYERS, [(2, 1)] * 2)
    want_b2 = flash_want(DP_LAYERS, [(2, 1)])
    for runs, want, restored in ((run_a, want_a, False),
                                 (run_b2, want_b2, True)):
        for out in runs:
            if out["launches"] != want or out["backend"] != "gloo" \
                    or out["restored"] != restored or out["epochs"] != 2 \
                    or out["sharded"] != "fsdp":
                fail(f"fsdp train rank {out['rank']}: launches "
                     f"{out['launches']} (expected {want}), backend "
                     f"{out['backend']}, restored {out['restored']}, "
                     f"{out['epochs']} epochs, layout {out['sharded']}")
    for a, b in zip(run_a, run_b2):
        if a["digest"] != b["digest"] or a["full_digest"] != b["full_digest"]:
            fail(f"fsdp train rank {a['rank']}: the resumed run differs from "
                 f"the uninterrupted one (shards {a['digest'][:12]} vs "
                 f"{b['digest'][:12]}, full {a['full_digest'][:12]} vs "
                 f"{b['full_digest'][:12]})")
    if len({out["full_digest"] for out in run_a}) != 1 \
            or run_a[0]["digest"] == run_a[1]["digest"]:
        fail("fsdp train: the ranks' full parameters differ, or their "
             "shards are equal")
    (a_xp,) = (a_dir / "xps").iterdir()
    (b_xp,) = (b_dir / "xps").iterdir()
    history_a = stripped(json.loads((a_xp / "history.json").read_text()))
    history_b = stripped(json.loads((b_xp / "history.json").read_text()))
    if len(history_a) != 2 or history_a != history_b:
        fail(f"fsdp train: histories differ: {history_a} vs {history_b}")
    want_dp = stripped(dp["history"])
    if [{s: sorted(m) for s, m in e.items()} for e in history_a] != \
            [{s: sorted(m) for s, m in e.items()} for e in want_dp]:
        fail(f"fsdp train: history keys {history_a} vs dp train's {want_dp}")
    relative = max(abs(g[s][k] - w[s][k]) / max(abs(w[s][k]), 1e-12)
                   for g, w in zip(history_a, want_dp) for s in w
                   for k in w[s])
    if not relative <= 1e-4:
        fail(f"fsdp train: history {history_a} against dp train A's "
             f"{want_dp}: {relative:.2e} relative (limit 1e-4)")
    meta = json.loads((a_xp / "checkpoint_meta.json").read_text())
    slot = a_xp / "checkpoint.th.sharded"
    pointer = (slot / "CURRENT").read_text().strip()
    files = sorted(json.loads((slot / pointer / "manifest.json").read_text())
                   ["files"])
    if meta["mode"] != "sharded" \
            or meta["state_sharding"]["summary"] != "fsdp(fsdp=2)" \
            or files != ["arrays-0.pt", "arrays-1.pt", "arrays.pt",
                         "state.pkl"] \
            or (a_xp / "checkpoint.th").exists():
        fail(f"fsdp train: checkpoint_meta {meta.get('mode')} "
             f"{meta.get('state_sharding')}, slot files {files}")
    seconds = run_a[0]["step_seconds"][1:]
    p50 = percentile(seconds, 50) * 1e3
    print(f"fsdp train: `main --workers=2 mesh.data=1 mesh.fsdp=2` with "
          f"sharded slots, phase 45's run otherwise (235M width, "
          f"{DP_LAYERS} layers, bf16, global b16 t1024, b8 a rank, "
          f"transformer_shardings over fsdp): run A 2 epochs (beside dp "
          f"train A), run B 1 epoch (beside dp collectives and dp step) then"
          f" resumed from the slots (beside dp train B2): each rank's shards"
          f" and the full parameters bit-identical "
          f"between A and the resumed B, histories equal; A's history "
          f"against dp train A's within {relative:.2e} relative (limit "
          f"1e-4; {'bit-equal' if relative == 0 else 'not bit-equal'}); "
          f"checkpoint_meta {meta['state_sharding']['summary']}, slot files"
          f" {files}; launches a rank {want_a} (A), {want_b2} (B resumed); "
          f"step p50 {p50:.2f} ms (steps 2..4, rank 0; each beside the "
          f"other) "
          f"against dp train A's {dp['p50']:.2f}; peak GiB a rank "
          f"{[round(o['peak_gib'], 2) for o in run_a]} against dp train "
          f"A's {[round(g, 2) for g in dp['peaks']]}; runs A "
          f"{a_seconds:.1f}, B1 {b1_seconds:.1f}, B2 {b2_seconds:.1f} s "
          f"({GLOO_LABEL}) [{card}]", flush=True)
    return run_a[0]["launches"]


# ----------------------------------------------------------------------
# queue A item 8b: Megatron tensor parallelism over a `tensor` process
# axis, two ranks on the card (gloo through the host: every activation
# all-reduce is staged there, so these step times are that staging's,
# not NVLink's or NCCL's)
# ----------------------------------------------------------------------
TP_FLAGS = ("mesh.data=1", "mesh.tensor=2", "--dp-sharded", "--dp-digest",
            "--dp-heads")
# the logged losses against `dp train` A's (the run moves them by about
# 3e-2 in all), and each parameter's gradient at the trained state
# against dp train A's, relative to its norm: the Megatron backward's
# check at this width (a dropped or doubled all-reduce moves the leaves
# upstream of it by a large part of their gradient)
TP_LOSS_LIMIT = 1e-3
TP_GRAD_LIMIT = 5e-2


def start_tp_bench(folder):
    """Start `python -m flashy_tpu_torch.parallel.tensor --workers=2` at
    the reference's defaults in `folder`; `phase_tp_bench` waits."""
    Path(folder).mkdir(exist_ok=True)
    path = Path(folder) / "tensor.json"
    argv = [sys.executable, "-m", "flashy_tpu_torch.parallel.tensor",
            "--workers=2", "--json", str(path)]
    started = start_sessions([(argv, dp_env(folder, "tensor"))], folder, 300,
                             "tp bench")
    started.update(begin=time.perf_counter(), path=path)
    return started


def phase_tp_bench(card, started):
    """Phase 45d: the tensor-width sweep over two ranks; its gates are
    the module's exit code (`finish_sessions` fails on a non-zero one),
    read again here. Returns the record."""
    finish_sessions(started)
    seconds = time.perf_counter() - started["begin"]
    record = json.loads(Path(started["path"]).read_text())
    problems = []
    if record["widths"] != [1, 2]:
        problems.append(f"widths {record['widths']}")
    if not record["grads_max_delta_overall"] <= 1e-4:
        problems.append(f"grads {record['grads_max_delta_overall']:.2e} "
                        f"from the oracle (limit 1e-4)")
    if record["flash_bwd_parity"] != 0.0:
        problems.append(f"flash backward parity "
                        f"{record['flash_bwd_parity']:.2e} (must be 0.0)")
    if record["recompiles"] != 0:
        problems.append(f"{record['recompiles']} recompiles")
    launched = record["flash_bwd_parity_launches"]
    if not all(launched.get(name, 0) > 0 for name in (
            "flash_bwd_fused_general", "flash_bwd_dq_general",
            "flash_bwd_dkv_general")):
        problems.append(f"the parity gate launched {launched}")
    if record["sharding"] != {"1": "zero1(data=2)", "2": "tensor(tensor=2)"}:
        problems.append(f"layouts {record['sharding']}")
    if problems:
        fail(f"tp bench: {problems}")

    def per_op(stats):
        return {op: f"{e['count']}x {e['bytes'] / 2 ** 20:.2f} MiB"
                for op, e in stats.items()}

    print(f"tp bench: `python -m flashy_tpu_torch.parallel.tensor "
          f"--workers=2` (f32, dense attention, dim 128, 2 layers, global "
          f"b{record['batch']} t{record['seq']}, widths 1 and 2 in one "
          f"start-up, beside dp collectives): step ms "
          f"{ {w: round(v, 2) for w, v in record['step_ms'].items()} }; "
          f"optimizer bytes a rank {record['opt_state_bytes_per_chip']} "
          f"(widest over replicated {record['opt_bytes_ratio']}); layouts "
          f"{record['sharding']}; collectives a step "
          f"{ {w: per_op(v) for w, v in record['collectives'].items()} }; "
          f"grads against the replicated oracle "
          f"{ {w: float(f'{v:.2e}') for w, v in record['grads_max_delta'].items()} }"
          f" (limit 1e-4); flash_bwd_parity {record['flash_bwd_parity']} "
          f"(f32 fused against split, launches {launched}); recompiles "
          f"{record['recompiles']}; {seconds:.1f} s with the spawn "
          f"({GLOO_LABEL}) [{card}]", flush=True)
    return record


def start_tp_b1(folder):
    """Run B's first epoch of `tp train` (`start_dp_train_run`)."""
    return start_dp_train_run(Path(folder) / "tp-b", 1, "tp train B1",
                              *TP_FLAGS)


def start_tp_b2(folder, b1):
    """Wait for `tp train` run B's first epoch, then start its resumed
    second; returns the first epoch's wall seconds and the start."""
    _, b1_seconds = finish_dp_train_run(b1)
    return b1_seconds, start_dp_train_run(Path(folder) / "tp-b", 2,
                                          "tp train B2", *TP_FLAGS)


def start_tp_a(folder):
    """Run A of `tp train`, with one more step's collectives counted."""
    return start_dp_train_run(Path(folder) / "tp-a", 2, "tp train A",
                              *TP_FLAGS, "--dp-grads", "--dp-collectives")


def phase_tp_train(torch, card, folder, started, dp):
    """Phase 45e: `main --workers=2` with `mesh.tensor=2` and sharded
    slots. `started` holds run A and run B (`start_tp_b2`); `dp` is
    phase 45's summary. Returns a rank's launches and the step's
    collectives."""
    from flashy_tpu_torch.utils import percentile
    a_dir, b_dir = Path(folder) / "tp-a", Path(folder) / "tp-b"
    started_a, (b1_seconds, started_b2) = started
    run_a, a_seconds = finish_dp_train_run(started_a)
    run_b2, b2_seconds = finish_dp_train_run(started_b2)
    want_a = flash_want(DP_LAYERS, [(2, 1)] * 2)
    want_b2 = flash_want(DP_LAYERS, [(2, 1)])
    for runs, want, restored in ((run_a, want_a, False),
                                 (run_b2, want_b2, True)):
        for out in runs:
            if out["launches"] != want or out["backend"] != "gloo" \
                    or out["restored"] != restored or out["epochs"] != 2 \
                    or out["sharded"] != "tensor" or out["heads"] != [8]:
                fail(f"tp train rank {out['rank']}: launches "
                     f"{out['launches']} (expected {want}), backend "
                     f"{out['backend']}, restored {out['restored']}, "
                     f"{out['epochs']} epochs, layout {out['sharded']}, "
                     f"heads a flash call {out['heads']} (expected [8])")
    for a, b in zip(run_a, run_b2):
        if a["digest"] != b["digest"] or a["full_digest"] != b["full_digest"]:
            fail(f"tp train rank {a['rank']}: the resumed run differs from "
                 f"the uninterrupted one (slices {a['digest'][:12]} vs "
                 f"{b['digest'][:12]}, full {a['full_digest'][:12]} vs "
                 f"{b['full_digest'][:12]})")
    if len({out["full_digest"] for out in run_a}) != 1 \
            or run_a[0]["digest"] == run_a[1]["digest"]:
        fail("tp train: the ranks' gathered parameters differ, or their "
             "slices are equal")
    (a_xp,) = (a_dir / "xps").iterdir()
    (b_xp,) = (b_dir / "xps").iterdir()
    history_a = stripped(json.loads((a_xp / "history.json").read_text()))
    history_b = stripped(json.loads((b_xp / "history.json").read_text()))
    if len(history_a) != 2 or history_a != history_b:
        fail(f"tp train: histories differ: {history_a} vs {history_b}")
    want_dp = stripped(dp["history"])
    if [sorted(e) for e in history_a] != [sorted(e) for e in want_dp]:
        fail(f"tp train: history stages {history_a} vs dp train's {want_dp}")
    gaps = [abs(g[s]["loss"] - w[s]["loss"])
            for g, w in zip(history_a, want_dp) for s in w if "loss" in w[s]]
    if not gaps or not max(gaps) <= TP_LOSS_LIMIT:
        fail(f"tp train: losses {history_a} against dp train A's {want_dp}:"
             f" {max(gaps) if gaps else None} apart (limit {TP_LOSS_LIMIT})")
    want_grads = torch.load(dp["grads"])
    got_grads = torch.load(run_a[0]["grads"])
    if set(got_grads) != set(want_grads):
        fail(f"tp train: gradients of {sorted(got_grads)} against dp train "
             f"A's {sorted(want_grads)}")
    grad_gaps = {name: float((got_grads[name] - want).norm() / want.norm())
                 for name, want in want_grads.items()}
    worst = max(grad_gaps, key=grad_gaps.get)
    if not grad_gaps[worst] <= TP_GRAD_LIMIT:
        fail(f"tp train: gradients against dp train A's, relative to their "
             f"norms: {grad_gaps} (limit {TP_GRAD_LIMIT})")
    meta = json.loads((a_xp / "checkpoint_meta.json").read_text())
    slot = a_xp / "checkpoint.th.sharded"
    pointer = (slot / "CURRENT").read_text().strip()
    files = sorted(json.loads((slot / pointer / "manifest.json").read_text())
                   ["files"])
    if meta["mode"] != "sharded" \
            or meta["state_sharding"]["summary"] != "tensor(tensor=2)" \
            or files != ["arrays-0.pt", "arrays-1.pt", "arrays.pt",
                         "state.pkl"] \
            or (a_xp / "checkpoint.th").exists():
        fail(f"tp train: checkpoint_meta {meta.get('mode')} "
             f"{meta.get('state_sharding')}, slot files {files}")
    stats = run_a[0]["collectives"]
    reduces = stats.get("all-reduce", {}).get("count", 0)
    # forward: the embedding's, two a block, the loss's two; backward: one
    # a block's two column splits and the head's; the clip's norm
    want_reduces = (1 + 2 * DP_LAYERS) + 2 + (2 * DP_LAYERS + 1) + 1
    if reduces != want_reduces or set(stats) != {"all-reduce"}:
        fail(f"tp train: one step's collectives {stats} (expected "
             f"{want_reduces} all-reduces and nothing else)")
    seconds = run_a[0]["step_seconds"][1:]
    p50 = percentile(seconds, 50) * 1e3
    tok_s = 16 * 1024 * len(seconds) / sum(seconds)

    def per_op(stats):
        return {op: f"{e['count']}x {e['bytes'] / 2 ** 20:.1f} MiB"
                for op, e in stats.items()}

    print(f"tp train: `main --workers=2 mesh.data=1 mesh.tensor=2` with "
          f"sharded slots, phase 45's run otherwise (235M width, "
          f"{DP_LAYERS} layers, bf16, global b16 t1024, each rank the "
          f"whole batch on 8 of 16 heads, half the MLP width and of the "
          f"vocabulary): run A 2 epochs (beside dp train A), run B 1 epoch "
          f"(beside dp step) then resumed from the slots (beside dp train "
          f"B2): each rank's slices and the gathered parameters "
          f"bit-identical between A and the resumed B, equal across the "
          f"ranks, histories equal; every logged loss within "
          f"{max(gaps):.2e} of dp train A's (limit {TP_LOSS_LIMIT}); "
          f"step 0's gradients at the trained state, gathered, within "
          f"{grad_gaps[worst]:.2e} of dp train A's relative to their norms "
          f"({worst}; median {percentile(list(grad_gaps.values()), 50):.2e};"
          f" limit {TP_GRAD_LIMIT}); "
          f"checkpoint_meta {meta['state_sharding']['summary']}, slot "
          f"files {files}; launches a rank {want_a} (A), {want_b2} (B "
          f"resumed), every flash call at {run_a[0]['heads']} heads; one "
          f"more step's collectives "
          f"{per_op(stats)} ({want_reduces} all-reduces expected); step "
          f"p50 {p50:.2f} ms "
          f"(steps 2..4, rank 0; beside the other runs), global tokens/s "
          f"{tok_s:.1f}, against dp train A's {dp['p50']:.2f} ms; peak GiB "
          f"a rank {[round(o['peak_gib'], 2) for o in run_a]} against dp "
          f"train A's {[round(g, 2) for g in dp['peaks']]}; runs A "
          f"{a_seconds:.1f}, B1 {b1_seconds:.1f}, B2 {b2_seconds:.1f} s "
          f"({GLOO_LABEL}) [{card}]", flush=True)
    return run_a[0]["launches"], stats


# ----------------------------------------------------------------------
# queue A item 8c: pipeline parallelism over the 'pipe' process axis, two
# ranks on the card (gloo through the host: every activation and
# cotangent hop is staged there, so these step times are that staging's)
# ----------------------------------------------------------------------
PIPE_TRAIN_ARGS = [arg for arg in TRAIN_ARGS
                   if not arg.startswith(("steps_per_epoch=",
                                          "valid_steps="))
                   ] + ["steps_per_epoch=2", "valid_steps=1",
                        "warmup_steps=1"]
PIPE_FLAGS = ("mesh.data=1", "mesh.pipe=2", "pipeline_schedule=1f1b",
              "pipeline_interleave=2", "pipeline_microbatches=4",
              "--dp-sharded", "--dp-digest", "--dp-blocks")
PIPE_ORACLE_FLAGS = ("mesh.pipe=1", "model.scan_layers=true", "--dp-grads")
# the logged losses against the one-process oracle's (bf16: the sums run
# in another order), and each parameter's gradient at the trained state
# against the oracle's, relative to its norm, as `tp train`'s gates
PIPE_LOSS_LIMIT = 1e-3
PIPE_GRAD_LIMIT = 5e-2
PIPE_BUBBLE = 1 / 9             # schedule_stats(2, 4, 2): 18 ticks
# timed steps a pipe bench leg (the reference's 3: cut for the script's
# time; each leg also runs its warm step, which the gates read)
PIPE_BENCH_STEPS = 1


def start_pipe_bench(folder):
    """Start `python -m flashy_tpu_torch.parallel.pipeline --workers=2`
    at the reference's defaults in `folder`; `phase_pipe_bench` waits."""
    Path(folder).mkdir(exist_ok=True)
    path = Path(folder) / "pipeline.json"
    argv = [sys.executable, "-W", "ignore::RuntimeWarning:runpy", "-m",
            "flashy_tpu_torch.parallel.pipeline", "--workers=2",
            "--steps", str(PIPE_BENCH_STEPS), "--json", str(path)]
    started = start_sessions([(argv, dp_env(folder, "pipeline"))], folder,
                             300, "pipe bench")
    started.update(begin=time.perf_counter(), path=path)
    return started


def phase_pipe_bench(card, started):
    """Phase 45f: the five schedules over two ranks. The module's own
    exit code also gates packed's step_ms against unpacked's, which two
    ranks sharing one card need not reproduce (an idle lane costs them no
    compute): exit 1 is read here and every other gate applied."""
    from flashy_tpu_torch.parallel.pipeline import bench_problems
    finish_sessions(started, codes=(0, 1))
    seconds = time.perf_counter() - started["begin"]
    record = json.loads(Path(started["path"]).read_text())
    problems = bench_problems(record, timing=False)
    if record["pipe"] != 2 or not record.get("bubble_track_recorded"):
        problems.append(f"pipe {record['pipe']}, bubble track "
                        f"{record.get('bubble_track_recorded')}")
    if problems:
        fail(f"pipe bench: {problems}")
    legs = {}
    for tag in ("dense", "moe"):
        legs[tag] = {name: {key: stats.get(key) for key in (
            "step_ms", "grad_drift", "bubble_frac", "dead_compute_frac",
            "step_ms_vs_unpacked", "tick_efficiency")
            if stats.get(key) is not None}
            for name, stats in record[tag]["schedules"].items()}
    print(f"pipe bench: `python -m flashy_tpu_torch.parallel.pipeline "
          f"--workers=2` (bf16, dense attention, dim 48, 8 layers, vocab "
          f"128, b{record['batch']} seq{record['seq']}, M "
          f"{record['num_micro']}, v {record['interleave']}, pipe 2, "
          f"deterministic algorithms): by leg {json.dumps(legs)}; packed "
          f"bit-identical to unpacked, 1F1B within 1e-2 of the GPipe "
          f"oracle, stash {record['stash_bytes_at_m']} -> "
          f"{record['stash_bytes_at_2m']} bytes at M -> 2M (GPipe "
          f"{record['gpipe_stash_bytes_at_m']} -> "
          f"{record['gpipe_stash_bytes_at_2m']}), recompiles "
          f"{record['recompiles']}; {seconds:.1f} s with the spawn "
          f"({GLOO_LABEL}) [{card}]", flush=True)
    return record


def start_pipe_b1(folder):
    """Run B's first epoch of `pipe train` (`start_dp_train_run`)."""
    return start_dp_train_run(Path(folder) / "pipe-b", 1, "pipe train B1",
                              *PIPE_FLAGS, args=PIPE_TRAIN_ARGS)


def start_pipe_b2(folder, b1):
    """Wait for `pipe train` run B's first epoch, then start its resumed
    second; returns the first epoch's wall seconds and the start."""
    _, b1_seconds = finish_dp_train_run(b1)
    return b1_seconds, start_dp_train_run(
        Path(folder) / "pipe-b", 2, "pipe train B2", *PIPE_FLAGS,
        args=PIPE_TRAIN_ARGS)


def start_pipe_a(folder):
    """Run A of `pipe train` (one more step's hops counted, a hop timed)."""
    return start_dp_train_run(Path(folder) / "pipe-a", 2, "pipe train A",
                              *PIPE_FLAGS, "--dp-grads", "--dp-collectives",
                              "--dp-time-hop", args=PIPE_TRAIN_ARGS)


def start_pipe_oracle(folder):
    """`pipe train`'s one-process oracle (12 layers whole: ~22 GiB, so
    it runs beside one-process phases, not beside the four two-rank runs
    of the dp group)."""
    return start_dp_train_run(Path(folder) / "pipe-oracle", 2,
                              "pipe train oracle", *PIPE_ORACLE_FLAGS,
                              args=PIPE_TRAIN_ARGS, ranks=1)


def phase_pipe_train(torch, card, folder, started):
    """Phase 45g: `main --workers=2` with `mesh.pipe=2` (1f1b, v 2, M 4)
    at the 235M layout against its one-process oracle. `started` holds
    the oracle (`start_pipe_oracle`), run A (`start_pipe_a`) and run B
    (`start_pipe_b2`). Returns a rank's launches."""
    from flashy_tpu_torch.utils import percentile
    started_oracle, started_a, (b1_seconds, started_b2) = started
    run_a, a_seconds = finish_dp_train_run(started_a)
    (oracle,), oracle_seconds = finish_dp_train_run(started_oracle)
    run_b2, b2_seconds = finish_dp_train_run(started_b2)
    # a rank runs its 6 layers' forward twice a microbatch (the F tick
    # and the B tick's recompute) and the fused backward once: 48 and 24
    # a training step at M 4; a valid step's 1f1b forward 24
    layers, micro = 6, 4
    step_fwd, step_bwd, valid_fwd = 2 * layers * micro, layers * micro, \
        layers * micro

    def want(epochs):
        return {"flash_fwd": epochs * (2 * step_fwd + valid_fwd),
                "flash_bwd_fused": epochs * 2 * step_bwd}

    for runs, expect, restored in ((run_a, want(2), False),
                                   (run_b2, want(1), True)):
        for out in runs:
            if out["launches"] != expect or out["backend"] != "gloo" \
                    or out["restored"] != restored or out["epochs"] != 2 \
                    or out["sharded"] != "pipe" or out["block_rows"] != 6:
                fail(f"pipe train rank {out['rank']}: launches "
                     f"{out['launches']} (expected {expect}), backend "
                     f"{out['backend']}, restored {out['restored']}, "
                     f"{out['epochs']} epochs, layout {out['sharded']}, "
                     f"{out['block_rows']} layers held (expected 6)")
    if oracle["launches"] != flash_want(12, [(2, 1)] * 2):
        fail(f"pipe train oracle: launches {oracle['launches']}")
    for a, b in zip(run_a, run_b2):
        if a["digest"] != b["digest"] or a["full_digest"] != b["full_digest"]:
            fail(f"pipe train rank {a['rank']}: the resumed run differs "
                 f"from the uninterrupted one (chunks {a['digest'][:12]} "
                 f"vs {b['digest'][:12]}, full {a['full_digest'][:12]} vs "
                 f"{b['full_digest'][:12]})")
    if len({out["full_digest"] for out in run_a}) != 1 \
            or run_a[0]["digest"] == run_a[1]["digest"]:
        fail("pipe train: the ranks' gathered parameters differ, or their "
             "chunks are equal")
    histories = []
    for sub in ("pipe-a", "pipe-b", "pipe-oracle"):
        (xp,) = (Path(folder) / sub / "xps").iterdir()
        histories.append(stripped(json.loads(
            (xp / "history.json").read_text())))
    history_a, history_b, history_oracle = histories
    if len(history_a) != 2 or history_a != history_b:
        fail(f"pipe train: histories differ: {history_a} vs {history_b}")
    bubbles = [epoch["train"].get("bubble_frac") for epoch in history_a]
    if any(b is None or abs(b - PIPE_BUBBLE) > 1e-6 for b in bubbles):
        fail(f"pipe train: bubble_frac {bubbles} (expected {PIPE_BUBBLE})")
    gaps = [abs(g[s]["loss"] - w[s]["loss"])
            for g, w in zip(history_a, history_oracle) for s in w
            if "loss" in w[s]]
    if len(gaps) != 4 or not max(gaps) <= PIPE_LOSS_LIMIT:
        fail(f"pipe train: losses {history_a} against the oracle's "
             f"{history_oracle}: {max(gaps) if gaps else None} apart "
             f"(limit {PIPE_LOSS_LIMIT})")
    want_grads = torch.load(oracle["grads"])
    got_grads = torch.load(run_a[0]["grads"])
    if set(got_grads) != set(want_grads):
        fail(f"pipe train: gradients of {sorted(got_grads)} against the "
             f"oracle's {sorted(want_grads)}")
    grad_gaps = {name: float((got_grads[name] - value).norm()
                             / value.norm())
                 for name, value in want_grads.items()}
    worst = max(grad_gaps, key=grad_gaps.get)
    if not grad_gaps[worst] <= PIPE_GRAD_LIMIT:
        fail(f"pipe train: gradients against the oracle's, relative to "
             f"their norms: {grad_gaps} (limit {PIPE_GRAD_LIMIT})")
    stats = run_a[0]["collectives"]
    hops = stats.get("collective-permute", {})
    seconds = run_a[0]["step_seconds"][1:]
    p50 = percentile(seconds, 50) * 1e3
    oracle_p50 = percentile(oracle["step_seconds"][1:], 50) * 1e3
    tok_s = 16 * 1024 * len(seconds) / sum(seconds)
    hop_ms = percentile(run_a[0]["hop_ms"], 50)

    def per_op(stats):
        return {op: f"{e['count']}x {e['bytes'] / 2 ** 20:.1f} MiB"
                for op, e in stats.items()}

    print(f"pipe train: `main --workers=2 mesh.data=1 mesh.pipe=2 "
          f"pipeline_schedule=1f1b pipeline_interleave=2 "
          f"pipeline_microbatches=4` with sharded slots (235M layout, 12 "
          f"layers, bf16, global b16 t1024; each rank 6 of the 12 layers): "
          f"run A 2 epochs x 2 steps + 1 valid (beside dp train A), run B "
          f"1 epoch then resumed (beside dp step, dp train B2), the oracle "
          f"beside packed train and the drills: each "
          f"rank's chunks and the gathered parameters bit-identical "
          f"between A and the resumed B, histories equal; every logged "
          f"loss within {max(gaps):.2e} of the one-process oracle's (limit "
          f"{PIPE_LOSS_LIMIT}); step 0's gradients at the trained state, "
          f"gathered, within {grad_gaps[worst]:.2e} of the oracle's "
          f"relative to their norms ({worst}; median "
          f"{percentile(list(grad_gaps.values()), 50):.2e}; limit "
          f"{PIPE_GRAD_LIMIT}); bubble_frac {bubbles[0]}; launches a rank "
          f"{run_a[0]['launches']} (A: {step_fwd} and {step_bwd} a "
          f"training step, {valid_fwd} a valid step), {run_b2[0]['launches']}"
          f" (B resumed); one more step's collectives {per_op(stats)} "
          f"(hops {hops.get('count', 0)}, "
          f"{hops.get('bytes', 0) / 2 ** 20:.1f} MiB a rank); one "
          f"[4, 1024, 1024] bf16 hop alone {hop_ms:.2f} ms "
          f"({run_a[0]['hop_bytes'] / 2 ** 20:.0f} MiB); step p50 "
          f"{p50:.2f} ms (steps 2..4, rank 0; beside the other runs), "
          f"global tokens/s {tok_s:.1f}, against the oracle's "
          f"{oracle_p50:.2f} ms; peak GiB a rank "
          f"{[round(o['peak_gib'], 2) for o in run_a]} against the "
          f"oracle's {oracle['peak_gib']:.2f}; runs A {a_seconds:.1f}, B1 "
          f"{b1_seconds:.1f}, B2 {b2_seconds:.1f}, oracle "
          f"{oracle_seconds:.1f} s ({GLOO_LABEL}) [{card}]", flush=True)
    return run_a[0]["launches"]


# ----------------------------------------------------------------------
# queue A item 8d, the expert half: expert parallelism over the 'expert'
# process axis, two ranks on the card (gloo through the host: every
# exchange is staged there, so these step times are that staging's)
# ----------------------------------------------------------------------
EP_TRAIN_ARGS = [arg for arg in TRAIN_ARGS
                 if not arg.startswith(("model.num_layers=",
                                        "steps_per_epoch=", "valid_steps="))
                 ] + MOE_ARGS[:2] + [f"model.num_layers={MOE_TRAIN_LAYERS}",
                                     "steps_per_epoch=2", "valid_steps=1",
                                     "warmup_steps=1"]
# capacity factor 2.0 = e: a source's assignments to one shard never pass
# its slots, so nothing drops and the run computes `dropless`'s function
EP_FLAGS = ("mesh.data=1", "+mesh.expert=2", "model.moe_dispatch=dropless_ep",
            "model.moe_capacity_factor=2.0", "--dp-sharded", "--dp-digest")
EP_ORACLE = "model.moe_dispatch=dropless"
# the logged losses against the one-process `dropless` oracle's, and each
# parameter's gradient at run A's trained state, relative to its norm,
# against two one-process functions at that same state: `dropless_ep` at
# expert=1 (the same function: the same rounding of the expert outputs
# to bf16 before the return exchange, no exchange; the expert weights'
# gradients sum their rows in another order, and a dropped, doubled or
# misrouted exchange moves whole experts' gradients), and `dropless`
# (which keeps the expert outputs in f32 until the combine: that
# rounding point's own gap, near-ties flipped by its last bit included)
EP_LOSS_LIMIT = 1e-3
EP_SAME_LIMIT = 5e-3
EP_GRAD_LIMIT = 5e-2


# `ep step`: `moe step`'s model and batch (f32, TF32 off, b2 t256, 12
# layers, capacity factor 8.0, no routing gap under MOE_TIE_GAP) through
# `dropless_ep` on two expert ranks, against `dropless` on each rank's
# whole model: where no token routes near a tie, the exchange computes
# `dropless`'s function, so loss and gradients agree at the kernels' f32
# bar (MOE_PLAIN_TOL)


def moe_step_config(torch, dispatch, layers=12):
    """`moe step`'s model configuration under `dispatch`."""
    return model_config(torch, torch.float32, 256, "flash", moe_experts=8,
                        moe_top_k=2, moe_capacity_factor=8.0,
                        moe_dispatch=dispatch, num_layers=layers)


def ep_step_rank(torch, device):
    """`ep step`, one rank: `moe step`'s batch search on the `dropless`
    model, its loss and gradients, then the same weights as
    `dropless_ep` over `+mesh.expert=2` (each rank 4 of every block's
    8 experts); rank 0's errors against the first, each sliced
    parameter's gradient gathered."""
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops import grouped_matmul as G
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.parallel import make_mesh, wrap
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = synthetic_token_stream(32768)
    model = TransformerLM(moe_step_config(torch, "dropless"), device=device,
                          seed=3)
    for step in range(32):
        tokens = torch.from_numpy(stream(2, 256, step)).long().to(device)
        margin = router_margin(torch, model, tokens)
        if margin > MOE_TIE_GAP:
            break
    loss = lm_next_token_loss(model, tokens, aux_weight=0.01)
    loss.backward()
    want_loss = loss.item()
    want = {name: p.grad for name, p in model.named_parameters()}
    del model, loss
    mesh = make_mesh({"data": 1, "expert": 2})
    model = TransformerLM(moe_step_config(torch, "dropless_ep"),
                          device=device, seed=3, mesh=mesh)
    wrap(model, mesh=mesh)
    G.reset_launch_counts()
    loss = lm_next_token_loss(model, tokens, aux_weight=0.01)
    loss.backward()
    torch.cuda.synchronize()
    counts = nonzero(G.launch_counts)
    errors = {}
    for name, p in model.named_parameters():
        sharding = getattr(p, "sharding", None)
        grad = p.grad if sharding is None else sharding.gather(p.grad)
        errors[name] = rel_err(grad, want[name])
    return {"step": step, "margin": margin, "dropless_loss": want_loss,
            "loss": loss.item(), "launches": counts, "errors": errors,
            "held": list(model.block_0.moe.w_up.shape)}


def phase_ep_step(card, started, moe_step):
    """Phase 12b: `ep step`'s two ranks (`start_dp_ranks('ep_step')`)
    against `dropless`, and their `dropless` run against `moe step`'s."""
    results, seconds = finish_dp_ranks(started)
    layers = 12
    want = {"gmm": 2 * layers, "gmm_t": 2 * layers, "tgmm": 2 * layers}
    for out in results:
        worst = max(out["errors"], key=out["errors"].get)
        loss_err = abs(out["loss"] - out["dropless_loss"]) \
            / abs(out["dropless_loss"])
        if out["step"] != moe_step["step"] \
                or out["dropless_loss"] != moe_step["loss"]:
            fail(f"ep step rank {out['rank']}: batch {out['step']} and "
                 f"dropless loss {out['dropless_loss']!r}, not moe step's "
                 f"{moe_step['step']} and {moe_step['loss']!r}")
        if out["launches"] != want or out["held"] != [4, 1024, 4096] \
                or not out["errors"][worst] <= MOE_PLAIN_TOL \
                or not loss_err <= MOE_PLAIN_TOL:
            fail(f"ep step rank {out['rank']}: launches {out['launches']} "
                 f"(expected {want}), experts held {out['held']}, loss rel "
                 f"err {loss_err:.2e}, grads max rel err "
                 f"{out['errors'][worst]:.2e} ({worst}; limit "
                 f"{MOE_PLAIN_TOL})")
    out = results[0]
    worst = max(out["errors"], key=out["errors"].get)
    print(f"ep step: moe step's model (f32, TF32 off, b2 t256, 12 layers, "
          f"capacity factor 8.0) and batch {out['step']} (min routing gap "
          f"{out['margin']:.2e}) through dropless_ep on two ranks "
          f"(`+mesh.expert=2`, 4 of every block's 8 experts a rank): loss "
          f"{out['loss']:.6f} against dropless "
          f"{out['dropless_loss']:.6f} (moe step's, bit-equal), grads max "
          f"rel err {out['errors'][worst]:.2e} ({worst}; limit "
          f"{MOE_PLAIN_TOL}); rows 9a/9b a rank {out['launches']}; "
          f"{seconds:.1f} s with the spawns (beside the dp group's first "
          f"runs; {GLOO_LABEL}) [{card}]", flush=True)


def start_ep_oracle(folder):
    """`ep train`'s one-process `dropless` oracle of the same config."""
    return start_dp_train_run(Path(folder) / "ep-oracle", 2,
                              "ep train oracle", EP_ORACLE,
                              args=EP_TRAIN_ARGS, ranks=1)


def start_ep_a(folder):
    """Run A of `ep train` (its gradients and parameters at the trained
    state written, one exchange timed alone, one more step's collectives
    counted)."""
    return start_dp_train_run(Path(folder) / "ep-a", 2, "ep train A",
                              *EP_FLAGS, "--dp-grads", "--dp-params",
                              "--dp-time-exchange", "--dp-collectives",
                              args=EP_TRAIN_ARGS)


def start_ep_b1(folder):
    """Run B's first epoch of `ep train` (`start_dp_train_run`)."""
    return start_dp_train_run(Path(folder) / "ep-b", 1, "ep train B1",
                              *EP_FLAGS, args=EP_TRAIN_ARGS)


def start_ep_b2(folder, b1):
    """Wait for `ep train` run B's first epoch, then start its resumed
    second; returns the first epoch's wall seconds and the start."""
    _, b1_seconds = finish_dp_train_run(b1)
    return b1_seconds, start_dp_train_run(
        Path(folder) / "ep-b", 2, "ep train B2", *EP_FLAGS,
        args=EP_TRAIN_ARGS)


def ep_slab_check(torch, device, card):
    """Row 9a at `ep train`'s receiving slab: 32768 rows = 2 sources x
    16384 slots, 4 local experts, about half the rows real (a seeded
    multinomial of 16384 over the 4 groups) and the empty slots after
    every group. `gmm` up and down on the slab held to the plain version
    there (rows past the groups exactly zero), then timed three times
    beside the same products on the real rows alone: the empty slots'
    cost. Returns {label: (slab ms, compact ms)} and the max abs err."""
    import numpy as np
    from flashy_tpu_torch.ops import grouped_matmul as G
    bf, f32 = torch.bfloat16, torch.float32
    E, D, F, M = 4, 1024, 4096, 32768
    sizes = np.random.default_rng(1).multinomial(M // 2, [1 / E] * E)
    real = int(sizes.sum())
    gs = torch.tensor(sizes, dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((M, D), generator=g, device=device).to(bf)
    h = torch.randn((M, F), generator=g, device=device).to(bf)
    x[real:], h[real:] = 0, 0
    w_up = (torch.randn((E, D, F), generator=g, device=device) * 0.02).to(bf)
    w_down = (torch.randn((E, F, D), generator=g, device=device)
              * 0.02).to(bf)
    times, err = {}, 0.0
    for label, lhs, rhs in (("up", x, w_up), ("down", h, w_down)):
        got = G.gmm(lhs, rhs, gs, f32)
        want = G._gmm_reference(lhs, rhs, gs, f32)
        torch.cuda.synchronize()
        err = max(err, gmm_check(torch, got, want, f"ep slab gmm {label}"))
        if got[real:].abs().max().item() != 0.0:
            fail(f"ep slab gmm {label}: rows past the groups not zero")
        compact = lhs[:real].contiguous()
        times[label] = (
            time_runs(torch, lambda: G.gmm(lhs, rhs, gs, f32), iters=20),
            time_runs(torch, lambda: G.gmm(compact, rhs, gs, f32), iters=20))
        del got, want, compact
    print(f"ep slab: row 9a at ep train's receiving slab ([{M}, {D}] bf16, "
          f"4 local experts, {real} real rows {sizes.tolist()}, the empty "
          f"slots after the groups): gmm up and down held to the plain "
          f"version (max abs err {err:.3e}, rows past the groups exactly "
          f"0); " + "; ".join(
              f"{label} slab {spread_text(slab)} against the real rows "
              f"alone {spread_text(compact)}"
              for label, (slab, compact) in times.items())
          + f" [{card}]", flush=True)
    return times, err


def phase_ep_train(torch, device, card, folder, started):
    """Phase 45h: `main --workers=2` with `+mesh.expert=2` and
    `moe_dispatch=dropless_ep` at the MoE layout, against a one-process
    `dropless` oracle of the same config. `started` holds run A
    (`start_ep_a`), run B (`start_ep_b2`) and the oracle
    (`start_ep_oracle`). Returns a rank's grouped-matmul launches."""
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.parallel import make_mesh
    from flashy_tpu_torch.utils import percentile
    started_a, (b1_seconds, started_b2), started_oracle = started
    run_a, a_seconds = finish_dp_train_run(started_a)
    # the one-process functions at run A's trained state (while B2 may
    # still run): `dropless_ep` at expert=1 and `dropless` on A's gathered
    # parameters, step 0's batch
    params = torch.load(run_a[0]["params"])
    tokens = torch.from_numpy(synthetic_token_stream(32768)(
        16, 1024, 0)).long().to(device)

    def grads_at_a(dispatch, mesh=None):
        release_memory(torch)
        model = TransformerLM(model_config(
            torch, torch.bfloat16, 1024, "flash", moe_experts=8,
            moe_top_k=2, moe_dispatch=dispatch, moe_capacity_factor=2.0,
            num_layers=MOE_TRAIN_LAYERS), device=device, seed=0, mesh=mesh)
        with torch.no_grad():
            model.load_state_dict(params)
        lm_next_token_loss(model, tokens, aux_weight=0.01).backward()
        return {name: p.grad.float().cpu()
                for name, p in model.named_parameters()}

    same_grads = grads_at_a("dropless_ep", make_mesh({"data": 1,
                                                      "expert": 1}))
    want_grads = grads_at_a("dropless")
    del params, tokens
    release_memory(torch)
    run_b2, b2_seconds = finish_dp_train_run(started_b2)
    (oracle,), _ = finish_dp_train_run(started_oracle)
    oracle_gmm = oracle["gmm_launches"]
    oracle_p50 = percentile(oracle["step_seconds"][1:], 50) * 1e3
    (xp,) = (Path(folder) / "ep-oracle" / "xps").iterdir()
    history_oracle = stripped(json.loads((xp / "history.json").read_text()))
    layers = MOE_TRAIN_LAYERS

    def want_gmm(train, valid):
        return {"gmm": 2 * layers * (train + valid),
                "gmm_t": 2 * layers * train, "tgmm": 2 * layers * train,
                "split_bf16": 2 * layers * train}

    if oracle_gmm != want_gmm(4, 2):
        fail(f"ep train oracle: launches {oracle_gmm}")
    for runs, epochs, restored in ((run_a, 2, False), (run_b2, 1, True)):
        want = flash_want(layers, [(2, 1)] * epochs)
        for out in runs:
            if out["launches"] != want \
                    or out["gmm_launches"] != want_gmm(2 * epochs, epochs) \
                    or out["backend"] != "gloo" \
                    or out["restored"] != restored or out["epochs"] != 2 \
                    or out["sharded"] != "expert" \
                    or out["ddp"] != "DistributedDataParallel":
                fail(f"ep train rank {out['rank']}: launches "
                     f"{out['launches']} and {out['gmm_launches']} "
                     f"(expected {want} and {want_gmm(2 * epochs, epochs)}),"
                     f" backend {out['backend']}, restored "
                     f"{out['restored']}, {out['epochs']} epochs, layout "
                     f"{out['sharded']}, {out['ddp']}")
    for a, b in zip(run_a, run_b2):
        if a["digest"] != b["digest"] or a["full_digest"] != b["full_digest"]:
            fail(f"ep train rank {a['rank']}: the resumed run differs from "
                 f"the uninterrupted one (own {a['digest'][:12]} vs "
                 f"{b['digest'][:12]}, full {a['full_digest'][:12]} vs "
                 f"{b['full_digest'][:12]})")
    if len({out["whole_digest"] for out in run_a + run_b2}) != 1 \
            or len({out["full_digest"] for out in run_a}) != 1 \
            or run_a[0]["digest"] == run_a[1]["digest"]:
        fail("ep train: the parameters the ranks hold whole differ across "
             "the ranks, or their gathered parameters differ, or their "
             "experts are equal")
    histories = []
    for sub in ("ep-a", "ep-b"):
        (xp,) = (Path(folder) / sub / "xps").iterdir()
        histories.append(stripped(json.loads(
            (xp / "history.json").read_text())))
    history_a, history_b = histories
    if len(history_a) != 2 or history_a != history_b:
        fail(f"ep train: histories differ: {history_a} vs {history_b}")
    gaps = [abs(g[s]["loss"] - w[s]["loss"])
            for g, w in zip(history_a, history_oracle) for s in w
            if "loss" in w[s]]
    if len(gaps) != 4 or not max(gaps) <= EP_LOSS_LIMIT:
        fail(f"ep train: losses {history_a} against the oracle's "
             f"{history_oracle}: {max(gaps) if gaps else None} apart "
             f"(limit {EP_LOSS_LIMIT})")
    got_grads = torch.load(run_a[0]["grads"])
    if not set(got_grads) == set(want_grads) == set(same_grads):
        fail(f"ep train: gradients of {sorted(got_grads)} against the "
             f"one-process functions' {sorted(want_grads)}")

    def relative_gaps(got, want):
        """Each parameter's gradient gap relative to `want`'s norm, and
        the worst parameter."""
        out = {name: float((got[name] - value).norm() / value.norm())
               for name, value in want.items()}
        return out, max(out, key=out.get)

    same_gaps, same_worst = relative_gaps(got_grads, same_grads)
    grad_gaps, worst = relative_gaps(got_grads, want_grads)
    point_gaps, point_worst = relative_gaps(same_grads, want_grads)
    if not same_gaps[same_worst] <= EP_SAME_LIMIT \
            or not grad_gaps[worst] <= EP_GRAD_LIMIT:
        fail(f"ep train: gradients at A's state, relative to their norms, "
             f"against one-process dropless_ep at expert=1: {same_gaps} "
             f"(limit {EP_SAME_LIMIT}); against dropless: {grad_gaps} "
             f"(limit {EP_GRAD_LIMIT})")
    (a_xp,) = (Path(folder) / "ep-a" / "xps").iterdir()
    meta = json.loads((a_xp / "checkpoint_meta.json").read_text())
    slot = a_xp / "checkpoint.th.sharded"
    pointer = (slot / "CURRENT").read_text().strip()
    files = sorted(json.loads((slot / pointer / "manifest.json").read_text())
                   ["files"])
    if meta["mode"] != "sharded" \
            or meta["state_sharding"]["summary"] != "fsdp(expert=2)" \
            or files != ["arrays-0.pt", "arrays-1.pt", "arrays.pt",
                         "state.pkl"]:
        fail(f"ep train: checkpoint_meta {meta.get('mode')} "
             f"{meta.get('state_sharding')}, slot files {files}")
    stats = run_a[0]["collectives"]
    # a block's exchanges: the tokens, their expert ids and the results
    # forward, the results' and the tokens' mirrors backward
    exchanges = stats.get("all-to-all", {})
    if exchanges.get("count") != 5 * layers or "reduce-scatter" in stats \
            or not stats.get("all-reduce", {}).get("count"):
        fail(f"ep train: one step's collectives {stats} (expected "
             f"{5 * layers} all-to-alls, the all-reduces of the leaves "
             f"held whole, no reduce-scatter)")
    exchange_ms = percentile(run_a[0]["exchange_ms"], 50)
    seconds = run_a[0]["step_seconds"][1:]
    p50 = percentile(seconds, 50) * 1e3
    tok_s = 16 * 1024 * len(seconds) / sum(seconds)
    gmm_a = run_a[0]["gmm_launches"]

    def per_op(stats):
        return {op: f"{e['count']}x {e['bytes'] / 2 ** 20:.1f} MiB"
                for op, e in stats.items()}

    print(f"ep train: `main --workers=2 mesh.data=1 +mesh.expert=2 "
          f"model.moe_dispatch=dropless_ep model.moe_capacity_factor=2.0` "
          f"with sharded slots (the MoE layout "
          f"at {layers} of 12 layers, 8 top-2 experts, bf16, global b16 "
          f"t1024; each rank 4 of every block's 8 experts and 8192 of the "
          f"16384 tokens of each MoE layer): run A 2 epochs x 2 steps + 1 "
          f"valid, run B 1 epoch then resumed from the slots (beside the "
          f"other families' phases), the one-process dropless oracle beside "
          f"them: each rank's state and the gathered parameters "
          f"bit-identical between A and the resumed B, the parameters held "
          f"whole (their gradients averaged over the expert ranks) "
          f"bit-identical across the ranks and runs, histories "
          f"equal; every logged loss within {max(gaps):.2e} of the "
          f"oracle's (limit {EP_LOSS_LIMIT}); step 0's gradients at A's "
          f"trained state, gathered, relative to their norms: within "
          f"{same_gaps[same_worst]:.2e} of one-process dropless_ep at "
          f"expert=1 at that state ({same_worst}; median "
          f"{percentile(list(same_gaps.values()), 50):.2e}; limit "
          f"{EP_SAME_LIMIT}), within {grad_gaps[worst]:.2e} of dropless's "
          f"({worst}; median {percentile(list(grad_gaps.values()), 50):.2e}"
          f"; limit {EP_GRAD_LIMIT}); dropless_ep at expert=1 against "
          f"dropless, the bf16 rounding point alone: "
          f"{point_gaps[point_worst]:.2e} ({point_worst}; median "
          f"{percentile(list(point_gaps.values()), 50):.2e}); "
          f"checkpoint_meta "
          f"{meta['state_sharding']['summary']}, slot files {files}; rows "
          f"9a/9b a rank {gmm_a} in A (2 gmm, 2 gmm_t, 2 tgmm a layer a "
          f"training step: {2 * layers} each), the oracle {oracle_gmm}; "
          f"flash {run_a[0]['launches']}; one more step's collectives a "
          f"rank {per_op(stats)} ({5 * layers} all-to-alls: "
          f"{exchanges.get('bytes', 0) / 2 ** 20:.1f} MiB); one [32768, "
          f"1024] bf16 all-to-all alone {exchange_ms:.2f} ms "
          f"({run_a[0]['exchange_bytes'] / 2 ** 20:.0f} MiB a rank); step "
          f"p50 "
          f"{p50:.2f} ms (steps 2..4, rank 0; beside the other phases), "
          f"global tokens/s {tok_s:.1f}, against the oracle's "
          f"{oracle_p50:.2f} ms; peak GiB a rank "
          f"{[round(o['peak_gib'], 2) for o in run_a]} against the "
          f"oracle's {oracle['peak_gib']:.2f}; runs A {a_seconds:.1f}, B1 "
          f"{b1_seconds:.1f}, B2 {b2_seconds:.1f} s to their checks, the "
          f"oracle's main {oracle['main_s']:.1f} s ({GLOO_LABEL}) [{card}]",
          flush=True)
    return gmm_a


class DocsSource:
    """A checkpointable document source: document i is 8 tokens of i."""

    def __init__(self):
        self.i = 0

    def __iter__(self):
        return self

    def __next__(self):
        import numpy as np
        doc = np.full(8, self.i, dtype=np.int32)
        self.i += 1
        return doc

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, state):
        self.i = state["i"]

    def close(self):
        pass


def phase_prefetch_to_device(torch, device, card, rounds=2, batches=24):
    """Phase 46: `data.prefetch_to_device` on the card."""
    import numpy as np
    from flashy_tpu_torch.data import prefetch_to_device
    from flashy_tpu_torch.datapipe import SequencePacker, prefetch
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.utils import percentile
    stream = synthetic_token_stream(32768)
    host = [stream(16, 1024, step) for step in range(batches)]
    got = list(prefetch_to_device(iter(host), size=2, device=device))
    if len(got) != batches or any(
            g.device != torch.device("cuda", 0) or g.dtype != torch.int32
            or not np.array_equal(g.cpu().numpy(), h)
            for g, h in zip(got, host)):
        fail("prefetch to device: delivered batches differ from the host's")
    pipe = prefetch(SequencePacker(DocsSource(), batch_size=8, max_len=8),
                    size=2)
    it = prefetch_to_device(pipe, size=2, device=device)
    seen = [int(next(it)["tokens"][0, 0]) for _ in range(2)]
    it.close()
    seen += [int(next(pipe)["tokens"][0, 0]) for _ in range(3)]
    pipe.close()
    if seen != [0, 8, 16, 24, 32]:
        fail(f"prefetch to device: the early stop did not rewind the "
             f"datapipe stage past the buffered batches: {seen}")
    # the data wait a batch: a step of ~5 ms of device work behind each
    # batch; a blocking upload waits for the card's queue, the prefetch
    # does not
    cycles = 10_000_000     # ~5 ms of spin at the H100's ~2 GHz

    def loop(prefetching):
        source = iter(host)
        it = prefetch_to_device(source, size=2, device=device) \
            if prefetching else (torch.from_numpy(h).to(device)
                                 for h in source)
        waits = []
        torch.cuda.synchronize()
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            waits.append(time.perf_counter() - t0)
            torch.cuda._sleep(cycles)
            batch.sum()
        torch.cuda.synchronize()
        return waits[2:]

    turns = {"with": [], "without": []}
    for _ in range(rounds):
        for kind in ("with", "without", "without", "with"):
            turns[kind] += loop(kind == "with")
    wait = {kind: percentile(values, 50) * 1e3
            for kind, values in turns.items()}
    print(f"prefetch to device: {batches} [16, 1024] int32 batches "
          f"bit-equal to the host's on cuda:0; an early stop after 2 of a "
          f"size-2 buffer rewound the datapipe stage to the last delivered "
          f"batch (docs {seen}); data wait a batch behind ~5 ms of device "
          f"work, p50 in turns (with, without, without, with) x {rounds}: "
          f"{wait['with']:.3f} ms with the prefetch, {wait['without']:.3f} "
          f"ms with a blocking upload [{card}]", flush=True)


# ----------------------------------------------------------------------
# queue A items 6 and 11: the vision models, the GAN loss, seq2seq and
# the basic, cifar, mlm and translate examples
# ----------------------------------------------------------------------
MODELS_TOL = 1e-4          # f32: the card against the CPU, flash vs dense
MODELS_F64_TOL = 1e-5      # f64 on the card against the CPU (f32 head)
VIT_BF16_TOL = 2e-2        # bf16 ViT logits, flash vs dense, of max |logit|
CIFAR_BATCH = 256
CIFAR_ARGS = ["model=resnet18", f"batch_size={CIFAR_BATCH}", "max_batches=12"]
# the synthetic set's train and valid images: 12 and 4 batches (cut from
# 24 for the time the pipeline phases add)
CIFAR_SIZES = (12 * CIFAR_BATCH, 4 * CIFAR_BATCH)
MLM_STEP = dict(vocab_size=32768, dim=512, num_layers=2, num_heads=8,
                mlp_ratio=4, max_seq_len=512, causal=False)
MLM_STEP_SHAPE = (2, 512)
TRANSLATE_STEP = dict(vocab_size=16384, dim=512, enc_layers=2, dec_layers=2,
                      num_heads=8, mlp_ratio=4, max_seq_len=128)
TRANSLATE_STEP_SHAPE = (4, 64)
TRAIN_RUN = ["epochs=1", "steps_per_epoch=8", "valid_steps=2"]


class StopRun(Exception):
    """Raised by a patched `commit` to stop a run after an epoch."""


def stop_after(solver_class, epochs):
    """Patch `solver_class.commit` to raise StopRun once `epochs` epochs
    are committed; returns the original to put back."""
    commit = solver_class.commit

    def commit_then_stop(self, save_checkpoint=True):
        commit(self, save_checkpoint=save_checkpoint)
        if len(self.history) == epochs:
            raise StopRun()

    solver_class.commit = commit_then_stop
    return commit


def worst_rel(torch, got, want):
    """(largest rel_err over the tensors of two dicts, its key)."""
    return max((rel_err(got[key].float().cpu(), value.float().cpu()), key)
               for key, value in want.items())


def resnet_step(torch, model, images, labels):
    """Train-mode logits, the loss's gradients and the updated statistics
    of one forward and backward of `model`, by name."""
    model.zero_grad(set_to_none=True)
    logits = model(images, train=True)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    return {"logits": logits.detach(),
            **{f"grad {n}": p.grad for n, p in model.named_parameters()},
            **{f"stat {n}": b.detach().clone()
               for n, b in model.named_buffers()}}


def vit_step(torch, model, images, labels):
    """Logits and the loss's gradients of `model`, with its launches."""
    from flashy_tpu_torch.ops import attention
    attention.reset_launch_counts()
    model.zero_grad(set_to_none=True)
    logits = model(images)
    torch.nn.functional.cross_entropy(logits.float(), labels).backward()
    torch.cuda.synchronize()
    return ({"logits": logits.detach(),
             **{f"grad {n}": p.grad for n, p in model.named_parameters()}},
            nonzero(attention.launch_counts))


def phase_models_step(torch, device, card):
    """Phase 47. Returns the ViT runs' flash launches by dtype."""
    import copy
    from flashy_tpu_torch.models import resnet18, resnet50, vit_tiny
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = []
    for label, factory, batch in (("ResNet-18", resnet18, 8),
                                  ("ResNet-50", resnet50, 4)):
        cpu = factory(num_classes=10, dtype=torch.float64, device="cpu",
                      seed=0)
        g = torch.Generator().manual_seed(batch)
        with torch.no_grad():
            # every norm away from the init's zero scales, so that every
            # gradient is exercised
            for name, param in cpu.named_parameters():
                if name.endswith(".scale"):
                    param.copy_(1.0 + 0.1 * torch.randn(param.shape,
                                                        generator=g))
        images = torch.randn(batch, 32, 32, 3, generator=g)
        labels = torch.randint(0, 10, (batch,), generator=g)
        got = {}
        for dtype in (torch.float64, torch.float32):
            on_card = copy.deepcopy(cpu).to(device)
            for module in on_card.modules():
                if getattr(module, "dtype", None) == torch.float64:
                    module.dtype = dtype
            got[dtype] = resnet_step(torch, on_card, images.to(device,
                                                                dtype),
                                     labels.to(device))
            torch.cuda.synchronize()
            del on_card
        want = resnet_step(torch, cpu, images.double(), labels)
        worst64 = worst_rel(torch, got[torch.float64], want)
        # in f32 the forward holds at the bar; the gradients of ResNet-50
        # at batch 4 (its last stage normalizes 64 values a channel) are
        # ill-conditioned: f32 on the card and on the CPU each land
        # ~0.14 of max |value| from f64 there, so they are printed
        held = {key: value for key, value in want.items()
                if label == "ResNet-18" or not key.startswith("grad")}
        worst32 = worst_rel(torch, got[torch.float32], held)
        grads32 = worst_rel(torch, got[torch.float32], {
            k: v for k, v in want.items() if k.startswith("grad")})
        if not math.isfinite(worst64[0]) or worst64[0] > MODELS_F64_TOL:
            fail(f"models step: {label} f64 on the card against the CPU: "
                 f"{worst64[1]} rel err {worst64[0]} > {MODELS_F64_TOL}")
        if not math.isfinite(worst32[0]) or worst32[0] > MODELS_TOL:
            fail(f"models step: {label} f32 on the card against the CPU in "
                 f"f64: {worst32[1]} rel err {worst32[0]} > {MODELS_TOL}")
        parts.append(
            f"{label} b{batch} 32x32 train mode, logits, "
            f"{sum(k.startswith('grad') for k in want)} grads and "
            f"{sum(k.startswith('stat') for k in want)} statistics against "
            f"the CPU run in f64: the card in f64 within {worst64[0]:.2e} "
            f"({worst64[1]}; limit {MODELS_F64_TOL}), in f32 within "
            f"{worst32[0]:.2e} ({worst32[1]}; limit {MODELS_TOL}"
            + (f" on the logits and statistics; grads {grads32[0]:.2e}, "
               f"{grads32[1]}, not held)" if label == "ResNet-50" else ")"))
        del cpu
    g = torch.Generator().manual_seed(0)
    images = torch.rand(8, 32, 32, 3, generator=g).to(device)
    labels = torch.randint(0, 10, (8,), generator=g).to(device)
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        runs = {kind: vit_step(torch, vit_tiny(
            num_classes=10, attention=kind, dtype=dtype, device=device,
            seed=0), images, labels) for kind in ("flash", "dense")}
        (flash, counts), (dense, dense_counts) = runs["flash"], runs["dense"]
        route = "_general" if dtype == torch.float32 else ""
        want = {f"flash_fwd{route}": 6, f"flash_bwd_fused{route}": 6}
        if counts != want or dense_counts:
            fail(f"models step: vit_tiny {name} launches flash {counts}, "
                 f"dense {dense_counts}, expected {want} and none")
        if dtype == torch.float32:
            worst, key = worst_rel(torch, flash, dense)
            bar = MODELS_TOL
        else:
            worst, key = rel_err(flash["logits"], dense["logits"]), "logits"
            bar = VIT_BF16_TOL
        if not math.isfinite(worst) or worst > bar:
            fail(f"models step: vit_tiny {name} flash against dense: {key} "
                 f"rel err {worst} > {bar}")
        parts.append(f"vit_tiny {name} b8 (64 patches, one tile) flash "
                     f"against dense: {'logits and grads' if bar == MODELS_TOL else 'logits'}"
                     f" within {worst:.2e} of max |value| (worst {key}; "
                     f"limit {bar}), launches {counts}")
        launches[name] = counts
    print("models step: " + "; ".join(parts) + f" [{card}]", flush=True)
    return launches


def phase_cifar_train(torch, card, root):
    """Phase 48: the cifar example through `main`: ResNet-18 stopped after
    its second commit and resumed to epoch 3, then vit_tiny."""
    from flashy_tpu_torch.examples.cifar import solver as cifar_solver
    from flashy_tpu_torch.examples.cifar import train as cifar_train
    from flashy_tpu_torch.examples.cifar.data import _synthetic
    from flashy_tpu_torch.utils import percentile
    data = _synthetic(*CIFAR_SIZES) + (False,)
    load = cifar_train.load_cifar10
    train_step = cifar_solver.Solver.train_step
    spans = []

    def timed(self, batch):
        begin = time.perf_counter()
        out = train_step(self, batch)
        # the metric read right after waits for the step anyway
        torch.cuda.synchronize()
        spans.append((begin, time.perf_counter()))
        return out

    root = Path(root)
    args = CIFAR_ARGS + ["epochs=3", f"dora.dir={root / 'resnet18'}"]
    cifar_train.load_cifar10 = lambda root=None: data
    cifar_solver.Solver.train_step = timed
    commit = stop_after(cifar_solver.Solver, 2)
    try:
        torch.cuda.reset_peak_memory_stats()
        try:
            cifar_train.main(args)
            fail("cifar train: the first call was not stopped after epoch 2")
        except StopRun:
            pass
        cifar_solver.Solver.commit = commit
        history = json.loads((cifar_train.main.get_xp(args).folder
                              / "history.json").read_text())
        resumed = cifar_train.main(args)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vit = cifar_train.main(["model=vit_tiny", f"batch_size={CIFAR_BATCH}",
                                "max_batches=12", "epochs=1",
                                f"dora.dir={root / 'vit'}"])
    finally:
        cifar_solver.Solver.commit = commit
        cifar_solver.Solver.train_step = train_step
        cifar_train.load_cifar10 = load
    steps = CIFAR_SIZES[0] // CIFAR_BATCH
    if len(resumed.history) != 3 or resumed.history[:2] != history \
            or resumed.state["step"] != 3 * steps:
        fail(f"cifar train: the second call did not resume at epoch 3 with "
             f"epochs 1-2 unchanged ({len(resumed.history)} epochs, step "
             f"{resumed.state['step']})")
    losses = [e[s]["loss"] for e in resumed.history for s in e]
    if not all(math.isfinite(x) for x in losses):
        fail(f"cifar train: losses {losses} not finite")
    epochs = []
    for index, entry in enumerate(resumed.history):
        span = spans[index * steps:(index + 1) * steps]
        busy = sum(end - begin for begin, end in span)
        duration = entry["train"]["duration"]
        epochs.append(
            f"epoch {index + 1} {entry['train']['images_per_sec']:.1f} "
            f"images/s, step p50 "
            f"{percentile([e - b for b, e in span[2:]], 50) * 1e3:.2f} ms "
            f"(steps 3..{steps}), data wait "
            f"{max(duration - busy, 0.0) / duration:.3f} of the epoch, "
            f"valid acc {entry['valid']['acc']:.4f}")
    print(f"cifar train: ResNet-18 bf16 b{CIFAR_BATCH} on synthetic CIFAR-10 "
          f"({CIFAR_SIZES[0]} train, {CIFAR_SIZES[1]} valid images), "
          f"{steps} steps an epoch, stopped after its second commit and "
          f"resumed at epoch 3 with epochs 1-2 unchanged; "
          + "; ".join(epochs) + f"; peak memory {peak:.1f} GiB; vit_tiny "
          f"(dense attention) 12 steps {vit.history[0]['train']['images_per_sec']:.1f}"
          f" images/s, loss {vit.history[0]['train']['loss']:.4f} [{card}]",
          flush=True)


def phase_adversarial(torch, device, card, root, steps=20):
    """Phase 49: AdversarialLoss with MLP generator and discriminator."""
    from flashy_tpu_torch.adversarial import AdversarialLoss
    from flashy_tpu_torch.checkpoint import load_state, save_state
    from flashy_tpu_torch.models import MLP
    from flashy_tpu_torch.utils import percentile
    width, noise_dim, data_dim, batch = 256, 64, 32, 256
    gen = MLP([width, width, data_dim], in_features=noise_dim, device=device,
              seed=1)
    g_opt = torch.optim.Adam(gen.parameters(), lr=1e-4, betas=(0.5, 0.999))

    def adversary(seed):
        disc = MLP([width, width, 1], in_features=data_dim, device=device,
                   seed=seed)
        return AdversarialLoss(disc, torch.optim.Adam(
            disc.parameters(), lr=1e-4, betas=(0.5, 0.999))), disc

    adv, disc = adversary(2)
    g = torch.Generator(device=device).manual_seed(0)
    center = torch.linspace(-1.0, 1.0, data_dim, device=device)

    def draw():
        noise = torch.randn(batch, noise_dim, generator=g, device=device)
        return noise, center + 0.1 * torch.randn(batch, data_dim, generator=g,
                                                 device=device)

    d_ms, d_losses, g_losses = [], [], []
    for step in range(steps):
        noise, real = draw()
        fake = gen(noise)
        fake.retain_grad()
        g_opt.zero_grad(set_to_none=True)
        g_before = [p.detach().clone() for p in gen.parameters()]
        d_before = [p.detach().clone() for p in disc.parameters()]
        torch.cuda.synchronize()
        begin = time.perf_counter()
        d_losses.append(adv.train_adv(fake, real))
        torch.cuda.synchronize()
        d_ms.append((time.perf_counter() - begin) * 1e3)
        if fake.grad is not None \
                or any(p.grad is not None for p in gen.parameters()) \
                or not all(torch.equal(a, b) for a, b in
                           zip(g_before, gen.parameters())) \
                or all(torch.equal(a, b) for a, b in
                       zip(d_before, disc.parameters())):
            fail(f"adversarial: step {step}: train_adv reached the generator "
                 f"or left the discriminator unchanged")
        adv.optimizer.zero_grad(set_to_none=True)
        g_loss = adv(fake)
        g_loss.backward()
        if any(p.grad is not None for p in disc.parameters()) \
                or fake.grad is None:
            fail(f"adversarial: step {step}: the generator loss's backward "
                 f"reached the discriminator or missed the generator")
        g_opt.step()
        g_losses.append(g_loss.detach())
    values = [float(x) for x in d_losses + g_losses]
    if not all(math.isfinite(x) for x in values):
        fail(f"adversarial: losses not finite: {values}")
    path = Path(root) / "adv.th"
    save_state(adv.state_dict(), path)
    twin, twin_disc = adversary(3)
    twin.load_state_dict(load_state(path))
    noise, real = draw()
    fake = gen(noise).detach()
    got, again = adv.train_adv(fake, real), twin.train_adv(fake, real)
    same = torch.equal(got, again) and all(
        torch.equal(a, b) for a, b in zip(disc.parameters(),
                                          twin_disc.parameters()))
    if not same:
        fail(f"adversarial: the step after a state round trip differs from "
             f"its twin's ({float(got)} vs {float(again)})")
    print(f"adversarial: MLP generator {noise_dim}->{width}->{width}->"
          f"{data_dim} and discriminator {data_dim}->{width}->{width}->1, "
          f"b{batch}, {steps} steps: train_adv left the generator, its "
          f"grads and fake.grad untouched and moved D; the generator "
          f"loss's backward left every D .grad None; D loss "
          f"{values[0]:.4f} -> {values[steps - 1]:.4f}, G loss "
          f"{values[steps]:.4f} -> {values[-1]:.4f}; after a save_state / "
          f"load_state round trip the next D step bit-identical to its "
          f"twin's; D step p50 {percentile(d_ms[2:], 50):.3f} ms (steps "
          f"3..{steps}, host clock around a synchronized step) [{card}]",
          flush=True)


def phase_basic(torch, card, root):
    """Phase 50: the basic example to epoch 2, resumed to epoch 4, against
    an uninterrupted 4-epoch run."""
    from flashy_tpu_torch.examples.basic import train as basic
    root = Path(root)
    args = ["epochs=4"]
    whole = basic.main(args + [f"dora.dir={root / 'a'}"])
    commit = stop_after(basic.Solver, 2)
    try:
        try:
            basic.main(args + [f"dora.dir={root / 'b'}"])
            fail("basic: the first call was not stopped after epoch 2")
        except StopRun:
            pass
    finally:
        basic.Solver.commit = commit
    resumed = basic.main(args + [f"dora.dir={root / 'b'}"])

    def history(solver):
        return stripped(json.loads((solver.folder / "history.json")
                                   .read_text()))

    if len(history(whole)) != 4 or history(resumed) != history(whole):
        fail(f"basic: the resumed run's history {history(resumed)} is not "
             f"the uninterrupted run's {history(whole)}")
    unequal = [name for name, value in whole.model.state_dict().items()
               if not torch.equal(resumed.model.state_dict()[name], value)]
    if unequal:
        fail(f"basic: resumed weights differ: {unequal}")
    losses = [entry["train"]["loss"] for entry in whole.history]
    print(f"basic: MLP([1]) with Adam, stopped after its epoch-2 checkpoint "
          f"and resumed to epoch 4: the four history entries and the "
          f"weights bit-equal to an uninterrupted run in a fresh XP; train "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f} [{card}]", flush=True)


def mlm_step_batch(torch, device):
    """The MLM step's masked batch ([B, 3, T] on the card) and its count."""
    import numpy as np
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    from flashy_tpu_torch.examples.mlm.solver import mask_tokens
    vocab = MLM_STEP["vocab_size"]
    batch = mask_tokens(synthetic_token_stream(vocab)(*MLM_STEP_SHAPE, 0), 0,
                        False, 0.15, 0, vocab)
    packed = np.stack([batch["inputs"], batch["labels"],
                       batch["selected"].astype(np.int32)], axis=1)
    return (torch.from_numpy(packed).long().to(device),
            max(float(batch["selected"].sum()), 1.0))


def grads_of(torch, model, loss_fn):
    """(loss, {name: grad}, launches) of one backward of loss_fn(model)."""
    from flashy_tpu_torch.ops import attention
    attention.reset_launch_counts()
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    torch.cuda.synchronize()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            nonzero(attention.launch_counts))


def flash_against_dense(torch, label, runs, want):
    """Hold the flash run of `runs` ({kind: grads_of(...)}) to the dense
    one (loss and every gradient within MODELS_TOL) and its launches to
    `want`; returns (loss rel err, worst grad rel err, its name)."""
    (loss, grads, counts), (dense_loss, dense_grads, dense_counts) = (
        runs["flash"], runs["dense"])
    if counts != want or dense_counts:
        fail(f"{label}: launches flash {counts}, dense {dense_counts}, "
             f"expected {want} and none")
    loss_err = rel_err(loss, dense_loss)
    worst, key = max((rel_err(g, dense_grads[n]), n)
                     for n, g in grads.items())
    if not (math.isfinite(worst) and math.isfinite(loss_err)) \
            or max(worst, loss_err) > MODELS_TOL:
        fail(f"{label}: flash against dense: loss rel err {loss_err}, grads "
             f"{worst} ({key}), limit {MODELS_TOL}")
    return loss_err, worst, key


def phase_mlm_step(torch, device, card):
    """Phase 51. Returns the flash run's launches."""
    from flashy_tpu_torch.examples.mlm.solver import masked_loss
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    torch.backends.cuda.matmul.allow_tf32 = False
    packed, count = mlm_step_batch(torch, device)
    runs, models = {}, {}
    for kind in ("flash", "dense"):
        models[kind] = TransformerLM(TransformerConfig(
            **MLM_STEP, dtype=torch.float32, attention=kind), device=device,
            seed=0)
        runs[kind] = grads_of(torch, models[kind],
                              lambda m: masked_loss(m, packed, count))
    want = {"flash_fwd_general": MLM_STEP["num_layers"],
            "flash_bwd_fused_general": MLM_STEP["num_layers"]}
    loss_err, worst, key = flash_against_dense(torch, "mlm step", runs, want)
    inputs = packed[:, 0]
    changed = inputs.clone()
    changed[:, -1] = (changed[:, -1] + 1) % MLM_STEP["vocab_size"]
    with torch.no_grad():
        moved = float((models["flash"](inputs)[:, 0]
                       - models["flash"](changed)[:, 0]).abs().max())
    if not moved > 1e-4:
        fail(f"mlm step: the last token did not reach position 0 ({moved})")
    cfg = models["flash"].config
    print(f"mlm step: TransformerLM(causal=False) at the MLM width (dim "
          f"{cfg.dim}, {cfg.num_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}), {cfg.num_layers} layers, f32 "
          f"b{packed.shape[0]} t{packed.shape[2]}, masked "
          f"loss {float(runs['flash'][0]):.6f}: flash against dense loss "
          f"rel err {loss_err:.2e}, grads max rel err {worst:.2e} ({key}; "
          f"limit {MODELS_TOL}); changing the last token moves position "
          f"0's logits by {moved:.4f}; launches {want} a step [{card}]",
          flush=True)
    return want


def phase_mlm_train(torch, device, card, root):
    """Phase 52: the MLM config through `main`, then rows 1 and 4
    non-causal at its shapes. Returns (launches, times, errors)."""
    from flashy_tpu_torch.examples.mlm.solver import main as mlm_main
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    attention.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    solver = mlm_main(TRAIN_RUN + [f"dora.dir={root}"])
    torch.cuda.synchronize()
    launches = nonzero(attention.launch_counts)
    cfg = solver.cfg
    layers = cfg.model.num_layers
    want = {"flash_fwd": layers * (cfg.steps_per_epoch + cfg.valid_steps),
            "flash_bwd_fused": layers * cfg.steps_per_epoch}
    if launches != want:
        fail(f"mlm train: launches {launches}, expected {want}")
    entry = solver.history[0]
    if not all(math.isfinite(entry[s]["loss"]) for s in entry):
        fail(f"mlm train: losses not finite: {entry}")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.seq_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mlm train: TransformerLM(causal=False) {layers} layers, dim "
          f"{cfg.model.dim}, bf16 b{cfg.batch_size} t{cfg.seq_len}, "
          f"{cfg.steps_per_epoch} steps + {cfg.valid_steps} valid: train "
          f"loss {entry['train']['loss']:.4f}, valid "
          f"{entry['valid']['loss']:.4f}; tokens/s={tok_s:.1f}, step "
          f"p50={p50:.2f} ms (steps 3..{cfg.steps_per_epoch}), peak memory "
          f"{peak:.1f} GiB; launches {launches} ({layers} and {layers} a "
          f"training step) [{card}]", flush=True)
    del solver
    release_memory(torch)
    times, errors = time_flash(torch, device, card, H=8, D=64, B=16, T=512,
                               causal=False)
    return launches, times, errors


def translate_step_batch(torch, device):
    """The translate step's [B, 3, S] batch (src, tgt, BOS + tgt[:-1])."""
    import numpy as np
    from flashy_tpu_torch.examples.translate.solver import synthetic_pairs
    src, tgt = synthetic_pairs(TRANSLATE_STEP["vocab_size"])(
        *TRANSLATE_STEP_SHAPE, 0)
    dec_in = np.concatenate([np.ones((src.shape[0], 1), np.int32),
                             tgt[:, :-1]], axis=1)
    return torch.from_numpy(np.stack([src, tgt, dec_in], axis=1)).long().to(
        device)


def phase_translate_step(torch, device, card):
    """Phase 53. Returns {"step": the flash run's launches, "greedy": the
    greedy oracle's}."""
    from flashy_tpu_torch.examples.translate.solver import teacher_loss
    from flashy_tpu_torch.models.seq2seq import (Seq2SeqConfig,
                                                 Seq2SeqTransformer,
                                                 cached_translate,
                                                 greedy_translate)
    from flashy_tpu_torch.ops import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = translate_step_batch(torch, device)
    runs, models = {}, {}
    for kind in ("flash", "dense"):
        models[kind] = Seq2SeqTransformer(Seq2SeqConfig(
            **TRANSLATE_STEP, dtype=torch.float32, attention=kind),
            device=device, seed=0)
        runs[kind] = grads_of(torch, models[kind],
                              lambda m: teacher_loss(m, packed))
    layers = TRANSLATE_STEP["enc_layers"] + TRANSLATE_STEP["dec_layers"]
    want = {"flash_fwd_general": layers, "flash_bwd_fused_general": layers}
    loss_err, worst, key = flash_against_dense(torch, "translate step", runs,
                                               want)
    model = models["flash"]
    src = packed[:, 0]
    new = TRANSLATE_STEP_SHAPE[1]
    attention.reset_launch_counts()
    cached = cached_translate(model, src, max_new_tokens=new)
    cached_launches = nonzero(attention.launch_counts)
    attention.reset_launch_counts()
    greedy = greedy_translate(model, src, max_new_tokens=new)
    torch.cuda.synchronize()
    greedy_launches = nonzero(attention.launch_counts)
    enc, dec = TRANSLATE_STEP["enc_layers"], TRANSLATE_STEP["dec_layers"]
    if cached_launches != {"flash_fwd_general": enc} \
            or greedy_launches != {"flash_fwd_general": enc + new * dec}:
        fail(f"translate step: launches cached {cached_launches}, greedy "
             f"{greedy_launches}: expected the encoder's {enc} and, for "
             f"greedy, {dec} a decoder pass of each of {new} steps")
    ties = []
    with torch.no_grad():
        memory = model.encode(src)
        for row in range(src.shape[0]):
            diff = (cached[row] != greedy[row]).nonzero()
            if len(diff):
                t = int(diff[0])
                prefix = torch.cat([torch.ones(1, dtype=torch.long,
                                               device=device),
                                    greedy[row, :t]])[None]
                top = torch.topk(model.decode(prefix, memory[row:row + 1])
                                 [0, -1], 2).values
                margin = float(top[0] - top[1])
                if margin >= NEAR_TIE:
                    fail(f"translate step: cached_translate row {row} "
                         f"diverges from greedy_translate at {t} with top-2 "
                         f"margin {margin:.3e} >= {NEAR_TIE}")
                ties.append((row, t, margin))
    cfg = model.config
    print(f"translate step: Seq2SeqTransformer at the translate width (dim "
          f"{cfg.dim}, {cfg.num_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}), {enc}+{dec} layers, f32 b{src.shape[0]} src "
          f"{src.shape[1]}, loss {float(runs['flash'][0]):.6f}: flash against dense "
          f"self-attention loss rel err {loss_err:.2e}, grads max rel err "
          f"{worst:.2e} ({key}; limit {MODELS_TOL}); launches {want} a step "
          f"(encoder non-causal, decoder causal, one tile each); "
          f"cached_translate token-exact against greedy_translate on "
          f"{src.shape[0]} sequences of {new} tokens (near ties {ties}); launches cached "
          f"{cached_launches}, greedy {greedy_launches} [{card}]", flush=True)
    return {"step": want, "greedy": greedy_launches}


def phase_translate_train(torch, device, card, root):
    """Phase 54: the translate config through `main`, then rows 1 and 4 at
    its shapes, causal and not. Returns (launches, {causal: (times,
    errors)})."""
    from flashy_tpu_torch.examples.translate.solver import main as tr_main
    from flashy_tpu_torch.models import transformer
    from flashy_tpu_torch.ops import attention
    from flashy_tpu_torch.utils import percentile
    flash = transformer.flash_attention
    calls = {True: 0, False: 0}

    def counted(q, k, v, causal=False, **kwargs):
        calls[causal] += 1
        return flash(q, k, v, causal, **kwargs)

    attention.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    transformer.flash_attention = counted
    try:
        solver = tr_main(TRAIN_RUN + ["translate_every=1",
                                      f"dora.dir={root}"])
    finally:
        transformer.flash_attention = flash
    torch.cuda.synchronize()
    launches = nonzero(attention.launch_counts)
    cfg = solver.cfg
    enc, dec = cfg.model.enc_layers, cfg.model.dec_layers
    passes = cfg.steps_per_epoch + cfg.valid_steps
    # and one encoder pass of cached_translate, whose steps read plain
    want = {"flash_fwd": (enc + dec) * passes + enc,
            "flash_bwd_fused": (enc + dec) * cfg.steps_per_epoch}
    want_calls = {False: enc * (passes + 1), True: dec * passes}
    if launches != want or calls != want_calls:
        fail(f"translate train: launches {launches}, expected {want}; "
             f"calls by causal {calls}, expected {want_calls}")
    entry = solver.history[0]
    if not all(math.isfinite(entry[s]["loss"]) for s in entry):
        fail(f"translate train: losses not finite: {entry}")
    seconds = solver.step_seconds[2:]
    tok_s = cfg.batch_size * cfg.src_len * len(seconds) / sum(seconds)
    p50 = percentile(seconds, 50) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"translate train: Seq2SeqTransformer {enc}+{dec} layers, dim "
          f"{cfg.model.dim}, bf16 b{cfg.batch_size} src {cfg.src_len}, "
          f"{cfg.steps_per_epoch} steps + {cfg.valid_steps} valid: train "
          f"loss {entry['train']['loss']:.4f}, valid "
          f"{entry['valid']['loss']:.4f}, tok_acc "
          f"{entry['valid']['tok_acc']:.4f}, seq_acc "
          f"{entry['valid']['seq_acc']:.4f} (cached_translate); target "
          f"tokens/s={tok_s:.1f}, step p50={p50:.2f} ms (steps "
          f"3..{cfg.steps_per_epoch}), peak memory {peak:.1f} GiB; launches "
          f"{launches} ({enc + dec} and {enc + dec} a training step); flash "
          f"calls non-causal {calls[False]} (encoder), causal {calls[True]} "
          f"(decoder) [{card}]", flush=True)
    del solver
    release_memory(torch)
    timed = {causal: time_flash(torch, device, card, H=8, D=64, B=32, T=64,
                                causal=causal) for causal in (True, False)}
    return launches, timed


# ----------------------------------------------------------------------
# queue A item 10: the serving fleet
# ----------------------------------------------------------------------
FLEET_NEW = 16              # fleet exact: new tokens a request
# the site's 9th occurrence: engine0's 5th step (two members step in turn)
FLEET_KILL_CALL = 9
FLEET_WAL_STEPS = 30        # fleet exact: steps before the WAL crash
# fleet serve bf16: requests, prompt tokens, the shared system prefix
# (4 blocks; the first is the router's chain key), new tokens
FLEET_SERVE = (32, 128, 64, 128)


def fleet_counts_reset(engines):
    """Every engine's step counts and the paged launch counts set to 0."""
    from flashy_tpu_torch.ops import paged_decode
    for engine in engines:
        engine.step_counts = dict.fromkeys(engine.step_counts, 0)
    paged_decode.reset_launch_counts()


def fleet_reads(engines, label, name="paged_decode"):
    """Row 5 launched once per layer per step of `engines` together, and
    nothing else launched; returns the count."""
    from flashy_tpu_torch.ops import paged_decode
    reads = sum(e._cfg.num_layers * (e.step_counts["decode"]
                                     + e.step_counts["prefill_chunk"]
                                     + e.step_counts["verify"])
                for e in engines)
    counts = nonzero(paged_decode.launch_counts)
    if reads < 1 or counts != {name: reads}:
        fail(f"{label}: launches {counts}, the engines made {reads} "
             f"attention reads on {name}")
    return reads


def fleet_warm(engines):
    return [dict(e.compile_cache.stats()) for e in engines]


def fleet_compile_free(engines, warm, label):
    """Nothing built or captured after each build's own warm-up."""
    for engine, before in zip(engines, warm):
        after = engine.compile_cache.stats()
        if after["misses"] != before["misses"] or after["recompiles"]:
            fail(f"{label}: {engine.cache_scope} built or captured after "
                 f"its warm-up: {before} -> {after}")


def phase_fleet_demo(card):
    """`python -m flashy_tpu_torch.serve.fleet`'s five legs on the card as
    a user runs it (`main` with `--kernel fused`, the demo's default
    gates, in this process; the wal leg's SIGKILLed worker a second
    process on the card). Every gate passes. Returns this process's
    launches of the paged kernels (the demo's tiny model, head_dim 8,
    reads on the general route)."""
    import logging
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.serve.fleet.__main__ import logger, main
    records = LogRecords()
    logger.addHandler(records.handler)
    paged_decode.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = main(["--kernel", "fused"])
    finally:
        logger.removeHandler(records.handler)
    counts = nonzero(paged_decode.launch_counts)
    if rc:
        errors = [r.getMessage() for r in records.records
                  if r.levelno >= logging.ERROR]
        fail(f"fleet demo: python -m flashy_tpu_torch.serve.fleet --kernel "
             f"fused returned {rc}: " + " | ".join(errors))
    if not counts:
        fail("fleet demo: the engines launched no paged kernel")
    gates = [r.getMessage() for r in records.records
             if r.getMessage().startswith(("verified", "determinism",
                                           "raw log", "fleet.json",
                                           "worker dead"))]
    print(f"fleet demo: python -m flashy_tpu_torch.serve.fleet --kernel "
          f"fused on cuda (handoff, sticky, preempt, drill, wal; the wal "
          f"worker a second process on the card): exit 0 in "
          f"{time.perf_counter() - t0:.1f}s, launches in this process "
          f"{counts}; " + " | ".join(line[:140] for line in gates)
          + f" [{card}]", flush=True)
    return counts


def phase_fleet_exact(torch, device, card):
    """The 235M layout in f32 (TF32 off) on the `exact` workload, 16 new
    tokens, through a fleet of 2 members x 4 slots whose engine0 is killed
    at its 5th step (`fleet.engine_step`, strict), a DisaggregatedPair
    (2 prefill + 4 decode slots over one pool) and a WAL recovery in this
    process: every stream token-exact against `generate` (near ties
    reported), the pools conserved, row 5 launched once a layer a step,
    nothing built or captured after each build's warm-up. Returns the
    launches."""
    import types
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.resilience import chaos
    from flashy_tpu_torch.serve.compile_cache import CompileCache
    from flashy_tpu_torch.serve.fleet import (
        ENGINE_FAULT_SITE, DisaggregatedPair, QuotaManager, RequestWAL,
        ServingFleet, TenantQuota)
    from flashy_tpu_torch.serve.fleet.wal import WAL_NAME
    cfg = model_config(torch, torch.float32, 512)
    model = TransformerLM(cfg, device=device, seed=0)
    prompts = exact_workload(np.random.default_rng(0), cfg.vocab_size)
    refs = reference_streams(torch, model, prompts, FLEET_NEW, device)
    kw = dict(block_size=16, max_seq_len=512, kernel="fused", device=device)
    t0 = time.perf_counter()

    def build(**extra):
        # the members of one build share a compile cache: the warm-up
        # seals it after both warmed
        fleet = ServingFleet.build(
            model, engines=2, slots=4, compile_cache=CompileCache(
                device=device),
            quotas=QuotaManager(default=TenantQuota(len(prompts))),
            **kw, **extra)
        fleet.warmup()
        engines = [m.engine for m in fleet.members.values()]
        if fleet_warm(engines)[0]["recompiles"]:
            fail("fleet exact: a member's warm-up counted as a recompile")
        return fleet, engines

    def streams(label, outputs):
        served = [types.SimpleNamespace(uid=i, output=np.asarray(o))
                  for i, o in enumerate(outputs)]
        return check_streams(torch, model, prompts, served, FLEET_NEW,
                             device, f"fleet exact {label}", refs=refs)

    # the drill
    fleet, engines = build()
    warm = fleet_warm(engines)
    fleet_counts_reset(engines)
    handles = [fleet.submit(p, FLEET_NEW) for p in prompts]
    injector = chaos.install(strict=True)
    injector.fail_at(ENGINE_FAULT_SITE, call=FLEET_KILL_CALL)
    try:
        fleet.run()
    finally:
        chaos.uninstall()
    torch.cuda.synchronize()
    if fleet.deaths != ["engine0"] or fleet.reroutes < 1:
        fail(f"fleet exact drill: deaths {fleet.deaths}, reroutes "
             f"{fleet.reroutes}")
    ties = {"drill": streams("drill", [h.output for h in handles])}
    engines[1].pool.check()      # the dead engine is never touched again
    launches = {"drill": fleet_reads(engines, "fleet exact drill")}
    fleet_compile_free(engines, warm, "fleet exact drill")
    drill = (fleet.reroutes, engines[0].step_counts["decode"],
             engines[0].step_counts["prefill_chunk"])
    del fleet, engines

    # the handoff
    pair = DisaggregatedPair(model, prefill_slots=2, decode_slots=4, **kw)
    pair.warmup()
    engines = [pair.prefill, pair.decode]
    warm = fleet_warm(engines)
    fleet_counts_reset(engines)
    outputs = pair.serve(prompts, FLEET_NEW)
    torch.cuda.synchronize()
    ties["handoff"] = streams("handoff", [
        np.concatenate([p, np.asarray(o)]) for p, o in zip(prompts,
                                                           outputs)])
    pair.pool.check()
    if len(pair.handoffs) != len(prompts):
        fail(f"fleet exact handoff: {len(pair.handoffs)} handoffs for "
             f"{len(prompts)} requests")
    launches["handoff"] = fleet_reads(engines, "fleet exact handoff")
    fleet_compile_free(engines, warm, "fleet exact handoff")
    del pair, engines

    # the WAL: a fleet stops after FLEET_WAL_STEPS steps with nothing
    # more written; a fresh build replays the log
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / WAL_NAME
        first, engines = build(wal=RequestWAL(path))
        fleet_counts_reset(engines)
        for p in prompts:
            first.submit(p, FLEET_NEW)
        for _ in range(FLEET_WAL_STEPS):
            first.step()
        first.wal.close()
        torch.cuda.synchronize()
        before = fleet_reads(engines, "fleet exact wal (before the crash)")
        del first, engines
        fleet, engines = build(wal=RequestWAL(path))
        warm = fleet_warm(engines)
        fleet_counts_reset(engines)
        rec = fleet.recover_from_wal()
        fleet.run()
        fleet.wal.close()
        torch.cuda.synchronize()
        outputs = []
        for uid, prompt in enumerate(prompts):
            if uid in rec["completed"]:
                outputs.append(np.concatenate(
                    [prompt, rec["completed"][uid].generated]))
            elif uid in rec["recovered"] and rec["recovered"][uid].done:
                outputs.append(rec["recovered"][uid].output)
            else:
                fail(f"fleet exact wal: acknowledged uid {uid} lost")
        ties["wal"] = streams("wal", outputs)
        completes = [json.loads(line)["uid"] for line in
                     path.read_text().splitlines()
                     if json.loads(line)["t"] == "complete"]
        if sorted(completes) != list(range(len(prompts))):
            fail(f"fleet exact wal: completion records {sorted(completes)}")
        for engine in engines:
            engine.pool.check()
        launches["wal"] = before + fleet_reads(engines, "fleet exact wal")
        fleet_compile_free(engines, warm, "fleet exact wal")
        recovered = (len(rec["recovered"]), len(rec["completed"]))
        del fleet, engines
    total = sum(launches.values())
    print(f"fleet exact: 235M f32, {len(prompts)} exact-workload requests x "
          f"{FLEET_NEW} new, every stream token-exact vs generate through "
          f"the drill (2 x 4 slots, engine0 killed at its 5th step after "
          f"{drill[1]} decode and {drill[2]} prefill-slice calls, "
          f"{drill[0]} requests re-routed), the handoff "
          f"(2 prefill + 4 decode slots over one pool, {len(prompts)} "
          f"handoffs) and the WAL recovery ({recovered[0]} re-admitted, "
          f"{recovered[1]} served from the log after {FLEET_WAL_STEPS} "
          f"steps, one completion record a uid); near ties {ties}; "
          f"launches paged_decode=={total} == reads ({launches}); pools "
          f"conserved; no build or capture after any warm-up; "
          f"{time.perf_counter() - t0:.1f}s [{card}]", flush=True)
    return total


def fleet_prompts(rng, vocab):
    """fleet serve bf16's traffic: every second prompt starts with the
    shared system prefix."""
    import numpy as np
    n, length, shared, _ = FLEET_SERVE
    system = rng.integers(1, vocab, shared)
    return [np.concatenate([system, rng.integers(1, vocab, length - shared)])
            if i % 2 == 0 else rng.integers(1, vocab, length)
            for i in range(n)]


def timed_turn(torch, schedulers, submit, step):
    """Submit (inside the window) and step until every scheduler idles,
    each scheduler's step timed and each outer step timed; returns (the
    handles, the window's seconds, member step seconds, outer step
    seconds, the members' seconds inside each outer step)."""
    member, outer, inner = [], [], []
    for scheduler in schedulers:
        def timed(step=scheduler.step):
            begin = time.perf_counter()
            emitted = step()
            member.append(time.perf_counter() - begin)
            return emitted
        scheduler.step = timed
    t0 = time.perf_counter()
    handles = submit()
    while not all(s.idle for s in schedulers):
        mark, begin = len(member), time.perf_counter()
        step()
        outer.append(time.perf_counter() - begin)
        inner.append(sum(member[mark:]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for scheduler in schedulers:
        del scheduler.step
    return handles, seconds, member, outer, inner


def turn_line(label, tokens, seconds, steps, ttft, hits, reasons,
              outside, launches, card, extra=""):
    """One turn's line: `steps` {what: step seconds}, `outside` the host
    seconds of each fleet step outside its members' steps (or None)."""
    from flashy_tpu_torch.utils import percentile
    p50s = ", ".join(f"{what} {percentile(t, 50) * 1e3:.3f} ms over "
                     f"{len(t)}" for what, t in steps.items())
    host = "n/a" if outside is None else \
        f"{percentile(outside, 50) * 1e6:.1f}"
    print(f"fleet serve bf16 {label}: tokens/s={tokens / seconds:.1f} "
          f"({tokens} tokens in {seconds:.3f}s); step p50: {p50s}; ttft "
          f"p50={percentile(ttft, 50) * 1e3:.1f} ms p95="
          f"{percentile(ttft, 95) * 1e3:.1f} ms; prefix hit rate={hits:.3f}; "
          f"route reasons {reasons or 'n/a'}; host us a fleet step outside "
          f"its members' steps p50={host}; launches paged_decode={launches}"
          f" == reads{extra} [{card}]", flush=True)


def phase_fleet_serve(torch, device, card):
    """The 235M layout in bf16 through the Hopper kernel, in turns in one
    process: FLEET_SERVE's traffic (32 requests submitted at once, 128-
    token prompts, every second one opening with a 64-token system
    prefix, 128 new tokens) through (a) a sticky fleet of 2 x 8 slots,
    (a+wal) the same with a RequestWAL, (b) round-robin, (c) one engine of
    16 slots, (d) a DisaggregatedPair of 2 prefill + 8 decode slots. Each
    turn's tokens/s, step p50s, TTFT, prefix hit rate, route reasons,
    the fleet step's host time outside its members, and row 5 launches
    == reads; (d)'s handoff host us a request and its streams against
    (c)'s. Returns the launches."""
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.fleet import (
        DisaggregatedPair, QuotaManager, RequestWAL, ServingFleet,
        TenantQuota)
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    n, length, _, max_new = FLEET_SERVE
    cfg = model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    prompts = fleet_prompts(np.random.default_rng(3), cfg.vocab_size)
    kw = dict(block_size=16, max_seq_len=256, kernel="fused", device=device)
    t0 = time.perf_counter()
    total, rates, sticky = 0, {}, None

    def hit_rate(pools):
        return (sum(p.prefix_matched_tokens for p in pools)
                / max(1, sum(p.prefix_total_tokens for p in pools)))

    def ttft(handles):
        return [h.first_token_at - h.submitted_at for h in handles]

    for label, policy, wal in (("(a) sticky 2x8", "sticky", False),
                               ("(a+wal) sticky 2x8 with a RequestWAL",
                                "sticky", True),
                               ("(b) round_robin 2x8", "round_robin",
                                False)):
        with tempfile.TemporaryDirectory() as tmp:
            fleet = ServingFleet.build(
                model, engines=2, slots=8, policy=policy,
                quotas=QuotaManager(default=TenantQuota(n)),
                wal=RequestWAL(Path(tmp) / "requests.wal") if wal else None,
                **kw)
            fleet.warmup()
            engines = [m.engine for m in fleet.members.values()]
            warm = fleet_warm(engines)
            fleet_counts_reset(engines)
            handles, seconds, member, outer, inner = timed_turn(
                torch, [m.scheduler for m in fleet.members.values()],
                lambda: [fleet.submit(p, max_new) for p in prompts],
                fleet.step)
            fleet.run()   # the last reap
            if wal:
                fleet.wal.close()
        check_outputs(handles, [length + max_new] * n, cfg.vocab_size,
                      f"fleet serve bf16 {label}")
        if policy == "sticky" and not wal:
            sticky = handles
        launches = fleet_reads(engines, f"fleet serve bf16 {label}")
        fleet_compile_free(engines, warm, f"fleet serve bf16 {label}")
        total += launches
        tokens = n * max_new
        rates[label] = tokens / seconds
        extra = ""
        if wal:
            extra = (f"; durable admission costs "
                     f"{1 - rates[label] / rates['(a) sticky 2x8']:.3f} of "
                     f"(a)'s tokens/s")
        turn_line(label, tokens, seconds, {"member": member, "fleet": outer},
                  ttft(handles), hit_rate([e.pool for e in engines]),
                  dict(fleet.route_reasons),
                  [o - i for o, i in zip(outer, inner)], launches, card,
                  extra)
        del fleet, engines

    # (c) one engine of 16 slots
    engine = DecodeEngine(model, slots=16, cache_layout="paged", **kw)
    engine.warmup()
    warm = fleet_warm([engine])
    fleet_counts_reset([engine])
    scheduler = ContinuousBatchingScheduler(engine)
    one, seconds, member, outer, inner = timed_turn(
        torch, [scheduler], lambda: [scheduler.submit(p, max_new)
                                     for p in prompts],
        lambda: scheduler.step())
    check_outputs(one, [length + max_new] * n, cfg.vocab_size,
                  "fleet serve bf16 (c)")
    launches = fleet_reads([engine], "fleet serve bf16 (c)")
    fleet_compile_free([engine], warm, "fleet serve bf16 (c)")
    engine.pool.check()
    total += launches
    rates["(c)"] = n * max_new / seconds
    turn_line("(c) one engine of 16 slots", n * max_new, seconds,
              {"engine": member}, ttft(one), hit_rate([engine.pool]), {},
              None, launches, card,
              f"; (a) at {rates['(a) sticky 2x8'] / rates['(c)']:.3f} of "
              f"(c)'s tokens/s")
    del engine, scheduler

    # (d) the disaggregated pair
    pair = DisaggregatedPair(model, prefill_slots=2, decode_slots=8, **kw)
    pair.warmup()
    engines = [pair.prefill, pair.decode]
    warm = fleet_warm(engines)
    fleet_counts_reset(engines)
    firsts, decode_s = [], []
    prefill_chunk, decode = pair.prefill.prefill_chunk, pair.decode.decode

    def timed_chunk(*args):
        start, first = prefill_chunk(*args)
        if first is not None:
            firsts.append(time.perf_counter())
        return start, first

    def timed_decode():
        begin = time.perf_counter()
        out = decode()
        decode_s.append(time.perf_counter() - begin)
        return out

    pair.prefill.prefill_chunk, pair.decode.decode = timed_chunk, \
        timed_decode
    begin = time.perf_counter()
    outputs = pair.serve(prompts, max_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - begin
    del pair.prefill.prefill_chunk, pair.decode.decode
    pair.pool.check()
    launches = fleet_reads(engines, "fleet serve bf16 (d)")
    fleet_compile_free(engines, warm, "fleet serve bf16 (d)")
    total += launches
    differ = []
    for i, (prompt, out, handle) in enumerate(zip(prompts, outputs, one)):
        got = np.asarray(out)
        want = np.asarray(handle.generated)
        if not np.array_equal(got, want):
            first = int(np.nonzero(got != want)[0][0])
            margin = top2_margin(torch, model, handle.output[:len(prompt)
                                                             + first])
            differ.append((i, first, f"{margin:.3e}"))
    # (a)'s members decode at 8 slots as (d)'s decode engine does, (c) at
    # 16: the same weights in GEMMs of another shape
    same_as_a = sum(np.array_equal(np.asarray(out), h.generated)
                    for out, h in zip(outputs, sticky))
    handoff_us = 1e6 * sum(pair.handoff_seconds) / len(pair.handoff_seconds)
    if len(firsts) != n or any(len(o) != max_new for o in outputs):
        fail(f"fleet serve bf16 (d): {len(firsts)} first tokens, output "
             f"lengths {sorted({len(o) for o in outputs})}")
    turn_line("(d) disaggregated 2 prefill + 8 decode", n * max_new,
              seconds, {"decode": decode_s}, [t - begin for t in firsts],
              hit_rate([pair.pool]), {}, None, launches, card,
              f"; handoff host us a request {handoff_us:.1f} over "
              f"{len(pair.handoff_seconds)} handoffs; streams "
              f"bit-identical to (c)'s (16 slots): {n - len(differ)} of "
              f"{n}, differing (request, first position, top-2 margin "
              f"there) {differ}; to (a)'s (8 slots a member): "
              f"{same_as_a} of {n}")
    del pair, engines
    print(f"fleet serve bf16: {n} requests x prompt {length} (every second "
          f"opening with a {FLEET_SERVE[2]}-token system prefix) x "
          f"{max_new} new per turn, launches paged_decode={total} == reads "
          f"over the five turns; {time.perf_counter() - t0:.1f}s [{card}]",
          flush=True)
    return total


def main() -> None:
    import argparse
    # the processes the dp phases start run this script with these flags
    worker = sys.argv[1] if sys.argv[1:2] in (["--dp-rank"],
                                              ["--dp-train"]) else None
    if worker is None:
        parser = argparse.ArgumentParser(
            description="Chip smoke test of the PyTorch port on one H100.")
        parser.add_argument("--seed", type=int, default=0,
                            help="seed of the packed-train corpus (phase 41)")
        args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not (ROOT / "flashy_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no flashy_tpu_torch package: run from the root "
             f"of a checkout")
    sys.path.insert(0, str(ROOT))
    if worker == "--dp-rank":
        dp_rank_main(torch, sys.argv[2])
        return
    if worker == "--dp-train":
        dp_train_main(torch, sys.argv[1:])
        return
    device = torch.device("cuda")
    card = card_line()
    laps, last = {}, [time.perf_counter()]

    def lap(label):
        """The seconds since the previous lap, under `label`."""
        now = time.perf_counter()
        laps[label] = round(now - last[0], 1)
        last[0] = now

    seconds = build_all()
    print(f"build: all sources in {seconds:.1f}s on [{card}]", flush=True)
    check_sass(card)
    lap("build, sass")

    errors = check_kernels(torch, device, card)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_errors = check_flash_kernels(torch, device, card)
    ssd_errors = check_ssd_kernel(torch, device, card)
    gmm_errors = check_gmm_kernels(torch, device, card)
    ring_errors = check_ring_kernel(torch, device, card)
    lap("kernel checks")
    phase_exact(torch, device, card)
    phase_ssd_exact(torch, device, card)
    lap("exact, ssd exact")

    paged = {"paged_decode": phase_serve(
        torch, device, card, kv_dtype="model", requests_n=16,
        prompt_len=128, max_new=128, label="serve bf16",
        compare_eager=True),
        "paged_decode_int8": phase_serve(
            torch, device, card, kv_dtype="int8", requests_n=8,
            prompt_len=64, max_new=32, label="int8 bf16",
            compare_eager=True)}
    check_sampling(torch, device, card)
    check_capture_gc(torch, device, card)
    ssd_launches, ssd_timing = phase_ssd_serve(torch, device, card)
    lap("serve bf16, int8 bf16, sampling, ssd serve bf16")
    # the dense layout, hybrid stacks and speculative decoding
    release_memory(torch)
    phase_dense_exact(torch, device, card)
    lap("dense exact")
    phase_serve_dense(torch, device, card)
    lap("serve dense bf16")
    phase_hybrid_exact(torch, device, card)
    lap("hybrid exact")
    hybrid_launches, slab_copies = phase_hybrid_serve(torch, device, card)
    lap("hybrid serve bf16")
    phase_spec_exact(torch, device, card)
    lap("spec exact")
    spec_kernels, _ = phase_spec_serve(torch, device, card)
    lap("spec serve bf16")
    phase_serve_demo(card)
    lap("serve demo")
    release_memory(torch)
    phase_step(torch, device, card)
    moe_step = phase_moe_step(torch, device, card)
    with tempfile.TemporaryDirectory() as folder:
        train_counts, solver, train_p50 = phase_train(torch, card, folder)
        profile_train(torch, solver, card,
                      watch=("flash_fwd_kernel", "flash_bwd"))
        del solver
    time_head(torch, device, card)
    flash_times, main_errors = time_flash(torch, device, card)
    # f32 at head_dim 64 takes the general route: its times at `step`'s
    # shapes
    time_flash(torch, device, card, B=2, T=256, dtype=torch.float32)
    lap("step, moe step, train, profile train, head and flash times")
    with tempfile.TemporaryDirectory() as folder:
        gmm_launches, solver = phase_moe_train(torch, card, folder)
        profile_train(torch, solver, card, steps=3,
                      label="profile moe train", watch=GMM_WATCH)
        del solver
    gmm_times, gmm_main_errors = time_gmm(torch, device, card)
    ep_slab, ep_slab_err = ep_slab_check(torch, device, card)
    lap("moe train, profile moe train, gmm times, ep slab")
    phase_ring_step(torch, device, card)
    with tempfile.TemporaryDirectory() as folder:
        ring_counts, solver = phase_ring_train(torch, card, folder)
        profile_train(torch, solver, card, steps=3,
                      label="profile ring train",
                      watch=("ring_fwd_kernel", "flash_bwd"))
        del solver
    ring_times, ring_main_error, pair_times, pair_errors = time_ring(
        torch, device, card)
    lap("ring step, ring train, profile ring train, ring times")

    # the other widths' full-width paths: d128, ssd n128, w260
    for bs, max_seq_len, chunk in ((16, 512, None), (128, 512, 16),
                                   (12, 504, None)):
        phase_exact(torch, device, card, heads=D128_HEADS, block_size=bs,
                    max_seq_len=max_seq_len, chunk=chunk,
                    label=f"exact d128 block {bs}")
    paged_general = {"paged_decode_general": phase_serve(
        torch, device, card, kv_dtype="model", requests_n=16,
        prompt_len=128, max_new=128, label="serve d128 bf16",
        heads=D128_HEADS),
        "paged_decode_int8_general": phase_serve(
            torch, device, card, kv_dtype="int8", requests_n=8,
            prompt_len=64, max_new=32, label="int8 d128 bf16",
            heads=D128_HEADS)}
    block_times, block_error = time_paged_block(torch, device, card)
    lap("exact d128, serve d128, int8 d128, paged block times")
    ssd_fma_launches, ssd_fma_times, ssd_fma_error = phase_ssd_n128(
        torch, device, card)
    step_d128_counts = phase_step(torch, device, card, heads=D128_HEADS,
                                  label="step d128")
    ring_general_counts = phase_ring_step(torch, device, card,
                                          heads=D128_HEADS,
                                          label="ring step d128")
    with tempfile.TemporaryDirectory() as folder:
        d128_counts = phase_train_d128(torch, card, folder)
    with tempfile.TemporaryDirectory() as folder:
        ring_d128_counts, solver = phase_ring_train(
            torch, card, folder, heads=D128_HEADS, steps=4, valid=1,
            label="ring train d128")
        del solver
    lap("ssd n128, step d128, ring step d128, train d128, ring train d128")
    # the Hopper kernels at 128 at the train d128 and ring train d128
    # shapes; the general route at the step d128 shapes (f32), and in bf16
    # at D 80 beside SDPA there
    d128_times, d128_errors = time_flash(torch, device, card, H=D128_HEADS,
                                         D=128)
    ring_128_times, ring_128_error, pair_128_times, pair_128_errors = \
        time_ring(torch, device, card, H=D128_HEADS, D=128)
    general_times, general_main_errors = time_flash(
        torch, device, card, H=D128_HEADS, D=128, B=2, T=256,
        dtype=torch.float32)
    time_flash(torch, device, card, H=D128_HEADS, D=80)
    ring_general_times, ring_general_main_error = time_ring_general(
        torch, device, card)
    # the general route above one head-dim slab: bf16 at D 576
    wide_b, wide_h, wide_t, wide_d = FLASH_WIDE
    wide_times, wide_errors = time_flash(torch, device, card, B=wide_b,
                                         H=wide_h, T=wide_t, D=wide_d)
    ring_wide_times, ring_wide_error = time_ring_general(
        torch, device, card, H=wide_h, D=wide_d, B=wide_b, t=128,
        dtype=torch.bfloat16)
    w260_counts = phase_step_w260(torch, device, card)
    padded_times, padded_errors = time_gmm_padded(torch, device, card)
    lap("the other widths' kernel times, step w260")

    # the LM trainer's switches and SSD training
    phase_remat_step(torch, device, card)
    with tempfile.TemporaryDirectory() as folder:
        phase_train_ema(torch, card, folder)
    lap("remat step, train ema")
    ssd_step_counts = phase_ssd_step(torch, device, card)
    ssd_train_counts, ssd_train_p50 = phase_ssd_train(torch, device, card)
    ssd_backward = time_ssd_backward(torch, device, card)
    lap("ssd step, ssd train")

    # the model layouts of queue A item 3's L7 and L8: MoE blocks,
    # scan-stacked stacks and int8 weights
    release_memory(torch)
    moe_exact = phase_moe_exact(torch, device, card)
    lap("moe exact")
    moe_serve = phase_moe_serve(torch, device, card)
    lap("moe serve bf16")
    scan_paged, scan_ssd = phase_scan_exact(torch, device, card)
    lap("scan exact")
    scan_step = phase_scan_step(torch, device, card)
    lap("scan step")
    with tempfile.TemporaryDirectory() as folder:
        scan_train = phase_scan_train(torch, card, folder, train_p50)
    lap("scan train")
    int8w_exact = phase_int8w_exact(torch, device, card)
    lap("int8w exact")
    int8w_serve = phase_int8w_serve(torch, device, card)
    lap("int8w serve bf16")

    # queue A item 3's L4-L6 and item 9's observability half: request
    # tracing, the SLO engine, the chaos fault points, the serve status
    # file, training telemetry
    release_memory(torch)
    check_roofline_graphs(torch, device, card)
    traced_launches = phase_serve_traced(torch, device, card)
    lap("serve traced")
    chaos_launches = phase_serve_chaos(torch, device, card)
    lap("serve chaos")
    release_memory(torch)
    with tempfile.TemporaryDirectory() as folder:
        telemetry_launches = phase_train_telemetry(torch, device, card,
                                                   folder)
    lap("train telemetry")

    # item 9's resilience half: the preemption guard, A/B slots,
    # asynchronous saves, the hang watchdog and the chaos drill
    release_memory(torch)
    with tempfile.TemporaryDirectory() as folder:
        clean, spread, preempt_launches = phase_train_preempt(torch, card,
                                                              folder)
    lap("train preempt")
    with tempfile.TemporaryDirectory() as folder:
        slots_launches, slot_commits = phase_train_slots(
            torch, card, folder, clean, spread)
    lap("train slots")
    with tempfile.TemporaryDirectory() as folder:
        async_launches = phase_train_async(torch, card, folder, clean,
                                           spread, slot_commits)
    lap("train async")
    del clean

    # queue A entry 1: the streaming datapipe (its drill, packed SSD
    # training at full width: row 7 on packed batches) and item 9's
    # chaos campaign
    release_memory(torch)
    # queue A item 8c: `pipe train`'s one-process oracle (the 12 layers
    # whole, ~22 GiB) runs beside these phases, not beside the four
    # two-rank runs of the dp group; its runs and the pipe bench come
    # later, all checked after the other families' phases
    pipe_folder = tempfile.TemporaryDirectory()
    pipe_oracle = start_pipe_oracle(pipe_folder.name)
    with tempfile.TemporaryDirectory() as folder:
        packed = phase_packed_train(torch, device, card, folder, args.seed,
                                    ssd_train_p50)
    lap("packed train")
    with tempfile.TemporaryDirectory() as folder:
        # phase 38 beside phases 39, 40 and 42 (its latency is the
        # child's own, read when it ends)
        hang = start_hang_abort(folder)
        phase_modules(card)
        hang_launches = phase_hang_abort(card, hang)
    lap("drill, datapipe drill, campaign, hang abort")

    # queue A item 5: data parallelism across processes, two ranks sharing
    # the card over gloo (NCCL refuses two ranks on one device)
    release_memory(torch)
    with tempfile.TemporaryDirectory() as train_folder:
        # queue A item 8a's runs go beside item 5's: the zero bench and
        # `fsdp train`'s run B1 beside `dp collectives` and `dp step`,
        # its run A beside `dp train`'s A, its resumed run B beside B2
        zero = start_zero_bench(Path(train_folder) / "zero")
        fsdp_b1 = start_fsdp_b1(train_folder)
        # queue A item 8b's: the tp bench beside `dp collectives`, `tp
        # train`'s run B1 beside `dp step`, A and the resumed B beside
        # `dp train`'s A and B2
        tp_bench = start_tp_bench(Path(train_folder) / "tensor")
        # queue A item 8d's `ep step` beside them too
        ep_step = start_dp_ranks("ep_step", train_folder, 300)
        # queue A item 8c's: `pipe train`'s run B1 beside `dp step`, A and
        # the resumed B beside `dp train`'s A and B2
        with tempfile.TemporaryDirectory() as folder:
            phase_dp_collectives(torch, card, folder)
        lap("dp collectives (and zero bench, fsdp train B1, tp bench)")
        # `dp train`'s run B1 (its first epoch, untimed) beside `dp step`
        b1 = start_dp_train_run(Path(train_folder) / "b", 1, "dp train B1")
        tp_b1 = start_tp_b1(train_folder)
        pipe_b1 = start_pipe_b1(pipe_folder.name)
        with tempfile.TemporaryDirectory() as folder:
            dp_step_launches = phase_dp_step(torch, card, folder)
        lap("dp step (and dp train B1, zero bench, fsdp train B1, tp train "
            "B1, pipe train B1)")
        phase_ep_step(card, ep_step, moe_step)
        lap("ep step")
        phase_zero_bench(card, zero)
        lap("zero bench")
        tp_record = phase_tp_bench(card, tp_bench)
        lap("tp bench")
        dp_train_launches, dp_summary, (fsdp_a, tp_a, pipe_a), \
            (fsdp_b2, tp_b2, pipe_b2) = phase_dp_train(
                torch, device, card, train_folder, b1,
                lambda: (start_fsdp_a(train_folder), start_tp_a(train_folder),
                         start_pipe_a(pipe_folder.name)),
                lambda: (start_fsdp_b2(train_folder, fsdp_b1),
                         start_tp_b2(train_folder, tp_b1),
                         start_pipe_b2(pipe_folder.name, pipe_b1)))
        lap("dp train (and fsdp train A, B2, tp train A, B2, pipe train A, "
            "B2)")
        fsdp_train_launches = phase_fsdp_train(torch, card, train_folder,
                                               (fsdp_a, fsdp_b2), dp_summary)
        lap("fsdp train")
        tp_train_launches, _ = phase_tp_train(torch, card, train_folder,
                                              (tp_a, tp_b2), dp_summary)
    lap("tp train")
    release_memory(torch)
    # the pipe bench beside the other families' phases; queue A item 8d:
    # `ep train`'s runs A and B1 there too, its resumed run B2 and its
    # oracle as soon as B1 ends (a thread waits for it), all checked
    # after `pipe train`
    pipe_bench = start_pipe_bench(Path(pipe_folder.name) / "pipeline")
    ep_folder = tempfile.TemporaryDirectory()
    ep_a, ep_b1 = start_ep_a(ep_folder.name), start_ep_b1(ep_folder.name)
    ep_pool = ThreadPoolExecutor(1)
    ep_later = ep_pool.submit(lambda: (start_ep_b2(ep_folder.name, ep_b1),
                                       start_ep_oracle(ep_folder.name)))
    phase_prefetch_to_device(torch, device, card)
    lap("prefetch to device")
    # queue A items 6 and 11: the vision models, the GAN loss, seq2seq
    # and their examples, driving rows 1 and 4 non-causal and at one tile
    release_memory(torch)
    vit_launches = phase_models_step(torch, device, card)
    lap("models step")
    with tempfile.TemporaryDirectory() as folder:
        phase_cifar_train(torch, card, folder)
    lap("cifar train")
    with tempfile.TemporaryDirectory() as folder:
        phase_adversarial(torch, device, card, folder)
    lap("adversarial")
    with tempfile.TemporaryDirectory() as folder:
        phase_basic(torch, card, folder)
    lap("basic")
    release_memory(torch)
    mlm_step_launches = phase_mlm_step(torch, device, card)
    lap("mlm step")
    with tempfile.TemporaryDirectory() as folder:
        mlm_launches, mlm_times, mlm_errors = phase_mlm_train(
            torch, device, card, folder)
    lap("mlm train")
    release_memory(torch)
    translate_step = phase_translate_step(torch, device, card)
    lap("translate step")
    with tempfile.TemporaryDirectory() as folder:
        translate_launches, translate_times = phase_translate_train(
            torch, device, card, folder)
    lap("translate train")
    phase_pipe_bench(card, pipe_bench)
    pipe_train_launches = phase_pipe_train(
        torch, card, pipe_folder.name, (pipe_oracle, pipe_a, pipe_b2))
    pipe_folder.cleanup()
    lap("pipe bench, pipe train (the bench beside the other families' "
        "phases, the oracle beside packed train and the drills)")
    ep_b2, ep_oracle = ep_later.result()
    ep_pool.shutdown()
    ep_gmm = phase_ep_train(torch, device, card, ep_folder.name,
                            (ep_a, ep_b2, ep_oracle))
    ep_folder.cleanup()
    lap("ep train (its runs and oracle beside the other families' "
        "phases)")
    # queue A item 10: the serving fleet, row 5 through its router,
    # handoff, drill and WAL paths
    release_memory(torch)
    fleet_demo_launches = phase_fleet_demo(card)
    lap("fleet demo")
    release_memory(torch)
    fleet_exact_launches = phase_fleet_exact(torch, device, card)
    lap("fleet exact")
    release_memory(torch)
    fleet_serve_launches = phase_fleet_serve(torch, device, card)
    lap("fleet serve bf16")
    ft = sum(laps[k] for k in ("train preempt", "train slots",
                               "train async"))
    print(f"phase seconds: {json.dumps(laps)}; train preempt, train slots "
          f"and train async at {LAYERS} of 12 layers: {ft:.1f} s together "
          f"(hang abort runs beside the drills; the four took "
          f"{FT_SECONDS_AT_12_LAYERS} s at 12) [{card}]", flush=True)

    # the split pair runs every ring backward: its main path is `ring
    # train` (`ring train d128` at 128), so its rows take the launches,
    # times and errors of the ring's pairs (the split run of `step` and
    # `ring step` check it too)
    split = ("flash_bwd_dq", "flash_bwd_dkv")
    flash_launches = {**train_counts,
                      **{name: ring_counts[name] for name in split}}
    flash_times.update({name: pair_times[name] for name in split})
    main_errors.update({name: pair_errors[name] for name in split})
    # at 128: the forward and fused backward from `train d128`, the split
    # pair from `ring train d128`; the general route: the forward and fused
    # backward from `step d128`'s fused run, the split pair from `ring step
    # d128` (f32 takes it at every head dim)
    for name in ("flash_fwd_128", "flash_bwd_fused_128"):
        flash_launches[name] = d128_counts[name]
        flash_times[name], main_errors[name] = d128_times[name], \
            d128_errors[name]
    for name in split:
        flash_launches[f"{name}_128"] = ring_d128_counts[f"{name}_128"]
        flash_times[f"{name}_128"] = pair_128_times[name]
        main_errors[f"{name}_128"] = pair_128_errors[name]
    for name in ("flash_fwd_general", "flash_bwd_fused_general"):
        flash_launches[name] = step_d128_counts[name]
    for name in split:
        flash_launches[f"{name}_general"] = ring_general_counts[
            f"{name}_general"]
    flash_times.update(general_times)
    main_errors.update(general_main_errors)
    paged.update(paged_general)
    keys = ("ms", "ms_runs", "spread", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "host_us")
    # the paged rows: T=1 (decode) at the top level, T=chunk (a prefill
    # chunk) under "chunk"; launches split the same way
    kernels = []
    for name in ("paged_decode", "paged_decode_int8", "paged_decode_general",
                 "paged_decode_int8_general"):
        launched, by_t, t1, tc = paged[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": PAGED_GENERAL_SOURCE
                        if name.endswith("_general") else PAGED_SOURCE,
                        "replaces": PAGED_REPLACES[
                            "quant" if "int8" in name else "dense"],
                        "launches": launched, "launches_by_T": by_t,
                        "max_abs_err": errors[name],
                        **{key: t1[key] for key in keys},
                        "chunk": {key: tc[key] for key in keys}})
        if name in spec_kernels:
            # the speculative verify step (T = SPEC_K + 1), `spec serve
            # bf16`: its launches by T and the kernel at that shape
            split, tv = spec_kernels[name]
            kernels[-1]["verify"] = {
                "launches": split[f"T={SPEC_K + 1} verify"],
                "launches_by_T": split, **{key: tv[key] for key in keys}}
    # the general route at one table entry of 16384 keys (head_dim 256)
    kernels[2]["one_block"] = {"shape": list(PAGED_BLOCK),
                               "max_abs_err": block_error,
                               **{key: block_times[key] for key in keys}}
    # the worst of the small cases (bf16 and f32) and of the main path's
    # shapes
    for route in (f"{name}{suffix}" for suffix in ("", "_128", "_general")
                  for name in FLASH_REPLACES):
        kernel = route.replace("_general", "").replace("_128", "")
        kernels.append({"name": route, "route": "cuda",
                        "source": FLASH_GENERAL_SOURCE
                        if route.endswith("_general") else FLASH_SOURCE,
                        "replaces": FLASH_REPLACES[kernel],
                        "launches": flash_launches[route],
                        "max_abs_err": max(
                            [main_errors[route]]
                            + [flash_errors[dt].get(route, 0.0)
                               for dt in flash_errors]),
                        **flash_times[route]})
        if route.endswith("_general"):
            # above one head-dim slab: bf16 at FLASH_WIDE
            kernels[-1]["d576"] = {"shape": list(FLASH_WIDE),
                                   "max_abs_err": wide_errors[route],
                                   **wide_times[route]}
    # the [1, 64] prefill slice at the top level, [8, 1024] under "long"
    slice_, long_ = (ssd_timing[shape] for shape in SSD_SHAPES)
    kernels.append({"name": "ssd_scan", "route": "cuda",
                    "source": SSD_SOURCE, "replaces": SSD_REPLACES,
                    "launches": ssd_launches,
                    "max_abs_err": max(ssd_errors["bfloat16"],
                                       slice_["max_abs_err"],
                                       long_["max_abs_err"]),
                    **{key: slice_[key] for key in keys},
                    "long": {"shape": list(SSD_SHAPES[1]),
                             **{key: long_[key] for key in keys}},
                    "hybrid_launches": hybrid_launches,
                    "hybrid_slab_copies": {
                        "ms": slab_copies["copies"]["ms"],
                        "bytes": slab_copies["bytes"],
                        "bound_ms": slab_copies["bound_ms"],
                        "slice_ms": slab_copies["slice_ms"]},
                    "train_launches": ssd_train_counts["ssd_scan"],
                    "train_backward_recomputes": ssd_train_counts[
                        "ssd_scan_backward"],
                    "train_backward": ssd_backward,
                    "packed_train": {
                        "launches": packed["launches"],
                        "backward_recomputes": packed[
                            "backward_recomputes"],
                        **{key: packed["check"][key] for key in (
                            "shape", "resets", "padded", "max_abs_err",
                            "state_rel_err", "ms", "ms_runs", "spread",
                            "bound_ms", "bound_by")}}})
    kernels.append({"name": "ssd_scan_fma", "route": "cuda",
                    "source": SSD_SOURCE, "replaces": SSD_REPLACES,
                    "launches": ssd_fma_launches,
                    "max_abs_err": max(ssd_errors["float32"], ssd_fma_error),
                    "shape": list(SSD_N128), **ssd_fma_times,
                    "train_launches": ssd_step_counts["ssd_scan_fma"]})
    # the main path's launches at its shapes and dtypes (the small cases'
    # errors, in every dtype form, are on the `gmm kernels` line); the
    # padded route's at the `step w260` layer
    for name, replaces in GMM_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": GMM_SOURCE,
                        "replaces": replaces,
                        "launches": gmm_launches[name],
                        "max_abs_err": gmm_main_errors[name],
                        **gmm_times[name]})
    # row 9a at `ep train`'s receiving slab, its empty slots after the
    # groups, beside the same products on the real rows alone
    next(k for k in kernels if k["name"] == "gmm")["ep_slab"] = {
        "shape": [32768, 1024, 4], "max_abs_err": ep_slab_err,
        **{f"{label}_ms": slab["ms"] for label, (slab, _) in ep_slab.items()},
        **{f"{label}_real_rows_ms": compact["ms"]
           for label, (_, compact) in ep_slab.items()}}
    for name in ("gmm_padded", "gmm_t_padded", "tgmm_padded"):
        kernels.append({"name": name, "route": "cuda", "source": GMM_SOURCE,
                        "replaces": GMM_REPLACES[name[:-len("_padded")]],
                        "launches": w260_counts[name],
                        "max_abs_err": max(gmm_errors[name[:-len("_padded")]],
                                           padded_errors[name]),
                        **padded_times[name]})
    # ring_attention: ms, plain_ms, bound_ms and library_ms of the four
    # ranks' launches of one layer at the training shapes together (per
    # rank on its line), ring_attention_128 at `ring train d128`'s;
    # ring_attention_general: at `ring step d128`'s
    for name, route, source, launches, main_error, times in (
            ("ring_attention", "ring_fwd", RING_SOURCE,
             ring_counts["ring_fwd"], ring_main_error, ring_times),
            ("ring_attention_128", "ring_fwd_128", RING_SOURCE,
             ring_d128_counts["ring_fwd_128"], ring_128_error,
             ring_128_times),
            ("ring_attention_general", "ring_fwd_general",
             FLASH_GENERAL_SOURCE, ring_general_counts["ring_fwd_general"],
             ring_general_main_error, ring_general_times)):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": RING_REPLACES, "launches": launches,
                        "max_abs_err": max([main_error] + [
                            ring_errors[dt].get(route, 0.0)
                            for dt in ring_errors]),
                        **times})
    kernels[-1]["d576"] = {"shape": [wide_b, 128, wide_h, wide_d],
                           "max_abs_err": ring_wide_error,
                           **ring_wide_times}
    # the launches of each kernel on the model layouts' paths, by phase
    layouts = {
        "paged_decode": {"moe exact": moe_exact, "moe serve bf16": moe_serve,
                         "scan exact": scan_paged,
                         "int8w exact": int8w_exact,
                         "serve traced": traced_launches,
                         "serve chaos": chaos_launches,
                         "fleet exact": fleet_exact_launches,
                         "fleet serve bf16": fleet_serve_launches},
        "paged_decode_int8": {"int8w serve bf16": int8w_serve},
        "ssd_scan": {"packed train": packed["launches"]},
        "ssd_scan_fma": {"scan exact ssd": scan_ssd},
        "flash_fwd": {"scan train": scan_train["flash_fwd"],
                      "train telemetry": telemetry_launches["flash_fwd"]},
        "flash_bwd_fused": {"scan train": scan_train["flash_bwd_fused"],
                            "train telemetry": telemetry_launches[
                                "flash_bwd_fused"]}}
    for name in ("flash_fwd", "flash_bwd_fused"):
        for phase, counts in (("train preempt", preempt_launches),
                              ("train slots", slots_launches),
                              ("train async", async_launches),
                              ("hang abort", hang_launches)):
            layouts[name][phase] = counts[name]
    for name in ("flash_fwd_general", "flash_bwd_fused_general", "gmm",
                 "gmm_t", "tgmm"):
        layouts[name] = {f"scan step {case}": counts[name]
                         for case, counts in scan_step.items()
                         if name in counts}
    # the expert-parallel path: a rank's launches (each of the two ranks
    # launches as many), rows 9a/9b through `ep_dropless_moe`
    for name in ("gmm", "gmm_t", "tgmm", "split_bf16"):
        layouts.setdefault(name, {})["ep train (a rank)"] = ep_gmm[name]
    # the data-parallel paths: a rank's launches (each of the two ranks
    # launches as many)
    for name in ("flash_fwd", "flash_bwd_fused"):
        layouts[name]["dp train (a rank)"] = dp_train_launches[name]
        layouts[name]["fsdp train (a rank)"] = fsdp_train_launches[name]
        layouts[name]["tp train (a rank, 8 heads)"] = tp_train_launches[name]
        layouts[name]["pipe train (a rank, 6 of 12 layers)"] = \
            pipe_train_launches[name]
    # the tp bench's parity gate: rows 2-4 (and 1) on the f32 route
    for name, count in tp_record["flash_bwd_parity_launches"].items():
        layouts.setdefault(name, {})["tp bench flash_bwd_parity"] = count
    for name in ("flash_fwd_general", "flash_bwd_fused_general"):
        layouts[name]["dp step (a rank)"] = dp_step_launches[name]
    # the vision models, the MLM and seq2seq paths (f32 steps on the
    # general route, bf16 runs on the Hopper kernels)
    for route, phase, counts in (
            ("", "models step vit bf16", vit_launches["bfloat16"]),
            ("_general", "models step vit f32", vit_launches["float32"]),
            ("_general", "mlm step", mlm_step_launches),
            ("", "mlm train", mlm_launches),
            ("_general", "translate step", translate_step["step"]),
            ("", "translate train", translate_launches)):
        for name in ("flash_fwd", "flash_bwd_fused"):
            layouts.setdefault(name + route, {})[phase] = counts[name + route]
    layouts["flash_fwd_general"]["translate greedy"] = translate_step[
        "greedy"]["flash_fwd_general"]
    # rows 1 and 4 at the MLM's and the translate model's shapes
    for name in ("flash_fwd", "flash_bwd_fused"):
        extra = {"mlm non-causal": ([16, 512, 8, 64], mlm_times, mlm_errors),
                 "translate causal": ([32, 64, 8, 64],) + translate_times[True],
                 "translate non-causal": ([32, 64, 8, 64],)
                 + translate_times[False]}
        record = next(k for k in kernels if k["name"] == name)
        for label, (shape, times, errors) in extra.items():
            record[label] = {"shape": shape, "max_abs_err": errors[name],
                             **{key: times[name][key] for key in keys}}
    # the fleet demo's tiny model (head_dim 8) reads on the general route
    for name, count in fleet_demo_launches.items():
        layouts.setdefault(name, {})["fleet demo"] = count
    for kernel in kernels:
        if kernel["name"] in layouts:
            kernel["layout_launches"] = layouts[kernel["name"]]
    print("kernels by route: " + ", ".join(
        f"{k['name']}={k['launches']}" for k in kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
