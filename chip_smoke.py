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
             pools (bf16, f32, int8 with f32 and bf16 q; T in {1, 4, 16,
             64}; block 16 over 512 keys and blocks 4, 16 and 64 over
             2048, which wrap its ring eight times; ragged,
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
             that take its time; then the same traffic through a twin
             engine with cuda_graphs=False: streams bit-identical,
             launches equal, its tokens/s and decode-step p50, and the
             host us of one decode step with graphs and eager; then two
             replays of the captured decode step at temperature 1.0 on
             the same inputs draw differently (the engine's generator is
             registered with the graph);
  8. int8    a short bf16 run with int8 K/V pools through the int8
             kernel: pool conserved, kernel launched on every read,
             kernel timed as in phase 7, graphs against eager as there;
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
 12. moe train  the MoE layout in bf16 at batch 16, seq 1024 through
             `main` with moe_dispatch=dropless in a fresh XP: 6 steps
             and 2 valid steps, the step loss finite and falling, the
             aux loss finite, gmm launched 12 x 2 x (train + valid
             steps) and gmm_t, tgmm and the split kernel 12 x 2 x train
             steps; tokens/s, step ms, peak memory; a profiled window of
             3 steps (the grouped kernels' device ms a step); then each
             grouped kernel's two launches of a layer at the training
             shapes, held against the plain version and timed three
             times (median and spread, device time, the split pass
             inside the f32-operand launches) beside the bound, the
             plain version and torch._grouped_mm, with the wrapper's
             host us a call; the split kernel alone on dY;
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
 19. train d128  the d128 layout in bf16 at batch 16, seq 1024 through
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
 22. train ema  `train`'s run with ema_decay 0.999, model.remat=true and
             remat_policy=dots through `main` in a fresh XP: the loss
             falls, valid runs on the f32 EMA shadow, which is not the
             live params; a resume restores the shadow bit-equal; a
             resume with ema_decay=0 drops it with the reference's
             warning; the flash forward launched 12 x (2 x train + valid
             steps), the fused backward 12 x train steps; tokens/s, step
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

The last two lines of standard output are the kernels' JSON record and
`{"ok": true, "device": {...}}`; the card's name and power limit come
before them.
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
                 num_heads=16, **kw):
    """The decode leg's 235M layout: vocab 32768, dim 1024, 12 layers,
    16 heads (head_dim 64), mlp_ratio 4; `num_heads=D128_HEADS` is the
    d128 layout (8 heads of 128, the same parameters)."""
    from flashy_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=32768, dim=1024, num_layers=12,
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


def check_kernels(torch, device, card=""):
    """Both routes of the paged read against the plain version on the
    card (and, in bf16, against the entry-by-entry reference) over
    PAGED_CASES x T in {1, 4, 16, 64} x the four variants; two launches on
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
            for T in (1, 4, 16, 64):
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
                  f"in (1, 4, 16, 64) max_abs_err={errors[counter]:.3e} vs "
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


def top2_margin(torch, model, stream):
    """f32 top-2 logit margin after `stream` (a prefill of the whole
    stream through the dense-cache step `generate` uses)."""
    from flashy_tpu_torch.models.decoding import (_apply_step,
                                                  decode_params, init_cache)
    cfg = model.config
    device = model.device
    tokens = torch.as_tensor(stream, device=device)[None]
    cache = init_cache(cfg, 1, tokens.shape[1], device)
    positions = torch.arange(tokens.shape[1], device=device)[None]
    with torch.no_grad():
        logits, _ = _apply_step(decode_params(model), cfg, tokens,
                                positions, cache, 0)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def serve(torch, engine, prompts, max_new):
    """Serve `prompts` through the scheduler with every launch count set
    to 0 just before; the engine's compile cache must make no new entry
    and no capture in the run (every step a replay of a graph `warmup()`
    captured, or, with cuda_graphs=False, an eager run of a warmed key).
    Returns (scheduler, requests, the launch counts of this run,
    seconds)."""
    from flashy_tpu_torch.ops import paged_decode, ssd_scan
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, max_new) for p in prompts]
    engine.step_counts = {"decode": 0, "prefill_chunk": 0}
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


def eager_twin(torch, model, engine, engine_kw, prompts, max_new, requests,
               counts, label, card):
    """The same traffic through a twin engine with cuda_graphs=False (the
    steps eager) on the same model: every stream bit-identical to the
    graphs' and the launch counts equal; prints both runs' tokens/s,
    decode-step p50 and host us a decode step. Returns the eager run's
    metrics summary."""
    import numpy as np
    from flashy_tpu_torch.serve.engine import DecodeEngine
    eager = DecodeEngine(model, cuda_graphs=False, **engine_kw)
    eager.warmup()
    e_scheduler, e_requests, e_counts, _ = serve(torch, eager, prompts,
                                                 max_new)
    for got, want in zip(requests, e_requests):
        if not np.array_equal(got.output, want.output):
            fail(f"{label}: request {got.uid}'s stream differs between "
                 f"graphs and eager")
    if nonzero(counts) != nonzero(e_counts):
        fail(f"{label}: launches with graphs {nonzero(counts)}, eager "
             f"{nonzero(e_counts)}")
    graphs = engine.compile_cache
    if not all(getattr(fn, "captured", False)
               for fn in graphs.executables().values()):
        fail(f"{label}: a step of the graph engine was not captured")
    host = {what: decode_host_us(torch, eng)
            for what, eng in (("graphs", engine), ("eager", eager))}
    e_summary = e_scheduler.metrics.summary()
    print(f"{label}: graphs vs eager: {len(requests)} streams bit-identical, "
          f"launches equal {nonzero(counts)}; eager tokens/s="
          f"{e_summary['tokens_per_sec']:.1f}, decode step p50="
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
                          device=device)
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


def check_streams(torch, model, prompts, requests, max_new, device, label):
    """Every request's output against the port's `generate`, token-exact
    up to near ties (top-2 f32 margin < NEAR_TIE at the first divergence,
    reported); returns the near ties."""
    import numpy as np
    from flashy_tpu_torch.models.decoding import generate
    ties = []
    for prompt, request in zip(prompts, requests):
        ref = generate(model, prompt[None], max_new_tokens=max_new,
                       device=device)[0].cpu().numpy()
        got = request.output
        if got.shape != ref.shape:
            fail(f"{label}: request {request.uid} output shape {got.shape} "
                 f"!= {ref.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            first = int(diff[0])
            margin = top2_margin(torch, model, ref[:first])
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
                  card):
    """Where the serving time goes: serve the same shape of work twice
    (fresh random prompts each time, so neither run hits the prefix
    cache), once plainly for the wall time and once under torch.profiler
    for the device time by kernel. Idle share = 1 - device busy / plain
    wall (the profiler's own host overhead stays out of the wall)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)

    def prompts():
        return [rng.integers(1, vocab, prompt_len) for _ in range(n_requests)]

    *_, wall_s = serve(torch, engine, prompts(), max_new)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(torch, engine, prompts(), max_new)
    rows = device_rows(torch, prof)
    busy_ms = sum(ms for ms, _, _ in rows)
    wall_ms = wall_s * 1e3
    top = "; ".join(f"{key[:40]} {ms:.1f} ms x{n}" for ms, n, key in rows[:6])
    ours = "; ".join(f"{name} {ms:.2f} ms x{n} ({ms / busy_ms:.3f} of "
                     f"busy)" for ms, n, key in rows
                     for name in ("paged_decode_kernel", "ssd_bf16_kernel",
                                  "ssd_fma_kernel")
                     if name in key)
    print(f"profile: {n_requests} requests x prompt {prompt_len} x "
          f"{max_new} new, plain wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"decode steps {engine.step_counts['decode']}, prefill chunks "
          f"{engine.step_counts['prefill_chunk']}; top: {top}; the path's "
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
                     kv_dtype=kv_dtype, device=device)
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
    returns (launch counts of the first call, the resumed solver)."""
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
    return counts, resumed


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


def time_flash(torch, device, card, H=16, D=64, B=16, T=1024, dtype=None):
    """Each flash kernel at [B, T, H, D] (causal; by default bf16 at the
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
    errors, share, out, _ = compare_flash(
        torch, q, k, v, do, True, f"flash {name} {where}")
    routes = {key: A.counter_name(key, D, dtype) for key in FLASH_REPLACES}
    print(f"flash {name} {where} causal: max abs err vs plain "
          + ", ".join(f"{routes[key]}={value:.3e}"
                      for key, value in errors.items())
          + f" (tolerance {FLASH_TOL[name]}, backward relative); vs "
          f"blockwise reference {share:.4f} of outputs differ (limit "
          f"{PLACEMENT_SHARE}), each within one ulp; fused == split "
          f"bitwise [{card}]", flush=True)
    del out
    out, lse = A.flash_forward(q, k, v, True)
    delta = A.flash_delta(do, out)
    args = (q, k, v, do, lse, delta, True)
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
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qh, kh, vh), doh, retain_graph=True))
    kernels = {
        "flash_fwd": (lambda: A.flash_forward(q, k, v, True),
                      lambda: A.flash_forward_blockwise(q, k, v, True),
                      sdpa_fwd),
        "flash_bwd_dq": (
            lambda: A._launch_backward(A._BWD_DQ, *args),
            lambda: A.flash_backward_dq_blockwise(*args), sdpa_bwd),
        "flash_bwd_dkv": (
            lambda: A._launch_backward(A._BWD_DKV, *args),
            lambda: A.flash_backward_dkv_blockwise(*args), sdpa_bwd),
        "flash_bwd_fused": (
            lambda: A.flash_backward_fused(*args), plain_fused, sdpa_bwd)}
    bounds = flash_bounds(B, H, T, D, q.element_size())
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
    print(f"flash times ({where} causal {name}): " + "; ".join(
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
        return model_config(torch, torch.float32, 256, "flash",
                            moe_experts=8, moe_top_k=2,
                            moe_capacity_factor=8.0, moe_dispatch=dispatch)

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


def phase_moe_train(torch, card, folder):
    """The 235M layout with every MLP 8 top-2 dropless experts, bf16, batch
    16, seq 1024, through `main` in a fresh XP: 1 epoch of 6 steps and 2
    valid steps. Returns (grouped-matmul launch counts, the solver)."""
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from flashy_tpu_torch.models.moe import moe_aux_loss
    from flashy_tpu_torch.ops import attention, grouped_matmul
    from flashy_tpu_torch.utils import percentile
    args = [a for a in TRAIN_ARGS if not a.startswith(("steps_per_epoch",
                                                       "valid_steps"))]
    args += MOE_ARGS + ["steps_per_epoch=6", "valid_steps=2", "epochs=1",
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
    args = [a for a in TRAIN_ARGS if not a.startswith("model.num_heads")]
    args += [f"model.num_heads={D128_HEADS}", "epochs=1",
             f"dora.dir={folder}"]
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
    print(f"train d128: 235M ({D128_HEADS} heads of {1024 // D128_HEADS}) "
          f"bf16 b{cfg.batch_size} t{cfg.seq_len}, {train_steps} steps + "
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
    args = TRAIN_ARGS + [f"dora.dir={folder}", "model.remat=true",
                         "model.remat_policy=dots", "epochs=2",
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
    print(f"train ema: 235M bf16 b16 t1024 ema_decay {EMA_DECAY}, remat "
          f"dots, {train_steps} steps + {valid_steps} valid, epoch losses "
          f"{losses[0]:.4f} -> {losses[1]:.4f}, tokens/s={tok_s:.1f}, step "
          f"p50={p50:.2f} ms (steps 3..{train_steps}), peak memory "
          f"{peak:.1f} GiB; valid on the shadow {on_shadow:.4f} (live params "
          f"{on_live:.4f}); resume: shadow bit-equal; ema_decay=0: dropped "
          f"with the warning; launches {counts}; EMA update {numel / 1e6:.1f}M"
          f" f32 {spread_text(ema)}, bound {ema_bound:.4f} ms "
          f"({ema_bytes / 1e9:.2f} GB at 3.35 TB/s) [{card}]", flush=True)
    return counts


def ssd_train_config(torch, dtype):
    """The pure-SSD 235M layout (state dim 16) as training takes it: the
    chunk `default_chunk(T)` picks (256 at T 256 and 1024)."""
    return model_config(torch, dtype, 1024, mixer="ssd", ssd_state_dim=16,
                        ssd_chunk=0)


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
    Returns the launch counts."""
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
    return counts


def main() -> None:
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
    device = torch.device("cuda")
    card = card_line()

    seconds = build_all()
    print(f"build: all sources in {seconds:.1f}s on [{card}]", flush=True)
    check_sass(card)

    errors = check_kernels(torch, device, card)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_errors = check_flash_kernels(torch, device, card)
    ssd_errors = check_ssd_kernel(torch, device, card)
    gmm_errors = check_gmm_kernels(torch, device, card)
    ring_errors = check_ring_kernel(torch, device, card)
    phase_exact(torch, device, card)
    phase_ssd_exact(torch, device, card)

    paged = {"paged_decode": phase_serve(
        torch, device, card, kv_dtype="model", requests_n=16,
        prompt_len=128, max_new=128, label="serve bf16",
        compare_eager=True),
        "paged_decode_int8": phase_serve(
            torch, device, card, kv_dtype="int8", requests_n=8,
            prompt_len=64, max_new=32, label="int8 bf16",
            compare_eager=True)}
    check_sampling(torch, device, card)
    ssd_launches, ssd_timing = phase_ssd_serve(torch, device, card)
    phase_step(torch, device, card)
    phase_moe_step(torch, device, card)
    with tempfile.TemporaryDirectory() as folder:
        train_counts, solver = phase_train(torch, card, folder)
        profile_train(torch, solver, card,
                      watch=("flash_fwd_kernel", "flash_bwd"))
        del solver
    time_head(torch, device, card)
    flash_times, main_errors = time_flash(torch, device, card)
    # f32 at head_dim 64 takes the general route: its times at `step`'s
    # shapes
    time_flash(torch, device, card, B=2, T=256, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as folder:
        gmm_launches, solver = phase_moe_train(torch, card, folder)
        profile_train(torch, solver, card, steps=3,
                      label="profile moe train", watch=GMM_WATCH)
        del solver
    gmm_times, gmm_main_errors = time_gmm(torch, device, card)
    phase_ring_step(torch, device, card)
    with tempfile.TemporaryDirectory() as folder:
        ring_counts, solver = phase_ring_train(torch, card, folder)
        profile_train(torch, solver, card, steps=3,
                      label="profile ring train",
                      watch=("ring_fwd_kernel", "flash_bwd"))
        del solver
    ring_times, ring_main_error, pair_times, pair_errors = time_ring(
        torch, device, card)

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

    # the LM trainer's switches and SSD training
    phase_remat_step(torch, device, card)
    with tempfile.TemporaryDirectory() as folder:
        phase_train_ema(torch, card, folder)
    ssd_step_counts = phase_ssd_step(torch, device, card)
    ssd_train_counts = phase_ssd_train(torch, device, card)
    ssd_backward = time_ssd_backward(torch, device, card)

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
                    "train_launches": ssd_train_counts["ssd_scan"],
                    "train_backward_recomputes": ssd_train_counts[
                        "ssd_scan_backward"],
                    "train_backward": ssd_backward})
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
    print("kernels by route: " + ", ".join(
        f"{k['name']}={k['launches']}" for k in kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
