#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, the CUDA
toolkit (`nvcc`) and PyTorch built for CUDA; it imports nothing of JAX
or of the JAX package. Phases, one line each, stopping at the first
failure with a non-zero exit:

  1. build   compile the serving path's kernel from
             flashy_tpu_torch/csrc with nvcc;
  2. kernel  the kernel against its plain PyTorch version on random
             pools (bf16, f32, int8; T in {1, 4, 16, 64}; ragged,
             sentinel-padded, all-sentinel and parked slots), and in
             bf16 against the entry-by-entry reference that rounds
             where the TPU kernel does: one bf16 ulp apart at most,
             and bit-equal almost everywhere;
  3. exact   the 235M TransformerLM in f32 (TF32 off) served through the
             paged engine and the continuous-batching scheduler, every
             stream token-exact against the port's dense-cache
             `generate` (a near tie, top-2 margin < 1e-5, is reported,
             not failed), the pool conserved, and the kernel launched
             exactly num_layers x (decode steps + prefill chunks) times;
  4. serve   the same layout in bf16 at the decode leg's shapes
             (8 slots, 16 requests, prompt 128, 128 new): tokens/s,
             decode-step ms, and the kernel's time at T=1 (decode) and
             T=16 (a prefill chunk) beside its bandwidth bound, its
             plain version and one library call; then a profiled
             serving window: the device's idle share and the kernels
             that take its time;
  5. int8    a short bf16 run with int8 K/V pools through the int8
             kernel: pool conserved, kernel launched, kernel timed.

The last two lines of standard output are the kernels' JSON record and
`{"ok": true, "device": {...}}`; the card's name and power limit come
before them.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NEAR_TIE = 1e-5
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def model_config(torch, dtype, max_seq_len):
    """The decode leg's 235M layout: vocab 32768, dim 1024, 12 layers,
    16 heads (head_dim 64), mlp_ratio 4."""
    from flashy_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=32768, dim=1024, num_layers=12,
                             num_heads=16, mlp_ratio=4,
                             max_seq_len=max_seq_len, dtype=dtype,
                             attention="dense")


# ----------------------------------------------------------------------
# phase 2: kernel against plain version
# ----------------------------------------------------------------------
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


def check_kernels(torch, device, card=""):
    """Kernel vs plain on the card (and, in bf16, vs the entry-by-entry
    reference); returns {variant: max_abs_err against plain}."""
    from flashy_tpu_torch.ops.paged_attention import paged_attention
    from flashy_tpu_torch.ops.paged_decode import (entrywise_paged_attention,
                                                   fused_paged_attention)
    errors = {}
    for q_dtype, kv in ((torch.float32, "model"), (torch.bfloat16, "model"),
                        (torch.float32, "int8"), (torch.bfloat16, "int8")):
        name = str(q_dtype).split(".")[1]
        label = name if kv == "model" else f"int8/{name}"
        worst = share = 0.0
        for T in (1, 4, 16, 64):
            q, entry, table, positions, live = random_case(
                torch, device, q_dtype=q_dtype, kv=kv, T=T, seed=T)
            args = (q, entry, table, positions)
            kw = {"head_dim": q.shape[-1], "dtype": q_dtype}
            got = fused_paged_attention(*args, **kw)[live].float()
            want = paged_attention(*args, **kw)[live].float()
            err = (got - want).abs().max().item()
            if not math.isfinite(err) or err > TOL[label]:
                fail(f"kernel {label} T={T}: max abs err {err} > "
                     f"{TOL[label]}")
            worst = max(worst, err)
            if q_dtype == torch.bfloat16:
                ref = entrywise_paged_attention(*args, **kw)[live].float()
                excess = ((got - ref).abs() - PLACEMENT_RTOL * ref.abs()
                          ).max().item()
                share_t = (got != ref).float().mean().item()
                if excess > PLACEMENT_ATOL or share_t > PLACEMENT_SHARE:
                    fail(f"kernel {label} T={T}: against the entry-by-entry "
                         f"reference {excess:.3e} over one ulp (limit "
                         f"{PLACEMENT_ATOL}), {share_t:.4f} of outputs "
                         f"differ (limit {PLACEMENT_SHARE})")
                share = max(share, share_t)
        errors[label] = worst
        placement = (f"; vs entry-by-entry reference: {share:.4f} of outputs "
                     f"differ (limit {PLACEMENT_SHARE}), each within one ulp"
                     if q_dtype == torch.bfloat16 else "")
        print(f"kernel {label}: T in (1, 4, 16, 64) max_abs_err={worst:.3e} "
              f"(tolerance {TOL[label]}){placement} [{card}]", flush=True)
    return errors


# ----------------------------------------------------------------------
# phase 3: token-exact serving in f32
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
    from flashy_tpu_torch.ops import paged_decode
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, max_new) for p in prompts]
    engine.step_counts = {"decode": 0, "prefill_chunk": 0}
    paged_decode.reset_launch_counts()
    t0 = time.perf_counter()
    scheduler.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(paged_decode.launch_counts)
    engine.pool.check()
    return scheduler, requests, counts, seconds


def phase_exact(torch, device, card=""):
    import numpy as np
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.float32, 512)
    model = TransformerLM(cfg, device=device, seed=0)
    engine = DecodeEngine(model, slots=8, block_size=16, max_seq_len=512,
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
    launched = counts["paged_decode"]
    if engine.kernel == "fused" and launched != reads:
        fail(f"exact: kernel launched {launched} times, engine made "
             f"{reads} attention reads")
    ties = []
    for prompt, request in zip(prompts, requests):
        ref = generate(model, prompt[None], max_new_tokens=max_new,
                       device=device)[0].cpu().numpy()
        got = request.output
        if got.shape != ref.shape:
            fail(f"exact: request {request.uid} output shape {got.shape} "
                 f"!= {ref.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            first = int(diff[0])
            margin = top2_margin(torch, model, ref[:first])
            if margin >= NEAR_TIE:
                fail(f"exact: request {request.uid} (prompt {len(prompt)}) "
                     f"diverges at position {first} with top-2 margin "
                     f"{margin:.3e} >= {NEAR_TIE}")
            ties.append((request.uid, first, margin))
    stats = engine.pool_stats()
    if stats["cow_forks"] < 1 or stats["prefix_hit_rate"] <= 0:
        fail(f"exact: workload made no prefix hit / COW fork: {stats}")
    print(f"exact: {len(requests)} requests token-exact vs generate "
          f"(near ties {ties}), launches={launched} == reads={reads}, "
          f"decode steps={engine.step_counts['decode']}, prefill "
          f"chunks={engine.step_counts['prefill_chunk']}, prefix hit rate="
          f"{stats['prefix_hit_rate']:.3f}, cow forks={stats['cow_forks']}, "
          f"{seconds:.2f}s [{card}]", flush=True)
    return launched


# ----------------------------------------------------------------------
# phases 4-5: bf16 serving and timing
# ----------------------------------------------------------------------
def time_ms(torch, fn, iters=50):
    """Mean ms per call over `iters` calls, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel(torch, engine, context, queries=1):
    """Time one layer's paged read at the serving shapes: every slot's
    `queries` rows ending at `context` tokens, over the engine's own
    pool (layer 0). T=1 is a decode step, T=chunk a prefill chunk."""
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
    ms = time_ms(torch, lambda: fused_paged_attention(*args, **kw))
    plain_ms = time_ms(torch, lambda: paged_attention(*args, **kw))
    k_view, v_view = gather_kv(entry, table, cfg.dtype)
    key_pos = torch.arange(k_view.shape[1], device=engine.device)
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, None]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k_view, v_view))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
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
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
            "bytes": nbytes}


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
    rows = []
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their kernels are listed on their own
        us = event.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    wall_ms = wall_s * 1e3
    top = "; ".join(f"{key[:40]} {ms:.1f} ms x{n}" for ms, n, key in rows[:6])
    print(f"profile: {n_requests} requests x prompt {prompt_len} x "
          f"{max_new} new, plain wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"decode steps {engine.step_counts['decode']}, prefill chunks "
          f"{engine.step_counts['prefill_chunk']}; top: {top} [{card}]",
          flush=True)


def phase_serve(torch, device, card, *, kv_dtype, requests_n, prompt_len,
                max_new, label):
    import numpy as np
    from flashy_tpu_torch.models.transformer import TransformerLM
    from flashy_tpu_torch.serve.engine import DecodeEngine
    cfg = model_config(torch, torch.bfloat16, 256)
    model = TransformerLM(cfg, device=device, seed=1)
    engine = DecodeEngine(model, slots=8, block_size=16, max_seq_len=256,
                          kv_dtype=kv_dtype, device=device)
    if engine.kernel != "fused":
        fail(f"{label}: engine resolved kernel={engine.kernel!r} on CUDA")
    engine.warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(requests_n)]
    scheduler, requests, counts, seconds = serve(torch, engine, prompts,
                                                 max_new)
    name = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    if counts[name] < 1:
        fail(f"{label}: kernel {name} was not launched")
    for request in requests:
        out = request.output
        if out.shape != (prompt_len + max_new,) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            fail(f"{label}: request {request.uid} output malformed")
    summary = scheduler.metrics.summary()
    timing = time_kernel(torch, engine, prompt_len + max_new // 2)
    chunk = time_kernel(torch, engine, prompt_len, queries=engine.chunk)
    print(f"{label}: kernel T={engine.chunk} (last prefill chunk) ms="
          f"{chunk['ms']:.4f} bound_ms={chunk['bound_ms']:.4f} "
          f"({chunk['bound_by']}) plain_ms={chunk['plain_ms']:.4f} "
          f"library_ms={chunk['library_ms']:.4f} [{card}]", flush=True)
    if kv_dtype == "model":
        profile_serve(torch, engine, cfg.vocab_size, 8, prompt_len, 32,
                      card)
    print(f"{label}: {requests_n} requests x {max_new} new, "
          f"tokens/s={summary['tokens_per_sec']:.1f}, decode step "
          f"p50={summary['itl_ms_p50']:.3f} ms, {seconds:.2f}s; kernel "
          f"T=1 ms={timing['ms']:.4f} bound_ms={timing['bound_ms']:.4f} "
          f"({timing['bound_by']}, {timing['bytes']} B) plain_ms="
          f"{timing['plain_ms']:.4f} library_ms(sdpa on gathered view)="
          f"{timing['library_ms']:.4f}; launches={counts[name]} [{card}]",
          flush=True)
    return counts[name], timing


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
    from flashy_tpu_torch.ops import _build
    device = torch.device("cuda")
    card = card_line()

    t0 = time.perf_counter()
    _build.build("paged_decode")
    for line in _build.build_info.get("paged_decode", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    built = "built" if "paged_decode" in _build.build_info else "cached"
    print(f"build: paged_decode {built} in {time.perf_counter() - t0:.1f}s "
          f"on [{card}]", flush=True)

    errors = check_kernels(torch, device, card)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_exact(torch, device, card)

    launches, timing = phase_serve(torch, device, card, kv_dtype="model",
                                   requests_n=16, prompt_len=128,
                                   max_new=128, label="serve bf16")
    launches8, timing8 = phase_serve(torch, device, card, kv_dtype="int8",
                                     requests_n=8, prompt_len=64,
                                     max_new=32, label="int8 bf16")
    print(f"kernels: paged_decode={launches}, "
          f"paged_decode_int8={launches8}", flush=True)
    source = "flashy_tpu_torch/csrc/paged_decode.cu"
    kernels = [
        {"name": "paged_decode", "route": "cuda", "source": source,
         "replaces": "flashy_tpu/ops/paged_decode.py:207",
         "launches": launches, "max_abs_err": errors["bfloat16"],
         "ms": timing["ms"], "plain_ms": timing["plain_ms"],
         "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
         "library_ms": timing["library_ms"]},
        {"name": "paged_decode_int8", "route": "cuda", "source": source,
         "replaces": "flashy_tpu/ops/paged_decode.py:200",
         "launches": launches8, "max_abs_err": errors["int8/bfloat16"],
         "ms": timing8["ms"], "plain_ms": timing8["plain_ms"],
         "bound_ms": timing8["bound_ms"], "bound_by": timing8["bound_by"],
         "library_ms": timing8["library_ms"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
