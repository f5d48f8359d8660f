"""`python -m flashy_tpu_torch.serve`: the serving demo (port of
flashy_tpu/serve/__main__.py), each leg an acceptance gate on a tiny
randomly initialized TransformerLM in f32:

  * batching     staggered mixed-length requests through a dense slot
                 engine, token-exact against per-request `generate()`,
                 nothing captured or built after the warm-up;
  * speculative  the same under speculative decoding and chunked
                 prefill on a repetitive workload: token-exact whatever
                 the draft proposed, the draft's acceptance rate above
                 the all-reject baseline (or a floor, when one is
                 given), nothing built after the warm-up;
  * chunked      a long prompt admitted mid-decode advances at most one
                 chunk a step while the live request emits on every step;
  * paged        an int8 block pool sized to the dense cache of half (or
                 fewer) the slots serves a shared-system-prompt workload
                 at >= 2x the concurrency, plain then speculative,
                 token-exact, prefix hits over a floor, a copy-on-write
                 fork, the pool conserved; `--kernel fused` reads it
                 through the Hopper paged kernel (CUDA only);
  * ssd          a pure-SSD stack on `cache_layout='ssd'`: the chunked
                 and recurrent scans agree, sessions stream token-exact
                 past the engine's ceiling, and the state bytes a slot
                 stay constant across max_seq_len while paged-int8 grows;
  * slo          the batching workload untraced, then traced at sampling
                 1.0 with an SLOEngine: no alert on the healthy run and
                 the `slo` block in serve.json, every request attributable
                 from requests.jsonl and the trace's async spans, nothing
                 built after the warm-ups, traced ITL p50 within 2x the
                 untraced + 2 ms.

Every leg runs on `--device` (cuda by default; `--device cpu` only when
asked for) and exits 1 on a failed gate.
"""
import argparse
import logging
import sys
import typing as tp

logger = logging.getLogger("flashy_tpu_torch.serve.demo")

LEGS = ("batching", "speculative", "chunked", "paged", "ssd", "slo")


def _config(vocab: int, **kw):
    import torch
    from ..models.transformer import TransformerConfig
    base = dict(vocab_size=vocab, dim=32, num_layers=2, num_heads=4,
                attention="dense", max_seq_len=64, dtype=torch.float32)
    return TransformerConfig(**{**base, **kw})


def _build_model(vocab: int, seed: int, device):
    from ..models.transformer import TransformerLM
    return TransformerLM(_config(vocab), device=device, seed=seed)


def _request_mix(n: int, vocab: int, seed: int):
    """(prompt, max_new_tokens) pairs with prompt lengths spanning several
    buckets."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = [3, 4, 5, 7, 9, 12, 14, 17, 20, 24]
    news = [4, 6, 8, 10, 12]
    return [(rng.integers(0, vocab, rng.choice(lengths)).astype(np.int32),
             int(rng.choice(news))) for _ in range(n)]


def _repetitive_mix(n: int, vocab: int, seed: int):
    """Mixed-length repetitive workload: each prompt tiles a random
    pattern of period 2-4, the regime prompt-lookup drafting is for."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = [4, 6, 9, 12, 15]
    news = [16, 20, 24]
    out = []
    for _ in range(n):
        period = int(rng.integers(2, 5))
        pattern = rng.integers(0, vocab, period).astype(np.int32)
        length = int(rng.choice(lengths))
        prompt = np.tile(pattern, length // period + 1)[:length]
        out.append((prompt, int(rng.choice(news))))
    return out


def _reference(model, prompt, max_new, device):
    import numpy as np
    from ..models.decoding import generate
    return np.asarray(generate(model, prompt[None], max_new_tokens=max_new,
                               device=device)[0].cpu())


def _mismatches(model, handles, device, log, what) -> int:
    import numpy as np
    bad = 0
    for handle in handles:
        want = _reference(model, handle.prompt, handle.max_new_tokens,
                          device)
        if not np.array_equal(handle.output, want):
            bad += 1
            log.error("request %d diverged from generate()%s:\n  served   "
                      "%s\n  generate %s", handle.uid, what,
                      handle.output.tolist(), want.tolist())
    return bad


def _compile_free(engine, warm_misses: int, log, what: str) -> int:
    """1 (a failure) when the compile cache built or captured anything
    after the warm-up."""
    stats = engine.compile_cache.stats()
    late = stats["misses"] - warm_misses
    if stats["recompiles"] or late:
        log.error("%s steady state was not compile-free: %d recompiles, "
                  "%d post-warm-up builds", what, stats["recompiles"], late)
        return 1
    return 0


def run_demo(requests: int = 32, slots: int = 8, verify: bool = True,
             seed: int = 0, max_queue: int = 64, stagger: int = 3,
             device: tp.Any = None,
             log: tp.Optional[logging.Logger] = None) -> int:
    """Serve `requests` staggered requests through a `slots`-slot dense
    engine; 0 on success, 1 when verification or the compile-free steady
    state fails. `stagger` requests are submitted a step."""
    from .engine import DecodeEngine
    from .scheduler import ContinuousBatchingScheduler

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    workload = _request_mix(requests, vocab, seed + 1)
    engine = DecodeEngine(model, slots=slots, device=device)
    log.info("warming %d-slot engine (buckets for prompt lengths %s)...",
             slots, sorted({len(p) for p, _ in workload}))
    engine.warmup(prompt_lengths=[len(p) for p, _ in workload])
    warm_misses = engine.compile_cache.stats()["misses"]

    scheduler = ContinuousBatchingScheduler(engine, max_queue=max_queue)
    handles, pending = [], list(workload)
    steps = deferred = 0
    while pending or not scheduler.idle:
        # honour the backpressure: defer what the queue cannot take
        room = scheduler.max_queue - scheduler.queue_depth
        wanted = min(stagger, len(pending))
        deferred += max(0, wanted - room)
        for _ in range(min(wanted, room)):
            prompt, max_new = pending.pop(0)
            handles.append(scheduler.submit(prompt, max_new))
        scheduler.step()
        steps += 1
    if deferred:
        log.info("backpressure: %d submission attempts deferred (queue at "
                 "its %d-deep cap)", deferred, scheduler.max_queue)
    stats = engine.compile_cache.stats()
    summary = scheduler.metrics.summary()
    log.info("served %d requests in %d steps: %s", len(handles), steps,
             ", ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in sorted(summary.items())))
    log.info("compile cache: %s", stats)
    failures = 0
    if not all(h.done for h in handles):
        log.error("%d requests never finished",
                  sum(not h.done for h in handles))
        failures += 1
    failures += _compile_free(engine, warm_misses, log, "batching")
    if verify:
        if _mismatches(model, handles, device, log, ""):
            failures += 1
        else:
            log.info("verified: all %d outputs token-exact against "
                     "per-request generate()", len(handles))
    return 1 if failures else 0


def run_spec_demo(requests: int = 16, slots: int = 4, k: int = 4,
                  chunk: int = 8, draft_kind: str = "ngram",
                  accept_floor: tp.Optional[float] = None, seed: int = 0,
                  device: tp.Any = None,
                  log: tp.Optional[logging.Logger] = None) -> int:
    """Speculative decoding + chunked prefill: 1 unless every output is
    token-exact against `generate()`, the acceptance rate clears
    `accept_floor` (None: it must beat the all-reject baseline, 0), and
    nothing is built after the warm-up.

    The reference's default floor, 0.2, is a property of its random
    weights, which the port's init does not reproduce: at seed 0 the
    port's tiny model accepts 0.18 of the n-gram draft's proposals on
    the CPU. So the port's default gate is the one every working verify
    step passes on a repetitive workload, some accepted draft at all."""
    from ..models.transformer import TransformerLM
    from .draft import ModelDraft, NGramDraft
    from .engine import DecodeEngine
    from .scheduler import ContinuousBatchingScheduler

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    workload = _repetitive_mix(requests, vocab, seed + 1)
    engine = DecodeEngine(model, slots=slots, spec_k=k, chunk=chunk,
                          device=device)
    if draft_kind == "ngram":
        draft: tp.Any = NGramDraft(slots=slots, k=k, ngram=3)
    elif draft_kind == "model":
        # a random half-size draft: poor acceptance, exact output all
        # the same (use --accept-floor 0)
        dmodel = TransformerLM(_config(vocab, dim=16, num_layers=1,
                                       num_heads=2),
                               device=device, seed=seed + 13)
        draft = ModelDraft(dmodel, slots=slots, k=k, device=device)
        draft.warmup(prompt_lengths=[len(p) for p, _ in workload])
    else:
        raise ValueError(f"unknown draft kind {draft_kind!r}")
    log.info("speculative leg: warming %d-slot engine (k=%d, chunk=%d, %s "
             "draft)...", slots, k, chunk, draft_kind)
    engine.warmup()
    warm_misses = engine.compile_cache.stats()["misses"]

    scheduler = ContinuousBatchingScheduler(engine, draft=draft)
    handles, pending = [], list(workload)
    steps = 0
    while pending or not scheduler.idle:
        room = scheduler.max_queue - scheduler.queue_depth
        for _ in range(min(2, len(pending), room)):
            prompt, max_new = pending.pop(0)
            handles.append(scheduler.submit(prompt, max_new))
        scheduler.step()
        steps += 1
    summary = scheduler.metrics.summary()
    log.info("speculative leg: %d requests in %d steps, acceptance %.0f%% "
             "(%d drafted -> %d emitted), accepted/step p50=%.1f p95=%.1f, "
             "itl p95 %.2fms", len(handles), steps,
             summary["acceptance_rate"] * 100, summary["spec_drafted"],
             summary["spec_emitted"], summary["accepted_per_step_p50"],
             summary["accepted_per_step_p95"], summary["itl_ms_p95"])
    failures = 0
    if not all(h.done for h in handles):
        log.error("%d requests never finished",
                  sum(not h.done for h in handles))
        failures += 1
    failures += _compile_free(engine, warm_misses, log, "speculative")
    if _mismatches(model, handles, device, log, " under speculation"):
        failures += 1
    else:
        log.info("verified: all %d speculative outputs token-exact against "
                 "per-request generate()", len(handles))
    rate = summary["acceptance_rate"]
    if accept_floor is None and rate <= 0.0:
        log.error("acceptance rate %.2f: no draft was ever accepted (the "
                  "all-reject baseline)", rate)
        failures += 1
    elif accept_floor is not None and rate < accept_floor:
        log.error("acceptance rate %.2f below the %.2f floor", rate,
                  accept_floor)
        failures += 1
    return 1 if failures else 0


def run_chunked_demo(chunk: int = 8, seed: int = 0, device: tp.Any = None,
                     log: tp.Optional[logging.Logger] = None) -> int:
    """Chunked-prefill stall bound: a long prompt admitted while another
    slot decodes advances at most one chunk a step, the live request
    emits on every step of that window, and both stay token-exact."""
    import time

    import numpy as np
    from .engine import DecodeEngine
    from .scheduler import ContinuousBatchingScheduler

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    rng = np.random.default_rng(seed + 2)
    engine = DecodeEngine(model, slots=2, chunk=chunk, device=device)
    log.info("chunked leg: warming 2-slot engine (chunk=%d)...", chunk)
    engine.warmup()
    warm_misses = engine.compile_cache.stats()["misses"]
    scheduler = ContinuousBatchingScheduler(engine)
    short = scheduler.submit(rng.integers(0, vocab, 4).astype(np.int32),
                             max_new_tokens=24)
    for _ in range(3):        # the short request is decoding...
        scheduler.step()
    long_prompt = rng.integers(0, vocab, 5 * chunk).astype(np.int32)
    long = scheduler.submit(long_prompt, max_new_tokens=4)
    # ...when the long prompt lands
    failures = ticks = 0
    stalls = []
    while long.state in ("queued", "prefilling"):
        before = len(short.generated)
        tick_start = time.perf_counter()
        scheduler.step()
        stalls.append(time.perf_counter() - tick_start)
        ticks += 1
        if scheduler.prefill_tokens_last_step > chunk:
            log.error("tick advanced %d prompt tokens > chunk %d",
                      scheduler.prefill_tokens_last_step, chunk)
            failures += 1
        if short.done:
            break
        if len(short.generated) <= before:
            log.error("live request stalled on tick %d of the long "
                      "prompt's prefill window", ticks)
            failures += 1
    scheduler.run()
    expected_ticks = -(-long_prompt.size // chunk)
    log.info("chunked leg: %d-token prompt prefilled over %d ticks "
             "(expected >= %d), max tick %.2fms, max prefill tokens/step "
             "%d (chunk %d)", long_prompt.size, ticks, expected_ticks,
             max(stalls) * 1e3 if stalls else 0.0,
             scheduler.max_prefill_tokens_per_step, chunk)
    if ticks < expected_ticks:
        log.error("prefill finished in %d ticks < %d", ticks,
                  expected_ticks)
        failures += 1
    if scheduler.max_prefill_tokens_per_step > chunk:
        log.error("max prefill tokens per step %d exceeds chunk %d",
                  scheduler.max_prefill_tokens_per_step, chunk)
        failures += 1
    failures += _compile_free(engine, warm_misses, log, "chunked")
    if _mismatches(model, (short, long), device, log, ""):
        failures += 1
    if not failures:
        log.info("verified: chunked admission mid-decode stayed token-exact "
                 "with the stall bound held")
    return 1 if failures else 0


def run_paged_demo(requests: int = 32, dense_slots: int = 4,
                   paged_slots: int = 16, block_size: int = 8, k: int = 4,
                   prefix_floor: float = 0.25, stagger: int = 4,
                   seed: int = 0, kernel: str = "fused",
                   device: tp.Any = None,
                   log: tp.Optional[logging.Logger] = None) -> int:
    """The paged layout: more slots per byte, exactly. An int8 pool sized
    to the dense cache of `dense_slots` slots serves a shared-system-
    prompt workload through `paged_slots` (>= 2x) slots, plain then
    speculative, on one engine. 1 unless every output is token-exact
    against `generate()`, the prefix hit rate clears `prefix_floor`, a
    copy-on-write fork happened, 2 x `dense_slots` slots were live at
    once inside the dense budget, the pool is conserved and nothing was
    built after the warm-up. The workload is screened, request by
    request on a pool without sharing, to requests whose greedy argmax
    survives int8 K/V (a random model's logits have near ties far below
    its quantization error)."""
    import numpy as np
    from ..ops.paged_attention import block_bytes
    from .draft import NGramDraft
    from .engine import DecodeEngine
    from .scheduler import ContinuousBatchingScheduler

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    cfg = model.config
    rng = np.random.default_rng(seed + 3)
    # a system prompt that ends inside a block: every repeat forks it
    system = rng.integers(0, vocab, 2 * block_size + block_size // 2 + 1
                          ).astype(np.int32)
    dense = DecodeEngine(model, slots=dense_slots, device=device,
                         cache_scope="densebudget")
    budget = dense.cache_bytes()
    del dense
    num_blocks = budget // block_bytes(cfg, block_size, "int8")
    engine = DecodeEngine(model, slots=paged_slots, cache_layout="paged",
                          block_size=block_size, num_blocks=num_blocks,
                          kv_dtype="int8", kernel=kernel, spec_k=k,
                          device=device)
    paged_bytes = engine.cache_bytes()
    log.info("paged leg (%s kernel): dense budget = %d slots x %d tokens = "
             "%.0f KiB; paged+int8 = %d blocks x %d tokens -> %d slots "
             "(%.1fx), %.0f KiB", engine.kernel, dense_slots,
             engine.max_seq_len, budget / 1024, num_blocks - 1, block_size,
             paged_slots, paged_slots / dense_slots, paged_bytes / 1024)

    screen = DecodeEngine(model, slots=1, cache_layout="paged",
                          block_size=block_size, kv_dtype="int8",
                          kernel=kernel, prefix_cache=False,
                          cache_scope="screen", device=device)
    screen.warmup()
    screen_sched = ContinuousBatchingScheduler(screen)
    workload = []
    tried = 0
    while len(workload) < requests and tried < requests * 4:
        tried += 1
        tail = rng.integers(0, vocab, int(rng.integers(3, block_size))
                            ).astype(np.int32)
        prompt = np.concatenate([system, tail])
        max_new = int(rng.integers(6, 13))
        handle = screen_sched.submit(prompt, max_new)
        screen_sched.run()
        want = _reference(model, prompt, max_new, device)
        if np.array_equal(handle.output, want):
            workload.append((prompt, max_new, want))
    if len(workload) < requests:
        log.error("screen kept only %d/%d requests: int8 argmax noise "
                  "dominates this init; pick another seed", len(workload),
                  requests)
        return 1
    log.info("screened workload: kept %d int8-argmax-safe requests out of "
             "%d candidates", len(workload), tried)
    log.info("warming %d-slot paged engine (block_size=%d, int8 K/V, "
             "spec_k=%d)...", paged_slots, block_size, k)
    engine.warmup()
    warm_misses = engine.compile_cache.stats()["misses"]

    peak_live = 0
    handles: tp.List[tp.Any] = []

    def serve_phase(batch, draft):
        nonlocal peak_live
        scheduler = ContinuousBatchingScheduler(engine, draft=draft)
        pending = list(batch)
        while pending or not scheduler.idle:
            room = scheduler.max_queue - scheduler.queue_depth
            for _ in range(min(stagger, len(pending), room)):
                prompt, max_new, _ = pending.pop(0)
                handles.append(scheduler.submit(prompt, max_new))
            scheduler.step()
            peak_live = max(peak_live, engine.live_count)
        return scheduler

    half = len(workload) // 2
    sched_a = serve_phase(workload[:half], draft=None)
    sched_b = serve_phase(workload[half:],
                          draft=NGramDraft(slots=paged_slots, k=k, ngram=3))
    pool = engine.pool_stats()
    summary_a = sched_a.metrics.summary()
    summary_b = sched_b.metrics.summary()
    log.info("paged leg: %d requests (%d plain + %d speculative), prefix "
             "hit rate %.0f%%, %d COW forks, %d evictions, peak %d/%d "
             "blocks, peak %d live slots, pool occupancy p95 %.0f%%/%.0f%%",
             len(handles), half, len(workload) - half,
             pool["prefix_hit_rate"] * 100, pool["cow_forks"],
             pool["evictions"], pool["peak_in_use"], pool["capacity"],
             peak_live, summary_a.get("pool_occupancy_p95", 0.0) * 100,
             summary_b.get("pool_occupancy_p95", 0.0) * 100)
    failures = 0
    if not all(h.done for h in handles):
        log.error("%d requests never finished",
                  sum(not h.done for h in handles))
        failures += 1
    mismatches = 0
    for handle, (_, _, want) in zip(handles, workload):
        if not np.array_equal(handle.output, want):
            mismatches += 1
            log.error("request %d diverged from generate() on the paged "
                      "int8 layout:\n  served   %s\n  generate %s",
                      handle.uid, handle.output.tolist(), want.tolist())
    if mismatches:
        failures += 1
    else:
        log.info("verified: all %d outputs token-exact against per-request "
                 "generate() (paged + prefix sharing + COW + int8 K/V)",
                 len(handles))
    failures += _compile_free(engine, warm_misses, log, "paged")
    if pool["prefix_hit_rate"] < prefix_floor:
        log.error("prefix hit rate %.2f below the %.2f floor",
                  pool["prefix_hit_rate"], prefix_floor)
        failures += 1
    if pool["cow_forks"] < 1:
        log.error("no COW fork happened")
        failures += 1
    if peak_live < 2 * dense_slots:
        log.error("peak concurrency %d never reached 2x the dense "
                  "budget's %d slots", peak_live, dense_slots)
        failures += 1
    if paged_bytes > budget:
        log.error("paged pool (%d bytes) exceeds the dense budget (%d "
                  "bytes)", paged_bytes, budget)
        failures += 1
    try:
        engine.pool.check()
    except AssertionError as exc:
        log.error("pool conservation violated: %s", exc)
        failures += 1
    if not failures:
        log.info("verified: %dx concurrent slots inside the dense budget, "
                 "pool never over-committed", peak_live // dense_slots)
    return 1 if failures else 0


def run_ssd_demo(requests: int = 6, slots: int = 4, chunk: int = 8,
                 ceiling: int = 64, seed: int = 0, device: tp.Any = None,
                 log: tp.Optional[logging.Logger] = None) -> int:
    """Constant-memory long-context decode on a pure-SSD stack (its
    `ssd_chunk` pinned to the engine's prefill chunk). 1 unless the
    chunked and recurrent scans agree, every session streams token-exact
    past the engine's `ceiling`, nothing is built after the warm-up, and
    the state bytes a slot stay constant across max_seq_len in {1k, 8k,
    64k} while paged-int8 grows, so that a 64k paged budget holds more
    SSD slots."""
    import numpy as np
    import torch
    from ..models.transformer import TransformerLM
    from ..ops.ssd_scan import ssd_chunked_scan, ssd_recurrent_scan
    from .engine import DecodeEngine, state_bytes_per_slot
    from .scheduler import ContinuousBatchingScheduler

    log = log or logger
    vocab = 64
    cfg = _config(vocab, max_seq_len=4096, mixer="ssd", ssd_state_dim=8,
                  ssd_chunk=chunk)
    model = TransformerLM(cfg, device=device, seed=seed)
    device = model.embed.device
    rng = np.random.default_rng(seed + 5)
    failures = 0

    # the state-space duality, at the ops layer
    b_, t_, h_, dh_, n_ = 2, 3 * chunk + 5, cfg.num_heads, cfg.head_dim, 8
    g = torch.Generator(device=device).manual_seed(seed + 7)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)

    c, bq, v = draw(b_, t_, h_, n_), draw(b_, t_, h_, n_), draw(b_, t_, h_,
                                                                dh_)
    la = -torch.nn.functional.softplus(draw(b_, t_, h_))
    y_chunk, s_chunk = ssd_chunked_scan(c, bq, v, la, chunk=chunk)
    y_rec, s_rec = ssd_recurrent_scan(c, bq, v, la,
                                      torch.zeros((b_, h_, dh_, n_),
                                                  device=device))
    err_y = float((y_chunk - y_rec).abs().max())
    err_s = float((s_chunk - s_rec).abs().max())
    log.info("ssd leg: dual-form parity on [%d, %d] tokens: max |dy| %.2e, "
             "max |dstate| %.2e", b_, t_, err_y, err_s)
    if err_y > 1e-4 or err_s > 1e-4:
        log.error("chunked and recurrent SSD forms diverged")
        failures += 1

    engine = DecodeEngine(model, slots=slots, chunk=chunk,
                          max_seq_len=ceiling, cache_layout="ssd",
                          device=device)
    if not engine.unbounded:
        log.error("a pure-SSD engine must be unbounded")
        return 1
    log.info("ssd leg: warming %d-slot ssd engine (chunk=%d, ceiling %d "
             "tokens, %d state bytes/slot)...", slots, chunk, ceiling,
             engine.state_bytes_per_slot())
    engine.warmup()
    warm_misses = engine.compile_cache.stats()["misses"]
    scheduler = ContinuousBatchingScheduler(engine)
    published = scheduler.metrics.static_info.get("state_bytes_per_slot")
    if published != engine.state_bytes_per_slot():
        log.error("static_info publishes state_bytes_per_slot=%s, engine "
                  "says %d", published, engine.state_bytes_per_slot())
        failures += 1
    workload = []
    for _ in range(requests):
        plen = int(rng.integers(5, 3 * chunk))
        max_new = ceiling - plen + int(rng.integers(8, 33))
        workload.append((rng.integers(0, vocab, plen).astype(np.int32),
                         max_new))
    handles, pending = [], list(workload)
    while pending or not scheduler.idle:
        room = scheduler.max_queue - scheduler.queue_depth
        for _ in range(min(2, len(pending), room)):
            prompt, max_new = pending.pop(0)
            handles.append(scheduler.submit(prompt, max_new))
        scheduler.step()
    finals = [len(p) + n for p, n in workload]
    log.info("ssd leg: %d sessions streamed to final positions %s "
             "(ceiling %d); compile cache %s", len(handles), sorted(finals),
             ceiling, engine.compile_cache.stats())
    if not all(h.done for h in handles):
        log.error("%d sessions never finished",
                  sum(not h.done for h in handles))
        failures += 1
    if min(finals) <= ceiling:
        log.error("a session ended at position %d <= the %d ceiling",
                  min(finals), ceiling)
        failures += 1
    failures += _compile_free(engine, warm_misses, log, "ssd")
    if _mismatches(model, handles, device, log, " past the ceiling"):
        failures += 1
    else:
        log.info("verified: all %d streaming sessions token-exact against "
                 "per-request generate() past the %d-token ceiling",
                 len(handles), ceiling)

    # O(1) state: the accounting `static_info` publishes
    attn_cfg = _config(vocab, max_seq_len=65536)
    lens = (1024, 8192, 65536)
    ssd_bytes = [state_bytes_per_slot(cfg, n, "ssd") for n in lens]
    paged_bytes = [state_bytes_per_slot(attn_cfg, n, "paged",
                                        kv_dtype="int8", block_size=16)
                   for n in lens]
    log.info("ssd leg: state bytes/slot across max_seq_len %s: ssd %s, "
             "paged-int8 %s", lens, ssd_bytes, paged_bytes)
    if len(set(ssd_bytes)) != 1:
        log.error("ssd state bytes/slot moved with max_seq_len: %s",
                  ssd_bytes)
        failures += 1
    if not paged_bytes[0] < paged_bytes[1] < paged_bytes[2]:
        log.error("paged-int8 bytes/slot %s do not grow with max_seq_len",
                  paged_bytes)
        failures += 1
    budget = 16 * paged_bytes[-1]
    ssd_slots = budget // ssd_bytes[-1]
    log.info("ssd leg: a 16-slot paged-int8 budget at 64k context (%.1f "
             "MiB) holds %d ssd slots (%.0fx)", budget / 2 ** 20,
             ssd_slots, ssd_slots / 16)
    if ssd_slots <= 16:
        log.error("ssd fits only %d slots in the 16-slot paged budget",
                  ssd_slots)
        failures += 1
    if not failures:
        log.info("verified: dual-form parity, token-exact streaming past "
                 "the ceiling, compile-free steady state, O(1) state bytes "
                 "per slot")
    return 1 if failures else 0


def run_slo_demo(requests: int = 24, slots: int = 8, stagger: int = 3,
                 overhead_factor: float = 2.0, seed: int = 0,
                 device: tp.Any = None,
                 log: tp.Optional[logging.Logger] = None) -> int:
    """SLO and request-tracing gate: the batching workload served twice,
    untraced (the baseline), then traced at sampling 1.0 with an
    SLOEngine attached; 1 unless the healthy run raises no burn-rate
    alert and its `serve.json` carries the `slo` block, every finished
    request is attributable from `requests.jsonl` (named phases) and
    from the Chrome trace's async spans, neither run builds or captures
    after its warm-up, and traced ITL p50 stays within `overhead_factor`
    x the untraced one + 2 ms (observability that slows the service down
    is a regression)."""
    import json
    import tempfile
    from pathlib import Path

    from ..observability import SLOEngine, Tracer, format_slo_report
    from ..xp import REQUESTS_NAME, SERVE_STATUS_NAME, TRACE_NAME
    from .engine import DecodeEngine
    from .metrics import ServeMetrics
    from .scheduler import ContinuousBatchingScheduler
    from .tracing import (RequestTracer, SPAN_DECODE, SPAN_PREFILL,
                          SPAN_QUEUED, SPAN_REQUEST)

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    workload = _request_mix(requests, vocab, seed + 1)

    def serve_pass(tracer, tracing, slo):
        engine = DecodeEngine(model, slots=slots, tracer=tracer,
                              cache_scope="traced" if tracer else "plain",
                              device=device)
        engine.warmup(prompt_lengths=[len(p) for p, _ in workload])
        warm_misses = engine.compile_cache.stats()["misses"]
        metrics = ServeMetrics(tracer=tracer, slo=slo)
        scheduler = ContinuousBatchingScheduler(engine, metrics=metrics,
                                                tracing=tracing)
        handles = []
        pending = list(workload)
        while pending or not scheduler.idle:
            room = scheduler.max_queue - scheduler.queue_depth
            for _ in range(min(stagger, len(pending), room)):
                prompt, max_new = pending.pop(0)
                handles.append(scheduler.submit(prompt, max_new))
            scheduler.step()
        stats = engine.compile_cache.stats()
        return (handles, scheduler,
                stats["recompiles"], stats["misses"] - warm_misses)

    failures = 0
    log.info("slo leg: baseline pass (tracing off)...")
    base_handles, base_sched, base_rec, base_builds = serve_pass(
        None, None, None)
    base_itl = base_sched.metrics.summary()["itl_ms_p50"]

    log.info("slo leg: traced pass (sampling=1.0, SLO engine attached)...")
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        tracer = Tracer(trace_path=folder / TRACE_NAME)
        tracing = RequestTracer(tracer=tracer,
                                journal_path=folder / REQUESTS_NAME,
                                sample_rate=1.0)
        slo = SLOEngine(tracer=tracer)
        handles, sched, recompiles, builds = serve_pass(tracer, tracing, slo)
        traced_itl = sched.metrics.summary()["itl_ms_p50"]
        sched.metrics.write_status(folder)
        tracing.close()
        tracer.close()

        if not all(h.done for h in base_handles + handles):
            log.error("requests never finished")
            failures += 1
        if base_rec or base_builds or recompiles or builds:
            log.error("steady state was not compile-free (baseline %d/%d, "
                      "traced %d/%d recompiles/builds): tracing must not "
                      "perturb the steps", base_rec, base_builds,
                      recompiles, builds)
            failures += 1

        # the SLO gate: the report is there, silent on the healthy run
        with open(folder / SERVE_STATUS_NAME) as f:
            status = json.load(f)
        report = status.get("slo")
        if not report or not report.get("budgets"):
            log.error("serve.json carries no slo report block")
            failures += 1
        elif report["alerting"]:
            log.error("burn-rate alert fired on a healthy run:\n%s",
                      format_slo_report(report))
            failures += 1
        else:
            log.info("slo report (healthy, no alert):\n%s",
                     format_slo_report(report))

        # the attribution gate: every finished uid has a journal line
        # with its named phases, and async spans in the trace
        finished: tp.Dict[int, tp.Dict[str, tp.Any]] = {}
        with open(folder / REQUESTS_NAME) as f:
            for line in f:
                event = json.loads(line)
                if event.get("event") == "finished":
                    finished[event["uid"]] = event
        for handle in handles:
            event = finished.get(handle.uid)
            if event is None:
                log.error("request %d finished but has no requests.jsonl "
                          "summary", handle.uid)
                failures += 1
            elif not {"queue_wait_s", "latency_s"} <= set(event):
                log.error("request %d summary lacks phase attribution: %s",
                          handle.uid, event)
                failures += 1
        spans: tp.Dict[tp.Tuple[str, str, str], int] = {}
        with open(folder / TRACE_NAME) as f:
            for event in json.load(f)["traceEvents"]:
                if event.get("ph") in ("b", "e"):
                    key = (event["name"], event["id"], event["ph"])
                    spans[key] = spans.get(key, 0) + 1
        for handle in handles:
            uid = f"0x{handle.uid:x}"
            for name in (SPAN_REQUEST, SPAN_QUEUED, SPAN_PREFILL,
                         SPAN_DECODE):
                opened = spans.get((name, uid, "b"), 0)
                closed = spans.get((name, uid, "e"), 0)
                if name == SPAN_REQUEST and (opened != 1 or closed != 1):
                    log.error("request %d: %s opened %d / closed %d times",
                              handle.uid, name, opened, closed)
                    failures += 1
                elif opened != closed:
                    log.error("request %d: unbalanced %s spans (%d open, "
                              "%d close)", handle.uid, name, opened, closed)
                    failures += 1

    # the overhead gate: full-rate tracing must stay cheap
    bound = base_itl * overhead_factor + 2.0
    log.info("slo leg: itl p50 %.3fms untraced vs %.3fms traced at "
             "sampling=1.0 (bound %.3fms)", base_itl, traced_itl, bound)
    if traced_itl > bound:
        log.error("tracing overhead blew the bound: %.3fms > %.3fms",
                  traced_itl, bound)
        failures += 1
    if not failures:
        log.info("verified: SLO report healthy, every request phase-"
                 "attributable from requests.jsonl + Perfetto, tracing "
                 "overhead bounded")
    return 1 if failures else 0


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.serve",
        description="Continuous-batching serving demo of the PyTorch port.")
    parser.add_argument("-n", "--requests", type=int, default=32)
    parser.add_argument("-s", "--slots", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stagger", type=int, default=3,
                        help="requests submitted per scheduler step")
    parser.add_argument("--max-queue", type=int, default=64,
                        help="admission queue depth (submissions past it "
                             "are deferred: the backpressure path)")
    parser.add_argument("--no-verify", dest="verify", action="store_false",
                        help="skip the per-request generate() comparison")
    parser.add_argument("--legs", default="all",
                        help=f"comma list of legs to run: {','.join(LEGS)} "
                             f"(or 'all')")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="tokens drafted per speculative step")
    parser.add_argument("--chunk", type=int, default=8,
                        help="prefill chunk size (speculative and chunked "
                             "legs)")
    parser.add_argument("--draft", default="ngram", choices=("ngram", "model"),
                        help="draft provider for the speculative leg")
    parser.add_argument("--accept-floor", type=float, default=None,
                        help="minimum acceptance rate of the speculative "
                             "leg (default: above 0, the all-reject "
                             "baseline; use 0 with --draft model)")
    parser.add_argument("--prefix-floor", type=float, default=0.25,
                        help="minimum prefix-cache hit rate of the paged "
                             "leg")
    parser.add_argument("--kernel", default="fused",
                        choices=("gather", "fused"),
                        help="the paged leg's pool read: the Hopper kernel "
                             "(CUDA only) or its plain version")
    parser.add_argument("--device", default="cuda",
                        help="where the legs run (cuda by default; cpu only "
                             "when asked for)")
    args = parser.parse_args(argv)

    legs = LEGS if args.legs == "all" else tuple(args.legs.split(","))
    unknown = set(legs) - set(LEGS)
    if unknown:
        parser.error(f"unknown legs: {sorted(unknown)} (choose from {LEGS})")
    if "paged" in legs and args.kernel == "fused" \
            and not args.device.startswith("cuda"):
        parser.error("--kernel fused is the Hopper kernel and needs the "
                     "card: use --kernel gather with --device cpu")
    from ..utils import resolve_device
    device = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="[%(levelname)s] %(message)s")
    rc = 0
    if "batching" in legs:
        rc |= run_demo(requests=args.requests, slots=args.slots,
                       verify=args.verify, seed=args.seed,
                       stagger=args.stagger, max_queue=args.max_queue,
                       device=device)
    if "speculative" in legs:
        rc |= run_spec_demo(requests=max(4, args.requests // 2),
                            slots=max(2, args.slots // 2), k=args.spec_k,
                            chunk=args.chunk, draft_kind=args.draft,
                            accept_floor=args.accept_floor, seed=args.seed,
                            device=device)
    if "chunked" in legs:
        rc |= run_chunked_demo(chunk=args.chunk, seed=args.seed,
                               device=device)
    if "paged" in legs:
        rc |= run_paged_demo(requests=args.requests, k=args.spec_k,
                             seed=args.seed, prefix_floor=args.prefix_floor,
                             kernel=args.kernel, device=device)
    if "ssd" in legs:
        rc |= run_ssd_demo(chunk=args.chunk, seed=args.seed, device=device)
    if "slo" in legs:
        rc |= run_slo_demo(requests=max(8, args.requests // 2),
                           slots=args.slots, stagger=args.stagger,
                           seed=args.seed, device=device)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
