# The port's paged serving path (flashy_tpu_torch/serve: DecodeEngine
# over a BlockPool + ContinuousBatchingScheduler) on the CPU, where the
# paged read is the kernel's plain version. Greedy streams must be
# token-exact against the port's dense-cache `generate` and against the
# JAX package's `generate` on the same weights; the pool must conserve
# its blocks.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY, jax_generate, tiny_pair

MAX_NEW = 8


def _workload():
    """Six prompts crossing 4-token block boundaries, in three lengths
    (5, 12, 14: one JAX compile each). With 2 slots the first two run
    first; the 12-token prompt indexes 3 full blocks (the shared 8-token
    prefix + 4 more), so later admissions hit the index: full-block
    matches, and a copy-on-write fork for the prompt sharing only 2
    tokens of the third block."""
    rng = np.random.default_rng(11)
    vocab = TINY["vocab_size"]
    prefix, more = rng.integers(1, vocab, 8), rng.integers(1, vocab, 4)

    def tail(n):
        return rng.integers(1, vocab, n)

    return [tail(5),
            np.concatenate([prefix, more]),
            np.concatenate([prefix, more, tail(2)]),
            np.concatenate([prefix, more[:2], tail(2)]),
            tail(5),
            np.concatenate([prefix, tail(6)])]


def _serve(model, prompts, **engine_kw):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    engine = DecodeEngine(model, slots=2, max_seq_len=64, block_size=4,
                          cache_layout="paged", device="cpu", **engine_kw)
    engine.warmup()
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, MAX_NEW) for p in prompts]
    scheduler.run()
    engine.pool.check()
    return engine, scheduler, requests


def test_paged_engine_token_exact_vs_generate_and_jax():
    from flashy_tpu_torch.models.decoding import generate
    jax_model, params, model = tiny_pair(seed=6)
    prompts = _workload()
    engine, scheduler, requests = _serve(model, prompts)
    assert engine.kernel == "gather"          # 'auto' on the CPU
    for length in sorted({len(p) for p in prompts}):
        group = [i for i, p in enumerate(prompts) if len(p) == length]
        batch = np.stack([prompts[i] for i in group]).astype(np.int32)
        port = generate(model, batch, max_new_tokens=MAX_NEW,
                        device="cpu").numpy()
        ref = jax_generate(jax_model, params, batch, max_new_tokens=MAX_NEW)
        for row, i in enumerate(group):
            assert requests[i].done
            assert requests[i].finish_reason == "length"
            np.testing.assert_array_equal(requests[i].output, port[row])
            np.testing.assert_array_equal(requests[i].output, ref[row])
    stats = engine.pool_stats()
    assert stats["cow_forks"] >= 1 and stats["prefix_hit_rate"] > 0
    assert scheduler.metrics.prefix_hits >= 2
    assert scheduler.admitted_order == list(range(len(prompts)))
    assert engine.step_counts["decode"] > 0
    assert engine.step_counts["prefill_chunk"] > 0
    summary = scheduler.metrics.summary()
    assert summary["completed"] == len(prompts)
    assert summary["tokens"] == len(prompts) * MAX_NEW
    assert summary["tokens_per_sec"] > 0 and summary["ttft_ms_p50"] > 0
    assert scheduler.metrics.static_info["kernel"] == "gather"


def test_int8_pool_serves_and_conserves_blocks():
    _, _, model = tiny_pair(seed=6)
    prompts = _workload()
    engine, scheduler, requests = _serve(model, prompts, kv_dtype="int8")
    assert engine.cache_box.value["block_0"]["k"].dtype == torch.int8
    for prompt, request in zip(prompts, requests):
        assert request.output.shape == (len(prompt) + MAX_NEW,)
        assert ((0 <= request.output)
                & (request.output < TINY["vocab_size"])).all()
    assert engine.state_bytes_per_slot() < \
        _serve(model, prompts[:1])[0].state_bytes_per_slot()


def test_priority_preemption_resumes_token_exact():
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    _, _, model = tiny_pair(seed=8)
    engine = DecodeEngine(model, slots=1, max_seq_len=64, block_size=4,
                          cache_layout="paged", device="cpu")
    scheduler = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(2)
    low_prompt, high_prompt = rng.integers(1, 256, 6), rng.integers(1, 256, 5)
    low = scheduler.submit(low_prompt, 10)
    for _ in range(5):
        scheduler.step()
    assert low.state == "running" and len(low.generated) > 1
    high = scheduler.submit(high_prompt, 6, priority=1)
    scheduler.run()
    assert low.preemptions == 1 and engine.pool.stats()["preemptions"] == 1
    assert scheduler.admitted_order == [0, 1, 0]
    for prompt, request in ((low_prompt, low), (high_prompt, high)):
        want = generate(model, prompt[None],
                        max_new_tokens=request.max_new_tokens,
                        device="cpu")[0].numpy()
        np.testing.assert_array_equal(request.output, want)
    engine.pool.check()


def test_engine_and_scheduler_guards():
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                                  QueueFull)
    _, _, model = tiny_pair()
    # the dense layout is the default, as in the JAX engine, and prefills
    # whole unless given a chunk; the paged layout takes spec_k and
    # reserves its overshoot in the pool
    dense = DecodeEngine(model, slots=2, cache_layout="dense", device="cpu")
    assert dense.pool is None and dense.chunk is None
    assert DecodeEngine(model, slots=2, device="cpu").cache_layout == "dense"
    with pytest.raises(ValueError, match="paged pool read"):
        DecodeEngine(model, slots=2, kernel="fused", device="cpu")
    with pytest.raises(ValueError, match="SSD layer"):
        DecodeEngine(model, slots=2, cache_layout="ssd", device="cpu")
    spec = DecodeEngine(model, slots=2, spec_k=2, cache_layout="paged",
                        block_size=4, device="cpu")
    assert spec.spec_k == 2 and spec.pool.spec_overshoot == 2
    with pytest.raises(ValueError, match="Generator"):
        DecodeEngine(model, slots=2, temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        DecodeEngine(model, slots=2, device="meta")
    engine = DecodeEngine(model, slots=2, max_seq_len=16, block_size=4,
                          cache_layout="paged", device="cpu")
    scheduler = ContinuousBatchingScheduler(engine, max_queue=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        scheduler.submit(np.arange(1, 12), 8)
    scheduler.submit(np.arange(1, 4), 2)
    with pytest.raises(QueueFull):
        scheduler.submit(np.arange(1, 4), 2)
    scheduler.run()
    engine.pool.check()
    slot = engine.acquire_slot()
    with pytest.raises(ValueError, match="before any slot"):
        engine.warmup()
    engine.allocator.release(slot)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_host_arithmetic_matches_jax(kv_dtype):
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.serve.compile_cache import bucket_length as jax_bucket
    from flashy_tpu.serve.engine import state_bytes_per_slot as jax_bytes
    from flashy_tpu_torch.models.transformer import TransformerConfig
    from flashy_tpu_torch.serve.compile_cache import bucket_length
    from flashy_tpu_torch.serve.engine import state_bytes_per_slot
    kw = dict(vocab_size=32768, dim=1024, num_layers=12, num_heads=16)
    cfg = TransformerConfig(**kw, dtype=torch.bfloat16)
    jcfg = JaxConfig(**kw, dtype=jnp.bfloat16)
    for layout in ("dense", "paged"):
        assert state_bytes_per_slot(cfg, 512, layout, kv_dtype=kv_dtype) \
            == jax_bytes(jcfg, 512, layout, kv_dtype=kv_dtype)
    for n in (1, 3, 4, 5, 17, 100, 256):
        assert bucket_length(n, maximum=256) == jax_bucket(n, maximum=256)
    with pytest.raises(ValueError):
        bucket_length(300, maximum=256)
