# The port's dense serving layout and hybrid stacks
# (flashy_tpu_torch/serve/engine.py, cache_layout='dense', the default,
# and cache_layout='ssd' with mixer='ssd,attention') on the CPU: greedy
# streams token-exact against the port's `generate`, the JAX package's
# `generate` and the JAX engine on the same weights; the host arithmetic
# and the warmed keys equal the JAX engine's; nothing is built after the
# warm-up; and the per-row cache write drops what falls past the cache.
import numpy as np
import pytest
import torch

from ._torch_port import TINY, jax_generate, tiny_pair

MAX_NEW = 6
HYBRID = dict(mixer="ssd,attention", ssd_state_dim=8, ssd_chunk=8,
              ssd_kernel="gather")


def _prompts(seed, lengths=(5, 12, 14, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], n).astype(np.int32)
            for n in lengths]


def _serve_port(model, prompts, **engine_kw):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    engine = DecodeEngine(model, slots=2, max_seq_len=64, device="cpu",
                          **engine_kw)
    engine.warmup(prompt_lengths=[len(p) for p in prompts])
    before = engine.compile_cache.stats()
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, MAX_NEW) for p in prompts]
    scheduler.run()
    after = engine.compile_cache.stats()
    assert after["misses"] == before["misses"] and after["recompiles"] == 0
    return engine, [r.output for r in requests]


def _serve_jax(jax_model, params, prompts, **engine_kw):
    from flashy_tpu.serve.engine import DecodeEngine
    from flashy_tpu.serve.scheduler import ContinuousBatchingScheduler
    engine = DecodeEngine(jax_model, params, slots=2, max_seq_len=64,
                          **engine_kw)
    engine.warmup(prompt_lengths=[len(p) for p in prompts])
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, MAX_NEW) for p in prompts]
    scheduler.run()
    return engine, [r.output for r in requests]


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunk8"])
def test_dense_streams_token_exact_vs_generate_and_jax(chunk):
    from flashy_tpu_torch.models.decoding import generate
    jax_model, params, model = tiny_pair(seed=12)
    prompts = _prompts(13)
    engine, got = _serve_port(model, prompts, chunk=chunk)
    assert engine.cache_layout == "dense" and engine.pool is None
    assert engine.step_counts["prefill" if chunk is None
                              else "prefill_chunk"] > 0
    _, jax_got = _serve_jax(jax_model, params, prompts, chunk=chunk)
    for prompt, out, jax_out in zip(prompts, got, jax_got):
        want = generate(model, prompt[None], max_new_tokens=MAX_NEW,
                        device="cpu")[0].numpy()
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, jax_out)
        np.testing.assert_array_equal(out, jax_generate(
            jax_model, params, prompt[None], max_new_tokens=MAX_NEW)[0])


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunk8"])
def test_hybrid_streams_token_exact_vs_jax_engine(chunk):
    # mixer 'ssd,attention' on cache_layout='ssd': dense slabs beside the
    # SSD states, both gathered and scattered back by every prefill slice
    from flashy_tpu_torch.models.decoding import generate
    jax_model, params, model = tiny_pair(seed=14, **HYBRID)
    prompts = _prompts(15, lengths=(5, 17, 9))
    engine, got = _serve_port(model, prompts, chunk=chunk,
                              cache_layout="ssd")
    assert not engine.unbounded
    _, jax_got = _serve_jax(jax_model, params, prompts, chunk=chunk,
                            cache_layout="ssd")
    for prompt, out, jax_out in zip(prompts, got, jax_got):
        want = generate(model, prompt[None], max_new_tokens=MAX_NEW,
                        device="cpu")[0].numpy()
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, jax_out)


@pytest.mark.parametrize("layout", ["dense", "hybrid"])
def test_state_and_cache_bytes_match_jax(layout):
    from flashy_tpu.serve.engine import DecodeEngine as JaxEngine
    from flashy_tpu.serve.engine import state_bytes_per_slot as jax_bytes
    from flashy_tpu_torch.serve.engine import (DecodeEngine,
                                               state_bytes_per_slot)
    overrides = HYBRID if layout == "hybrid" else {}
    cache_layout = "ssd" if layout == "hybrid" else "dense"
    jax_model, params, model = tiny_pair(seed=16, **overrides)
    engine = DecodeEngine(model, slots=3, max_seq_len=32,
                          cache_layout=cache_layout, device="cpu")
    jax_engine = JaxEngine(jax_model, params, slots=3, max_seq_len=32,
                           cache_layout=cache_layout)
    assert engine.state_bytes_per_slot() == jax_engine.state_bytes_per_slot()
    assert engine.cache_bytes() == jax_engine.cache_bytes()
    for n in (16, 64, 1024):
        assert state_bytes_per_slot(model.config, n, cache_layout) \
            == jax_bytes(jax_model.config, n, cache_layout)


def test_warmup_keys_match_jax_and_traffic_builds_nothing():
    # warmup(prompt_lengths) registers the JAX engine's keys (the decode
    # step, every bucket those lengths land in, the verify step), and
    # admission, prefill, decode, verify and retirement then build nothing
    from flashy_tpu.serve.engine import DecodeEngine as JaxEngine
    from flashy_tpu_torch.serve.draft import NGramDraft
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    jax_model, params, model = tiny_pair(seed=17)
    prompts = _prompts(18, lengths=(3, 9, 20, 4, 11))
    lengths = [len(p) for p in prompts]
    engine = DecodeEngine(model, slots=2, spec_k=3, cache_scope="target",
                          device="cpu")
    engine.warmup(prompt_lengths=lengths)
    jax_engine = JaxEngine(jax_model, params, slots=2, spec_k=3,
                           cache_scope="target")
    jax_engine.warmup(prompt_lengths=lengths)
    keys = set(engine.compile_cache.executables())
    assert keys == set(jax_engine.compile_cache.executables())
    assert keys == {"target/decode/2", "target/verify/2/3",
                    "target/prefill/4", "target/prefill/16",
                    "target/prefill/32"}
    warm = engine.compile_cache.stats()
    for draft in (None, NGramDraft(slots=2, k=3)):
        scheduler = ContinuousBatchingScheduler(engine, draft=draft)
        for prompt in prompts:
            scheduler.submit(prompt, MAX_NEW)
        scheduler.run()
    stats = engine.compile_cache.stats()
    assert stats["misses"] == warm["misses"] and stats["recompiles"] == 0
    assert engine.step_counts["verify"] > 0
    assert engine.step_counts["decode"] > 0


def test_cache_write_drops_rows_past_the_end():
    # the per-row write of a [B] index: a parked slot's rows are dropped,
    # and a slot at max_len - 1 writing k+1 rows changes its one real row
    # and nothing else (the rest land in the spare row past the slab)
    from flashy_tpu_torch.models.decoding import (_cache_write, init_cache,
                                                  with_spare_row)
    from flashy_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    max_len, k = 16, 3
    slab = init_cache(cfg, 3, max_len, "cpu")["block_0"]["k"]
    slab.copy_(torch.randn(slab.shape, generator=torch.Generator()
                           .manual_seed(0)))
    before = slab.clone()
    new = torch.randn((3, k + 1) + slab.shape[2:],
                      generator=torch.Generator().manual_seed(1))
    index = torch.tensor([max_len, max_len - 1, 2])
    _cache_write(slab, new, index)
    assert torch.equal(slab[0], before[0])                  # parked
    assert torch.equal(slab[1, max_len - 1], new[1, 0])     # its real row
    assert torch.equal(slab[1, :max_len - 1], before[1, :max_len - 1])
    assert torch.equal(slab[2, 2:2 + k + 1], new[2])
    assert torch.equal(slab[2, :2], before[2, :2])
    assert torch.equal(slab[2, 2 + k + 1:], before[2, 2 + k + 1:])
    assert with_spare_row(slab).shape[1] == max_len + 1
    # a slab without the spare row refuses the per-row write
    with pytest.raises(ValueError, match="spare row"):
        _cache_write(torch.zeros_like(before), new, index)
