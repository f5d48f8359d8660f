# The serving CompileCache (flashy_tpu_torch/serve/compile_cache.py, the
# port of flashy_tpu/serve/compile_cache.py: captured CUDA graphs on the
# card, the eager callables here) and the engine's use of it, on the CPU:
# the cache's accounting as the JAX package's tests pin it
# (tests/test_serve.py), the engine's warm-up registering the same keys
# as the JAX engine on the same tiny config, a scheduler run that builds
# nothing after warm-up and stays token-exact against `generate`, and the
# static buffers a captured step reads keeping their storage across
# steps.
import numpy as np
import pytest
import torch

from ._torch_port import TINY, tiny_pair

SSD = dict(mixer="ssd", ssd_state_dim=8, ssd_chunk=8)
ENGINE = dict(slots=2, max_seq_len=64, chunk=8, tail_bucket=4)


def test_compile_cache_hit_miss_accounting():
    from flashy_tpu_torch.serve.compile_cache import CompileCache
    cache = CompileCache(device="cpu")
    build = lambda: (lambda x: x + 1)  # noqa: E731
    fn = cache.get(("step", 4), build)
    assert cache.stats() == {"hits": 0, "misses": 1, "entries": 1,
                             "recompiles": 0}
    assert cache.get(("step", 4), build) is fn  # hit returns same object
    assert cache.get(("step", 8), build) is not fn
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 2
    assert ("step", 4) in cache and ("step", 16) not in cache
    assert len(cache) == 2 and set(cache.executables()) == {"step/4",
                                                             "step/8"}
    assert fn(1) == 2  # on the CPU an entry is the eager callable
    # built before the seal: warm-up; after it, every new key is a
    # recompile, and a hit is not
    cache.seal()
    cache.get(("step", 4), build)
    assert cache.recompiles() == 0
    cache.get(("step", 16), build)
    assert cache.recompiles() == 1
    assert cache.stats() == {"hits": 2, "misses": 3, "entries": 3,
                             "recompiles": 1}


def test_compile_cache_warm_executes_once():
    from flashy_tpu_torch.serve.compile_cache import CompileCache
    cache = CompileCache(device="cpu")
    calls = []

    def build():
        return lambda x: calls.append(x) or x * 2

    assert cache.warm(("inc",), build, 3) == 6
    assert calls == [3] and cache.stats()["misses"] == 1
    assert cache.warm(("inc",), build, 4) == 8  # a hit, run again
    assert calls == [3, 4] and cache.stats() == {
        "hits": 1, "misses": 1, "entries": 1, "recompiles": 0}


def test_compile_cache_refuses_what_is_not_ported():
    from flashy_tpu_torch.serve.compile_cache import CompileCache
    for name in ("watchdog", "tracer", "roofline"):
        with pytest.raises(NotImplementedError, match="item 9"):
            CompileCache(**{name: object()}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CompileCache()
    # on the CPU there is nothing to capture: the entries stay eager
    assert not CompileCache(device="cpu").graphs


def _jax_keys(jax_model, params, cache_layout, **kw):
    from flashy_tpu.serve.engine import DecodeEngine as JaxEngine
    engine = JaxEngine(jax_model, params, cache_layout=cache_layout,
                       kernel="gather", **ENGINE, **kw)
    engine.warmup()
    return set(engine.compile_cache.executables())


def _port_engine(model, cache_layout, **kw):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    engine = DecodeEngine(model, cache_layout=cache_layout, device="cpu",
                          **ENGINE, **kw)
    engine.warmup()
    return engine


@pytest.mark.parametrize("cache_layout", ["paged", "ssd"])
def test_warmup_keys_match_jax_and_traffic_builds_nothing(cache_layout):
    # The port's warm-up registers the JAX engine's keys on the same tiny
    # config (the decode step, both prefill slices, and the paged COW
    # copy); a scheduler run after it builds no entry (misses unchanged,
    # recompiles 0) and serves every stream token-exact against the
    # port's `generate`.
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    overrides = SSD if cache_layout == "ssd" else {}
    layout_kw = {} if cache_layout == "ssd" else {"block_size": 4}
    jax_model, params, model = tiny_pair(seed=7, **overrides)
    engine = _port_engine(model, cache_layout, **layout_kw)
    keys = set(engine.compile_cache.executables())
    want = {"decode/2", "prefill_chunk/4", "prefill_chunk/8"}
    if cache_layout == "paged":
        want.add("copy_block")
    assert keys == want
    assert keys == _jax_keys(jax_model, params, cache_layout, **layout_kw)
    before = engine.compile_cache.stats()
    assert before["recompiles"] == 0 and before["misses"] == len(want)
    rng = np.random.default_rng(8)
    prefix = rng.integers(1, TINY["vocab_size"], 8)
    prompts = [rng.integers(1, TINY["vocab_size"], 5),
               np.concatenate([prefix, rng.integers(1, 256, 6)]),
               np.concatenate([prefix, rng.integers(1, 256, 3)]),
               rng.integers(1, TINY["vocab_size"], 19)]
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, 6) for p in prompts]
    scheduler.run()
    after = engine.compile_cache.stats()
    assert after["misses"] == before["misses"] and after["recompiles"] == 0
    assert after["hits"] > before["hits"]
    for prompt, request in zip(prompts, requests):
        want_tokens = generate(model, prompt[None], max_new_tokens=6,
                               device="cpu")[0].numpy()
        np.testing.assert_array_equal(request.output, want_tokens)
    if engine.pool is not None:
        engine.pool.check()


@pytest.mark.parametrize("cache_layout", ["paged", "ssd"])
def test_engine_buffers_keep_their_storage_across_steps(cache_layout):
    # A captured step reads and writes the tensors it was captured over:
    # the per-slot tokens, positions and active mask, the block tables
    # and every prefill slice's inputs are filled in place, never rebound.
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    overrides = SSD if cache_layout == "ssd" else {}
    layout_kw = {} if cache_layout == "ssd" else {"block_size": 4}
    _, _, model = tiny_pair(seed=9, **overrides)
    engine = _port_engine(model, cache_layout, **layout_kw)

    def storage():
        tensors = {"tokens": engine._tokens, "positions": engine._positions,
                   "active": engine._active}
        if engine.pool is not None:
            tensors["table"] = engine._table_dev
        for size, bufs in engine._prefill_inputs.items():
            tensors.update({f"{name}/{size}": t for name, t in bufs.items()})
        return {name: t.data_ptr() for name, t in tensors.items()}

    first = storage()
    rng = np.random.default_rng(10)
    scheduler = ContinuousBatchingScheduler(engine)
    for n in (5, 13, 9):
        scheduler.submit(rng.integers(1, TINY["vocab_size"], n), 5)
    steps = 0
    while not scheduler.idle:
        scheduler.step()
        steps += 1
        assert storage() == first
    assert steps > 5 and engine.step_counts["decode"] > 0
    engine.warmup()   # a fresh warm-up fills the same buffers again
    assert storage() == first
