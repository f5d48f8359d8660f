# The serving engine (flashy_tpu_torch/serve/engine.py) on the model
# layouts of ROADMAP queue A item 3's L7 and L8, on the CPU in f32: MoE
# blocks, scan-stacked stacks (stacked caches and pools, the stacked
# copy-on-write fork) and int8 weights (`params=`, from
# `quantize_lm_params`), on the dense, paged, ssd and speculative
# layouts, every greedy stream token-exact against the port's
# `generate` on the same weights, the MoE streams also against the JAX
# engine; both of `_moe_forward`'s evaluation orders run inside the
# engine; nothing is built after the warm-up.
import numpy as np
import pytest
import torch

from ._torch_port import TINY, tiny_pair

MAX_NEW = 6
MAX_SEQ = 128
MOE = dict(moe_experts=4, moe_top_k=2, max_seq_len=MAX_SEQ)
SCAN = dict(scan_layers=True)
SSD = dict(mixer="ssd", ssd_state_dim=8, ssd_chunk=8, ssd_kernel="gather")
MODELS = {"moe": MOE, "scan": dict(SCAN, max_seq_len=MAX_SEQ),
          "scan_moe": dict(MOE, **SCAN)}
LAYOUTS = {"dense": dict(cache_layout="dense"),
           "dense_chunk8": dict(cache_layout="dense", chunk=8),
           "paged": dict(cache_layout="paged", block_size=4),
           "dense_spec": dict(cache_layout="dense", spec_k=3),
           "paged_spec": dict(cache_layout="paged", block_size=4, spec_k=3)}


def _prompts(seed, lengths=(5, 70, 14, 9)):
    """Four prompts; the 70-token one is past `_MOE_GATHER_MAX_TOKENS`,
    so a monolithic prefill of it streams over the experts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], n).astype(np.int32)
            for n in lengths]


def _serve(model, prompts, params=None, draft=None, **engine_kw):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    engine = DecodeEngine(model, slots=2, max_seq_len=MAX_SEQ, device="cpu",
                          params=params, **engine_kw)
    engine.warmup(prompt_lengths=[len(p) for p in prompts])
    before = engine.compile_cache.stats()
    scheduler = ContinuousBatchingScheduler(engine, draft=draft)
    requests = [scheduler.submit(p, MAX_NEW) for p in prompts]
    scheduler.run()
    after = engine.compile_cache.stats()
    assert after["misses"] == before["misses"] and after["recompiles"] == 0
    return engine, [r.output for r in requests]


def _expected(model, prompts, params=None):
    from flashy_tpu_torch.models.decoding import generate
    return [generate(model, p[None], max_new_tokens=MAX_NEW, params=params,
                     device="cpu")[0].numpy() for p in prompts]


def _draft(engine_kw):
    from flashy_tpu_torch.serve.draft import NGramDraft
    k = engine_kw.get("spec_k")
    return None if k is None else NGramDraft(slots=2, k=k)


@pytest.fixture()
def moe_orders(monkeypatch):
    """The token counts N of every `_moe_forward` call."""
    from flashy_tpu_torch.models import decoding
    seen, forward = [], decoding._moe_forward

    def spy(cfg, mp, x):
        seen.append(x.shape[0] * x.shape[1])
        return forward(cfg, mp, x)

    monkeypatch.setattr(decoding, "_moe_forward", spy)
    return seen


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(MODELS))
def test_streams_token_exact_vs_generate(kind, layout, moe_orders):
    from flashy_tpu_torch.models.decoding import _MOE_GATHER_MAX_TOKENS
    _, _, model = tiny_pair(seed=21, **MODELS[kind])
    prompts = _prompts(22)
    want = _expected(model, prompts)
    del moe_orders[:]
    engine_kw = LAYOUTS[layout]
    engine, got = _serve(model, prompts, draft=_draft(engine_kw),
                         **engine_kw)
    for out, ref in zip(got, want):
        np.testing.assert_array_equal(out, ref)
    if "spec_k" in engine_kw:
        assert engine.step_counts["verify"] > 0
    if "moe_experts" in MODELS[kind]:
        # decode steps gather; a monolithic 70-token prefill streams
        assert min(moe_orders) <= _MOE_GATHER_MAX_TOKENS
        streams = layout in ("dense", "dense_spec")
        assert (max(moe_orders) > _MOE_GATHER_MAX_TOKENS) == streams


def test_moe_streams_match_the_jax_engine():
    from flashy_tpu.serve.engine import DecodeEngine
    from flashy_tpu.serve.scheduler import ContinuousBatchingScheduler
    jax_model, params, model = tiny_pair(seed=23, **MOE)
    prompts = _prompts(24)
    _, got = _serve(model, prompts, cache_layout="paged", block_size=4)
    engine = DecodeEngine(jax_model, params, slots=2, max_seq_len=MAX_SEQ,
                          cache_layout="paged", block_size=4)
    engine.warmup(prompt_lengths=[len(p) for p in prompts])
    scheduler = ContinuousBatchingScheduler(engine)
    requests = [scheduler.submit(p, MAX_NEW) for p in prompts]
    scheduler.run()
    for out, request in zip(got, requests):
        np.testing.assert_array_equal(out, request.output)


@pytest.mark.parametrize("layout", ["dense", "paged", "paged_spec"])
@pytest.mark.parametrize("kind", ["per_layer", "scan_moe"])
def test_int8_weights_serve_token_exact(kind, layout):
    from flashy_tpu_torch.models.decoding import lm_params
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    overrides = {} if kind == "per_layer" else MODELS[kind]
    _, _, model = tiny_pair(seed=25, **{"max_seq_len": MAX_SEQ,
                                        **overrides})
    qp = quantize_lm_params(lm_params(model))
    prompts = _prompts(26)
    engine_kw = dict(LAYOUTS[layout])
    if layout == "paged":
        engine_kw["kv_dtype"] = "int8"
    engine, got = _serve(model, prompts, params=qp,
                         draft=_draft(engine_kw), **engine_kw)
    want = _expected(model, prompts, params=qp)
    if layout == "paged":
        # int8 K/V rows: the streams the dense-cache reference keeps
        want = [w for w, o in zip(want, got) if np.array_equal(w, o)]
        assert len(want) >= 2
    else:
        for out, ref in zip(got, want):
            np.testing.assert_array_equal(out, ref)
    # the weights stay int8 in the engine
    block = engine._params["blocks"]["block"] if model.config.scan_layers \
        else engine._params["block_0"]
    assert block["attn"]["qkv"]["kernel"]["q"].dtype == torch.int8


def test_int8_model_draft_serves_token_exact():
    from flashy_tpu_torch.models.decoding import lm_params
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    from flashy_tpu_torch.serve.draft import ModelDraft
    _, _, target = tiny_pair(seed=27, max_seq_len=MAX_SEQ)
    _, _, small = tiny_pair(seed=28, max_seq_len=MAX_SEQ, num_layers=1,
                            **SCAN)
    draft = ModelDraft(small, slots=2, k=3, max_seq_len=MAX_SEQ,
                       device="cpu",
                       params=quantize_lm_params(lm_params(small)))
    prompts = _prompts(29)
    draft.warmup([len(p) for p in prompts])
    _, got = _serve(target, prompts, draft=draft, spec_k=3)
    for out, ref in zip(got, _expected(target, prompts)):
        np.testing.assert_array_equal(out, ref)
    assert draft.engine.compile_cache.stats()["recompiles"] == 0
    assert draft.engine.step_counts["decode"] > 0


def test_stacked_paged_fork_copies_every_layer():
    # a prefix-shared admission forks a partially shared block: the
    # stacked pool copies it on axis 1, in every layer's slab
    from flashy_tpu_torch.serve.engine import DecodeEngine
    _, _, model = tiny_pair(seed=30, **MODELS["scan_moe"])
    engine = DecodeEngine(model, slots=2, max_seq_len=MAX_SEQ,
                          cache_layout="paged", block_size=4, device="cpu")
    engine.warmup()
    prompt = _prompts(31, lengths=(10,))[0]
    slot = engine.acquire_slot()
    start, first = engine.admit(slot, prompt, 4), None
    while first is None:
        start, first = engine.prefill_chunk(slot, prompt, start)
    fork = np.concatenate([prompt[:6], [1, 2, 3]]).astype(np.int32)
    other = engine.acquire_slot()
    assert engine.admit(other, fork, 4) == 6
    assert engine.pool.stats()["cow_forks"] == 1
    src, dst = (int(b) for b in engine._copy_blocks[:, 0])
    pool = engine.cache_box.value
    assert pool["k"].shape[:2] == (TINY["num_layers"], engine.num_blocks)
    for leaf in pool.values():
        assert torch.equal(leaf[:, dst], leaf[:, src])
        assert leaf[:, dst].abs().sum() > 0
    start, first = 6, None
    while first is None:
        start, first = engine.prefill_chunk(other, fork, start)
    from flashy_tpu_torch.models.decoding import generate
    want = generate(model, fork[None], max_new_tokens=1, device="cpu")
    assert first == int(want[0, -1])


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunk8"])
def test_stacked_ssd_serves_token_exact(chunk):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    _, _, model = tiny_pair(seed=32, **SSD, **MOE, **SCAN)
    prompts = _prompts(33)
    engine, got = _serve(model, prompts, cache_layout="ssd", chunk=chunk)
    assert engine.unbounded
    state = engine.cache_box.value["ssd"]
    assert state.shape[:2] == (TINY["num_layers"], 2)
    assert engine.cache_bytes() == state.numel() * 4 == 2 * \
        engine.state_bytes_per_slot()
    for out, ref in zip(got, _expected(model, prompts)):
        np.testing.assert_array_equal(out, ref)
    assert isinstance(engine, DecodeEngine)
