# The port's draft providers (flashy_tpu_torch/serve/draft.py) and the
# scheduler's speculative branch on the CPU: `NGramDraft` proposes what
# the JAX package's proposes over the same scripted histories, the
# `ModelDraft` mirror takes k+1 decode steps for k drafts and resyncs to
# the verified position, and a scheduler run with a draft keeps the JAX
# scheduler's speculative counters on the same weights and workload.
import numpy as np
import pytest

from ._torch_port import TINY, tiny_pair

V = TINY["vocab_size"]


def _scripted(draft):
    """Drive a draft through begin / propose / observe / retire over
    fixed histories; returns every proposal."""
    rng = np.random.default_rng(0)
    pattern = rng.integers(0, 20, 3)
    proposals = []
    draft.begin(0, np.tile(pattern, 4), 7)
    draft.begin(2, np.arange(1, 6), 1)
    draft.begin(3, np.asarray([9]), 9)
    proposals.append(np.asarray(draft.propose()))
    for step in range(6):
        draft.observe(0, pattern[step % 3:step % 3 + 2], 0)
        draft.observe(2, rng.integers(0, 6, 3), 0)
        draft.observe(3, [9, 9] if step % 2 else [4], 0)
        proposals.append(np.asarray(draft.propose()))
    draft.retire(2)
    draft.begin(1, rng.integers(0, 4, 30), 2)
    for _ in range(3):
        draft.observe(1, rng.integers(0, 4, 2), 0)
        proposals.append(np.asarray(draft.propose()))
    return proposals


@pytest.mark.parametrize("k,ngram,window", [(4, 2, 1024), (3, 3, 1024),
                                            (5, 1, 6)])
def test_ngram_proposals_identical_to_jax(k, ngram, window):
    from flashy_tpu.serve.draft import NGramDraft as JaxNGram
    from flashy_tpu_torch.serve.draft import NGramDraft
    got = _scripted(NGramDraft(slots=4, k=k, ngram=ngram, pad_token=-1,
                               window=window))
    want = _scripted(JaxNGram(slots=4, k=k, ngram=ngram, pad_token=-1,
                              window=window))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        NGramDraft(slots=1, k=0)


def test_model_draft_mirror_steps_and_resync():
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.serve.draft import ModelDraft
    _, _, model = tiny_pair(seed=20)
    prompt = np.random.default_rng(21).integers(1, V, 9)
    want = generate(model, prompt[None], max_new_tokens=8,
                    device="cpu")[0].numpy()[len(prompt):]
    k = 3
    # the target as its own draft proposes the target's greedy stream
    draft = ModelDraft(model, slots=2, k=k, device="cpu")
    draft.warmup(prompt_lengths=[len(prompt)])
    engine = draft.engine
    assert engine.cache_layout == "dense" and engine.cache_scope == "draft"
    assert "draft/decode/2" in engine.compile_cache.executables()
    draft.begin(1, prompt, int(want[0]))
    assert engine.slot_length(1) == len(prompt)
    before = engine.step_counts["decode"]
    proposal = draft.propose()
    assert engine.step_counts["decode"] == before + k + 1
    assert proposal.shape == (2, k)
    np.testing.assert_array_equal(proposal[1], want[1:k + 1])
    # k + 1 steps wrote the last draft's row: the mirror ran k + 1 ahead
    assert engine.slot_length(1) == len(prompt) + k + 1
    # the verify step kept one draft and emitted a bonus: resync there
    draft.observe(1, want[1:3], len(prompt) + 2)
    assert engine.slot_length(1) == len(prompt) + 2
    np.testing.assert_array_equal(draft.propose()[1], want[3:3 + k])
    draft.retire(1)
    assert engine.live_count == 0
    assert engine.compile_cache.stats()["recompiles"] == 0
    # the tracer reaches the mirror engine, whose steps it spans
    from flashy_tpu_torch.observability import Tracer
    tracer = Tracer()
    traced = ModelDraft(model, slots=2, tracer=tracer, device="cpu")
    assert traced.engine.tracer is tracer
    traced.engine.decode()
    assert [e["name"] for e in tracer.events if e["ph"] == "X"] == [
        "serve/decode"]


def _repetitive(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pattern = rng.integers(0, V, int(rng.integers(2, 5)))
        length = int(rng.choice([4, 6, 9, 12]))
        out.append(np.tile(pattern, length // len(pattern) + 1)[:length]
                   .astype(np.int32))
    return out


def test_scheduler_spec_counters_match_jax():
    # the same weights, workload and n-gram draft through both packages'
    # schedulers (dense layout, chunk 8): the same streams and the same
    # speculative counters, step by step
    from flashy_tpu.serve.draft import NGramDraft as JaxNGram
    from flashy_tpu.serve.engine import DecodeEngine as JaxEngine
    from flashy_tpu.serve.scheduler import \
        ContinuousBatchingScheduler as JaxScheduler
    from flashy_tpu_torch.serve.draft import NGramDraft
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    jax_model, params, model = tiny_pair(seed=22)
    prompts = _repetitive(6, 23)
    k = 3

    def run(scheduler):
        requests = [scheduler.submit(p, 14) for p in prompts]
        scheduler.run()
        return [r.output for r in requests], scheduler.metrics

    engine = DecodeEngine(model, slots=3, max_seq_len=64, chunk=8,
                          spec_k=k, device="cpu")
    engine.warmup()
    got, metrics = run(ContinuousBatchingScheduler(
        engine, draft=NGramDraft(slots=3, k=k, ngram=3)))
    jax_engine = JaxEngine(jax_model, params, slots=3, max_seq_len=64,
                           chunk=8, spec_k=k)
    jax_engine.warmup()
    want, jax_metrics = run(JaxScheduler(
        jax_engine, draft=JaxNGram(slots=3, k=k, ngram=3)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in ("spec_steps", "spec_drafted", "spec_accepted",
                 "spec_emitted", "accepted_per_step", "tokens"):
        assert getattr(metrics, name) == getattr(jax_metrics, name), name
    summary, jax_summary = metrics.summary(), jax_metrics.summary()
    for name in ("spec_drafted", "spec_emitted", "acceptance_rate",
                 "accepted_per_step_p50"):
        assert summary[name] == jax_summary[name], name
    assert metrics.spec_accepted > 0
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingScheduler(engine, draft=NGramDraft(slots=3, k=2))
