# Speculative decoding in the port (flashy_tpu_torch/models/decoding.py
# `speculative_acceptance`, `nucleus_filter`, `generate`'s top-k/top-p,
# and the engine's [S, k+1] verify step, `decode_speculative`) on the
# CPU: greedy acceptance and the filters bitwise against the JAX
# package, rejection sampling held to the target law, the verify step
# token-exact against `generate` under adversarial drafts on the dense
# and paged layouts, and the rollback after a full rejection.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY, tiny_pair

V = TINY["vocab_size"]


def test_acceptance_greedy_bitwise_vs_jax():
    from flashy_tpu.models.decoding import speculative_acceptance as jax_acc
    from flashy_tpu_torch.models.decoding import speculative_acceptance
    rng = np.random.default_rng(0)
    batch, k, vocab = 64, 4, 11
    logits = rng.normal(size=(batch, k + 1, vocab)).astype(np.float32)
    # ties in some rows: argmax takes the first maximum in both packages
    logits[::7, :, 3] = logits[::7, :, 5] = logits[::7].max(-1) + 1.0
    target = logits.argmax(-1)
    drafts = rng.integers(0, vocab, (batch, k))
    # a matching prefix of every length 0..k, then a random tail
    for row in range(batch):
        keep = row % (k + 1)
        drafts[row, :keep] = target[row, :keep]
    out, accepted = speculative_acceptance(torch.from_numpy(drafts),
                                           torch.from_numpy(logits),
                                           pad_token=-1)
    jout, jacc = jax_acc(jnp.asarray(drafts, jnp.int32), jnp.asarray(logits),
                         pad_token=-1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(accepted.numpy(), np.asarray(jacc))
    assert set(accepted.tolist()) == set(range(k + 1))


@pytest.mark.parametrize("proposal", ["one_hot", "draft_probs"])
def test_acceptance_sampling_follows_the_target_law(proposal):
    # rejection sampling emits an exact sample of the target: over 20000
    # draws on a 6-token vocabulary the first emitted token's frequencies
    # lie within total variation 0.02 of softmax(logits[0] / T) (the
    # sampling error alone is ~0.006 here), whether the drafts are one-hot
    # or come with a proposal distribution
    from flashy_tpu_torch.models.decoding import speculative_acceptance
    n, k, vocab, temperature = 20000, 2, 6, 0.8
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((1, k + 1, vocab), generator=g).expand(n, -1, -1)
    draft_probs = None
    if proposal == "one_hot":
        drafts = torch.full((n, k), 2)
    else:
        q = torch.softmax(torch.randn((1, k, vocab), generator=g), -1)
        draft_probs = q.expand(n, -1, -1)
        drafts = torch.multinomial(draft_probs[:, 0], 1, replacement=True,
                                   generator=g).expand(n, k).clone()
        drafts[:, 1] = torch.multinomial(draft_probs[:, 1], 1,
                                         replacement=True, generator=g)[:, 0]
    out, accepted = speculative_acceptance(
        drafts, logits, temperature=temperature, draft_probs=draft_probs,
        generator=torch.Generator().manual_seed(4))
    want = torch.softmax(logits[0, 0] / temperature, -1)
    got = torch.bincount(out[:, 0], minlength=vocab).double() / n
    tv = 0.5 * (got - want.double()).abs().sum().item()
    assert tv < 0.02, (tv, got, want)
    assert 0 < accepted.float().mean().item() < k
    with pytest.raises(ValueError, match="Generator"):
        speculative_acceptance(drafts, logits, temperature=1.0)


def _jax_sample_logits(logits, temperature, top_k, top_p):
    """The JAX `generate`'s sampling logits (its inner `sample` before the
    categorical draw), spelled with the same jnp operations."""
    from flashy_tpu.models.decoding import nucleus_filter
    logits = jnp.asarray(logits) / temperature
    if top_k is not None:
        kth = jnp.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = jnp.where(logits < kth, -1e30, logits)
    if top_p is not None:
        logits = nucleus_filter(logits, top_p)
    return np.asarray(logits)


@pytest.mark.parametrize("top_k,top_p", [(None, 0.5), (None, 0.9),
                                         (5, None), (5, 0.7), (None, 1.0),
                                         (1, None)])
def test_filters_bitwise_vs_jax(top_k, top_p):
    from flashy_tpu.models.decoding import nucleus_filter as jax_nucleus
    from flashy_tpu_torch.models.decoding import (filter_logits,
                                                  nucleus_filter)
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 40)).astype(np.float32) * 2
    # ties at and around every cutoff: repeated values in each row
    logits[:, 20:30] = logits[:, :10]
    logits[3] = 0.5
    if top_p is not None:
        np.testing.assert_array_equal(
            nucleus_filter(torch.from_numpy(logits), top_p).numpy(),
            np.asarray(jax_nucleus(jnp.asarray(logits), top_p)))
    got = filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_array_equal(
        got.numpy(), _jax_sample_logits(logits, 0.7, top_k, top_p))
    # the argmax always survives; ties with the cutoff all stay
    kept = got.numpy() > -1e29
    assert kept[np.arange(16), logits.argmax(-1)].all()
    cutoff = np.where(kept, logits, np.inf).min(-1, keepdims=True)
    np.testing.assert_array_equal(kept, logits >= cutoff)


def test_generate_top_k_top_p_and_range():
    from flashy_tpu_torch.models.decoding import generate
    _, _, model = tiny_pair(seed=6)
    prompt = np.random.default_rng(7).integers(0, V, (2, 5))
    greedy = generate(model, prompt, max_new_tokens=6, device="cpu")
    g = torch.Generator().manual_seed(0)
    # top_k=1 and a tiny top_p keep the argmax alone: greedy
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        sampled = generate(model, prompt, max_new_tokens=6, temperature=1.0,
                           generator=g, device="cpu", **kw)
        assert torch.equal(sampled, greedy)
    a, b = (generate(model, prompt, max_new_tokens=6, temperature=1.5,
                     top_k=8, top_p=0.9, device="cpu",
                     generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    assert torch.equal(a, b) and int(a.max()) < V
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            generate(model, prompt, max_new_tokens=2, temperature=1.0,
                     top_p=bad, generator=g, device="cpu")


def _engine(model, layout, **kw):
    from flashy_tpu_torch.serve.engine import DecodeEngine
    layout_kw = {"block_size": 4} if layout == "paged" else {}
    return DecodeEngine(model, slots=2, max_seq_len=64, spec_k=3,
                        cache_layout=layout, device="cpu", **layout_kw, **kw)


def _admit(engine, slot_prompt):
    """Prefill each prompt into its own slot; returns their first tokens."""
    firsts = []
    for prompt in slot_prompt:
        slot = engine.acquire_slot()
        if engine.chunk is None:
            firsts.append(engine.prefill(slot, prompt))
            continue
        start = engine.admit(slot, prompt, 40)
        first = None
        while first is None:
            start, first = engine.prefill_chunk(slot, prompt, start)
        firsts.append(first)
    return firsts


@pytest.mark.parametrize("drafts", ["reject", "accept", "random"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_speculative_token_exact(layout, drafts):
    # whatever is proposed, greedy verification emits generate()'s tokens:
    # drafts that never match (full rejection), the target's own greedy
    # continuation (full acceptance), and random ones
    from flashy_tpu_torch.models.decoding import generate
    _, _, model = tiny_pair(seed=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, V, n) for n in (5, 11)]
    new = 24
    want = [generate(model, p[None], max_new_tokens=new + 4,
                     device="cpu")[0].numpy()[len(p):] for p in prompts]
    engine = _engine(model, layout)
    engine.warmup(prompt_lengths=[len(p) for p in prompts])
    emitted = [[first] for first in _admit(engine, prompts)]
    k = engine.spec_k
    while min(len(e) for e in emitted) < new:
        proposal = np.zeros((2, k), np.int64)
        for s, e in enumerate(emitted):
            n = len(e)
            if drafts == "accept":
                proposal[s] = want[s][n:n + k]
            elif drafts == "reject":
                proposal[s] = (want[s][n:n + k] + 1) % V
            else:
                proposal[s] = rng.integers(0, V, k)
        out, accepted = engine.decode_speculative(proposal)
        for s, e in enumerate(emitted):
            e.extend(out[s, :accepted[s] + 1].tolist())
            assert engine.slot_length(s) == len(prompts[s]) + len(e) - 1
        if drafts == "accept":
            assert accepted.tolist() == [k, k]
        elif drafts == "reject":
            assert accepted.tolist() == [0, 0]
    for s, e in enumerate(emitted):
        np.testing.assert_array_equal(e[:new], want[s][:new])
    assert engine.compile_cache.stats()["recompiles"] == 0
    if engine.pool is not None:
        engine.pool.check()


def test_rollback_after_full_rejection():
    # after a forced full rejection the slot's rows up to the accepted
    # position equal a fresh prefill's of the same tokens, within 1e-6
    # absolute in f32. The JAX package's own version of this test
    # (tests/test_speculative.py) claims bit-identity and fails on this
    # CPU by 3.1e-7: the verify step's rows come out of a [S, k+1]
    # forward, a fresh prefill's out of a [1, bucket] one, and the
    # matmuls round differently at those shapes.
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.serve.engine import DecodeEngine
    _, _, model = tiny_pair(seed=10)
    prompt = np.asarray([5, 9, 2, 14, 7])
    want = generate(model, prompt[None], max_new_tokens=4,
                    device="cpu")[0].numpy()[len(prompt):]
    engine = DecodeEngine(model, slots=2, spec_k=3, device="cpu")
    engine.warmup(prompt_lengths=[len(prompt)])
    slot = engine.acquire_slot()
    first = engine.prefill(slot, prompt)
    assert first == want[0]
    # drafts that differ from the greedy continuation: full rejection
    _, accepted = engine.decode_speculative(
        np.tile((want[1:4] + 1) % V, (2, 1)))
    assert int(accepted[slot]) == 0
    n = len(prompt) + 1          # the prompt and the verified `first`
    assert engine.slot_length(slot) == n
    fresh = DecodeEngine(model, slots=2, device="cpu")
    fresh_slot = fresh.acquire_slot()
    fresh.prefill(fresh_slot, np.concatenate([prompt, [first]]))
    for name, entry in engine.cache_box.value.items():
        for leaf in ("k", "v"):
            got = entry[leaf][slot, :n]
            ref = fresh.cache_box.value[name][leaf][fresh_slot, :n]
            assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("mixer", ["ssd", "ssd,attention"])
def test_spec_k_on_the_ssd_layout_raises(mixer):
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.serve.engine import DecodeEngine
    model = TransformerLM(TransformerConfig(
        **TINY, mixer=mixer, ssd_state_dim=8, ssd_chunk=8,
        dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        DecodeEngine(model, slots=2, cache_layout="ssd", spec_k=2,
                     device="cpu")
    engine = DecodeEngine(model, slots=2, cache_layout="ssd", chunk=8,
                          device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        engine.decode_speculative(np.zeros((2, 2), np.int64))


def test_pool_reserves_spec_overshoot():
    from flashy_tpu.serve.paged import BlockPool as JaxPool
    from flashy_tpu_torch.serve.paged import BlockPool
    _, _, model = tiny_pair(seed=11)
    engine = _engine(model, "paged")
    assert engine.pool.spec_overshoot == engine.spec_k == 3
    kw = dict(num_blocks=40, block_size=4, max_seq_len=64)
    for overshoot in (0, 3, 5):
        pool = BlockPool(**kw, spec_overshoot=overshoot)
        jax_pool = JaxPool(**kw, spec_overshoot=overshoot)
        for prompt, new in ((5, 3), (8, 8), (13, 0), (60, 4)):
            assert pool.reserve_blocks_for(prompt, new) \
                == jax_pool.reserve_blocks_for(prompt, new)
    assert BlockPool(**kw, spec_overshoot=3).reserve_blocks_for(8, 8) \
        > BlockPool(**kw).reserve_blocks_for(8, 8)
