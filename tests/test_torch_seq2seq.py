# The port's Seq2SeqTransformer against the JAX package's on the same
# weights (seq2seq_from_jax), in f32 on the CPU: teacher-forced logits
# within 1e-4 of max |logit| with dense and flash self-attention (the
# kernels' plain versions here); `encode` alone; the encoder
# bidirectional and the decoder causal; `cached_translate` token-exact
# against the JAX package's and against the port's `greedy_translate`.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TINY = dict(vocab_size=64, dim=32, enc_layers=2, dec_layers=2, num_heads=2,
            max_seq_len=32)
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_pair():
    from flashy_tpu.models.seq2seq import (Seq2SeqConfig as JaxConfig,
                                           Seq2SeqTransformer as JaxModel)
    model = JaxModel(JaxConfig(**TINY, dtype=jnp.float32, attention="dense"))
    src, tgt = _tokens()
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                 src, tgt))
    return model, params


def _port(attention):
    from flashy_tpu_torch.models import Seq2SeqConfig, Seq2SeqTransformer
    from flashy_tpu_torch.models.convert import seq2seq_from_jax
    _, params = _jax_pair()
    model = Seq2SeqTransformer(Seq2SeqConfig(**TINY, dtype=torch.float32,
                                             attention=attention),
                               device="cpu")
    model.load_state_dict(seq2seq_from_jax(params, model))
    return model


def _tokens(seed=1, batch=3, s=12, t=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(2, TINY["vocab_size"], (batch, s)).astype(np.int32),
            rng.integers(2, TINY["vocab_size"], (batch, t)).astype(np.int32))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_and_encode_match_jax(attention):
    from flashy_tpu.models.seq2seq import Seq2SeqTransformer as JaxModel
    jax_model, params = _jax_pair()
    model = _port(attention)
    src, tgt = _tokens()
    want = np.asarray(jax_model.apply(params, src, tgt))
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
        memory = model.encode(torch.from_numpy(src)).numpy()
    assert got.shape == (3, 10, TINY["vocab_size"]) and got.dtype == np.float32
    assert _rel(got, want) <= TOL
    want_memory = np.asarray(jax_model.apply(params, src,
                                             method=JaxModel.encode))
    assert _rel(memory, want_memory) <= TOL


def test_encoder_is_bidirectional_and_decoder_causal():
    model = _port("flash")
    src, tgt = _tokens()
    other_src, other_tgt = src.copy(), tgt.copy()
    other_src[:, -1] = (src[:, -1] + 1) % TINY["vocab_size"]
    other_tgt[:, -1] = (tgt[:, -1] + 1) % TINY["vocab_size"]
    with torch.no_grad():
        memory = model.encode(torch.from_numpy(src))
        moved = model.encode(torch.from_numpy(other_src))
        logits = model.decode(torch.from_numpy(tgt), memory)
        later = model.decode(torch.from_numpy(other_tgt), memory)
    # the last source token reaches the first position's encoding ...
    assert float((memory[:, 0] - moved[:, 0]).abs().max()) > 1e-4
    # ... but the last target token reaches no earlier decoder position
    assert torch.equal(logits[:, :-1], later[:, :-1])
    assert float((logits[:, -1] - later[:, -1]).abs().max()) > 1e-4


def test_cached_translate_is_token_exact():
    from flashy_tpu.models.seq2seq import cached_translate as jax_cached
    from flashy_tpu_torch.models import cached_translate, greedy_translate
    jax_model, params = _jax_pair()
    model = _port("flash")
    src, _ = _tokens(seed=5, batch=4, s=12)
    want = np.asarray(jax_cached(jax_model, params, jnp.asarray(src),
                                 max_new_tokens=12))
    got = cached_translate(model, src, max_new_tokens=12).numpy()
    oracle = greedy_translate(model, src, max_new_tokens=12).numpy()
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    with pytest.raises(ValueError, match="max_seq_len"):
        cached_translate(model, src, max_new_tokens=TINY["max_seq_len"])


def test_cache_and_shardings_surface():
    from flashy_tpu_torch.models import (Seq2SeqConfig, init_decode_cache,
                                         seq2seq_shardings)
    cfg = Seq2SeqConfig(**TINY)
    cache = init_decode_cache(cfg, 2, 9, device="cpu")
    assert set(cache) == {"dec_blocks_0", "dec_blocks_1"}
    assert cache["dec_blocks_0"]["k"].shape == (2, 9, 2, 16)
    assert cache["dec_blocks_0"]["v"].dtype == torch.bfloat16
    # the spec of every leaf equals the JAX package's on the same weights
    from flashy_tpu.models.seq2seq import seq2seq_shardings as jax_specs
    _, params = _jax_pair()
    want = {"/".join(str(getattr(k, "key", k)) for k in path[1:]):
            tuple(spec) for path, spec in jax.tree_util.tree_flatten_with_path(
                jax_specs(params),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}
    model = _port("dense")
    got = {name.replace(".", "/"): tuple(spec) for name, spec in
           seq2seq_shardings(dict(model.named_parameters())).items()}
    assert got == want
    assert got["dec_blocks_0/xattn/kv/kernel"] == ("fsdp", None, "tensor",
                                                   None)
    with pytest.raises(ValueError, match="max_seq_len"):
        model.encode(torch.zeros(1, 40, dtype=torch.long))
