# The port's int8 weight quantization (flashy_tpu_torch/models/quantize.py
# `quantize_lm_params`) and the quantized decode path
# (models/decoding.py `_kernel`, `_postscale`, the int8 row gather, head
# and expert slabs) against the JAX package on the CPU: payloads and
# scales bit-equal on the same f32 weights (per-layer, scan-stacked and
# MoE trees, with and without keep_embed_dense), quantized decode
# logits within 1e-5 of max |logit| of the JAX package's on its own
# test_quantize.py cases, and quantized `generate` token-exact.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import jax_generate

# flashy_tpu's tests/test_quantize.py `_model`: vocab 128, dim 64, two
# layers of two heads, dense attention, f32
QUANT = dict(vocab_size=128, dim=64, num_layers=2, num_heads=2,
             max_seq_len=64, attention="dense")
LOGIT_RTOL = 1e-5
CASES = {"per_layer": {}, "scan": dict(scan_layers=True),
         "moe": dict(moe_experts=2),
         "scan_moe": dict(scan_layers=True, moe_experts=2, moe_top_k=2),
         "ssd": dict(mixer="ssd", ssd_state_dim=8, ssd_chunk=8,
                     ssd_kernel="gather")}


def _pair(case, seed=1):
    """(jax_model, jax params, port model) on the same f32 weights, and
    the test_quantize.py tokens."""
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    kw = {**QUANT, **CASES[case]}
    jax_model = JaxLM(JaxConfig(**kw, dtype=jnp.float32))
    tokens = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(
        np.int32)
    params = {"params": jax_model.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(tokens))["params"]}
    cfg = TransformerConfig(**kw, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    return jax_model, params, model, tokens


def _flat(tree, prefix=()):
    out = {}
    for key, child in tree.items():
        if isinstance(child, dict):
            out.update(_flat(child, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(child)
    return out


@pytest.mark.parametrize("keep_embed_dense", [False, True],
                         ids=["int8_embed", "dense_embed"])
@pytest.mark.parametrize("case", list(CASES))
def test_payloads_and_scales_bit_equal_to_jax(case, keep_embed_dense):
    from flashy_tpu.models import quantize_lm_params as jax_quantize
    from flashy_tpu_torch.models.decoding import lm_params
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    _, params, model, _ = _pair(case)
    want = _flat(jax_quantize(params, keep_embed_dense=keep_embed_dense)
                 ["params"])
    tree = quantize_lm_params(lm_params(model),
                              keep_embed_dense=keep_embed_dense)
    got = _flat(tree)
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))
    int8 = [p for p in got if p[-1] == "q"]
    assert (("embed", "q") in int8) != keep_embed_dense
    # norms, routers, dt_bias and the SSD kernels stay dense
    assert not any(name in p for p in int8 for name in ("router", "ssd"))
    assert len(int8) > 1


def test_wrapped_tree_dequantize_and_zero_channel():
    from flashy_tpu.models import dequantize_lm_params as jax_dequantize
    from flashy_tpu.models import quantize_lm_params as jax_quantize
    from flashy_tpu_torch.models.decoding import lm_params
    from flashy_tpu_torch.models.quantize import (dequantize,
                                                  dequantize_lm_params,
                                                  quantize_lm_params)
    _, params, model, _ = _pair("per_layer")
    tree = lm_params(model)
    wrapped = quantize_lm_params({"params": tree})
    assert set(wrapped) == {"params"}
    back = _flat(dequantize_lm_params(wrapped)["params"])
    want = _flat(jax_dequantize(jax_quantize(params))["params"])
    assert set(back) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
    # an all-zero output channel quantizes to q == 0, scale 1
    w = torch.zeros((4, 3))
    w[:, 0] = torch.tensor([0.5, -1.0, 0.25, 0.0])
    from flashy_tpu_torch.models.quantize import _quantize
    q = _quantize(w, (0,))
    assert torch.equal(q["scale"][0, 1:], torch.ones(2))
    assert torch.equal(dequantize(q)[:, 1:], torch.zeros((4, 2)))
    assert dequantize(w) is w


@pytest.mark.parametrize("case", ["per_layer", "scan", "moe", "scan_moe"])
def test_quantized_decode_logits_match_jax(case):
    # test_quantize.py's test_quantized_decode_tracks_full_precision
    # cases: one prefill step over the 16 tokens, then one decode step
    from flashy_tpu.models import quantize_lm_params as jax_quantize
    from flashy_tpu.models.decoding import _apply_step as jax_step
    from flashy_tpu.models.decoding import init_cache as jax_cache
    from flashy_tpu_torch.models.decoding import (_apply_step,
                                                  decode_params, init_cache,
                                                  lm_params)
    from flashy_tpu_torch.models.quantize import quantize_lm_params
    jax_model, params, model, tokens = _pair(case)
    cfg = model.config
    qp = decode_params(model, params=quantize_lm_params(lm_params(model)))
    jqp = jax_quantize(params)
    jcache = jax_cache(jax_model.config, 2, 32)
    cache = init_cache(cfg, 2, 32, "cpu")
    step_tokens, start = tokens, 0
    for _ in range(2):
        n = step_tokens.shape[1]
        positions = np.broadcast_to(np.arange(start, start + n), (2, n))
        want, jcache = jax_step(jax_model, jqp, jax_model.config,
                                jnp.asarray(step_tokens),
                                jnp.asarray(positions, jnp.int32), jcache,
                                jnp.int32(start))
        with torch.no_grad():
            got, cache = _apply_step(qp, cfg, torch.from_numpy(step_tokens),
                                     torch.from_numpy(positions.copy()),
                                     cache, start)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(want).max())
        start += n
        step_tokens = want[:, -1:].argmax(-1).astype(np.int32)


@pytest.mark.parametrize("case", ["per_layer", "scan_moe"])
def test_quantized_generate_token_exact_vs_jax(case):
    from flashy_tpu.models import quantize_lm_params as jax_quantize
    from flashy_tpu_torch.models.decoding import generate, lm_params
    from flashy_tpu_torch.models.quantize import (is_quantized,
                                                  quantize_lm_params)
    jax_model, params, model, tokens = _pair(case, seed=2)
    qp = quantize_lm_params(lm_params(model))
    assert is_quantized(qp["embed"])
    want = jax_generate(jax_model, jax_quantize(params), tokens,
                        max_new_tokens=8)
    got = generate(model, tokens, max_new_tokens=8, params=qp,
                   device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # the int8 weights stay resident as int8 in the decode tree
    from flashy_tpu_torch.models.decoding import decode_params
    block = "blocks" if model.config.scan_layers else "block_0"
    tree = decode_params(model, params=qp)[block]
    leaf = (tree["block"]["moe"]["w_up"] if block == "blocks"
            else tree["mlp"]["up"]["kernel"])
    assert leaf["q"].dtype == torch.int8
