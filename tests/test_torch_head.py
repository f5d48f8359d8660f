# The tied head as the JAX package runs it (ROADMAP T8): operands in the
# compute dtype, f32 accumulation and output (`ops.losses.head_matmul`),
# in the dense head's forward and its backward (dlogits rounded to the
# compute dtype before dX and dEmbed, as the chunked VJP does), in the
# chunked loss and in the decode steps. On the CPU a bf16 tiny model is
# held to the JAX package's: the dense head's logits and gradients and
# the chunked loss's values and gradients on the same bf16 hidden states
# and f32 embedding, and the whole model's loss and gradients. The
# decode head and the forward head are one function: bit-equal logits.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY

# bf16 tolerances, each relative to the largest |value| of the JAX
# result. The head alone: the products of bf16 values are exact in f32,
# so the logits differ by f32 summation order only (1e-5); its gradients
# by the rounding of dlogits to bf16, which the port's VJP applies (as
# the reference's chunked VJP does) and JAX's autodiff of the einsum does
# not, plus one bf16 ulp of the dX output (2^-7; observed 2.8e-3). The
# whole model: bf16 rounds after every product on both sides, in other
# orders: the loss within 1e-4 (observed 9.6e-6), each gradient within
# 5e-2 of its largest |value| (observed 2.4e-2 at worst).
HEAD_TOL, HEAD_GRAD_TOL = 1e-5, 2 ** -7
MODEL_LOSS_TOL, MODEL_GRAD_TOL = 1e-4, 5e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _head_inputs(seed=0, batch=2, t=9, dim=32, vocab=48):
    rng = np.random.default_rng(seed)
    hidden = np.asarray(jnp.asarray(
        rng.standard_normal((batch, t, dim)), jnp.bfloat16).astype(
            jnp.float32))
    embed = (rng.standard_normal((vocab, dim)) * 0.5).astype(np.float32)
    return hidden, embed, rng


def test_dense_head_values_and_grads_match_jax_in_bf16():
    from flashy_tpu_torch.ops.losses import tied_head
    hidden, embed, rng = _head_inputs()
    grad = rng.standard_normal(hidden.shape[:2] + (embed.shape[0],)).astype(
        np.float32)

    def jax_head(x, e):
        return jnp.einsum("btd,vd->btv", x, e.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    jx = jnp.asarray(hidden, jnp.bfloat16)
    want, vjp = jax.vjp(jax_head, jx, jnp.asarray(embed))
    want_dx, want_de = vjp(jnp.asarray(grad))
    x = torch.from_numpy(hidden).to(torch.bfloat16).requires_grad_()
    e = torch.from_numpy(embed).requires_grad_()
    got = tied_head(x, e)
    assert got.dtype == torch.float32
    got.backward(torch.from_numpy(grad))
    assert x.grad.dtype == torch.bfloat16 and e.grad.dtype == torch.float32
    assert _rel(got.detach(), want) <= HEAD_TOL
    assert _rel(x.grad.float(), np.asarray(want_dx.astype(jnp.float32))) \
        <= HEAD_GRAD_TOL
    assert _rel(e.grad, want_de) <= HEAD_GRAD_TOL


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_loss_values_and_grads_match_jax_in_bf16(chunk):
    from flashy_tpu.ops.losses import \
        chunked_softmax_cross_entropy as jax_ce
    from flashy_tpu_torch.ops.losses import chunked_softmax_cross_entropy
    hidden, embed, rng = _head_inputs(seed=chunk)
    labels = rng.integers(0, embed.shape[0], hidden.shape[:2]).astype(
        np.int32)
    grad = rng.standard_normal(hidden.shape[:2]).astype(np.float32)
    want, vjp = jax.vjp(lambda h, w: jax_ce(h, w, jnp.asarray(labels),
                                            chunk),
                        jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(embed))
    want_dx, want_de = vjp(jnp.asarray(grad))
    h = torch.from_numpy(hidden).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(embed).requires_grad_()
    got = chunked_softmax_cross_entropy(h, w, torch.from_numpy(labels), chunk)
    got.backward(torch.from_numpy(grad))
    # both sides round dlogits to bf16 before the two products: f32 sum
    # order, then one bf16 ulp of the dx output
    assert _rel(got.detach(), want) <= HEAD_TOL
    assert _rel(h.grad.float(), np.asarray(want_dx.astype(jnp.float32))) \
        <= HEAD_GRAD_TOL
    assert _rel(w.grad, want_de) <= 1e-5


def _bf16_pair(seed=0):
    """The tiny LM in bf16 on both sides, on the same f32 weights."""
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    kw = {**TINY, "attention": "dense"}
    jax_model = JaxLM(JaxConfig(**kw, dtype=jnp.bfloat16))
    params = {"params": jax.jit(jax_model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]}
    cfg = TransformerConfig(**kw, dtype=torch.bfloat16)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    return jax_model, params, model


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_bf16_model_loss_and_grads_match_jax(mode):
    from flashy_tpu.ops.losses import lm_next_token_loss as jax_loss
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    jax_model, params, model = _bf16_pair(seed=3)
    tokens = np.random.default_rng(4).integers(
        0, TINY["vocab_size"], (2, 24)).astype(np.int32)
    want, grads = jax.value_and_grad(lambda p: jax_loss(
        jax_model, p, jnp.asarray(tokens), mode=mode, chunk_size=5))(params)
    loss = lm_next_token_loss(model, torch.from_numpy(tokens), mode=mode,
                              chunk_size=5)
    loss.backward()
    assert abs(float(loss) - float(want)) <= MODEL_LOSS_TOL * abs(
        float(want))
    want_grads = params_from_jax(jax.tree.map(
        lambda g: np.asarray(g, np.float32), grads), model.config)
    for name, param in model.named_parameters():
        assert _rel(param.grad, want_grads[name].numpy()) <= \
            MODEL_GRAD_TOL, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_head_equals_forward_head(dtype):
    # The reference requires a decode step's logits to equal the uncached
    # forward's on the same hidden states: both heads call head_matmul on
    # the same operands, so they are bit-equal (the embedding is kept in
    # the compute dtype by decode_params).
    from flashy_tpu_torch.models.decoding import _head_logits, decode_params
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.ops.losses import tied_head
    cfg = TransformerConfig(**TINY, dtype=dtype)
    model = TransformerLM(cfg, device="cpu", seed=5)
    params = decode_params(model)
    assert params["embed"].dtype == dtype
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 7, TINY["dim"])).astype(np.float32)).to(dtype)
    with torch.no_grad():
        forward = tied_head(model.norm_f(x), model.embed)
        decode = _head_logits(params, x, cfg)
    assert forward.dtype == decode.dtype == torch.float32
    assert torch.equal(forward, decode)
    # and the row lookup sees the same values as the forward's
    tokens = torch.tensor([[0, 5, 17]])
    assert torch.equal(params["embed"][tokens],
                       model.embed.detach()[tokens].to(dtype))


def test_head_matmul_takes_one_compute_dtype():
    from flashy_tpu_torch.ops.losses import head_matmul
    a = torch.ones((2, 3, 4), dtype=torch.bfloat16)
    b = torch.ones((4, 5), dtype=torch.bfloat16)
    out = head_matmul(a, b)
    assert out.shape == (2, 3, 5) and out.dtype == torch.float32
    assert torch.equal(out, torch.full((2, 3, 5), 4.0))
    with pytest.raises(ValueError, match="dtypes differ"):
        head_matmul(a, b.float())
