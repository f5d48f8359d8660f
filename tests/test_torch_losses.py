# The port's losses (flashy_tpu_torch/ops/losses.py) held against the
# JAX package's: the chunked cross-entropy's values and its custom
# backward (dx, dhead) on identical f32 inputs, with a T the chunk does
# not divide, and the dense and chunked next-token losses of the tiny
# LM. Tolerance 1e-5: f32 reduction order only.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import tiny_pair

TOL = dict(rtol=1e-5, atol=1e-5)


def _ce_inputs(seed=0, batch=2, t=13, dim=8, vocab=31):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((batch, t, dim)).astype(np.float32)
    head = rng.standard_normal((vocab, dim)).astype(np.float32)
    labels = rng.integers(0, vocab, (batch, t)).astype(np.int32)
    grad = rng.standard_normal((batch, t)).astype(np.float32)
    return hidden, head, labels, grad


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_chunked_cross_entropy_values_and_grads_match_jax(chunk):
    from flashy_tpu.ops.losses import \
        chunked_softmax_cross_entropy as jax_ce
    from flashy_tpu_torch.ops.losses import chunked_softmax_cross_entropy
    hidden, head, labels, grad = _ce_inputs(seed=chunk)
    want, vjp = jax.vjp(lambda h, w: jax_ce(h, w, jnp.asarray(labels),
                                            chunk),
                        jnp.asarray(hidden), jnp.asarray(head))
    want_dx, want_dhead = vjp(jnp.asarray(grad))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    got = chunked_softmax_cross_entropy(h, w, torch.from_numpy(labels),
                                        chunk)
    got.backward(torch.from_numpy(grad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dhead), **TOL)
    # against the dense log-softmax, for good measure
    logits = h.detach() @ w.detach().t()
    dense = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(labels).long().reshape(-1), reduction="none")
    np.testing.assert_allclose(got.detach().numpy().reshape(-1),
                               dense.numpy(), **TOL)


def _tokens(seed=1, batch=2, t=24, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (batch, t)
                                                ).astype(np.int32)


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_lm_next_token_loss_matches_jax(mode):
    from flashy_tpu.ops.losses import lm_next_token_loss as jax_loss
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    jax_model, params, model = tiny_pair()
    tokens = _tokens()
    want = jax_loss(jax_model, params, jnp.asarray(tokens), mode=mode,
                    chunk_size=5)
    got = lm_next_token_loss(model, torch.from_numpy(tokens), mode=mode,
                             chunk_size=5)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)


def test_lm_next_token_loss_dense_and_chunked_agree():
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    _, _, model = tiny_pair()
    tokens = torch.from_numpy(_tokens(seed=2))
    results = {}
    for mode in ("dense", "chunked"):
        model.zero_grad()
        loss = lm_next_token_loss(model, tokens, mode=mode, chunk_size=7)
        loss.backward()
        results[mode] = (float(loss), {name: p.grad.clone() for name, p in
                                       model.named_parameters()})
    np.testing.assert_allclose(results["chunked"][0], results["dense"][0],
                               **TOL)
    for name, grad in results["dense"][1].items():
        np.testing.assert_allclose(results["chunked"][1][name].numpy(),
                                   grad.numpy(), **TOL, err_msg=name)


def test_lm_next_token_loss_refuses_an_unknown_mode():
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    _, _, model = tiny_pair()
    with pytest.raises(ValueError, match="mode"):
        lm_next_token_loss(model, torch.from_numpy(_tokens()), mode="bogus")
