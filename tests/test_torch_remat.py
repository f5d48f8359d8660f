# The LM's training switches (flashy_tpu_torch/models/transformer.py):
# selective remat (remat_policy 'full', 'dots', 'dots_no_batch') and
# dropout. Remat: the loss and every gradient of each policy against the
# JAX package's on the same converted f32 weights, at the bars of
# tests/test_models.py's remat test (loss rtol 1e-6; gradients rtol
# 1e-5, atol 1e-6), every policy bit-equal to no remat in the port, and
# which aten ops each policy saves for one block. Dropout: off without
# train=True (bit-equal to dropout=0), masks fixed by the seed, the keep
# rate within 3 sigma, remat bit-equal to no remat with dropout on, the
# microbatches of accumulate=2 on distinct masks, and a missing seed
# raising, as flax does without a 'dropout' rng.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ._torch_port import TINY, tiny_pair

POLICIES = ["full", "dots", "dots_no_batch"]


def _tokens(seed=0, batch=2, t=32):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (batch, t)).astype(np.int32)


def _port_loss_and_grads(model, tokens, **kw):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(tokens), **kw)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    return float(loss.detach()), {name: p.grad.clone()
                                  for name, p in model.named_parameters()}


def _jax_loss_and_grads(jax_model, params, tokens):
    def loss_fn(params):
        logits = jax_model.apply(params, tokens)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tokens[:, 1:]).mean()
    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(policy, attention):
    from flashy_tpu_torch.models.convert import params_from_jax
    jax_model, params, model = tiny_pair(
        seed=4, attention=attention, remat=True, remat_policy=policy)
    tokens = _tokens(seed=6)
    want, jax_grads = _jax_loss_and_grads(jax_model, params,
                                          jnp.asarray(tokens))
    loss, grads = _port_loss_and_grads(model, tokens)
    np.testing.assert_allclose(loss, float(want), rtol=1e-6)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jax_grads),
                                 model.config)
    assert set(want_grads) == set(grads)
    for name, grad in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mixer", ["attention", "ssd,attention"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_bit_equal_to_no_remat(policy, mixer):
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    kw = dict(TINY, attention="flash", mixer=mixer, ssd_state_dim=8,
              ssd_chunk=8, dtype=torch.float32)
    plain = TransformerLM(TransformerConfig(**kw), device="cpu", seed=5)
    remat = TransformerLM(TransformerConfig(**kw, remat=True,
                                            remat_policy=policy),
                          device="cpu")
    remat.load_state_dict(plain.state_dict())
    tokens = _tokens(seed=7)
    loss, grads = _port_loss_and_grads(plain, tokens)
    remat_loss, remat_grads = _port_loss_and_grads(remat, tokens)
    assert loss == remat_loss
    for name, grad in grads.items():
        assert torch.equal(remat_grads[name], grad), name


def test_remat_saves_classifies_the_products():
    from flashy_tpu_torch.models.transformer import remat_saves
    aten = torch.ops.aten
    one = torch.empty(1, 4, 4)
    many = torch.empty(8, 4, 4)
    mat = torch.empty(4, 4)
    cases = [(aten.mm.default, (mat, mat), True, True),
             (aten.addmm.default, (mat, mat, mat), True, True),
             (aten.bmm.default, (one, one), True, True),
             (aten.bmm.default, (many, many), True, False),
             (aten.baddbmm.default, (many, one, one), True, True),
             (aten.baddbmm.default, (one, many, many), True, False),
             (aten.mul.Tensor, (mat, mat), False, False),
             (aten.exp.default, (mat,), False, False)]
    for op, args, dots, no_batch in cases:
        assert remat_saves("dots", op, *args) is dots, op
        assert remat_saves("dots_no_batch", op, *args) is no_batch, op
        assert remat_saves("full", op, *args) is False, op


def _saved_products(policy, attention):
    """The (op, lhs shape) pairs that the policy saves in one block's
    checkpointed forward (B 2, T 16, dim 32, 4 heads)."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)
    from flashy_tpu_torch.models import transformer
    cfg = transformer.TransformerConfig(**TINY, attention=attention,
                                        dtype=torch.float32)
    block = transformer.Block(cfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    saved = []

    def policy_fn(ctx, op, *args, **kwargs):
        if transformer.remat_saves(policy, op, *args):
            if not ctx.is_recompute:
                lhs = args[0] if op != torch.ops.aten.baddbmm.default \
                    else args[1]
                saved.append((str(op), tuple(lhs.shape)))
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    x = torch.randn(2, 16, 32, requires_grad=True)
    positions = torch.arange(16).expand(2, 16)
    out = checkpoint(block, x, positions, use_reentrant=False,
                     context_fn=functools.partial(
                         create_selective_checkpoint_contexts, policy_fn))
    out.sum().backward()
    return sorted(saved)


PROJECTIONS = [("aten.bmm.default", (1, 32, 32)),    # qkv (einsum)
               ("aten.bmm.default", (1, 32, 32)),    # out (einsum)
               ("aten.mm.default", (32, 32)),        # mlp up
               ("aten.mm.default", (32, 128))]       # mlp down
SCORES = [("aten.bmm.default", (8, 16, 8)),          # q k^T, [B*H, T, Dh]
          ("aten.bmm.default", (8, 16, 16))]         # p v


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_what_each_policy_saves_for_one_block(attention):
    dots = _saved_products("dots", attention)
    if attention == "dense":
        assert dots == sorted(PROJECTIONS + SCORES)
    else:
        # on the CPU flash runs the kernels' plain blockwise version,
        # whose products have a batch; on the card the kernel is a
        # launch no policy sees
        extra = list(dots)
        for item in PROJECTIONS:
            extra.remove(item)
        assert extra and all(shape[0] > 1 for _, shape in extra)
    assert _saved_products("dots_no_batch", attention) == sorted(PROJECTIONS)
    assert _saved_products("full", attention) == []


def _dropout_model(dropout=0.25, remat=False, policy="full", mixer=None,
                   seed=0):
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    kw = dict(TINY, attention="flash", dropout=dropout, remat=remat,
              remat_policy=policy, dtype=torch.float32)
    if mixer:
        kw.update(mixer=mixer, ssd_state_dim=8, ssd_chunk=8)
    return TransformerLM(TransformerConfig(**kw), device="cpu", seed=seed)


def test_dropout_is_off_without_train():
    tokens = torch.from_numpy(_tokens())
    model = _dropout_model(0.25)
    plain = _dropout_model(0.0)
    plain.load_state_dict(model.state_dict())
    want = plain(tokens)
    assert torch.equal(model(tokens), want)
    assert torch.equal(model(tokens, dropout_seed=3), want)
    model.train()   # nn.Module.training plays no part
    assert torch.equal(model(tokens), want)
    assert torch.equal(plain(tokens, train=True, dropout_seed=3), want)
    assert not torch.equal(model(tokens, train=True, dropout_seed=3), want)


def test_dropout_masks_follow_the_seed():
    tokens = torch.from_numpy(_tokens())
    model = _dropout_model(0.25, mixer="ssd,attention")
    first = model(tokens, train=True, dropout_seed=11)
    assert torch.equal(model(tokens, train=True, dropout_seed=11), first)
    assert not torch.equal(model(tokens, train=True, dropout_seed=12), first)


def test_dropout_keep_rate_and_scale():
    from flashy_tpu_torch.models.transformer import dropout, fold_seed
    n, rate = 200_000, 0.1
    x = torch.ones(n)
    out = dropout(x, rate, fold_seed(5, 0, 1))
    kept = int((out != 0).sum())
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept - n * (1 - rate)) <= 3 * sigma, kept
    assert torch.equal(out[out != 0], torch.full((kept,), 1 / (1 - rate)))
    # different sites of one layer draw different masks
    other = dropout(x, rate, fold_seed(5, 0, 0))
    assert not torch.equal(other != 0, out != 0)
    assert torch.equal(dropout(x, 1.0, 3), torch.zeros(n))
    assert dropout(x, 0.1, None) is x


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_with_dropout_bit_equal_to_no_remat(policy):
    tokens = _tokens(seed=2)
    plain = _dropout_model(0.2, mixer="ssd,attention")
    remat = _dropout_model(0.2, remat=True, policy=policy,
                           mixer="ssd,attention")
    remat.load_state_dict(plain.state_dict())
    loss, grads = _port_loss_and_grads(plain, tokens, train=True,
                                       dropout_seed=9)
    remat_loss, remat_grads = _port_loss_and_grads(remat, tokens, train=True,
                                                   dropout_seed=9)
    assert loss == remat_loss
    for name, grad in grads.items():
        assert torch.equal(remat_grads[name], grad), name


def test_accumulated_microbatches_draw_distinct_masks():
    from flashy_tpu_torch.examples.lm.solver import value_and_grad
    from flashy_tpu_torch.models.transformer import fold_seed
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    model = _dropout_model(0.3)
    micro = _tokens(seed=4, batch=2, t=16)
    tokens = torch.from_numpy(np.concatenate([micro, micro]))
    seeds, losses = [], []

    def loss_fn(m, t, dropout_seed):
        seeds.append(dropout_seed)
        loss = lm_next_token_loss(m, t, train=True, dropout_seed=dropout_seed)
        losses.append(float(loss))
        return loss

    total = value_and_grad(model, loss_fn, tokens, accumulate=2,
                           dropout_seed=21)
    assert seeds == [fold_seed(21, 0), fold_seed(21, 1)]
    # the same tokens twice: only the masks tell the microbatches apart
    assert losses[0] != losses[1]
    assert float(total) == pytest.approx(sum(losses) / 2, rel=1e-6)
    # without a seed the loss function gets no dropout_seed
    value_and_grad(model, lambda m, t: lm_next_token_loss(m, t), tokens,
                   accumulate=2)


def test_train_step_passes_the_dropout_seed():
    from flashy_tpu_torch.examples.lm.solver import (build_optimizer,
                                                     train_step)
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    cfg = {"epochs": 1, "steps_per_epoch": 4, "warmup_steps": 1, "lr": 1e-2,
           "weight_decay": 0.1}
    tokens = torch.from_numpy(_tokens(seed=8, batch=2, t=16))
    results = []
    for seed in (1, 1, 2):
        model = _dropout_model(0.3, seed=3)
        optimizer, schedule = build_optimizer(model, cfg)
        metrics = train_step(
            model, optimizer, schedule, 1, tokens,
            lambda m, t, dropout_seed: lm_next_token_loss(
                m, t, train=True, dropout_seed=dropout_seed),
            dropout_seed=seed)
        results.append(float(metrics["loss"]))
    assert results[0] == results[1] != results[2]


def test_dropout_without_a_seed_raises():
    model = _dropout_model(0.1)
    tokens = torch.from_numpy(_tokens())
    with pytest.raises(ValueError, match="dropout_seed"):
        model(tokens, train=True)


def test_fold_seed_is_stable_and_spreads():
    from flashy_tpu_torch.models.transformer import fold_seed
    # fixed values: a change of the mixing function changes every mask
    assert fold_seed(0) == fold_seed(0) < 2 ** 63
    seeds = {fold_seed(s, layer, site) for s in range(4)
             for layer in range(12) for site in range(2)}
    assert len(seeds) == 4 * 12 * 2
    assert fold_seed(1, 2) != fold_seed(2, 1)
    assert fold_seed(-1) == fold_seed(2 ** 64 - 1)
