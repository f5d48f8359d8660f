# The port's training path on the tiny LM, held against the JAX package
# on identical f32 weights: the loss and every gradient with
# attention='flash' (the JAX side through its Pallas kernels in
# interpret mode, the port through the kernels' plain versions), packed
# batches (segment_ids), remat, gradient accumulation, and four updates
# of the optimizer chain the LM solver builds. Model tolerance: max abs
# error over max abs value <= 1e-4 per leaf (f32 reduction order through
# two layers and the head); optimizer: loss and grad_norm 1e-5 relative,
# parameters 1e-5 relative in norm per leaf.
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ._torch_port import TINY, tiny_pair


def _tokens(seed=0, batch=2, t=32):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (batch, t)).astype(np.int32)


def _jax_loss(jax_model, **kw):
    def loss(params, tokens):
        logits = jax_model.apply(params, tokens, **kw)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tokens[:, 1:]).mean()
    return loss


def _port_loss_and_grads(model, tokens, **kw):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(tokens), **kw)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    return float(loss.detach()), {name: p.grad.clone()
                                  for name, p in model.named_parameters()}


def _assert_grads_close(got, jax_grads, cfg, rel):
    from flashy_tpu_torch.models.convert import params_from_jax
    want = params_from_jax(jax.tree.map(np.asarray, jax_grads), cfg)
    assert set(want) == set(got)
    for name, grad in want.items():
        scale = float(grad.abs().max())
        err = float((got[name] - grad).abs().max())
        assert err <= rel * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("packed", [False, True])
def test_flash_lm_loss_and_grads_match_jax(packed):
    jax_model, params, model = tiny_pair(attention="flash")
    tokens = _tokens()
    kw = {}
    if packed:
        # two packed documents and padding per row; rotary phases restart
        # per document
        segments = np.array([[1] * 10 + [2] * 14 + [0] * 8,
                             [1] * 20 + [2] * 12], np.int32)
        positions = np.concatenate([np.arange(10), np.arange(14),
                                    np.arange(8)])[None].repeat(2, 0)
        positions[1] = np.concatenate([np.arange(20), np.arange(12)])
        kw = {"segment_ids": segments, "positions": positions.astype(
            np.int32)}
    want, jax_grads = jax.value_and_grad(_jax_loss(
        jax_model, **{k: jnp.asarray(v) for k, v in kw.items()}))(
            params, jnp.asarray(tokens))
    loss, grads = _port_loss_and_grads(
        model, tokens, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    _assert_grads_close(grads, jax_grads, model.config, 1e-4)


def test_remat_gives_bit_equal_grads():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    _, _, model = tiny_pair(attention="flash")
    cfg = TransformerConfig(**TINY, attention="flash", remat=True,
                            dtype=torch.float32)
    remat = TransformerLM(cfg, device="cpu")
    remat.load_state_dict(model.state_dict())
    tokens = _tokens(seed=3)
    loss, grads = _port_loss_and_grads(model, tokens)
    remat_loss, remat_grads = _port_loss_and_grads(remat, tokens)
    assert loss == remat_loss
    for name, grad in grads.items():
        assert torch.equal(remat_grads[name], grad), name


@pytest.mark.parametrize("overrides,error,match", [
    ({"remat_policy": "bogus"}, ValueError, "remat_policy"),
    ({"mixer": "ssd,mamba"}, ValueError, "mixer"),
    # the exchange needs a mesh (the reference's ValueError)
    ({"moe_experts": 4, "moe_dispatch": "dropless_ep"}, ValueError,
     "needs the mesh"),
    # a stacked model needs one mixer (the reference's ValueError)
    ({"scan_layers": True, "mixer": "ssd,attention"}, ValueError,
     "uniform mixer pattern"),
])
def test_layouts_the_port_lacks_raise(overrides, error, match):
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    cfg = TransformerConfig(**TINY, dtype=torch.float32, **overrides)
    with pytest.raises(error, match=match):
        TransformerLM(cfg, device="cpu")


def test_segment_ids_with_ring_attention_raise():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    cfg = TransformerConfig(**TINY, attention="ring", dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    tokens = torch.from_numpy(_tokens())
    with pytest.raises(ValueError, match="segment_ids"):
        model(tokens, segment_ids=torch.ones_like(tokens))


def _optax_chain(cfg):
    # examples/lm/solver.py's optimizer, as LMSolver builds it
    total = max(cfg["epochs"] * cfg["steps_per_epoch"], 2)
    warmup = min(cfg["warmup_steps"], total // 2)
    schedule = optax.warmup_cosine_decay_schedule(0.0, cfg["lr"], warmup,
                                                  total)
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(schedule,
                                   weight_decay=cfg["weight_decay"]))


def test_optimizer_and_train_step_match_the_optax_chain():
    from flashy_tpu_torch.examples.lm.solver import (build_optimizer,
                                                     train_step)
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    cfg = {"epochs": 3, "steps_per_epoch": 2, "warmup_steps": 2,
           "lr": 1e-2, "weight_decay": 0.1}
    jax_model, params, model = tiny_pair()
    optim = _optax_chain(cfg)
    opt_state = optim.init(params)
    loss_fn = _jax_loss(jax_model)
    optimizer, schedule = build_optimizer(model, cfg)
    norms = []
    for step in range(4):
        tokens = _tokens(seed=10 + step, batch=4, t=24)
        want, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(tokens))
        want_norm = float(optax.global_norm(grads))
        updates, opt_state = optim.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        got = train_step(model, optimizer, schedule, step,
                         torch.from_numpy(tokens),
                         lambda m, t: lm_next_token_loss(m, t))
        np.testing.assert_allclose(float(got["loss"]), float(want),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), want_norm,
                                   rtol=1e-5)
        norms.append(want_norm)
    assert max(norms) > 1.0, norms  # the clip engaged
    # parameters: norm-wise relative error per leaf. Adam divides by
    # sqrt(v), which amplifies the grads' f32 rounding differences
    # elementwise, and optax takes its bias corrections in f32, where
    # 1 - 0.999**t keeps ~5 digits; the port's AdamW takes them in f64.
    want = params_from_jax(jax.tree.map(np.asarray, params), model.config)
    for name, value in model.state_dict().items():
        err = float((value - want[name]).norm() / want[name].norm())
        assert err <= 1e-5, (name, err)


def test_schedule_reads_the_count_before_the_update():
    from flashy_tpu_torch.examples.lm.solver import lr_schedule
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 40)
    got = lr_schedule(3e-4, 5, 40)
    assert got(0) == 0.0
    for count in range(45):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


def test_grad_accumulation_matches_jax():
    from flashy_tpu.parallel import with_grad_accumulation
    from flashy_tpu_torch.examples.lm.solver import value_and_grad
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    jax_model, params, model = tiny_pair()
    tokens = _tokens(seed=5, batch=4, t=16)
    want, jax_grads = with_grad_accumulation(
        jax.value_and_grad(_jax_loss(jax_model)), 2)(params,
                                                     jnp.asarray(tokens))
    loss = value_and_grad(model, lambda m, t: lm_next_token_loss(m, t),
                          torch.from_numpy(tokens), accumulate=2)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    grads = {name: p.grad for name, p in model.named_parameters()}
    _assert_grads_close(grads, jax_grads, model.config, 1e-4)
