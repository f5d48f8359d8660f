# The port's pipeline parallelism in one process, held to the JAX
# package: the pipe=1 paths of `pipeline`, `pipeline_1f1b` and
# `pipelined_value_and_grad` against the reference's, the sequential
# per-microbatch oracle against the reference's on a tiny scan-stacked
# LM (dense and MoE: einsum, aux weight 0.01) at rtol 1e-4 / atol 1e-5,
# the stacked weights carried across by params_from_jax, and the
# validation errors. The multi-rank schedules are in
# test_torch_pipeline_multiproc.py.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashy_tpu.models import TransformerConfig as JaxConfig
from flashy_tpu.models import TransformerLM as JaxLM
from flashy_tpu_torch.models.convert import params_from_jax
from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                 TransformerLM)

LM = dict(vocab_size=64, dim=32, num_layers=4, num_heads=4,
          attention="dense", scan_layers=True)


def _moe(moe):
    return dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=8.0) \
        if moe else {}


def _models(moe, seed=0):
    """The JAX LM's f32 variables and the port's LM on the same weights,
    with a seeded [8, 12] batch."""
    kwargs = {**LM, **_moe(moe)}
    model = JaxLM(JaxConfig(**kwargs, dtype=jnp.float32))
    tokens = np.random.default_rng(seed).integers(0, 64, (8, 12)) \
        .astype(np.int32)
    variables = {"params": jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(tokens))["params"]}
    cfg = TransformerConfig(**kwargs, dtype=torch.float32)
    port = TransformerLM(cfg, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables),
                                         cfg))
    return model, variables, port, cfg, tokens


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _tanh(p, h):
    return torch.tanh(h @ p["w"])


def test_single_stage_pipeline_and_1f1b_match_the_references():
    from flashy_tpu.parallel import make_mesh as jax_mesh
    from flashy_tpu.parallel import pipeline as jax_pipeline
    from flashy_tpu.parallel import pipeline_1f1b as jax_1f1b
    from flashy_tpu_torch.parallel import make_mesh, pipeline, pipeline_1f1b
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    mesh, jmesh = make_mesh({"data": -1}), jax_mesh({"data": -1})
    w1 = rng.normal(size=(1, 8, 8)).astype(np.float32) * 0.3
    got = pipeline(_tanh, {"w": torch.from_numpy(w1)}, torch.from_numpy(x),
                   mesh=mesh)
    want = jax_pipeline(lambda p, h: jnp.tanh(h @ p["w"]),
                        {"w": jnp.asarray(w1)}, jnp.asarray(x), mesh=jmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for interleave in (1, 2):
        w = rng.normal(size=(interleave, 8, 8)).astype(np.float32) * 0.3
        out = pipeline_1f1b(_tanh, {"w": torch.from_numpy(w)},
                            torch.from_numpy(x), mesh=mesh,
                            interleave=interleave)
        jout = jax_1f1b(lambda p, h: jnp.tanh(h @ p["w"]),
                        {"w": jnp.asarray(w)}, jnp.asarray(x), mesh=jmesh,
                        interleave=interleave)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
        lp = rng.normal(size=(8,)).astype(np.float32)
        loss, grads = pipeline_1f1b(
            _tanh, {"w": torch.from_numpy(w)}, torch.from_numpy(x),
            loss_fn=lambda p, h: ((h * p["s"]) ** 2).mean(),
            loss_params={"s": torch.from_numpy(lp)}, mesh=mesh,
            interleave=interleave)
        jloss, jgrads = jax_1f1b(
            lambda p, h: jnp.tanh(h @ p["w"]), {"w": jnp.asarray(w)},
            jnp.asarray(x), loss_fn=lambda p, h: ((h * p["s"]) ** 2).mean(),
            loss_params={"s": jnp.asarray(lp)}, mesh=jmesh,
            interleave=interleave)
        _close(loss, jloss)
        _close(grads["stage_params"]["w"], jgrads["stage_params"]["w"])
        _close(grads["loss_params"]["s"], jgrads["loss_params"]["s"])
        _close(grads["x"], jgrads["x"])


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_sequential_value_and_grad_matches_the_reference(moe):
    from flashy_tpu.models.pipelined import \
        sequential_value_and_grad as jax_sequential
    from flashy_tpu_torch.models import sequential_value_and_grad
    model, variables, port, cfg, tokens = _models(moe)
    weight = 0.01 if moe else 0.0
    jloss, jgrads = jax.jit(jax_sequential(
        model, num_microbatches=4, aux_weight=weight))(
            variables, jnp.asarray(tokens))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    loss, grads = sequential_value_and_grad(
        port, num_microbatches=4, aux_weight=weight)(
            None, torch.from_numpy(tokens).long())
    _close(loss, jloss)
    assert set(grads) == set(want)
    for name, value in want.items():
        _close(grads[name], value)


@pytest.mark.parametrize("schedule,moe", [
    ("gpipe", False), ("1f1b", False), ("packed_1f1b", False),
    ("gpipe", True), ("1f1b", True)])
def test_single_stage_value_and_grad_matches_the_reference(schedule, moe):
    from flashy_tpu.models.pipelined import \
        pipelined_value_and_grad as jax_value_and_grad
    from flashy_tpu.parallel import make_mesh as jax_mesh
    from flashy_tpu_torch.models import pipelined_value_and_grad
    from flashy_tpu_torch.parallel import make_mesh
    model, variables, port, cfg, tokens = _models(moe, seed=1)
    weight = 0.01 if moe else 0.0
    kwargs = dict(num_microbatches=None if schedule == "gpipe" else 2,
                  schedule=schedule, aux_weight=weight)
    jloss, jgrads = jax.jit(jax_value_and_grad(
        model, mesh=jax_mesh({"data": -1}), **kwargs))(
            variables, jnp.asarray(tokens))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    loss, grads = pipelined_value_and_grad(
        port, mesh=make_mesh({"data": -1}), **kwargs)(
            None, torch.from_numpy(tokens).long())
    _close(loss, jloss)
    for name, value in want.items():
        _close(grads[name], value)


def test_params_from_jax_carries_the_stacked_weights():
    _, variables, port, cfg, _ = _models(False)
    block = variables["params"]["blocks"]["block"]
    state = port.state_dict()
    leaves = jax.tree_util.tree_leaves_with_path(block)
    assert len(leaves) == len(port.blocks.names)
    for path, leaf in leaves:
        name = "blocks.block." + ".".join(str(k.key) for k in path)
        assert state[name].shape[0] == cfg.num_layers
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(state["embed"].numpy(),
                                  np.asarray(variables["params"]["embed"]))


def test_validation_errors_equal_the_references():
    from flashy_tpu.models.pipelined import pipelined_apply as jax_apply
    from flashy_tpu.parallel import make_mesh as jax_mesh
    from flashy_tpu.parallel import pipeline_1f1b as jax_1f1b
    from flashy_tpu_torch.models import pipelined_apply
    from flashy_tpu_torch.parallel import (default_overlap, make_mesh,
                                           pipeline_1f1b)
    model, variables, port, _, tokens = _models(False)
    cases = [dict(schedule="packed_1f1b"), dict(schedule="gpipe",
                                                interleave=2),
             dict(schedule="nope"), dict(schedule="1f1b", interleave=3)]
    for kwargs in cases:
        with pytest.raises(ValueError) as want:
            jax_apply(model, variables, jnp.asarray(tokens),
                      mesh=jax_mesh({"data": -1}), **kwargs)
        with pytest.raises(ValueError) as got:
            pipelined_apply(port, torch.from_numpy(tokens).long(),
                            mesh=make_mesh({"data": -1}), **kwargs)
        assert str(got.value) == str(want.value)
    x = torch.ones(4, 8)
    w = {"w": torch.ones(1, 8, 8)}
    for kwargs in (dict(packed=True), dict(overlap=True,
                                           loss_fn=lambda p, h: h.sum())):
        with pytest.raises(ValueError) as want:
            jax_1f1b(lambda p, h: h, {"w": jnp.ones((1, 8, 8))},
                     jnp.ones((4, 8)), mesh=jax_mesh({"data": -1}),
                     **{k: (v if k != "loss_fn" else
                            (lambda p, h: h.sum())) for k, v in
                        kwargs.items()})
        with pytest.raises(ValueError) as got:
            pipeline_1f1b(_tanh, w, x, mesh=make_mesh({"data": -1}),
                          **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="chunk dim"):
        pipeline_1f1b(_tanh, {"w": torch.ones(3, 8, 8)}, x,
                      mesh=make_mesh({"data": -1}))
    assert not default_overlap(True, 1, None, "cpu")
    assert default_overlap(True, 1, None, "cuda")
    assert not default_overlap(True, 2, None, "cuda")
    assert not default_overlap(False, 1, None, "cuda")
