# The port's MLP, ResNet and ViT against the JAX package's on the same
# weights (carried across by models.convert), all in f32 on the CPU:
#  * MLP logits within 1e-6;
#  * ResNet at a tiny width (stage_sizes (1, 1), 8 filters, Basic and
#    Bottleneck blocks, 16x16 and 15x15 inputs, both stems): train-mode
#    logits within 1e-4, the updated batch_stats within 1e-5 of max
#    |value|, eval-mode logits within 1e-4 (f32 reduction order);
#  * flax's 'SAME' padding at stride 2, which a symmetric padding=1 does
#    not reproduce;
#  * ViT (dim 32, 2 heads of 16, 16 patches), dense and flash (the
#    kernels' plain versions here), within 1e-4; bidirectional; a
#    non-square image raises;
#  * the converters' round trip and their guards.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-4
STATS_RTOL = 1e-5


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(variables, seed):
    """Random BatchNorm scales, biases and statistics (the init's zero
    scales would hide each block's residual branch)."""
    rng = np.random.default_rng(seed)

    def leaf(path, value):
        name = path[-1].key
        if name in ("scale", "bias", "mean"):
            return (rng.normal(size=value.shape) * 0.5
                    + (name == "scale")).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        return value

    return jax.tree_util.tree_map_with_path(leaf, _numpy(variables))


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_mlp_matches_jax():
    from flashy_tpu.models import MLP as JaxMLP
    from flashy_tpu_torch.models import MLP
    from flashy_tpu_torch.models.convert import mlp_from_jax
    x = np.random.default_rng(0).normal(size=(5, 12)).astype(np.float32)
    jax_model = JaxMLP([16, 8, 3])
    params = _numpy(jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 12))))
    model = MLP([16, 8, 3], in_features=12, device="cpu")
    model.load_state_dict(mlp_from_jax(params, model))
    got = model(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax_model.apply(params, x))
    assert np.abs(got - want).max() <= 1e-6


@functools.lru_cache(maxsize=None)
def _resnet_variables(block, small):
    """The JAX ResNet and its perturbed variables (one init a layout: the
    parameters do not depend on the image size)."""
    from flashy_tpu.models.resnet import (BasicBlock as JaxBasic,
                                          BottleneckBlock as JaxBottleneck,
                                          ResNet as JaxResNet)
    jax_block = {"basic": JaxBasic, "bottleneck": JaxBottleneck}[block]
    jax_model = JaxResNet((1, 1), jax_block, num_filters=8,
                          small_inputs=small, dtype=jnp.float32)
    variables = jax_model.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 16, 16, 3)), train=False)
    return jax_model, _perturbed(variables, seed=int(small))


def _resnet_pair(block, small):
    from flashy_tpu_torch.models.convert import resnet_from_jax
    from flashy_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock,
                                                ResNet)
    jax_model, variables = _resnet_variables(block, small)
    model = ResNet((1, 1), {"basic": BasicBlock,
                            "bottleneck": BottleneckBlock}[block],
                   num_filters=8, small_inputs=small, dtype=torch.float32,
                   device="cpu")
    model.load_state_dict(resnet_from_jax(variables, model))
    return jax_model, variables, model


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("side", [16, 15])
def test_resnet_train_and_eval_match_jax(block, small, side):
    jax_model, variables, model = _resnet_pair(block, small)
    x = np.random.default_rng(side).normal(
        size=(4, side, side, 3)).astype(np.float32)
    want, mutated = jax_model.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
    got = model(torch.from_numpy(x), train=True).detach().numpy()
    assert _max_rel(got, np.asarray(want)) <= TOL
    state = model.state_dict()
    stats = jax.tree_util.tree_flatten_with_path(
        _numpy(mutated["batch_stats"]))[0]
    assert len(stats) == sum(name.endswith((".mean", ".var"))
                             for name in state)
    for path, value in stats:
        name = ".".join(key.key for key in path)
        assert _max_rel(state[name].numpy(), value) <= STATS_RTOL, name
    # eval: the updated statistics on both sides
    want = jax_model.apply({"params": variables["params"],
                            "batch_stats": mutated["batch_stats"]}, x,
                           train=False)
    got = model(torch.from_numpy(x), train=False).detach().numpy()
    assert _max_rel(got, np.asarray(want)) <= TOL


def test_resnet_grads_match_jax():
    import optax
    from flashy_tpu_torch.models.convert import resnet_from_jax
    jax_model, variables, model = _resnet_pair("basic", True)
    x = np.random.default_rng(3).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    labels = np.array([0, 3, 7, 9], np.int32)

    def loss_fn(params):
        logits, _ = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    grads = jax.grad(loss_fn)(variables["params"])
    loss = torch.nn.functional.cross_entropy(
        model(torch.from_numpy(x), train=True),
        torch.from_numpy(labels).long())
    loss.backward()
    want = resnet_from_jax({"params": _numpy(grads),
                            "batch_stats": variables["batch_stats"]}, model)
    for name, param in model.named_parameters():
        assert _max_rel(param.grad.numpy(), want[name].numpy()) <= TOL, name


@pytest.mark.parametrize("side", [32, 16])
def test_same_padding_is_flaxs_not_symmetric(side):
    # stride 2, 3x3: flax pads (0, 1) on an even side; torch's padding=1
    # keeps the shape but reads other pixels
    import flax.linen as nn
    from flashy_tpu_torch.models.layers import Conv
    x = np.random.default_rng(side).normal(
        size=(2, side, side, 4)).astype(np.float32)
    jax_conv = nn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False)
    params = _numpy(jax_conv.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jax_conv.apply(params, x))
    conv = Conv(4, 6, (3, 3), torch.Generator().manual_seed(0),
                torch.device("cpu"), strides=(2, 2))
    conv.kernel.data = torch.tensor(params["params"]["kernel"])
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(nchw, torch.float32).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    symmetric = torch.nn.functional.conv2d(
        nchw, conv.kernel.permute(3, 2, 0, 1), stride=2, padding=1)
    symmetric = symmetric.permute(0, 2, 3, 1).detach().numpy()
    assert symmetric.shape == want.shape
    assert np.abs(symmetric - want).max() > 0.1


def _vit_pair(attention):
    from flashy_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxConfig
    from flashy_tpu_torch.models import ViT, ViTConfig
    from flashy_tpu_torch.models.convert import vit_from_jax
    kw = dict(image_size=16, patch_size=4, num_classes=10, dim=32,
              num_layers=2, num_heads=2)
    jax_model = JaxViT(JaxConfig(**kw, dtype=jnp.float32, attention="dense"))
    params = _numpy(jax_model.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 16, 16, 3))))
    model = ViT(ViTConfig(**kw, dtype=torch.float32, attention=attention),
                device="cpu")
    model.load_state_dict(vit_from_jax(params, model))
    return jax_model, params, model


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_matches_jax_and_is_bidirectional(attention):
    jax_model, params, model = _vit_pair(attention)
    assert model.config.num_patches == 16
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(jax_model.apply(params, x))
    got = model(torch.from_numpy(x))
    assert _max_rel(got.detach().numpy(), want) <= TOL
    # a change in the last patch moves every patch's output: the pooled
    # logits move, and so does the first patch's encoding
    changed = x.copy()
    changed[:, 12:, 12:] += 1.0
    first = {}

    def keep(module, args, output):
        first.setdefault("out", []).append(output[:, 0].detach().clone())

    handle = model.block_1.register_forward_hook(keep)
    with torch.no_grad():
        model(torch.from_numpy(x))
        model(torch.from_numpy(changed))
    handle.remove()
    before, after = first["out"]
    assert float((before - after).abs().max()) > 1e-3


def test_vit_refuses_other_image_shapes():
    _, _, model = _vit_pair("dense")
    with pytest.raises(ValueError, match="square"):
        model(torch.zeros(1, 16, 12, 3))
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros(1, 20, 20, 3))


def test_converters_round_trip_and_refuse_mismatches():
    from flashy_tpu_torch.models import MLP
    from flashy_tpu_torch.models.convert import (mlp_from_jax,
                                                 resnet_from_jax,
                                                 vit_from_jax)
    _, variables, model = _resnet_pair("bottleneck", False)
    state = resnet_from_jax(variables, model)
    assert set(state) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(state[name], value), name
    # a missing statistic, a wrong shape, an extra leaf
    broken = jax.tree.map(np.copy, variables)
    del broken["batch_stats"]["stem_norm"]["var"]
    with pytest.raises(KeyError, match="stem_norm/var"):
        resnet_from_jax(broken, model)
    broken = jax.tree.map(np.copy, variables)
    broken["params"]["head"]["kernel"] = np.zeros((3, 10), np.float32)
    with pytest.raises(ValueError, match="head/kernel"):
        resnet_from_jax(broken, model)
    broken = jax.tree.map(np.copy, variables)
    broken["params"]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        resnet_from_jax(broken, model)
    with pytest.raises(KeyError, match="batch_stats"):
        resnet_from_jax({"params": variables["params"]}, model)
    _, params, vit = _vit_pair("dense")
    inner = vit_from_jax(params["params"], vit)    # the inner tree works
    assert all(torch.equal(inner[k], v) for k, v in vit.state_dict().items())
    mlp = MLP([4, 2], in_features=3, device="cpu")
    with pytest.raises(KeyError, match="layers_1"):
        mlp_from_jax({"layers_0": {"kernel": np.zeros((3, 4), np.float32),
                                   "bias": np.zeros(4, np.float32)}}, mlp)
