# The port's scan-stacked TransformerLM (`scan_layers=True`,
# flashy_tpu_torch/models/transformer.py StackedBlocks) on the CPU in
# f32: JAX `blocks/block/...` trees convert (attention, SSD and MoE
# stacks) and give the JAX model's logits within 1e-5 of max |logit|;
# the stacked model equals a per-layer model with the same weights
# bitwise, in logits, loss and every gradient (restacked), under every
# training switch; stacked `generate` is token-exact against the JAX
# package's; and the LM solver trains, resumes and evaluates with
# model.scan_layers=true.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_port import TINY, jax_generate, tiny_pair

LOGIT_RTOL = 1e-5        # of max |logit|, f32
SSD = dict(mixer="ssd", ssd_state_dim=8, ssd_chunk=8, ssd_kernel="gather")
MOE = dict(moe_experts=4, moe_top_k=2)
LAYOUTS = {"attention": {}, "ssd": SSD,
           "moe": dict(MOE, moe_dispatch="dropless")}


def _tokens(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], shape).astype(np.int32)


def _restack(state, layers):
    """A per-layer state dict's block leaves stacked into the stacked
    model's `blocks.block.<leaf>` names."""
    out = {k: v for k, v in state.items() if not k.startswith("block_")}
    for name in state:
        if name.startswith("block_0."):
            leaf = name[len("block_0."):]
            out[f"blocks.block.{leaf}"] = torch.stack(
                [state[f"block_{i}.{leaf}"] for i in range(layers)])
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stacked_tree_converts_and_matches_jax_logits(layout):
    jax_model, params, model = tiny_pair(seed=1, scan_layers=True,
                                         **LAYOUTS[layout])
    state = model.state_dict()
    assert "blocks.block.norm1.scale" in state
    assert not any(k.startswith("block_") for k in state)
    assert all(v.shape[0] == TINY["num_layers"] for k, v in state.items()
               if k.startswith("blocks."))
    tokens = _tokens(2)
    want = np.asarray(jax_model.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


def test_stacked_converter_checks_leaves():
    from flashy_tpu_torch.models.convert import params_from_jax
    _, params, model = tiny_pair(seed=1, scan_layers=True)
    tree = jax.tree.map(np.asarray, params)["params"]
    wrong = jax.tree.map(lambda a: a, tree)
    # a per-layer shape where the stacked one is expected
    wrong["blocks"]["block"]["mlp"]["up"]["kernel"] = \
        tree["blocks"]["block"]["mlp"]["up"]["kernel"][0]
    with pytest.raises(ValueError, match="blocks/block/mlp/up/kernel"):
        params_from_jax(wrong, model.config)
    unknown = jax.tree.map(lambda a: a, tree)
    unknown["blocks"]["block"]["ssd"] = {}
    with pytest.raises(ValueError, match="ssd"):
        params_from_jax(unknown, model.config)
    with pytest.raises(KeyError, match="blocks"):
        params_from_jax({k: v for k, v in tree.items() if k != "blocks"},
                        model.config)
    per_layer = {k: v for k, v in tree.items() if k != "blocks"}
    per_layer["block_0"] = {}
    with pytest.raises(ValueError, match="block_0"):
        params_from_jax(per_layer, model.config)


SWITCHES = {
    "dense": dict(attention="dense"),
    "flash": dict(attention="flash"),
    "remat_full": dict(attention="flash", remat=True),
    "remat_dots": dict(attention="flash", remat=True, remat_policy="dots"),
    "remat_dots_no_batch": dict(attention="flash", remat=True,
                                remat_policy="dots_no_batch"),
    "dropout": dict(attention="flash", dropout=0.1),
    "ssd": dict(SSD),
    "moe_einsum": dict(MOE, moe_dispatch="einsum"),
    "moe_sorted": dict(MOE, moe_dispatch="sorted"),
    "moe_dropless_remat": dict(MOE, moe_dispatch="dropless", remat=True,
                               remat_policy="dots", dropout=0.1),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_stacked_equals_per_layer_bitwise(switch):
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    kw = dict(TINY, num_layers=3, dtype=torch.float32, **SWITCHES[switch])
    per_layer = TransformerLM(TransformerConfig(**kw), device="cpu", seed=5)
    stacked = TransformerLM(TransformerConfig(**kw, scan_layers=True),
                            device="cpu", seed=5)
    # the same seed draws the same weights in both layouts
    restacked = _restack(per_layer.state_dict(), 3)
    assert set(restacked) == set(stacked.state_dict())
    for name, value in stacked.state_dict().items():
        assert torch.equal(restacked[name], value), name
    tokens = torch.from_numpy(_tokens(3))
    model_kw = {"train": True, "dropout_seed": 11} \
        if "dropout" in kw else {}
    aux = 0.01 if "moe_experts" in kw else None
    losses, grads = [], []
    for model in (per_layer, stacked):
        loss = lm_next_token_loss(model, tokens, aux_weight=aux, **model_kw)
        loss.backward()
        losses.append(loss.detach())
        grads.append({name: p.grad for name, p in model.named_parameters()})
    assert torch.equal(losses[0], losses[1])
    restacked = _restack(grads[0], 3)
    assert set(restacked) == set(grads[1])
    for name, grad in grads[1].items():
        assert torch.equal(restacked[name], grad), name


def test_stacked_parameters_are_registered_once():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    model = TransformerLM(TransformerConfig(**TINY, **MOE,
                                            scan_layers=True,
                                            dtype=torch.float32),
                          device="cpu")
    names = [name for name, _ in model.named_parameters()]
    assert len(names) == len(set(names)) == len(model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.numel() for v in model.state_dict().values())
    # the EMA path: the model run on other weights of the same names
    shadow = {name: p.detach() * 0.5 for name, p in model.named_parameters()}
    tokens = torch.from_numpy(_tokens(4))
    with torch.no_grad():
        own = model(tokens)
        other = torch.func.functional_call(model, shadow, (tokens,))
        again = model(tokens)
    assert not torch.equal(own, other) and torch.equal(own, again)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stacked_generate_token_exact_vs_jax(layout):
    from flashy_tpu_torch.models.decoding import generate, init_cache
    jax_model, params, model = tiny_pair(seed=3, scan_layers=True,
                                         **LAYOUTS[layout])
    cache = init_cache(model.config, 3, 20, "cpu")
    lead = (TINY["num_layers"], 3)
    assert all(t.shape[:2] == lead for t in cache.values())
    prompt = _tokens(7, (3, 9))
    want = jax_generate(jax_model, params, prompt, max_new_tokens=10)
    got = generate(model, prompt, max_new_tokens=10, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_lm_solver_trains_resumes_and_evaluates_stacked(tmp_path):
    from flashy_tpu_torch.examples.lm import solver as lm
    args = ["device=cpu", "model.vocab_size=256", "model.dim=32",
            "model.num_layers=2", "model.num_heads=4", "seq_len=32",
            "batch_size=4", "steps_per_epoch=3", "valid_steps=1",
            "warmup_steps=2", "lr=1e-2", "model.scan_layers=true",
            "ema_decay=0.9", f"dora.dir={tmp_path}"]
    first = lm.main(args + ["epochs=1"])
    assert first.model.config.scan_layers
    assert "blocks.block.attn.qkv.kernel" in first.state["ema"]
    resumed = lm.main(args + ["epochs=2"])
    assert resumed.restored and resumed.state["step"] == 6
    losses = [entry["train"]["loss"] for entry in resumed.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert np.isfinite(resumed.history[-1]["valid"]["loss"])
