# The port's TransformerLM, converter and dense-cache decoding
# (flashy_tpu_torch/models) held against the JAX package on converted
# weights, in f32 on the CPU. Logits agree to 1e-4 (f32 reduction order
# through two layers); greedy streams must be token-exact.
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ._torch_port import TINY, jax_generate, tiny_pair


def test_converter_round_trip_and_guards():
    from flashy_tpu_torch.models.convert import params_from_jax
    jax_model, params, model = tiny_pair(seed=4)
    tree = jax.tree.map(np.asarray, params)
    state = model.state_dict()
    assert set(state) == set(params_from_jax(tree, model.config))
    np.testing.assert_array_equal(state["embed"].numpy(),
                                  tree["params"]["embed"])
    np.testing.assert_array_equal(
        state["block_1.attn.qkv.kernel"].numpy(),
        tree["params"]["block_1"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(
        state["block_0.mlp.down.kernel"].numpy(),
        tree["params"]["block_0"]["mlp"]["down"]["kernel"])
    assert all(t.dtype == torch.float32 for t in state.values())
    # the inner tree converts the same as the variables dict
    inner = params_from_jax(tree["params"], model.config)
    assert all(torch.equal(inner[k], state[k]) for k in state)
    # a stacked tree for a per-layer config raises (stacked trees
    # convert for a scan_layers config: tests/test_torch_scan.py)
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax({**tree["params"], "blocks": {}}, model.config)
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["params"]["norm_f"]["scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(wrong, model.config)


def test_uncached_logits_match_jax():
    jax_model, params, model = tiny_pair(seed=1)
    tokens = np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                               (2, 11)).astype(np.int32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_unported_paths_raise_not_implemented():
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.serve.engine import DecodeEngine
    from flashy_tpu_torch.parallel import make_mesh
    base = dict(TINY, dtype=torch.float32)
    # expert parallelism is ported (its exchange needs the mesh, as in
    # the JAX package); expert composed with fsdp is not
    with pytest.raises(ValueError, match="needs the mesh"):
        TransformerLM(TransformerConfig(**base, moe_experts=2,
                                        moe_dispatch="dropless_ep"),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh({"expert": 2, "fsdp": 2})
    # scan_layers=True is ported: the stacked model builds and serves
    stacked = TransformerLM(TransformerConfig(**base, scan_layers=True),
                            device="cpu")
    assert stacked.blocks.block.attn.qkv.kernel.shape[0] == TINY["num_layers"]
    engine = DecodeEngine(stacked, slots=2, device="cpu")
    assert set(engine.cache_box.value) == {"k", "v"}
    # a hybrid stack serves on the ssd layout: dense slabs beside the
    # states, so it keeps the max_seq_len ceiling
    hybrid = TransformerLM(TransformerConfig(**base, mixer="ssd,attention"),
                           device="cpu")
    engine = DecodeEngine(hybrid, slots=2, cache_layout="ssd", device="cpu")
    assert not engine.unbounded and engine.pool is None
    assert set(engine.cache_box.value["block_1"]) == {"k", "v"}


def test_apply_step_logits_match_jax():
    from flashy_tpu.models.decoding import _apply_step as jax_step
    from flashy_tpu.models.decoding import init_cache as jax_cache
    from flashy_tpu_torch.models.decoding import (_apply_step,
                                                  decode_params, init_cache)
    jax_model, params, model = tiny_pair(seed=2)
    cfg = model.config
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    total = 6 + 3
    jcache = jax_cache(jax_model.config, 2, total)
    cache = init_cache(cfg, 2, total, "cpu")
    p = decode_params(model)
    tokens, start = prompt, 0
    for step in range(4):       # one prefill + 3 decode steps
        n = tokens.shape[1]
        positions = np.broadcast_to(np.arange(start, start + n), (2, n))
        jl, jcache = jax_step(jax_model, params, jax_model.config,
                              jnp.asarray(tokens),
                              jnp.asarray(positions, jnp.int32), jcache,
                              jnp.int32(start))
        with torch.no_grad():
            tl, cache = _apply_step(p, cfg, torch.from_numpy(tokens),
                                    torch.from_numpy(positions.copy()),
                                    cache, start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        start += n
        tokens = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    np.testing.assert_allclose(cache["block_1"]["k"].numpy(),
                               np.asarray(jcache["block_1"]["k"]),
                               atol=1e-5, rtol=0)


def test_generate_greedy_token_exact_vs_jax():
    from flashy_tpu_torch.models.decoding import generate
    jax_model, params, model = tiny_pair(seed=3)
    prompt = np.random.default_rng(7).integers(
        0, TINY["vocab_size"], (3, 7)).astype(np.int32)
    want = jax_generate(jax_model, params, prompt, max_new_tokens=12)
    got = generate(model, prompt, max_new_tokens=12, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # eos pinning: a row stays at eos after emitting it
    eos = int(want[0, 9])
    want_eos = jax_generate(jax_model, params, prompt, max_new_tokens=12,
                            eos_token=eos)
    got_eos = generate(model, prompt, max_new_tokens=12, eos_token=eos,
                       device="cpu").numpy()
    np.testing.assert_array_equal(got_eos, want_eos)
    assert (got_eos[0, 9:] == eos).all()


def test_generate_sampling_uses_the_generator():
    from flashy_tpu_torch.models.decoding import generate
    _, _, model = tiny_pair(seed=3)
    prompt = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="Generator"):
        generate(model, prompt, max_new_tokens=4, temperature=1.0,
                 device="cpu")

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(model, prompt, max_new_tokens=8, temperature=1.0,
                        generator=g, device="cpu")

    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))


def test_head_dim_128_logits_and_grads_match_jax():
    # The d128 layout's head width (2 heads of 128 at dim 256; the card's
    # path is 8 heads of 128 at dim 1024) with attention='flash': the port
    # through the flash kernels' plain versions (on CUDA f32 takes the
    # general route, bf16 the Hopper kernels built at 128), the JAX package
    # through its Pallas kernels in interpret mode, on converted weights.
    # Logits 1e-4 absolute; the loss 1e-5
    # relative; every gradient within 1e-4 of its leaf's max |value|
    # (f32 reduction order through two layers and the head).
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.ops.attention import flash_route
    jax_model, params, model = tiny_pair(seed=5, attention="flash", dim=256,
                                         num_heads=2)
    assert model.config.head_dim == 128
    assert flash_route(128, "flash_bwd_fused", torch.float32) == "general"
    tokens = np.random.default_rng(6).integers(
        0, TINY["vocab_size"], (2, 32)).astype(np.int32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(tokens)))
    logits = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-4,
                               rtol=0)

    def jax_loss(p):
        out = jax_model.apply(p, jnp.asarray(tokens))
        return optax.softmax_cross_entropy_with_integer_labels(
            out[:, :-1], jnp.asarray(tokens[:, 1:])).mean()

    want_loss, jax_grads = jax.value_and_grad(jax_loss)(params)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        torch.from_numpy(tokens[:, 1:]).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jax_grads),
                                 model.config)
    for name, p in model.named_parameters():
        scale = float(want_grads[name].abs().max())
        err = float((p.grad - want_grads[name]).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)
