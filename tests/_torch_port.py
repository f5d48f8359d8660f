"""Shared set-up of the PyTorch port's parity tests: one tiny JAX
TransformerLM and its port counterpart on the same (converted) weights,
both computing in f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY = dict(vocab_size=256, dim=32, num_layers=2, num_heads=4,
            max_seq_len=64)


def tiny_pair(seed: int = 0, **overrides):
    """(jax_model, jax_params, port_model) with identical f32 weights
    (dense attention unless `attention=` says otherwise)."""
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    kw = {**TINY, "attention": "dense", **overrides}
    jax_model = JaxLM(JaxConfig(**kw, dtype=jnp.float32))
    # only the parameters: an MoE model's init also returns the losses
    # its layers sow, which `apply(..., mutable=["losses"])` would extend
    params = {"params": jax.jit(jax_model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]}
    cfg = TransformerConfig(**kw, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    return jax_model, params, model


def jax_generate(jax_model, params, prompt, **kw):
    """The JAX package's `generate` under one jit (a third of the eager
    call's compile time on the CPU); returns numpy tokens."""
    from flashy_tpu.models.decoding import generate
    fn = jax.jit(lambda p, x: generate(jax_model, p, x, **kw))
    return np.asarray(fn(params, jnp.asarray(prompt, jnp.int32)))
