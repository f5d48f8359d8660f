"""Weights across the frameworks: the JAX package's parameter pytree ->
this package's `TransformerLM` state dict.

The JAX tree arrives as numpy arrays (`jax.tree.map(np.asarray, ...)`);
leaves keep their layouts and stay f32, so a converted model computes
the same function. Per-layer trees convert, attention, SSD and hybrid
stacks alike (each block's mixer from `mixer_pattern`), with a dense or
an MoE MLP (`moe_experts > 0`); scan-stacked trees raise.
"""
import typing as tp

import numpy as np
import torch

from .transformer import (TODO_DECODE_VARIANTS, TransformerConfig,
                          mixer_pattern)

# Per-block leaves: (path in the flax tree, name in the state dict,
# expected shape from the config), by the block's mixer.
_MIXER_LEAVES = {
    "attention": (
        (("attn", "qkv", "kernel"), "attn.qkv.kernel",
         lambda c: (c.dim, 3, c.num_heads, c.head_dim)),
        (("attn", "out", "kernel"), "attn.out.kernel",
         lambda c: (c.num_heads, c.head_dim, c.dim))),
    "ssd": (
        (("ssd", "cbv", "kernel"), "ssd.cbv.kernel",
         lambda c: (c.dim, c.num_heads, 2 * c.ssd_state_dim + c.head_dim
                    + 1)),
        (("ssd", "dt_bias"), "ssd.dt_bias", lambda c: (c.num_heads,)),
        (("ssd", "out", "kernel"), "ssd.out.kernel",
         lambda c: (c.num_heads, c.head_dim, c.dim))),
}
_BLOCK_LEAVES = (
    (("norm1", "scale"), "norm1.scale", lambda c: (c.dim,)),
    (("norm2", "scale"), "norm2.scale", lambda c: (c.dim,)),
)
# The block's MLP: dense, or routed experts when moe_experts > 0.
_MLP_LEAVES = {
    False: (
        (("mlp", "up", "kernel"), "mlp.up.kernel",
         lambda c: (c.dim, 2 * c.dim * c.mlp_ratio)),
        (("mlp", "down", "kernel"), "mlp.down.kernel",
         lambda c: (c.dim * c.mlp_ratio, c.dim))),
    True: (
        (("moe", "router", "kernel"), "moe.router.kernel",
         lambda c: (c.dim, c.moe_experts)),
        (("moe", "w_up"), "moe.w_up",
         lambda c: (c.moe_experts, c.dim, c.dim * c.mlp_ratio)),
        (("moe", "w_down"), "moe.w_down",
         lambda c: (c.moe_experts, c.dim * c.mlp_ratio, c.dim))),
}


def _leaf(tree: tp.Mapping, path: tp.Sequence[str], shape: tp.Tuple[int, ...],
          where: str) -> torch.Tensor:
    node: tp.Any = tree
    for key in path:
        if not isinstance(node, tp.Mapping) or key not in node:
            raise KeyError(f"JAX params have no leaf {where}/"
                           f"{'/'.join(path)}")
        node = node[key]
    array = np.asarray(node)
    if array.shape != shape:
        raise ValueError(f"leaf {where}/{'/'.join(path)} has shape "
                         f"{array.shape}, expected {shape}")
    return torch.from_numpy(np.array(array, dtype=np.float32))


def params_from_jax(tree: tp.Mapping, cfg: TransformerConfig
                    ) -> tp.Dict[str, torch.Tensor]:
    """JAX `TransformerLM` params (numpy leaves) -> port state dict.

    Accepts the variables dict (`{"params": ...}`, other collections
    such as an MoE init's sown `losses` ignored) or the inner tree.
    Every leaf is checked against the shape `cfg` implies; unknown
    layouts raise rather than load half a model.
    """
    if "params" in tree:
        tree = tree["params"]   # a variables dict, maybe with MoE losses
    if "blocks" in tree:
        raise NotImplementedError(
            f"scan-stacked parameter trees are not ported yet: "
            f"{TODO_DECODE_VARIANTS}")
    state = {"embed": _leaf(tree, ("embed",), (cfg.vocab_size, cfg.dim), ""),
             "norm_f.scale": _leaf(tree, ("norm_f", "scale"), (cfg.dim,), "")}
    for i, mixer in enumerate(mixer_pattern(cfg)):
        name = f"block_{i}"
        block = tree.get(name)
        if not isinstance(block, tp.Mapping):
            raise KeyError(f"JAX params have no {name}")
        leaves = (_BLOCK_LEAVES + _MLP_LEAVES[cfg.moe_experts > 0]
                  + _MIXER_LEAVES[mixer])
        extra = set(block) - {path[0] for path, _, _ in leaves}
        if extra:
            raise ValueError(f"{name} holds {sorted(extra)}, which a "
                             f"{mixer!r} block of this config does not")
        for path, key, shape in leaves:
            state[f"{name}.{key}"] = _leaf(block, path, shape(cfg), name)
    return state
