"""Weights across the frameworks: the JAX package's parameter pytrees ->
this package's state dicts (`params_from_jax` for the TransformerLM;
`mlp_from_jax`, `resnet_from_jax`, `vit_from_jax` and `seq2seq_from_jax`
for the other families, whose modules carry flax's names one to one).

The JAX tree arrives as numpy arrays (`jax.tree.map(np.asarray, ...)`);
leaves keep their layouts and stay f32, so a converted model computes
the same function. Per-layer trees convert, attention, SSD and hybrid
stacks alike (each block's mixer from `mixer_pattern`), with a dense or
an MoE MLP (`moe_experts > 0`); so do scan-stacked trees
(`scan_layers=True`: `blocks/block/<leaf>`, each leaf with a leading
[L]), into the stacked model's `blocks.block.<leaf>`.
"""
import typing as tp

import numpy as np
import torch

from .transformer import TransformerConfig, mixer_pattern

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
    state = {"embed": _leaf(tree, ("embed",), (cfg.vocab_size, cfg.dim), ""),
             "norm_f.scale": _leaf(tree, ("norm_f", "scale"), (cfg.dim,), "")}
    pattern = mixer_pattern(cfg)
    if cfg.scan_layers:
        # one stacked body: the (uniform) mixer of every layer, each leaf
        # with a leading [L]
        blocks = (("blocks", "block", "blocks.block", pattern[0],
                   (cfg.num_layers,)),)
    else:
        blocks = tuple((f"block_{i}", None, f"block_{i}", mixer, ())
                       for i, mixer in enumerate(pattern))
    extra = set(tree) - {"embed", "norm_f"} - {b[0] for b in blocks}
    if extra:
        raise ValueError(f"JAX params hold {sorted(extra)}, which a "
                         f"{'scan-stacked' if cfg.scan_layers else 'per-layer'}"
                         f" model of this config does not")
    for top, inner, name, mixer, lead in blocks:
        block = tree.get(top)
        if inner is not None and isinstance(block, tp.Mapping):
            block = block.get(inner) if set(block) == {inner} else None
        if not isinstance(block, tp.Mapping):
            raise KeyError(f"JAX params have no {name.replace('.', '/')}")
        leaves = (_BLOCK_LEAVES + _MLP_LEAVES[cfg.moe_experts > 0]
                  + _MIXER_LEAVES[mixer])
        extra = set(block) - {path[0] for path, _, _ in leaves}
        if extra:
            raise ValueError(f"{name} holds {sorted(extra)}, which a "
                             f"{mixer!r} block of this config does not")
        where = name.replace(".", "/")
        for path, key, shape in leaves:
            state[f"{name}.{key}"] = _leaf(block, path, lead + shape(cfg),
                                           where)
    return state


def _module_from_jax(collections: tp.Mapping[str, tp.Mapping],
                     model: torch.nn.Module,
                     buffers: str = "batch_stats"
                     ) -> tp.Dict[str, torch.Tensor]:
    """The state dict of `model` filled from flax collections, name for
    name: the parameter `a.b.kernel` from `collections['params']['a']['b']
    ['kernel']`, a buffer from `collections[buffers]` (flax's
    `batch_stats`). Each leaf must exist and have the port's shape, and
    the JAX tree may hold no leaf the model lacks."""
    state = {}
    wanted: tp.Dict[str, tp.Set[tp.Tuple[str, ...]]] = {}
    named = [("params", name, p) for name, p in model.named_parameters()] \
        + [(buffers, name, b) for name, b in model.named_buffers()]
    for collection, name, value in named:
        path = tuple(name.split("."))
        if collection not in collections:
            raise KeyError(f"JAX variables have no '{collection}' "
                           f"collection (needed for {'/'.join(path)})")
        state[name] = _leaf(collections[collection], path,
                            tuple(value.shape), collection)
        wanted.setdefault(collection, set()).add(path)
    for collection, paths in wanted.items():
        extra = sorted("/".join(p) for p in _paths(collections[collection])
                       if p not in paths)
        if extra:
            raise ValueError(f"JAX {collection} hold {extra[:4]}, which "
                             f"this {type(model).__name__} does not")
    return state


def _paths(tree: tp.Mapping, prefix: tp.Tuple[str, ...] = ()
           ) -> tp.Iterator[tp.Tuple[str, ...]]:
    for key, value in tree.items():
        if isinstance(value, tp.Mapping):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


def _variables(tree: tp.Mapping) -> tp.Mapping[str, tp.Mapping]:
    """A flax variables dict as it is, or an inner params tree wrapped as
    one (`{"params": tree}`)."""
    return tree if "params" in tree else {"params": tree}


def mlp_from_jax(tree: tp.Mapping, model: torch.nn.Module
                 ) -> tp.Dict[str, torch.Tensor]:
    """JAX `MLP` params (numpy leaves; the variables dict or the inner
    tree) -> the state dict of the port's `models.MLP` `model`."""
    return _module_from_jax(_variables(tree), model)


def resnet_from_jax(variables: tp.Mapping, model: torch.nn.Module
                    ) -> tp.Dict[str, torch.Tensor]:
    """JAX `ResNet` variables (numpy leaves: `params` and `batch_stats`)
    -> the state dict of the port's `models.ResNet` `model`, parameters
    and BatchNorm statistics (`mean`, `var` buffers)."""
    return _module_from_jax(variables, model)


def vit_from_jax(tree: tp.Mapping, model: torch.nn.Module
                 ) -> tp.Dict[str, torch.Tensor]:
    """JAX `ViT` params -> the state dict of the port's `models.ViT`."""
    return _module_from_jax(_variables(tree), model)


def seq2seq_from_jax(tree: tp.Mapping, model: torch.nn.Module
                     ) -> tp.Dict[str, torch.Tensor]:
    """JAX `Seq2SeqTransformer` params -> the state dict of the port's
    `models.Seq2SeqTransformer`."""
    return _module_from_jax(_variables(tree), model)
