"""Single-file checkpoints and the torch state-dict interop (the port of
the single-file half of flashy_tpu/checkpoint.py).

`save_state` writes a solver's state dict with `torch.save` through
`write_and_rename`, so a process killed mid-write never leaves a
truncated checkpoint; `load_state` reads it back onto the CPU with
`torch.load(weights_only=True)`, which unpickles only tensors and plain
containers. Module and optimizer state dicts load into their live
objects, which puts the tensors back on their devices. The sharded
(Orbax) half has no counterpart yet.

`to_torch_state_dict` / `from_torch_state_dict` flatten a nested tree to
'.'-joined keys and back, and `import_flashy_checkpoint` reads a
checkpoint of the original flashy (a `torch.save` file) for the port's
`BaseSolver.load_state_dict`.
"""
import typing as tp
from pathlib import Path

import numpy as np
import torch

from .utils import AnyPath, write_and_rename

TODO_SHARDED = ("ROADMAP.md queue A item 8 (sharded and asynchronous "
                "checkpoints)")


def _plain(value: tp.Any) -> tp.Any:
    """Mappings (the attribute-access `xp.Config` among them) as plain
    dicts, so the file holds only what `weights_only` loading accepts."""
    if isinstance(value, dict):
        return {key: _plain(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(item) for item in value)
    return value


def save_state(state: tp.Any, path: AnyPath) -> None:
    """Write a state dict to one file, atomically."""
    with write_and_rename(path, "wb") as f:
        torch.save(_plain(state), f)


def load_state(path: AnyPath) -> tp.Any:
    """Load a state dict written by `save_state`, tensors on the CPU."""
    if not Path(path).exists():
        raise FileNotFoundError(f"No checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def to_torch_state_dict(tree: tp.Any, prefix: str = ""
                        ) -> tp.Dict[str, tp.Any]:
    """Flatten a nested tree (dicts, lists, tuples) into a torch-style
    flat state dict: keys joined with '.', list and tuple items keyed by
    their index. Tensors stay tensors, numpy arrays become tensors
    sharing their memory where it is contiguous, None leaves are
    dropped and other leaves pass through."""
    flat: tp.Dict[str, tp.Any] = {}

    def visit(node: tp.Any, path: str) -> None:
        if isinstance(node, dict):
            for key, value in node.items():
                visit(value, f"{path}.{key}" if path else str(key))
        elif isinstance(node, (list, tuple)):
            for index, value in enumerate(node):
                visit(value, f"{path}.{index}" if path else str(index))
        elif isinstance(node, np.ndarray):
            flat[path] = torch.from_numpy(np.ascontiguousarray(node))
        elif node is not None:
            flat[path] = node

    visit(tree, prefix)
    return flat


def from_torch_state_dict(state_dict: tp.Mapping[str, tp.Any]
                          ) -> tp.Dict[str, tp.Any]:
    """Unflatten a torch-style state dict ('.'-joined keys) into nested
    dicts, the leaves as they are (tensors stay tensors)."""
    out: tp.Dict[str, tp.Any] = {}
    for dotted, value in state_dict.items():
        *path, leaf = dotted.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def import_flashy_checkpoint(path: AnyPath) -> tp.Dict[str, tp.Any]:
    """Load a checkpoint of the original flashy (`checkpoint.th`, a
    `torch.save` file) as a solver state dict for the port's
    `BaseSolver.load_state_dict`: every tensor, at any depth (optimizer
    states nest them), detached on the CPU; module state dicts stay flat
    ('.'-joined keys, the port's own format); 'history', 'xp.cfg' and
    'xp.sig' pass through.

    The file is unpickled in full (`weights_only=False`), as flashy's
    files hold plain Python objects beside the tensors: unpickling runs
    code the file names, so load only files you trust.
    """
    if not Path(path).exists():
        raise FileNotFoundError(f"No checkpoint at {path}")
    raw = torch.load(str(path), map_location="cpu", weights_only=False)

    def convert(node: tp.Any) -> tp.Any:
        if isinstance(node, torch.Tensor):
            return node.detach().cpu()
        if isinstance(node, tp.Mapping):
            return {key: convert(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(value) for value in node)
        return node

    return {name: convert(entry) for name, entry in raw.items()}
