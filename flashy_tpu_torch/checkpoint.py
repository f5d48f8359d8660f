"""Single-file checkpoints (the port of the single-file half of
flashy_tpu/checkpoint.py).

`save_state` writes a solver's state dict with `torch.save` through
`write_and_rename`, so a process killed mid-write never leaves a
truncated checkpoint; `load_state` reads it back onto the CPU with
`torch.load(weights_only=True)`, which unpickles only tensors and plain
containers. Module and optimizer state dicts load into their live
objects, which puts the tensors back on their devices. The sharded
(Orbax) half has no counterpart yet.
"""
import typing as tp
from pathlib import Path

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
