"""MLP: the port of flashy_tpu/models/mlp.py, dense layers with an
activation between them (none after the last)."""
import typing as tp

import torch
from torch import nn

from ..utils import resolve_device
from .layers import Dense


class MLP(nn.Module):
    """Multi-layer perceptron over [..., in_features] inputs.

    Args:
        features: output size of each layer; the last entry is the
            network's output dimension. A single entry is a plain linear
            layer.
        activation: nonlinearity between layers (not after the last).
        in_features: the input size (flax infers it at init).
        device: where the parameters live; `cuda` unless asked otherwise.
        seed: seeds the init (flax's: lecun-normal kernels, zero biases).

    Layers are `layers_{i}`, each with `kernel` [in, out] and `bias`, as
    in the flax tree.
    """

    def __init__(self, features: tp.Sequence[int],
                 activation: tp.Callable[[torch.Tensor], torch.Tensor]
                 = torch.relu, *, in_features: int, device: tp.Any = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self.features = tuple(features)
        self.activation = activation
        sizes = (in_features,) + self.features
        for i in range(len(self.features)):
            setattr(self, f"layers_{i}", Dense(sizes[i], sizes[i + 1],
                                               generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.features)):
            x = getattr(self, f"layers_{i}")(x)
            if i < len(self.features) - 1:
                x = self.activation(x)
        return x
