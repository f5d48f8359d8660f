"""flax's `nn.Dense` and `nn.Conv` in PyTorch, for the port's MLP, ResNet
and ViT: the parameters keep flax's names and layouts (`kernel` [in, out]
for a dense layer, [kh, kw, in, out] for a convolution, `bias` [out]), so
a JAX tree converts leaf for leaf (`models.convert`), and the inits are
flax's (`variance_scaling` over fan-in with a truncated normal).

Convolutions take and return NCHW tensors in channels_last memory: an
NHWC image permuted to NCHW is one already. The kernel is permuted to
torch's [out, in, kh, kw] (channels_last too) where it is used. Padding
follows flax's 'SAME' rule (`same_padding`), which is asymmetric at
stride 2 on an even side: (0, 1) at 32 pixels and a 3x3 kernel, where a
symmetric `padding=1` would read other pixels.
"""
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers' truncated_normal correction)
_TRUNCATED_STD = 0.87962566103423978


def variance_scaling(shape: tp.Sequence[int], fan_in: int, scale: float,
                     generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """flax's `variance_scaling(scale, 'fan_in', 'truncated_normal')`:
    a normal of variance scale / fan_in truncated at two standard
    deviations. scale 1 is `lecun_normal`, scale 2 `kaiming_normal`."""
    std = math.sqrt(scale / fan_in) / _TRUNCATED_STD
    out = torch.empty(tuple(shape), device=device)
    return nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> tp.Tuple[int, int]:
    """flax's 'SAME' padding of one side: the output keeps ceil(size /
    stride) positions; `total` pixels are added, the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """`nn.Dense`: `kernel` [in, out] (lecun normal), `bias` [out]
    (zeros). The product runs in `dtype` (the input's when None) and the
    bias adds in it."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        self.kernel = nn.Parameter(variance_scaling(
            (in_features, out_features), in_features, 1.0, generator,
            device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor,
                dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = x.dtype if dtype is None else dtype
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class Conv(nn.Module):
    """`nn.Conv` over NCHW tensors in channels_last memory: `kernel`
    [kh, kw, in, out] (`variance_scaling(init_scale)` over kh * kw * in),
    an optional `bias` [out]; 'SAME' or 'VALID' padding; operands cast to
    `dtype` at use."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tp.Tuple[int, int], generator: torch.Generator,
                 device: torch.device, strides: tp.Tuple[int, int] = (1, 1),
                 padding: str = "SAME", use_bias: bool = False,
                 init_scale: float = 2.0):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.kernel = nn.Parameter(variance_scaling(
            (kh, kw, in_channels, out_channels), kh * kw * in_channels,
            init_scale, generator, device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_channels,
                                                 device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        weight = self.kernel.permute(3, 2, 0, 1).to(
            dtype, memory_format=torch.channels_last)
        bias = self.bias.to(dtype) if hasattr(self, "bias") else None
        x = x.to(dtype)
        if (kh, kw) == (1, 1) and self.strides != (1, 1):
            # a 1x1 kernel at stride s reads every s-th pixel and pads
            # nothing: subsample, then convolve at stride 1 (PyTorch
            # 2.13's CPU backward of a strided 1x1 convolution over
            # channels_last input corrupts the heap)
            sh, sw = self.strides
            return F.conv2d(x[:, :, ::sh, ::sw], weight, bias)
        pad = (0, 0), (0, 0)
        if self.padding == "SAME":
            pad = (same_padding(x.shape[2], kh, self.strides[0]),
                   same_padding(x.shape[3], kw, self.strides[1]))
        (top, bottom), (left, right) = pad
        if top == bottom and left == right:
            return F.conv2d(x, weight, bias, self.strides, (top, left))
        x = F.pad(x, (left, right, top, bottom)).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, weight, bias, self.strides)
