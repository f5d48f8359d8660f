"""ResNet-18/34/50 over NHWC images: the port of
flashy_tpu/models/resnet.py.

Parameters and statistics keep the flax tree's names and layouts (`stem`,
`stem_norm`, `BasicBlock_{k}` / `BottleneckBlock_{k}` with `Conv_{i}`,
`BatchNorm_{i}` and, where a block changes the shape, `proj` and
`proj_norm`, then `head`; conv kernels [kh, kw, in, out]; each
BatchNorm's `scale` and `bias` parameters and its `mean` and `var`
buffers, flax's `batch_stats`), so `models.convert.resnet_from_jax`
carries a JAX model across leaf for leaf.

Images come in as [B, H, W, C], as the JAX model and the data pipeline
give them; the permuted NCHW view of a contiguous NHWC tensor is
channels_last memory, and every convolution runs in it
(`layers.Conv`, flax's 'SAME' padding). Activations run in `dtype` (bf16
by default) with f32 parameters cast at use; the head is f32.

BatchNorm is flax's: statistics reduced in at least f32 as E[x] and
E[x^2] - E[x]^2 (clipped at 0), the biased variance both to normalize
and to update `var`, `momentum` 0.9 weighting the old value, eps 1e-5. In
training each forward normalizes with the batch's statistics and
updates the running ones; `train=False` normalizes with the running
ones. Under several processes (`distrib.is_distributed()`) a training
forward all-reduces each layer's per-channel sums (with their backward),
so every rank normalizes with the global batch's statistics, as the JAX
step, one program over the global batch, does.
"""
import functools
import typing as tp

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import distrib
from ..utils import resolve_device
from .layers import Conv, Dense, same_padding


class _GlobalSum(torch.autograd.Function):
    """The sum of a tensor over the processes; its backward sums the
    incoming gradients the same way (each rank's statistics feed every
    rank's normalization)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the channels of an NCHW tensor."""

    def __init__(self, features: int, dtype: torch.dtype,
                 device: torch.device, zero_scale: bool = False,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter((torch.zeros if zero_scale else torch.ones)(
            features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        # at least f32, as flax promotes the statistics
        h = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            sums = torch.cat([h.sum((0, 2, 3)), (h * h).sum((0, 2, 3)),
                              h.new_full((1,), h.numel() / h.shape[1])])
            if distrib.is_distributed():
                sums = _GlobalSum.apply(sums)
            channels = h.shape[1]
            count = sums[-1]
            mean = sums[:channels] / count
            var = torch.clamp(sums[channels:-1] / count - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (h - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.dtype = dtype
        conv = functools.partial(Conv, generator=generator, device=device)
        self.Conv_0 = conv(in_channels, filters, (3, 3),
                           strides=(strides, strides))
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = BatchNorm(filters, dtype, device, zero_scale=True)
        if strides != 1 or in_channels != filters:
            self.proj = conv(in_channels, filters, (1, 1),
                             strides=(strides, strides))
            self.proj_norm = BatchNorm(filters, dtype, device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x, self.dtype), train))
        y = self.BatchNorm_1(self.Conv_1(y, self.dtype), train)
        residual = x
        if hasattr(self, "proj"):
            residual = self.proj_norm(self.proj(x, self.dtype), train)
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.dtype = dtype
        out = filters * self.expansion
        conv = functools.partial(Conv, generator=generator, device=device)
        self.Conv_0 = conv(in_channels, filters, (1, 1))
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = conv(filters, filters, (3, 3),
                           strides=(strides, strides))
        self.BatchNorm_1 = BatchNorm(filters, dtype, device)
        self.Conv_2 = conv(filters, out, (1, 1))
        self.BatchNorm_2 = BatchNorm(out, dtype, device, zero_scale=True)
        if strides != 1 or in_channels != out:
            self.proj = conv(in_channels, out, (1, 1),
                             strides=(strides, strides))
            self.proj_norm = BatchNorm(out, dtype, device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x, self.dtype), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y, self.dtype), train))
        y = self.BatchNorm_2(self.Conv_2(y, self.dtype), train)
        residual = x
        if hasattr(self, "proj"):
            residual = self.proj_norm(self.proj(x, self.dtype), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet over NHWC images: [B, H, W, C] -> f32 logits [B, classes].

    Args:
        stage_sizes: blocks per stage, e.g. (2, 2, 2, 2) for ResNet-18.
        block: BasicBlock or BottleneckBlock.
        num_classes: classifier output size.
        num_filters: stem width.
        small_inputs: the 3x3 stem without max-pool (32x32 CIFAR images);
            False gives the ImageNet 7x7/2 stem and the 3x3/2 max-pool.
        dtype: compute dtype; parameters stay f32.
        in_channels: image channels (flax infers them at init).
        device: where the parameters live; `cuda` unless asked otherwise.
        seed: seeds the init (flax's: kaiming-normal convs, lecun-normal
            head, the last norm of each block at scale 0).
    """

    def __init__(self, stage_sizes: tp.Sequence[int], block: tp.Type,
                 num_classes: int = 10, num_filters: int = 64,
                 small_inputs: bool = True,
                 dtype: torch.dtype = torch.bfloat16, *, in_channels: int = 3,
                 device: tp.Any = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.small_inputs = small_inputs
        self.stage_sizes = tuple(stage_sizes)
        kernel, strides = ((3, 3), (1, 1)) if small_inputs \
            else ((7, 7), (2, 2))
        self.stem = Conv(in_channels, num_filters, kernel, generator, device,
                         strides=strides)
        self.stem_norm = BatchNorm(num_filters, dtype, device)
        self.blocks: tp.List[str] = []
        channels = num_filters
        for stage, size in enumerate(self.stage_sizes):
            for index in range(size):
                name = f"{block.__name__}_{len(self.blocks)}"
                filters = num_filters * 2 ** stage
                setattr(self, name, block(
                    channels, filters, 2 if stage > 0 and index == 0 else 1,
                    dtype, generator, device))
                self.blocks.append(name)
                channels = filters * block.expansion
        self.head = Dense(channels, num_classes, generator, device)

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_norm(self.stem(x, self.dtype), train))
        if not self.small_inputs:
            (top, bottom), (left, right) = (same_padding(x.shape[2], 3, 2),
                                            same_padding(x.shape[3], 3, 2))
            x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
            x = F.max_pool2d(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        pooled = x.mean(dim=(2, 3))
        return self.head(pooled, torch.float32)


def resnet18(num_classes: int = 10, **kwargs: tp.Any) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes=num_classes, **kwargs)


def resnet34(num_classes: int = 10, **kwargs: tp.Any) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes=num_classes, **kwargs)


def resnet50(num_classes: int = 10, **kwargs: tp.Any) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes=num_classes,
                  **kwargs)
