"""Vision Transformer classifier: the port of flashy_tpu/models/vit.py.

The patches are one strided convolution with a bias ('VALID'), flattened
to [B, N, D] in flax's row-major (h, w) order; the encoder is the port's
own `transformer.Block` with `causal=False` and rotary positions over
the patch index (remat as the LM has it); then the final RMSNorm, a mean
over the patches and an f32 head with a bias. Parameters keep the flax
tree's names (`patch`, `block_{i}`, `norm`, `head`), so
`models.convert.vit_from_jax` carries a JAX model across.

With `attention='flash'` every attention call on a CUDA tensor runs the
Hopper flash kernels, non-causal, at any patch count (the kernels mask a
ragged edge): 64 patches (the 32x32 images of `vit_tiny`) are one of
their 64-row tiles, where the JAX package, whose kernel tiles by 128,
takes dense attention.
"""
import dataclasses
import typing as tp

import torch
from torch import nn

from ..utils import resolve_device
from .layers import Conv, Dense
from .transformer import (Block, DropoutSeed, RMSNorm, TransformerConfig,
                          _run_block, training_dropout_seed)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    num_classes: int = 10
    dim: int = 192
    num_layers: int = 6
    num_heads: int = 3
    mlp_ratio: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    attention: str = "dense"     # 'dense' | 'flash' (the Hopper kernels)
    remat: bool = False
    remat_policy: str = "full"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def block_config(self) -> TransformerConfig:
        """The shared-block config: bidirectional, no vocab."""
        return TransformerConfig(
            vocab_size=1, dim=self.dim, num_layers=self.num_layers,
            num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            max_seq_len=self.num_patches, dropout=self.dropout,
            dtype=self.dtype, attention=self.attention, causal=False,
            remat=self.remat, remat_policy=self.remat_policy)


class ViT(nn.Module):
    """images [B, H, W, C] float -> f32 logits [B, num_classes].

    Args:
        config: the model configuration.
        in_channels: image channels (flax infers them at init).
        device: where the parameters live; `cuda` unless asked otherwise.
        seed: seeds the random init.
    """

    def __init__(self, config: ViTConfig, *, in_channels: int = 3,
                 device: tp.Any = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self.config = config
        p = config.patch_size
        self.patch = Conv(in_channels, config.dim, (p, p), generator, device,
                          strides=(p, p), padding="VALID", use_bias=True,
                          init_scale=1.0)
        bcfg = config.block_config()
        for layer in range(config.num_layers):
            setattr(self, f"block_{layer}", Block(bcfg, generator, device,
                                                  index=layer))
        self.norm = RMSNorm(config.dim, config.dtype, device)
        self.head = Dense(config.dim, config.num_classes, generator, device)

    def forward(self, images: torch.Tensor, train: bool = False,
                dropout_seed: tp.Optional[DropoutSeed] = None
                ) -> torch.Tensor:
        """Logits of `images`; `train=True` with `dropout > 0` drops, as
        the LM does, and then needs a `dropout_seed`."""
        cfg = self.config
        if images.shape[1] != cfg.image_size \
                or images.shape[2] != cfg.image_size:
            raise ValueError(
                f"image shape {images.shape[1]}x{images.shape[2]} != "
                f"config.image_size={cfg.image_size} (square input): the "
                f"patch grid would contradict num_patches")
        dropout_seed = training_dropout_seed(cfg.dropout, train,
                                             dropout_seed)
        x = self.patch(images.permute(0, 3, 1, 2), cfg.dtype)
        batch = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(batch, -1, cfg.dim)   # [B, N, D]
        positions = torch.arange(x.shape[1], device=x.device).expand(
            batch, x.shape[1])
        bcfg = cfg.block_config()
        for layer in range(cfg.num_layers):
            x = _run_block(bcfg, getattr(self, f"block_{layer}"), x,
                           positions, None, dropout_seed)
        pooled = self.norm(x).mean(dim=1)
        return self.head(pooled, torch.float32)


def vit_tiny(num_classes: int = 10, image_size: int = 32,
             patch_size: int = 4, *, device: tp.Any = None, seed: int = 0,
             **kw: tp.Any) -> ViT:
    """ViT-Ti-ish for 32x32 inputs (the cifar example's scale)."""
    return ViT(ViTConfig(image_size=image_size, patch_size=patch_size,
                         num_classes=num_classes, dim=192, num_layers=6,
                         num_heads=3, **kw), device=device, seed=seed)


def vit_small(num_classes: int = 1000, image_size: int = 224,
              patch_size: int = 16, *, device: tp.Any = None, seed: int = 0,
              **kw: tp.Any) -> ViT:
    """ViT-S/16 at the standard ImageNet scale."""
    return ViT(ViTConfig(image_size=image_size, patch_size=patch_size,
                         num_classes=num_classes, dim=384, num_layers=12,
                         num_heads=6, **kw), device=device, seed=seed)
