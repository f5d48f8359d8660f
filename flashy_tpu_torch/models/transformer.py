"""TransformerLM in PyTorch: the port of flashy_tpu/models/transformer.py.

Parameters keep the JAX package's layouts and f32 storage so weights
cross over leaf for leaf (`models.convert.params_from_jax`):

    embed                  [V, D]          f32 (also the tied head)
    block_i.norm1.scale    [D]
    block_i.attn.qkv.kernel [D, 3, H, Dh]   (attention layers)
    block_i.attn.out.kernel [H, Dh, D]
    block_i.ssd.cbv.kernel [D, H, 2N+Dh+1]  (SSD layers, `models.ssd`)
    block_i.ssd.dt_bias    [H]
    block_i.ssd.out.kernel [H, Dh, D]
    block_i.norm2.scale    [D]
    block_i.mlp.up.kernel  [D, 2F]
    block_i.mlp.down.kernel [F, D]
    block_i.moe.router.kernel [D, E]       (MoE layers, `models.moe`)
    block_i.moe.w_up       [E, D, F]
    block_i.moe.w_down     [E, F, D]
    norm_f.scale           [D]

Activations run in `config.dtype`; kernels are cast to it at use, norms
accumulate in f32 and the tied head accumulates in f32. With
`attention='flash'` every attention call on a CUDA tensor runs the
Hopper flash kernels (`ops.attention.flash_attention`); `segment_ids`
(packed batches) take the dense masked path, as in the JAX package.
`attention='ring'` and `'ring_fused'` run sequence-parallel ring
attention over the `seq` axis of the model's mesh
(`parallel.ring_self_attention`): the flash kernels per block, or one
Hopper ring kernel per rank (`csrc/ring_attention.cu`).
`mixer` picks each layer's sequence mixer ('attention', 'ssd' or a
comma-separated pattern cycled over the depth); SSD layers run the
chunked scan, on CUDA through the Hopper SSD kernel. With
`moe_experts > 0` every block's MLP is a routed `MoEMLP` (gelu experts
of width `dim * mlp_ratio`); its `moe_dispatch='dropless'` runs the
expert projections as grouped matmuls, on CUDA through the Hopper
grouped-GEMM kernels, and `forward(..., return_aux=True)` also returns
the summed load-balancing loss.
"""
import dataclasses
import math
import typing as tp

import torch
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import dot_product_attention, flash_attention
from ..ops.losses import tied_head
from ..parallel.mesh import Mesh
from ..parallel.moe_ep import TODO_EXPERT_PARALLEL
from ..parallel.ring import ring_self_attention
from ..utils import resolve_device
from .moe import MoEMLP, moe_aux_loss

# Where each part the port does not have yet is scheduled (ROADMAP.md).
TODO_REMAT_POLICY = "ROADMAP.md queue A item 2, T1 (remat 'dots' policies)"
TODO_DROPOUT = "ROADMAP.md queue A item 2, T2 (dropout)"
TODO_DECODE_VARIANTS = ("ROADMAP.md queue A item 3, L7 (scan-stacked "
                        "layouts; MoE in the serving engine)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 512
    num_layers: int = 8
    num_heads: int = 8
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"     # 'flash' | 'dense' | 'ring' | 'ring_fused'
    causal: bool = True
    remat: bool = False          # recompute each block in the backward
    remat_policy: str = "full"   # what remat saves: 'full' = nothing
    dropout: float = 0.0         # > 0 is not ported (check_supported)
    moe_experts: int = 0         # > 0 replaces the MLP with a routed MoE
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"  # einsum | sorted | dropless (the Hopper
                                  # grouped-GEMM kernels); dropless_ep is
                                  # not ported (check_supported)
    scan_layers: bool = False    # True is not ported (check_supported)
    mixer: str = "attention"     # 'attention', 'ssd' or a pattern such
                                 # as 'ssd,attention' (mixer_pattern)
    ssd_state_dim: int = 16      # Dstate of SSD layers ([H, Dh, Dstate])
    ssd_chunk: int = 0           # chunked-form chunk; 0 = default_chunk
    ssd_kernel: str = "auto"     # 'auto' | 'gather' | 'fused'

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def mixer_pattern(cfg: TransformerConfig) -> tp.Tuple[str, ...]:
    """Resolve cfg.mixer into one mixer name per layer ('attention' or
    'ssd'; a comma-separated pattern is cycled over the depth)."""
    names = tuple(part.strip() for part in cfg.mixer.split(","))
    bad = [n for n in names if n not in ("attention", "ssd")]
    if bad:
        raise ValueError(
            f"config.mixer entries must be 'attention' or 'ssd', got "
            f"{bad[0]!r} in {cfg.mixer!r}")
    return tuple(names[i % len(names)] for i in range(cfg.num_layers))


def check_supported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for layouts the port cannot hold yet."""
    if cfg.moe_experts > 0 and cfg.moe_dispatch == "dropless_ep":
        raise NotImplementedError(
            f"moe_dispatch='dropless_ep' is not ported yet: "
            f"{TODO_EXPERT_PARALLEL}")
    mixer_pattern(cfg)  # raises on an unknown mixer name
    if cfg.scan_layers:
        raise NotImplementedError(
            f"scan_layers=True is not ported yet: {TODO_DECODE_VARIANTS}")
    if cfg.dropout > 0.0:
        raise NotImplementedError(
            f"dropout > 0 is not ported yet: {TODO_DROPOUT}")
    if cfg.remat_policy in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet: "
            f"{TODO_REMAT_POLICY}")
    if cfg.remat_policy != "full":
        raise ValueError(f"remat_policy must be one of ['dots', "
                         f"'dots_no_batch', 'full'], got "
                         f"{cfg.remat_policy!r}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """RMSNorm with f32 accumulation and eps 1e-6, cast to `dtype`."""
    h = x.float()
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + 1e-6)
    return (h * scale.float()).to(dtype)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings on [B, T, H, D] at [B, T] positions: f32 angles,
    result cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[:, :, None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _param(shape: tp.Sequence[int], std: float, generator: torch.Generator,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator,
                                    device=device) * std)


class _Kernel(nn.Module):
    """Holder of one matmul kernel leaf (`<name>.kernel`), f32."""

    def __init__(self, shape: tp.Sequence[int], fan_in: int,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        self.kernel = _param(shape, 1.0 / math.sqrt(fan_in), generator,
                             device)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device, mesh: tp.Optional[Mesh] = None):
        super().__init__()
        self.config = cfg
        self.mesh = mesh
        h, dh = cfg.num_heads, cfg.head_dim
        self.qkv = _Kernel((cfg.dim, 3, h, dh), cfg.dim, generator, device)
        self.out = _Kernel((h, dh, cfg.dim), h * dh, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        qkv = torch.einsum("btd,dchk->btchk", x.to(cfg.dtype),
                           self.qkv.kernel.to(cfg.dtype))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = _rotary(q, positions)
        k = _rotary(k, positions)
        if cfg.attention not in ("flash", "dense", "ring", "ring_fused"):
            raise ValueError(f"unknown attention {cfg.attention!r}")
        if segment_ids is not None:
            # packed batches: tokens attend within their own segment, on
            # the dense masked path (the flash kernels take no mask)
            if cfg.attention in ("ring", "ring_fused"):
                raise ValueError(
                    f"segment_ids is not supported with attention="
                    f"{cfg.attention!r}: segment-aware masking uses the "
                    "dense O(T^2) path, which cannot shard the sequence "
                    "axis; use attention='dense' (or 'flash', which falls "
                    "back to dense under a mask) for packed batches.")
            segment_mask = (segment_ids[:, :, None]
                            == segment_ids[:, None, :])[:, None]
            out = dot_product_attention(q, k, v, causal=cfg.causal,
                                        mask=segment_mask)
        elif cfg.attention in ("ring", "ring_fused"):
            out = ring_self_attention(
                q, k, v, mesh=self.mesh, causal=cfg.causal,
                impl="fused" if cfg.attention == "ring_fused" else "scan")
        elif cfg.attention == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = dot_product_attention(q, k, v, causal=cfg.causal)
        return torch.einsum("bqhd,hdD->bqD", out,
                            self.out.kernel.to(cfg.dtype))


class MLPBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.config = cfg
        hidden = cfg.dim * cfg.mlp_ratio
        self.up = _Kernel((cfg.dim, 2 * hidden), cfg.dim, generator, device)
        self.down = _Kernel((hidden, cfg.dim), hidden, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        gate, value = (x.to(dtype) @ self.up.kernel.to(dtype)).chunk(2, -1)
        return (nn.functional.silu(gate) * value) @ self.down.kernel.to(dtype)


class Block(nn.Module):
    """Pre-norm block; its mixer submodule is `ssd` or `attn`, as in the
    flax tree."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device, mixer: str = "attention",
                 mesh: tp.Optional[Mesh] = None):
        super().__init__()
        self.mixer = mixer
        self.norm1 = RMSNorm(cfg.dim, cfg.dtype, device)
        if mixer == "ssd":
            from .ssd import SSDMixer
            self.ssd = SSDMixer(cfg, generator, device)
        else:
            self.attn = Attention(cfg, generator, device, mesh)
        self.norm2 = RMSNorm(cfg.dim, cfg.dtype, device)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(cfg.dim, cfg.dim * cfg.mlp_ratio,
                              cfg.moe_experts, cfg.moe_top_k,
                              cfg.moe_capacity_factor, cfg.dtype,
                              cfg.moe_dispatch, generator=generator,
                              device=device)
        else:
            self.mlp = MLPBlock(cfg, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        mix = self.ssd if self.mixer == "ssd" else self.attn
        x = x + mix(self.norm1(x), positions, segment_ids)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.norm2(x))


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens [B, T] int -> f32 logits [B, T, vocab].

    Args:
        config: the model configuration (widths, depth, dtype).
        device: where the parameters live; `cuda` by default, the CPU
            only when asked for explicitly.
        seed: seeds the random init (a `torch.Generator` on `device`).
            Weights from the JAX package load with `load_state_dict(
            params_from_jax(...))` instead.
        mesh: the mesh whose `seq` axis ring attention runs over
            (`parallel.make_mesh`); None takes `parallel.default_mesh()`
            at call time, as the JAX package does.
    """

    def __init__(self, config: TransformerConfig, *,
                 device: tp.Any = None, seed: int = 0,
                 mesh: tp.Optional[Mesh] = None):
        super().__init__()
        check_supported(config)
        device = resolve_device(device)
        self.config = config
        generator = torch.Generator(device=device).manual_seed(seed)
        self.embed = _param((config.vocab_size, config.dim), 0.02,
                            generator, device)
        for i, mixer in enumerate(mixer_pattern(config)):
            setattr(self, f"block_{i}", Block(config, generator, device,
                                              mixer, mesh))
        self.norm_f = RMSNorm(config.dim, config.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor,
                positions: tp.Optional[torch.Tensor] = None,
                segment_ids: tp.Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                return_aux: bool = False) -> tp.Any:
        """Logits [B, T, vocab] f32, or with `return_hidden` the final
        hidden states and the tied embedding (for a chunked loss that
        never materializes the logits), or with `return_aux` the logits
        and the MoE layers' summed load-balancing loss of this forward
        (`models.moe.moe_aux_loss`). `segment_ids` ([B, T], 0 =
        padding) makes attention segment-aware for packed batches; pass
        the packer's per-segment `positions` with them."""
        cfg = self.config
        if return_hidden and return_aux:
            raise ValueError("return_hidden and return_aux exclude each "
                             "other (the chunked loss takes no MoE aux)")
        if tokens.shape[1] > cfg.max_seq_len \
                and "attention" in mixer_pattern(cfg):
            # nothing in a pure-SSD stack caps T
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds "
                f"config.max_seq_len={cfg.max_seq_len}")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.embed[tokens].to(cfg.dtype)
        for i in range(cfg.num_layers):
            block = getattr(self, f"block_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    block, x, positions, segment_ids, use_reentrant=False)
            else:
                x = block(x, positions, segment_ids)
        x = self.norm_f(x)
        if return_hidden:
            return x, self.embed
        logits = tied_head(x, self.embed)
        if return_aux:
            return logits, moe_aux_loss(self)
        return logits
