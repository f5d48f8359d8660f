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

Training switches, as in the JAX package:
- `dropout > 0` applies dropout after each mixer's output projection
  and after the MLP's down projection, only with `forward(...,
  train=True, dropout_seed=s)`. Each site draws its mask from a
  `torch.Generator` of its own on the activation's device, seeded with
  `fold_seed(s, layer, site)`, so a recompute draws the same mask.
- `remat=True` recomputes each block in the backward
  (`torch.utils.checkpoint`); `remat_policy` says what it saves: 'full'
  nothing, 'dots' the outputs of every matrix product, 'dots_no_batch'
  those of the products with no batch dimension (`remat_saves`). The
  flash and SSD kernels launch through `torch.autograd.Function`s that
  no policy sees, so under every policy their forwards launch again in
  the backward's recompute, as the Pallas kernels do under JAX's.
"""
import dataclasses
import math
import typing as tp

import torch
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import dot_product_attention, flash_attention
from ..ops.losses import tied_head
from ..parallel.mesh import Mesh
from ..parallel.moe_ep import TODO_EXPERT_PARALLEL
from ..parallel.ring import ring_self_attention
from ..utils import resolve_device
from .moe import MoEMLP, moe_aux_loss

# Where each part the port does not have yet is scheduled (ROADMAP.md).
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
    remat_policy: str = "full"   # what remat saves: 'full' nothing,
                                 # 'dots' every matrix product's output,
                                 # 'dots_no_batch' those with no batch dim
    dropout: float = 0.0         # after the mixer and MLP outputs when
                                 # forward(train=True, dropout_seed=...)
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
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {list(REMAT_POLICIES)}"
                         f", got {cfg.remat_policy!r}")


REMAT_POLICIES = ("dots", "dots_no_batch", "full")
# the matrix products as the dispatcher sees them: torch.einsum lowers a
# product to bmm (a projection with no batch dimension to a batch of 1),
# `@` on a [B, T, D] activation and a matrix to mm
_NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_PRODUCTS = (torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default)


def remat_saves(policy: str, op: tp.Any, *args: tp.Any) -> bool:
    """Whether the selective recompute of `remat_policy=policy` saves the
    output of the aten op `op` called on `args` (everything else is
    recomputed in the backward).

    'dots' saves every matrix product, as `jax.checkpoint_policies.
    dots_saveable` does; 'dots_no_batch' those with no batch dimension,
    as `dots_with_no_batch_dims_saveable` does: mm and addmm, and bmm or
    baddbmm over a batch of 1, which is how torch.einsum runs the
    projections that flax runs as a `dot_general` with no batch
    dimension ([B, T, D] x [D, ...] -> one [1, B*T, D] x [1, D, ...]
    bmm). A product with a true batch of 1 (dense attention at one
    sequence of one head) counts as no-batch too; that changes what is
    kept, not a value. 'full' saves nothing.
    """
    if policy == "full":
        return False
    if op in _NO_BATCH_PRODUCTS:
        return True
    if op in _BATCHED_PRODUCTS:
        lhs = args[0] if op == torch.ops.aten.bmm.default else args[1]
        return policy == "dots" or lhs.shape[0] == 1
    return False


def remat_context_fn(policy: str) -> tp.Callable:
    """The `context_fn` of `torch.utils.checkpoint.checkpoint` that
    implements `policy` (`remat_saves`) as a selective checkpoint."""

    def policy_fn(ctx: tp.Any, op: tp.Any, *args: tp.Any,
                  **kwargs: tp.Any) -> CheckpointPolicy:
        return (CheckpointPolicy.MUST_SAVE if remat_saves(policy, op, *args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy_fn)


_SEED_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _SEED_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _SEED_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _SEED_MASK
    return x ^ (x >> 31)


def fold_seed(seed: int, *data: int) -> int:
    """A seed derived from `seed` and the integers `data` (a layer index,
    a dropout site, a microbatch index), the port's counterpart of
    `jax.random.fold_in`: SplitMix64's finalizer over the seed, then
    over the running value XOR each datum in turn; 63 bits, as
    `torch.Generator.manual_seed` takes them."""
    value = _splitmix64(int(seed) & _SEED_MASK)
    for datum in data:
        value = _splitmix64(value ^ (int(datum) & _SEED_MASK))
    return value & ((1 << 63) - 1)


# dropout sites of a block: after the mixer, after the MLP
DROPOUT_MIXER, DROPOUT_MLP = 0, 1


def dropout(x: torch.Tensor, rate: float, seed: tp.Optional[int]
            ) -> torch.Tensor:
    """flax's `nn.Dropout(rate)` in training: keep each value with
    probability 1 - rate, scaled by 1 / (1 - rate), else 0. The mask is
    drawn from a fresh `torch.Generator` on x's device seeded with
    `seed`, so the same seed draws the same mask, in a recompute too.
    `seed=None` (not training) returns x."""
    if seed is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    generator = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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
    flax tree. `index` is its layer, which seeds its dropout sites."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device, mixer: str = "attention",
                 mesh: tp.Optional[Mesh] = None, index: int = 0):
        super().__init__()
        self.config = cfg
        self.index = index
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
                segment_ids: tp.Optional[torch.Tensor] = None,
                dropout_seed: tp.Optional[int] = None) -> torch.Tensor:
        """With `dropout_seed` (training with dropout > 0) dropout follows
        the mixer's output projection and the MLP's down projection (not
        an MoE layer's, as in the JAX package), each site seeded with
        `fold_seed(dropout_seed, index, site)`."""
        rate = self.config.dropout

        def site(number: int) -> tp.Optional[int]:
            return None if dropout_seed is None else fold_seed(
                dropout_seed, self.index, number)

        mix = self.ssd if self.mixer == "ssd" else self.attn
        x = x + dropout(mix(self.norm1(x), positions, segment_ids), rate,
                        site(DROPOUT_MIXER))
        if hasattr(self, "moe"):
            return x + self.moe(self.norm2(x))
        return x + dropout(self.mlp(self.norm2(x)), rate, site(DROPOUT_MLP))


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
                                              mixer, mesh, index=i))
        self.norm_f = RMSNorm(config.dim, config.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor,
                positions: tp.Optional[torch.Tensor] = None,
                segment_ids: tp.Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                return_aux: bool = False, train: bool = False,
                dropout_seed: tp.Optional[int] = None) -> tp.Any:
        """Logits [B, T, vocab] f32, or with `return_hidden` the final
        hidden states and the tied embedding (for a chunked loss that
        never materializes the logits), or with `return_aux` the logits
        and the MoE layers' summed load-balancing loss of this forward
        (`models.moe.moe_aux_loss`). `segment_ids` ([B, T], 0 =
        padding) makes attention segment-aware for packed batches; pass
        the packer's per-segment `positions` with them.

        `train=True` turns dropout on when `config.dropout > 0`, as the
        JAX package's `train` does (`nn.Module.training` plays no part:
        `generate` and the serving engine never drop); it then needs a
        `dropout_seed` (an int), as flax needs a 'dropout' rng."""
        cfg = self.config
        if train and cfg.dropout > 0.0:
            if dropout_seed is None:
                raise ValueError(
                    f"train=True with dropout={cfg.dropout} needs a "
                    f"dropout_seed (the JAX package needs rngs="
                    f"{{'dropout': key}})")
        else:
            dropout_seed = None
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
        remat = {} if cfg.remat_policy == "full" else {
            "context_fn": remat_context_fn(cfg.remat_policy)}
        for i in range(cfg.num_layers):
            block = getattr(self, f"block_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    block, x, positions, segment_ids, dropout_seed,
                    use_reentrant=False, **remat)
            else:
                x = block(x, positions, segment_ids, dropout_seed)
        x = self.norm_f(x)
        if return_hidden:
            return x, self.embed
        logits = tied_head(x, self.embed)
        if return_aux:
            return logits, moe_aux_loss(self)
        return logits
