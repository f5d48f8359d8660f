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

With `scan_layers=True` (the JAX package's `nn.scan` layout) the blocks
are one `blocks.block` module whose every parameter carries a leading
[L] dim (`blocks.block.attn.qkv.kernel [L, D, 3, H, Dh]`, ...), the
names and shapes of the JAX tree's `blocks/block/...`; the mixer
pattern must be uniform. Its forward runs the same block body layer by
layer on per-layer views of the stacked parameters (`StackedBlocks`).

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
grouped-GEMM kernels, `'dropless_ep'` the same over the mesh's 'expert'
ranks after a capacity-bounded all-to-all (`parallel.moe_ep`), and
`forward(..., return_aux=True)` also returns the summed load-balancing
loss.

Megatron tensor parallelism (`parallel.tensor`): `parallel.wrap` over a
mesh whose 'tensor' axis is above 1 cuts the model by
`transformer_shardings`, and each layer then reads its widths from the
slices it holds: the QKV, SSD `cbv` and MLP up-projections split by
column (after `copy_to_tensor`), the attention-out, SSD-out and MLP
down-projections by row (then `reduce_from_tensor`: one all-reduce
after each mixer and each MLP), the embedding and tied head by
vocabulary rows, an MoE block's experts by their hidden width. Expert
parallelism: `parallel.wrap` over a mesh whose 'expert' axis is above 1
gives each rank `E / e` of every MoE block's experts (`models.moe`).

Training switches, as in the JAX package:
- `dropout > 0` applies dropout after each mixer's output projection
  and after the MLP's down projection, only with `forward(...,
  train=True, dropout_seed=s)`. Each site draws its mask from a
  `torch.Generator` of its own on the activation's device, seeded with
  `fold_seed(s, layer, site)`, so a recompute draws the same mask.
  A data-parallel rank passes a `RowShard(s, rank, world)`: each site
  then draws its mask over the global batch (`world` x B rows) and
  keeps the rank's rows, so ranks holding contiguous rows of a global
  batch drop exactly what one process on the whole batch drops.
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
from ..parallel.ring import ring_self_attention
from ..parallel.tensor import (copy_to_tensor, layer_mesh,
                               reduce_from_tensor,
                               vocab_parallel_embedding)
from ..utils import resolve_device
from .moe import MoEMLP, moe_aux_loss


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
                                  # grouped-GEMM kernels) | dropless_ep
                                  # (the same over the 'expert' ranks)
    scan_layers: bool = False    # one stacked [L, ...] parameter a leaf
                                 # (StackedBlocks); uniform mixers only
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
    """Raise for layouts the model cannot hold."""
    pattern = mixer_pattern(cfg)  # raises on an unknown mixer name
    if cfg.scan_layers and len(set(pattern)) > 1:
        # one stacked body = one parameter shape: a hybrid stack's
        # attention and SSD layers have different parameter trees
        raise ValueError(
            "scan_layers requires a uniform mixer pattern (one scanned "
            f"body = one parameter shape); got {pattern}. Use "
            "scan_layers=False for hybrid attention/SSD stacks.")
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


class RowShard(tp.NamedTuple):
    """A dropout seed for one data-parallel rank: masks are drawn with
    `seed` over `shards` x B rows (B the local batch) and the rank keeps
    rows [shard * B, (shard + 1) * B)."""
    seed: int
    shard: int
    shards: int


DropoutSeed = tp.Union[int, RowShard]


def fold_dropout_seed(seed: DropoutSeed, *data: int) -> DropoutSeed:
    """`fold_seed` of a dropout seed, a `RowShard` keeping its rows."""
    if isinstance(seed, RowShard):
        return seed._replace(seed=fold_seed(seed.seed, *data))
    return fold_seed(seed, *data)


def training_dropout_seed(rate: float, train: bool,
                          dropout_seed: tp.Optional[DropoutSeed]
                          ) -> tp.Optional[DropoutSeed]:
    """The seed a forward drops with: `dropout_seed` when `train` and
    `rate > 0` (None there raises, as flax needs a 'dropout' rng), else
    None (no dropout)."""
    if not (train and rate > 0.0):
        return None
    if dropout_seed is None:
        raise ValueError(f"train=True with dropout={rate} needs a "
                         f"dropout_seed (the JAX package needs rngs="
                         f"{{'dropout': key}})")
    return dropout_seed


# dropout sites of a block: after the mixer, after the MLP
DROPOUT_MIXER, DROPOUT_MLP = 0, 1


def dropout(x: torch.Tensor, rate: float, seed: tp.Optional[DropoutSeed]
            ) -> torch.Tensor:
    """flax's `nn.Dropout(rate)` in training: keep each value with
    probability 1 - rate, scaled by 1 / (1 - rate), else 0. The mask is
    drawn from a fresh `torch.Generator` on x's device seeded with
    `seed`, so the same seed draws the same mask, in a recompute too; a
    `RowShard` draws it over all shards' rows and keeps its own.
    `seed=None` (not training) returns x."""
    if seed is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shape, rows = x.shape, slice(None)
    if isinstance(seed, RowShard):
        shape = (seed.shards * x.shape[0],) + tuple(x.shape[1:])
        rows = slice(seed.shard * x.shape[0], (seed.shard + 1) * x.shape[0])
        seed = seed.seed
    generator = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(shape, generator=generator, device=x.device)[rows] \
        < keep
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
        """Under tensor parallelism the layer holds its rank's heads
        (`qkv` [D, 3, H/T, Dh], `out` [H/T, Dh, D]): the input enters
        through `copy_to_tensor`, attention runs on the rank's heads and
        the output's partial sums leave through `reduce_from_tensor`."""
        cfg = self.config
        mesh = layer_mesh(self.mesh, self.qkv.kernel.shape[2], cfg.num_heads,
                          "attention heads")
        x = copy_to_tensor(x.to(cfg.dtype), mesh)
        qkv = torch.einsum("btd,dchk->btchk", x,
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
        return reduce_from_tensor(torch.einsum(
            "bqhd,hdD->bqD", out, self.out.kernel.to(cfg.dtype)), mesh)


class MLPBlock(nn.Module):
    """The gated MLP. Under tensor parallelism the layer holds its rank's
    slice of the hidden width: `up` [D, 2F/T] as its columns of `gate`
    then the same columns of `value` (the `pairs` layout of
    `transformer_shardings`), `down` [F/T, D] the matching rows."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device, mesh: tp.Optional[Mesh] = None):
        super().__init__()
        self.config = cfg
        self.mesh = mesh
        hidden = cfg.dim * cfg.mlp_ratio
        self.up = _Kernel((cfg.dim, 2 * hidden), cfg.dim, generator, device)
        self.down = _Kernel((hidden, cfg.dim), hidden, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = cfg.dtype
        mesh = layer_mesh(self.mesh, self.down.kernel.shape[0],
                          cfg.dim * cfg.mlp_ratio, "MLP hidden width")
        x = copy_to_tensor(x.to(dtype), mesh)
        gate, value = (x @ self.up.kernel.to(dtype)).chunk(2, -1)
        return reduce_from_tensor(
            (nn.functional.silu(gate) * value) @ self.down.kernel.to(dtype),
            mesh)


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
            self.ssd = SSDMixer(cfg, generator, device, mesh)
        else:
            self.attn = Attention(cfg, generator, device, mesh)
        self.norm2 = RMSNorm(cfg.dim, cfg.dtype, device)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(cfg.dim, cfg.dim * cfg.mlp_ratio,
                              cfg.moe_experts, cfg.moe_top_k,
                              cfg.moe_capacity_factor, cfg.dtype,
                              cfg.moe_dispatch, generator=generator,
                              device=device, mesh=mesh)
        else:
            self.mlp = MLPBlock(cfg, generator, device, mesh)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: tp.Optional[torch.Tensor] = None,
                dropout_seed: tp.Optional[DropoutSeed] = None,
                layer: tp.Optional[int] = None) -> torch.Tensor:
        """With `dropout_seed` (training with dropout > 0) dropout follows
        the mixer's output projection and the MLP's down projection (not
        an MoE layer's, as in the JAX package), each site seeded with
        `fold_seed(dropout_seed, layer, site)`; `layer` defaults to the
        block's `index` (a stacked model's one block passes its loop's
        layer)."""
        rate = self.config.dropout
        layer = self.index if layer is None else layer

        def site(number: int) -> tp.Optional[DropoutSeed]:
            return None if dropout_seed is None else fold_dropout_seed(
                dropout_seed, layer, number)

        mix = self.ssd if self.mixer == "ssd" else self.attn
        x = x + dropout(mix(self.norm1(x), positions, segment_ids), rate,
                        site(DROPOUT_MIXER))
        if hasattr(self, "moe"):
            return x + self.moe(self.norm2(x))
        return x + dropout(self.mlp(self.norm2(x)), rate, site(DROPOUT_MLP))


def _owner(module: nn.Module, name: str) -> tp.Tuple[nn.Module, str]:
    """The submodule holding the dotted parameter `name`, and its leaf."""
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def _run_block(cfg: TransformerConfig, block: tp.Callable, *args: tp.Any
               ) -> torch.Tensor:
    """`block(*args)`, recomputed in the backward under `cfg.remat`
    (`torch.utils.checkpoint`, `remat_policy` as its context)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return block(*args)
    remat = {} if cfg.remat_policy == "full" else {
        "context_fn": remat_context_fn(cfg.remat_policy)}
    return torch.utils.checkpoint.checkpoint(block, *args,
                                             use_reentrant=False, **remat)


class StackedBlocks(nn.Module):
    """The scan-stacked layout's `blocks`: one `block`, a `Block` whose
    every parameter carries a leading [L] dim (the JAX tree's
    `blocks/block/...`), run layer by layer.

    The init draws L blocks from the generator in the per-layer model's
    order and stacks their weights, so both layouts start from the same
    weights at the same seed. The forward takes the per-layer views with
    one `torch.unbind` a leaf (its backward stacks the L gradients once)
    and runs `block`'s own forward on them
    (`torch.func.functional_call`): the block body, remat, dropout (the
    loop's layer seeds the sites) and every mixer and MoE dispatch are
    the per-layer model's. `block`'s modules hold only the stacked
    parameters, so `parameters()`, the optimizer and the state dict see
    each weight once. Its MoE layer overwrites its `aux` every layer, so
    the loop sums the layers' losses here (`aux`), in the per-layer
    model's order, and `moe_aux_loss` reads this sum instead.
    """

    reports_aux = True

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device, mixer: str,
                 mesh: tp.Optional[Mesh] = None):
        super().__init__()
        self.config = cfg
        layers = [Block(cfg, generator, device, mixer, mesh, index=i)
                  for i in range(cfg.num_layers)]
        self.block = layers[0]
        self.names = tuple(name for name, _ in self.block.named_parameters())
        with torch.no_grad():
            for name in self.names:
                stacked = torch.stack([layer.get_parameter(name)
                                       for layer in layers])
                owner, leaf = _owner(self.block, name)
                setattr(owner, leaf, nn.Parameter(stacked))
        for module in self.block.modules():
            if isinstance(module, MoEMLP):
                module.reports_aux = False   # this module's `aux` sums them
        self.aux: tp.Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: tp.Optional[torch.Tensor] = None,
                dropout_seed: tp.Optional[DropoutSeed] = None) -> torch.Tensor:
        views = {name: torch.unbind(getattr(*_owner(self.block, name)), 0)
                 for name in self.names}
        moe = getattr(self.block, "moe", None)
        aux = None
        for i in range(self.config.num_layers):
            weights = {name: view[i] for name, view in views.items()}

            def layer(x, positions, segment_ids, dropout_seed,
                      weights=weights, i=i):
                return torch.func.functional_call(
                    self.block, weights,
                    (x, positions, segment_ids, dropout_seed),
                    {"layer": i})

            x = _run_block(self.config, layer, x, positions, segment_ids,
                           dropout_seed)
            if moe is not None:
                aux = moe.aux if aux is None else aux + moe.aux
        self.aux = aux
        return x


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
            at call time, as the JAX package does. Its 'tensor' axis is
            what `parallel.wrap` cuts the model over: the model is built
            whole, the wrap slices it, and each layer then runs on the
            slice it holds (`layer_mesh`): the embedding vocab-parallel,
            the tied head giving the rank's [B, T, V/T] logits (reduce
            them with `parallel.tensor.vocab_parallel_cross_entropy`).
            Its 'expert' axis cuts the MoE blocks' experts the same way
            (`models.moe`); `moe_dispatch='dropless_ep'` needs the mesh
            (ValueError without one, as in the JAX package).
    """

    def __init__(self, config: TransformerConfig, *,
                 device: tp.Any = None, seed: int = 0,
                 mesh: tp.Optional[Mesh] = None):
        super().__init__()
        check_supported(config)
        device = resolve_device(device)
        self.config = config
        self.mesh = mesh
        generator = torch.Generator(device=device).manual_seed(seed)
        self.embed = _param((config.vocab_size, config.dim), 0.02,
                            generator, device)
        pattern = mixer_pattern(config)
        if config.scan_layers:
            self.blocks = StackedBlocks(config, generator, device,
                                        pattern[0], mesh)
        else:
            for i, mixer in enumerate(pattern):
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
                dropout_seed: tp.Optional[DropoutSeed] = None) -> tp.Any:
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
        `dropout_seed` (an int, or a data-parallel rank's `RowShard`), as
        flax needs a 'dropout' rng."""
        cfg = self.config
        dropout_seed = training_dropout_seed(cfg.dropout, train,
                                             dropout_seed)
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
        mesh = layer_mesh(self.mesh, self.embed.shape[0], cfg.vocab_size,
                          "vocabulary rows")
        if mesh is None:
            x = self.embed[tokens].to(cfg.dtype)
        else:
            x = vocab_parallel_embedding(tokens, self.embed, mesh
                                         ).to(cfg.dtype)
        if cfg.scan_layers:
            x = self.blocks(x, positions, segment_ids, dropout_seed)
        else:
            for i in range(cfg.num_layers):
                x = _run_block(cfg, getattr(self, f"block_{i}"), x,
                               positions, segment_ids, dropout_seed)
        x = self.norm_f(x)
        if return_hidden:
            return x, self.embed
        logits = tied_head(copy_to_tensor(x, mesh), self.embed)
        if return_aux:
            return logits, moe_aux_loss(self)
        return logits

    def shardings(self) -> tp.Dict[str, tp.Any]:
        """`transformer_shardings` of the model's parameters: the layout
        `parallel.wrap` cuts it by."""
        return transformer_shardings(dict(self.named_parameters()))


def transformer_spec(path: str) -> tp.Any:
    """The spec of the TransformerLM leaf at `path` ('/'-joined, as the
    JAX package matches it on substrings): see `transformer_shardings`.
    `mlp/up` carries `pairs=2` (its `gate | value` halves split apart)."""
    from ..parallel.sharding import P

    if "embed" in path:
        return P("tensor", "fsdp")
    pairs = 1
    if "moe/w_up" in path:
        base: tp.Tuple = ("expert", "fsdp", "tensor")
    elif "moe/w_down" in path:
        base = ("expert", "tensor", "fsdp")
    elif "router" in path:
        base = ()
    elif "qkv" in path:
        base = ("fsdp", None, "tensor", None)
    elif "attn/out" in path:
        base = ("tensor", None, "fsdp")
    elif "ssd/cbv" in path:
        base = ("fsdp", "tensor", None)
    elif "ssd/out" in path:
        base = ("tensor", None, "fsdp")
    elif "ssd/dt_bias" in path:
        base = ("tensor",)
    elif "mlp/up" in path:
        base, pairs = ("fsdp", "tensor"), 2
    elif "mlp/down" in path:
        base = ("tensor", "fsdp")
    else:
        base = ()
    if "blocks/" in path:
        return P("pipe", *base, pairs=pairs)
    return P(*base, pairs=pairs)


def transformer_shardings(params: tp.Any) -> tp.Dict[str, tp.Any]:
    """The spec of every parameter of a TransformerLM, by name: the port
    of the JAX package's `transformer_shardings` over the port's names
    (`dict(model.named_parameters())`, a state dict or `params_from_jax`'s
    tree; the layouts are the JAX package's, so each spec splits the
    reference's dims). Megatron-style tensor splits over 'tensor' with
    FSDP sharding over 'fsdp':

      embed [V, D]            -> (tensor, fsdp)
      attn qkv [D, 3, H, Dh]  -> (fsdp, None, tensor, None)
      attn out [H, Dh, D]     -> (tensor, None, fsdp)
      ssd cbv [D, H, P]       -> (fsdp, tensor, None)
      ssd out [H, Dh, D]      -> (tensor, None, fsdp)
      ssd dt_bias [H]         -> (tensor,)
      mlp up [D, 2F]          -> (fsdp, tensor)
      mlp down [F, D]         -> (tensor, fsdp)
      moe w_up [E, D, F]      -> (expert, fsdp, tensor)
      moe w_down [E, F, D]    -> (expert, tensor, fsdp)
      moe router [D, E]       -> replicated
      norms [D]               -> replicated

    A scan-stacked leaf (`blocks.block....`) leads with 'pipe'. At
    `tensor=1` the tensor entries are replication; `wrap(model,
    fsdp=True, state_sharding=transformer_shardings(...))` holds each
    parameter as its 'fsdp' shard. `mlp/up`'s spec carries `pairs=2`: a
    tensor rank holds its columns of `gate` and of `value` (the spec's
    tuple is the reference's; the reference's partitioner moves the
    halves where the port's layout puts them)."""
    return {name: transformer_spec(name.replace(".", "/"))
            for name in params}
