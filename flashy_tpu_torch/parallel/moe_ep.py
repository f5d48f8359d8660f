"""The expert layer's routing and grouped MLP: the single-device half of
flashy_tpu/parallel/moe_ep.py.

* `_topk_route`: sequential top-k argmax routing at the raw softmax
  probability, as the JAX package routes every dispatch mode.
* `grouped_mlp`: the gelu MLP over expert-sorted rows, both projections
  grouped matmuls (`ops.grouped_matmul`, on CUDA the Hopper kernels of
  `csrc/grouped_matmul.cu`), as a `torch.autograd.Function` whose
  backward is megablox's `_gmm_bwd` for each projection: the input
  gradient `gmm(dY, W, transpose_rhs=True)` in the input's dtype, the
  weight gradient `tgmm(X, dY)` in the cast weight's dtype.

The JAX package pads the rows to a multiple of 128 before its grouped
matmuls (a TPU tiling rule); the port does not: its kernels mask the
ragged edge, and the pad rows would be zeros in and zeros out.

`ep_dropless_moe`, the expert-parallel exchange, is not ported yet.
"""
import typing as tp

import torch
import torch.nn.functional as F

from ..ops.grouped_matmul import gmm, tgmm

TODO_EXPERT_PARALLEL = ("ROADMAP.md queue A item 8d (expert parallelism: "
                        "moe_dispatch='dropless_ep')")


def _topk_route(probs: torch.Tensor, num_experts: int, top_k: int
                ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per round each token takes its best unused expert at the raw
    softmax probability. Returns (expert_ids [k, N], gates [k, N],
    hard_density [E], the mean of the one-hot picks summed over
    rounds). The one-hot masks compare against an arange instead of
    calling `F.one_hot`, which reads its input's range to the host."""
    experts = torch.arange(num_experts, device=probs.device)
    remaining = probs
    hard_density = torch.zeros(num_experts, dtype=torch.float32,
                               device=probs.device)
    ids, gates = [], []
    for _ in range(top_k):
        expert_index = torch.argmax(remaining, dim=-1)                 # [N]
        gate = torch.gather(remaining, -1, expert_index[:, None])[:, 0]
        one_hot = (expert_index[:, None] == experts).to(probs.dtype)
        hard_density = hard_density + one_hot.mean(0)
        ids.append(expert_index)
        gates.append(gate)
        remaining = remaining * (1.0 - one_hot)
    return torch.stack(ids), torch.stack(gates), hard_density


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class _GroupedMLP(torch.autograd.Function):
    """gelu(gmm(X, W_up)) -> gmm(., W_down), operands already in the
    compute dtype. Rounding points as `_grouped_mlp`: the first product
    comes out f32 and is cast to the compute dtype before gelu, the
    second comes out f32."""

    @staticmethod
    def forward(ctx, xs, w_up, w_down, group_sizes):
        h = gmm(xs, w_up, group_sizes, torch.float32).to(xs.dtype)
        y = gmm(_gelu(h), w_down, group_sizes, torch.float32)
        ctx.save_for_backward(xs, w_up, w_down, h, group_sizes)
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, w_up, w_down, h, group_sizes = ctx.saved_tensors
        g = _gelu(h)                       # recomputed: the same bits
        # The second projection's output gradient dY = dout * gate is a
        # true f32 tensor, and megablox computes gmm_t(dY, W_down) and
        # tgmm(H, dY) in f32. Against a bf16 W_down or H (a bf16 run) the
        # kernels take their split route: dY as three bf16 planes (hi +
        # mid + lo == dY exactly), each an exact product on the tensor
        # cores, summed in f32; in an f32 run, f32 FMAs.
        dy = dy.float().contiguous()
        dg = gmm(dy, w_down, group_sizes, g.dtype, transpose_rhs=True)
        dw_down = tgmm(g, dy, group_sizes, w_down.dtype)
        # The first projection's output gradient is the gelu gradient in
        # the compute dtype, which JAX widens to f32 (the transpose of
        # its astype): bf16-exact values. It is passed as it is, so in a
        # bf16 run gmm_t(dH, W_up) and tgmm(X, dH) run on the tensor
        # cores: the same exact products as megablox's f32 ones, summed
        # in another order.
        dh = torch.ops.aten.gelu_backward(dg, h, approximate="tanh")
        dxs = gmm(dh, w_up, group_sizes, xs.dtype, transpose_rhs=True)
        dw_up = tgmm(xs, dh, group_sizes, w_up.dtype)
        return dxs, dw_up, dw_down, None


def grouped_mlp(xs: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                group_sizes: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    """gelu-MLP over expert-sorted rows: xs [M, D] sorted by expert,
    w_up [E, D, F], w_down [E, F, D], group_sizes [E] int32. Returns
    [M, D] f32. The weights are cast to `dtype` here, so their f32
    parameters' gradients are the kernels' `dtype` gradients widened
    (bf16-rounded in a bf16 run, as JAX's astype transpose gives)."""
    return _GroupedMLP.apply(xs.to(dtype), w_up.to(dtype), w_down.to(dtype),
                             group_sizes)


def ep_dropless_moe(*args, **kwargs):
    """The expert-parallel dropless exchange: not ported yet."""
    raise NotImplementedError(
        f"ep_dropless_moe (the capacity-bounded all-to-all between expert "
        f"shards) is not ported yet: {TODO_EXPERT_PARALLEL}")
