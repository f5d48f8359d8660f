"""The expert layer's routing, grouped MLP and expert-parallel exchange:
the port of flashy_tpu/parallel/moe_ep.py.

* `_topk_route`: sequential top-k argmax routing at the raw softmax
  probability, as the JAX package routes every dispatch mode.
* `grouped_mlp`: the gelu MLP over expert-sorted rows, both projections
  grouped matmuls (`ops.grouped_matmul`, on CUDA the Hopper kernels of
  `csrc/grouped_matmul.cu`), as a `torch.autograd.Function` whose
  backward is megablox's `_gmm_bwd` for each projection: the input
  gradient `gmm(dY, W, transpose_rhs=True)` in the input's dtype, the
  weight gradient `tgmm(X, dY)` in the cast weight's dtype.
* `ep_dropless_moe`: expert-parallel dropless MoE, one process a shard
  of the mesh's `expert` axis. Each shard holds `E / e` experts and its
  `n_loc` tokens. Per-(source, destination shard) capacity is
  `ceil(capacity_factor * k * n_loc / e)`; assignments claim slots
  first-come-first-served in (round, token) order and the overflow
  drops (`ep_plan`). `[e * C, D]` send buffers and a local-expert id
  buffer (the sentinel `E / e` in empty slots) cross by all-to-all
  (`distrib.all_to_all`, an autograd Function whose backward is the
  mirror exchange); the receiver sorts its slab by local expert and runs
  `grouped_mlp` on it; the results return by the mirror all-to-all and
  combine at the source with the gates in f32. The aux loss takes the
  densities' means over the `(token_axes..., expert)` processes.
  `ep_dropless_shard` is the body; it takes the exchange and the mean as
  functions, so the shards of one mesh can also be driven in one
  process.

The JAX package pads the rows to a multiple of 128 before its grouped
matmuls (a TPU tiling rule) and folds the exchange's empty slots into
the last group; the port does neither: its kernels mask the ragged
edge, and the empty slots, sorted after every group, are rows past the
groups' sum, which `gmm` writes as zeros and `tgmm` skips (zeros in and
zeros out either way, without a host read of the count).
"""
import math
import typing as tp

import torch
import torch.nn.functional as F

from .. import distrib
from ..ops.grouped_matmul import gmm, tgmm
from .mesh import Mesh
from .tensor import copy_to_tensor, reduce_from_tensor


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


class EpPlan(tp.NamedTuple):
    """The exchange's bookkeeping of one shard's assignments, each [k *
    n_loc] in (round, token) order: the token, gate and destination
    shard of each, its slot in that shard's buffer, whether it is kept
    (`slot < capacity`), its row in the `[e * C]` send buffer (`e * C`
    for a dropped one), and the send buffer's local-expert ids
    (`send_eid` [e * C] int32, the sentinel `E / e` in empty slots)."""
    token: torch.Tensor
    gate: torch.Tensor
    dest_shard: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    flat_dest: torch.Tensor
    send_eid: torch.Tensor


def ep_capacity(capacity_factor: float, top_k: int, n_loc: int,
                shards: int) -> int:
    """Slots a source gives each destination shard: `ceil(capacity_factor
    * top_k * n_loc / shards)`, at least 1."""
    return max(1, -(-int(capacity_factor * top_k * n_loc) // shards))


def ep_plan(expert_ids: torch.Tensor, gates: torch.Tensor, shards: int,
            experts_local: int, capacity: int) -> EpPlan:
    """Slots of one shard's assignments (`_topk_route`'s [k, n_loc] ids
    and gates): the running count of assignments to each destination
    shard, first-come-first-served in (round, token) order; past
    `capacity` an assignment drops. Integer bookkeeping throughout."""
    top_k, n_loc = expert_ids.shape
    device = expert_ids.device
    assignment_expert = expert_ids.reshape(-1)
    token = torch.arange(n_loc, device=device).repeat(top_k)
    dest_shard = torch.div(assignment_expert, experts_local,
                           rounding_mode="floor")
    one_hot = (dest_shard[:, None] == torch.arange(shards, device=device)
               ).to(torch.int32)
    position = torch.cumsum(one_hot, 0, dtype=torch.int32) - 1
    slot = torch.gather(position, 1, dest_shard[:, None])[:, 0]
    keep = slot < capacity
    flat_dest = torch.where(keep, dest_shard * capacity + slot,
                            shards * capacity)
    send_eid = torch.full((shards * capacity + 1,), experts_local,
                          dtype=torch.int32, device=device).index_put(
        (flat_dest,), (assignment_expert % experts_local).to(torch.int32)
    )[:-1]
    return EpPlan(token, gates.reshape(-1), dest_shard, slot, keep,
                  flat_dest, send_eid)


def ep_dropless_shard(x_loc: torch.Tensor, probs_loc: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor, *,
                      num_experts: int, shards: int, top_k: int,
                      capacity_factor: float, dtype: torch.dtype,
                      exchange: tp.Callable[[torch.Tensor], torch.Tensor],
                      mean: tp.Callable[[torch.Tensor], torch.Tensor],
                      tensor_mesh: tp.Optional[Mesh] = None
                      ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One shard's expert-parallel dropless MoE; returns `(out [n_loc, D]
    in dtype, aux)`. `exchange(t)` sends row block j of `t` to shard j
    and returns the blocks received, in shard order (an all-to-all over
    the expert axis, differentiable for a float `t`); `mean(t)` is `t`'s
    mean over the shards of the token axes and the expert axis
    (`ep_dropless_moe` gives both over the mesh's processes).

    x_loc [n_loc, D] and probs_loc [n_loc, E] are the shard's tokens and
    their router softmax; w_up [E / e, D, F'] and w_down [E / e, F', D]
    the shard's experts, F' = F / tensor under `tensor_mesh` (the expert
    MLP is then a Megatron pair: `copy_to_tensor` before the first
    product, the second product's f32 partials reduced before the one
    cast to the compute dtype that precedes the return exchange)."""
    n_loc, dim = x_loc.shape
    experts_local = num_experts // shards
    capacity = ep_capacity(capacity_factor, top_k, n_loc, shards)
    expert_ids, gates, hard_density = _topk_route(probs_loc, num_experts,
                                                  top_k)
    # the densities over every shard's tokens: the aux loss does not
    # depend on how the tokens are cut
    density, hard_density = mean(torch.stack(
        [probs_loc.mean(0), hard_density])).unbind(0)
    aux = num_experts * torch.sum(density * hard_density / top_k)

    plan = ep_plan(expert_ids, gates, shards, experts_local, capacity)
    send_x = torch.zeros((shards * capacity + 1, dim), dtype=dtype,
                         device=x_loc.device).index_put(
        (plan.flat_dest,), x_loc[plan.token].to(dtype))[:-1]
    recv_x = exchange(send_x)
    recv_eid = exchange(plan.send_eid)

    # dropless on the local slab: sorted by local expert, the empty
    # (sentinel) slots after every group, where gmm writes zeros
    order = torch.argsort(recv_eid, stable=True)
    group_sizes = torch.zeros(experts_local + 1, dtype=torch.int32,
                              device=x_loc.device).index_add_(
        0, recv_eid.long(), torch.ones_like(recv_eid))[:-1]
    xs = copy_to_tensor(recv_x[order], tensor_mesh)
    ys = reduce_from_tensor(grouped_mlp(xs, w_up, w_down, group_sizes,
                                        dtype), tensor_mesh)
    y = torch.zeros_like(ys).index_put((order,), ys)           # unsort
    back_x = exchange(y.to(dtype))

    # combine at the source: each kept assignment reads its slot back,
    # scaled by its gate; a dropped one reads the zero row
    padded = torch.cat([back_x, back_x.new_zeros((1, dim))])
    y_assign = padded[plan.flat_dest].float()
    out = torch.zeros((n_loc, dim), dtype=torch.float32,
                      device=x_loc.device).index_add(
        0, plan.token, y_assign * (plan.gate * plan.keep)[:, None])
    return out.to(dtype), aux


class _AllToAll(torch.autograd.Function):
    """`distrib.all_to_all` over a group; the backward is the mirror
    exchange (block i of process j goes back to block j of process i)."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, group: tp.Any) -> torch.Tensor:
        ctx.group = group
        return distrib.all_to_all(x, group)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        return distrib.all_to_all(grad.contiguous(), ctx.group), None


class _TokenMean(torch.autograd.Function):
    """The mean of `x` over the `count` processes of the token axes and
    the expert axis. Its backward assumes what the data-parallel step
    does: the ranks of an expert group hold one loss (each its copy) and
    DistributedDataParallel averages the gradients over the token axes'
    processes (and over the expert ranks, where they are equal: `wrap`).
    The cotangents are summed over the token axes and divided
    by `count`, so that after that average each shard's densities carry
    `1 / count` of the loss's gradient, once, as the JAX package's pmean
    transposes."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, mesh: Mesh,
                token_axes: tp.Tuple[str, ...], count: int) -> torch.Tensor:
        ctx.mesh, ctx.token_axes, ctx.count = mesh, token_axes, count
        total = distrib.all_reduce(x.contiguous(), "sum",
                                   mesh.group(token_axes + ("expert",)))
        return total / count

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        summed = grad.contiguous() if not ctx.token_axes else \
            distrib.all_reduce(grad.contiguous(), "sum",
                               ctx.mesh.group(ctx.token_axes))
        return summed / ctx.count, None, None, None


def ep_dropless_moe(x_loc: torch.Tensor, probs_loc: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, *,
                    mesh: Mesh, num_experts: int, top_k: int = 1,
                    capacity_factor: float = 1.25,
                    token_axes: tp.Sequence[str] = ("data",),
                    dtype: torch.dtype = torch.bfloat16,
                    tensor_mesh: tp.Optional[Mesh] = None
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE MLP over this process's shard of the tokens.

    `x_loc` [n_loc, D] and `probs_loc` [n_loc, E] are the process's
    tokens (its 'expert'-th block of its data-parallel rows: `shard_map`'s
    `P((token_axes..., 'expert'))` block) and their router softmax;
    `w_up` [E / e, D, F'] and `w_down` [E / e, F', D] its experts (e =
    `mesh.shape['expert']`, which must divide E). Returns `(out [n_loc,
    D] in dtype, aux)`: `aux` is the Switch load-balancing loss (eq. 4, E
    * sum_e density_e * hard_density_e / k) over the densities' means over
    the `(token_axes..., 'expert')` processes, the same on each of them.
    The exchanges run over `mesh.group('expert')` (an all-to-all each: the
    tokens, their local-expert ids, the results), the means over the
    group of the token axes and 'expert'; collective: every process of
    those groups calls it together."""
    shards = mesh.shape["expert"]
    if num_experts % shards:
        raise ValueError(f"num_experts={num_experts} not divisible by "
                         f"mesh axis 'expert' of size {shards}")
    if w_up.shape[0] != num_experts // shards:
        raise ValueError(f"w_up holds {w_up.shape[0]} experts; a shard of "
                         f"{num_experts} over expert={shards} holds "
                         f"{num_experts // shards}")
    # the token axes whose processes hold other tokens
    token_axes = tuple(a for a in token_axes if mesh.shape[a] > 1)
    means = math.prod(mesh.shape[a] for a in token_axes) * shards
    group = mesh.group("expert") if shards > 1 else None

    def mean(tensor: torch.Tensor) -> torch.Tensor:
        if means == 1:
            return tensor
        return _TokenMean.apply(tensor, mesh, token_axes, means)

    def exchange(tensor: torch.Tensor) -> torch.Tensor:
        if shards == 1:
            return tensor
        if tensor.is_floating_point():
            return _AllToAll.apply(tensor, group)
        return distrib.all_to_all(tensor, group)

    return ep_dropless_shard(
        x_loc, probs_loc, w_up, w_down, num_experts=num_experts,
        shards=shards, top_k=top_k, capacity_factor=capacity_factor,
        dtype=dtype, exchange=exchange, mean=mean, tensor_mesh=tensor_mesh)
