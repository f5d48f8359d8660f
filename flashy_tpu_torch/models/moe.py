"""Routed mixture-of-experts MLP: the port of flashy_tpu/models/moe.py.

`MoEMLP` routes each token to its top-k experts (f32 softmax router,
sequential argmax rounds, raw-probability gates) and runs a gelu MLP per
expert. Parameters keep the JAX names and layouts, f32:

    router.kernel [D, E]     applied to the f32 activations
    w_up          [E, D, F]
    w_down        [E, F, D]

Dispatch modes, as in the JAX package:

* 'einsum': one-hot [N, E, C] dispatch and combine tensors and per-
  expert einsums over capacity buffers of C = capacity_factor * N * k /
  E slots; tokens past an expert's capacity get no expert output.
* 'sorted': the same routing and keep decisions with O(N) buffers
  (argsort scatter into per-expert slabs, gather back).
* 'dropless': no capacity: token-expert assignments sort by expert and
  both projections run as grouped matmuls (`parallel.moe_ep.
  grouped_mlp`, on CUDA the Hopper kernels of `csrc/grouped_matmul.cu`).
* 'dropless_ep': expert parallelism over the mesh's 'expert' axis
  (`parallel.moe_ep.ep_dropless_moe`): each expert rank takes its block
  of the rows, a capacity-bounded all-to-all carries each assignment to
  the rank holding its expert, the grouped matmuls run there, and the
  results return by the mirror exchange. It needs the mesh (ValueError
  without one, as in the JAX package).

'einsum' and 'sorted' are plain PyTorch (the JAX package has no kernel
there); they are the oracles of 'dropless' (with a capacity factor
large enough that nothing drops). Each forward records its Switch
load-balancing loss, `E * sum(mean(probs) * hard_density / k)`, on the
module (`aux`); `moe_aux_loss(model)` sums them over a model, in place
of flax's `sow('losses', 'moe_aux')` and `moe_aux_loss(mutated)`.

Over a mesh, `parallel.wrap` cuts the expert weights by
`transformer_shardings` (`w_up` (expert, fsdp, tensor), `w_down`
(expert, tensor, fsdp)), and the layer reads what it holds from their
shapes: `E / e` experts under 'expert' and `F / t` of the hidden width
under 'tensor'. The router runs on the rank's whole rows, as one process
runs it. Under 'expert' the 'einsum', 'sorted' and 'dropless' dispatches
compute only the assignments to the rank's own experts, and the block's
output is summed over the expert ranks (`copy_to_tensor` of the tokens
and gates at the entry, `reduce_from_tensor` of the f32 output at the
exit, over 'expert'); 'dropless_ep' enters by this rank's block of the
rows (gathered over 'expert' in the backward) and leaves by the
gathered blocks (this rank's block of the gradient in the backward).
Either way the rest of the block sees whole, identical tensors on every
expert rank, so its parameters and the router get equal gradients there
up to the order of a non-deterministic kernel's sums; `parallel.wrap`
averages them over the expert ranks, which makes them one value. Under
'tensor' the expert MLP is a
Megatron pair: `copy_to_tensor` before the first product, the second
product's f32 partials reduced before the one cast to the compute dtype.
"""
import math
import typing as tp

import torch
from torch import nn

from .. import distrib
from ..parallel.moe_ep import (_gelu, _topk_route, ep_dropless_moe,
                               grouped_mlp)
from ..parallel.tensor import (copy_to_tensor, layer_mesh,
                               reduce_from_tensor)

DISPATCHES = ("einsum", "sorted", "dropless", "dropless_ep")


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """Sum of the load-balancing losses the MoEMLPs of `model` recorded
    in their last forward (a zero scalar when it has none); a stacked
    model's layers report through their `StackedBlocks`, which sums its
    loop's losses."""
    losses = [m.aux for m in model.modules()
              if getattr(m, "reports_aux", False) and m.aux is not None]
    if not losses:
        param = next(model.parameters(), None)
        return torch.zeros((), device=None if param is None
                           else param.device)
    return sum(losses[1:], losses[0])


def _one_hot(index: torch.Tensor, classes: int) -> torch.Tensor:
    """int32 one-hot rows; an index outside [0, classes) gives a zero
    row, as jax.nn.one_hot does."""
    return (index[..., None] == torch.arange(classes, device=index.device)
            ).to(torch.int32)


class _TakeRows(torch.autograd.Function):
    """This expert rank's block of the rows forward (block `coord` of the
    group's `n`); the gradient blocks of every rank of the group gathered
    backward (all of them compute the same downstream, so each holds the
    gradient of its own block)."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, mesh: tp.Any,
                axis: str) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        n = mesh.shape[axis]
        return x.reshape(n, -1, *x.shape[1:])[mesh.coord(axis)].clone()

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        return _gather_rows(grad, ctx.mesh, ctx.axis), None, None


class _GatherRows(torch.autograd.Function):
    """Every expert rank's block of the rows gathered forward; this rank's
    block of the gradient backward."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, mesh: tp.Any,
                axis: str) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        return _gather_rows(x, mesh, axis)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        n = ctx.mesh.shape[ctx.axis]
        return (grad.reshape(n, -1, *grad.shape[1:])[
            ctx.mesh.coord(ctx.axis)].clone(), None, None)


def _gather_rows(x: torch.Tensor, mesh: tp.Any, axis: str) -> torch.Tensor:
    """The blocks of `x` of every rank of the mesh's `axis` group, joined
    along dim 0 in rank order (one all-gather)."""
    n = mesh.shape[axis]
    flat = distrib.all_gather(x.contiguous().reshape(-1), mesh.group(axis))
    return flat.view(n * x.shape[0], *x.shape[1:])


class MoEMLP(nn.Module):
    """Routed MoE MLP over [B, T, D] activations (see the module doc).
    Its `aux` counts in `moe_aux_loss` while `reports_aux` holds.

    Args:
        dim: model width.
        hidden: per-expert MLP hidden width.
        num_experts: expert count.
        top_k: experts per token.
        capacity_factor: slack over perfectly balanced routing ('einsum'
            and 'sorted'; 'dropless_ep''s slots a destination shard).
        dtype: activation/compute dtype.
        dispatch: 'einsum', 'sorted', 'dropless' or 'dropless_ep'.
        generator, device: the random init (lecun-normal weights).
        mesh: the mesh whose 'expert' and 'tensor' axes the layer's
            weights may be cut over (`parallel.wrap`); required by
            'dropless_ep'.
        expert_axis: the axis the experts shard over ('expert').
        token_axes: the other axes the tokens shard over, whose
            processes the aux loss's densities are averaged over with
            the expert ranks' ('dropless_ep'; ("data",)).
    """

    reports_aux = True

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 dispatch: str = "einsum", *,
                 generator: torch.Generator, device: tp.Any,
                 mesh: tp.Any = None, expert_axis: str = "expert",
                 token_axes: tp.Tuple[str, ...] = ("data",)):
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown dispatch {dispatch!r}; expected one "
                             f"of {DISPATCHES}")
        if dispatch == "dropless_ep" and mesh is None:
            raise ValueError("dispatch='dropless_ep' needs the mesh "
                             "(MoEMLP(mesh=...)); use 'dropless' for "
                             "replicated-expert training")
        if expert_axis != "expert":
            raise ValueError(f"the port's expert axis is 'expert', got "
                             f"{expert_axis!r}")
        self.num_experts, self.top_k = num_experts, top_k
        self.hidden = hidden
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.dispatch = dispatch
        self.mesh, self.expert_axis = mesh, expert_axis
        self.token_axes = tuple(token_axes)
        self.router = nn.Module()
        self.router.kernel = self._param((dim, num_experts), generator,
                                         device)
        self.w_up = self._param((num_experts, dim, hidden), generator, device)
        self.w_down = self._param((num_experts, hidden, dim), generator,
                                  device)
        self.aux: tp.Optional[torch.Tensor] = None

    @staticmethod
    def _param(shape, generator, device) -> nn.Parameter:
        """lecun-normal: std 1/sqrt(fan_in), with flax's fan_in of a
        [..., in, out] kernel, the product of all but the last dim."""
        return nn.Parameter(torch.randn(*shape, generator=generator,
                                        device=device)
                            / math.sqrt(math.prod(shape[:-1])))

    def _shards(self) -> int:
        """The expert ranks of the mesh (1 without one)."""
        return 1 if self.mesh is None else int(
            self.mesh.shape[self.expert_axis])

    def _local_experts(self) -> tp.Tuple[int, int, tp.Any]:
        """(the first expert this rank computes, how many, the mesh its
        output is summed over or None): every expert on one rank; under
        'expert' the E / e this rank holds (`parallel.wrap`'s slices)."""
        held = self.w_up.shape[0]
        if held == self.num_experts:
            return 0, held, None
        shards = self._shards()
        if held * shards != self.num_experts:
            raise ValueError(
                f"experts: the layer holds {held} of {self.num_experts}, "
                f"which a mesh with {self.expert_axis}={shards} does not "
                f"give")
        return self.mesh.coord(self.expert_axis) * held, held, self.mesh

    def _tensor_mesh(self) -> tp.Any:
        """The mesh the expert MLP's Megatron pair runs over, None when
        the layer holds the whole hidden width."""
        return layer_mesh(self.mesh, self.w_up.shape[2], self.hidden,
                          "MoE hidden width")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, dim = x.shape
        n_tokens = batch * seq
        # capacity scales with top_k: there are N*k assignments to fill
        capacity = max(1, int(self.capacity_factor * n_tokens * self.top_k
                              / self.num_experts))
        x_flat = x.reshape(n_tokens, dim)
        probs = torch.softmax(x_flat.float() @ self.router.kernel, dim=-1)
        if self.dispatch == "dropless_ep":
            out = self._dropless_ep(x_flat, probs)
            return out.reshape(batch, seq, dim)
        experts, gates, hard_density = _topk_route(probs, self.num_experts,
                                                   self.top_k)
        self.aux = self.num_experts * torch.sum(
            probs.mean(0) * hard_density / self.top_k)
        _, _, expert_mesh = self._local_experts()
        # a rank of an expert group computes its experts' assignments:
        # the tokens and gates enter by the copy whose backward sums the
        # ranks' partial gradients, and the output leaves summed
        x_flat = copy_to_tensor(x_flat, expert_mesh, self.expert_axis)
        gates = copy_to_tensor(gates, expert_mesh, self.expert_axis)
        if self.dispatch == "sorted":
            out = self._sorted(x_flat, experts, gates, capacity)
        elif self.dispatch == "dropless":
            out = self._dropless(x_flat, experts, gates)
        else:
            out = self._einsum(x_flat, experts, gates, capacity)
        if expert_mesh is not None:
            out = reduce_from_tensor(out, expert_mesh, self.expert_axis)
        return out.to(self.dtype).reshape(batch, seq, dim)

    def _expert_weights(self) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """'dropless_ep''s w_up and w_down, those of this rank's shard: as
        held, or this rank's E / e of whole weights (an unwrapped model,
        or one whose full parameters are summoned)."""
        shards = self._shards()
        if shards == 1 or self.w_up.shape[0] != self.num_experts:
            return self.w_up, self.w_down
        local = self.num_experts // shards
        first = self.mesh.coord(self.expert_axis) * local
        return (self.w_up[first:first + local],
                self.w_down[first:first + local])

    def _dropless_ep(self, x_flat: torch.Tensor,
                     probs: torch.Tensor) -> torch.Tensor:
        """'dropless_ep': this rank's block of the rows through the
        exchange (`ep_dropless_moe`), the blocks gathered back."""
        shards = self._shards()
        if x_flat.shape[0] % shards:
            raise ValueError(f"{x_flat.shape[0]} tokens do not split over "
                             f"{self.expert_axis}={shards}")
        if shards > 1:
            x_flat = _TakeRows.apply(x_flat, self.mesh, self.expert_axis)
            probs = _TakeRows.apply(probs, self.mesh, self.expert_axis)
        w_up, w_down = self._expert_weights()
        out, self.aux = ep_dropless_moe(
            x_flat, probs, w_up, w_down, mesh=self.mesh,
            num_experts=self.num_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            token_axes=self.token_axes, dtype=self.dtype,
            tensor_mesh=self._tensor_mesh())
        if shards > 1:
            out = _GatherRows.apply(out, self.mesh, self.expert_axis)
        return out

    def _expert_mlp(self, slab: torch.Tensor) -> torch.Tensor:
        """[E', C, D] capacity buffers -> [E', C, D], in the compute
        dtype; under 'tensor' a Megatron pair over the held hidden
        columns, the f32 partial sums reduced before the cast."""
        tensor_mesh = self._tensor_mesh()
        slab = copy_to_tensor(slab, tensor_mesh)
        h = _gelu(torch.einsum("ecd,edf->ecf", slab,
                               self.w_up.to(self.dtype)))
        if tensor_mesh is None:
            return torch.einsum("ecf,efd->ecd", h,
                                self.w_down.to(self.dtype))
        partial = torch.einsum("ecf,efd->ecd", h.float(),
                               self.w_down.to(self.dtype).float())
        return reduce_from_tensor(partial, tensor_mesh).to(self.dtype)

    def _einsum(self, x_flat, experts, gates, capacity):
        n_tokens = x_flat.shape[0]
        num_experts = self.num_experts
        combine = torch.zeros((n_tokens, num_experts, capacity),
                              dtype=torch.float32, device=x_flat.device)
        # slots handed out per expert by earlier rounds; integer
        # bookkeeping, as in the JAX package
        counts = torch.zeros(num_experts, dtype=torch.int32,
                             device=x_flat.device)
        for expert_index, gate in zip(experts, gates):
            mask = _one_hot(expert_index, num_experts)               # [N, E]
            position = ((torch.cumsum(mask, 0, dtype=torch.int32) - 1)
                        + counts[None, :]) * mask
            mask = mask * (position < capacity).to(torch.int32)
            slot = _one_hot(position.sum(-1), capacity)              # [N, C]
            combine = combine + (gate[:, None, None]
                                 * mask.float()[:, :, None]
                                 * slot.float()[:, None, :])
            counts = counts + mask.sum(0, dtype=torch.int32)
        first, local, expert_mesh = self._local_experts()
        if expert_mesh is not None:
            combine = combine[:, first:first + local]
        dispatch = (combine > 0.0).to(self.dtype)
        expert_in = torch.einsum("nec,nd->ecd", dispatch,
                                 x_flat.to(self.dtype))
        expert_out = self._expert_mlp(expert_in)
        if expert_mesh is None:
            return torch.einsum("nec,ecd->nd", combine.to(self.dtype),
                                expert_out)
        # this rank's experts' part, summed over the ranks in f32
        return torch.einsum("nec,ecd->nd", combine.to(self.dtype).float(),
                            expert_out.float())

    def _sorted(self, x_flat, experts, gates, capacity):
        n_tokens, dim = x_flat.shape
        num_experts = self.num_experts
        device = x_flat.device
        first, local, expert_mesh = self._local_experts()
        counts = torch.zeros(num_experts, dtype=torch.long, device=device)
        # one spare row takes the dropped tokens (JAX: mode='drop' /
        # mode='fill') and, under 'expert', those of the other ranks'
        # experts; the destinations of kept tokens are disjoint across
        # rounds, so all rounds share one slab
        slab = torch.zeros((local * capacity + 1, dim),
                           dtype=self.dtype, device=device)
        arange = torch.arange(n_tokens, device=device)
        rounds = []
        for expert_index, gate in zip(experts, gates):
            order = torch.argsort(expert_index, stable=True)
            idx_sorted = expert_index[order]
            starts = torch.searchsorted(
                idx_sorted, torch.arange(num_experts, device=device))
            pos = arange - starts[idx_sorted] + counts[idx_sorted]
            keep = pos < capacity
            held = keep if expert_mesh is None else keep & (
                idx_sorted >= first) & (idx_sorted < first + local)
            dest = torch.where(held, (idx_sorted - first) * capacity + pos,
                               torch.full_like(pos, local * capacity))
            slab = slab.index_put((dest,), x_flat[order].to(self.dtype))
            rounds.append((order, dest, gate[order] * keep))
            kept = torch.zeros(num_experts + 1, dtype=torch.long,
                               device=device).index_add_(
                0, torch.where(keep, idx_sorted,
                               torch.full_like(idx_sorted, num_experts)),
                torch.ones_like(idx_sorted))
            counts = counts + kept[:-1]
        expert_out = self._expert_mlp(
            slab[:-1].reshape(local, capacity, dim))
        flat_out = torch.cat([expert_out.reshape(-1, dim),
                              expert_out.new_zeros((1, dim))])
        out = torch.zeros((n_tokens, dim), dtype=torch.float32, device=device)
        for order, dest, gate_kept in rounds:
            y_sorted = flat_out[dest].float() * gate_kept[:, None]
            out = out + y_sorted[torch.argsort(order)]
        return out

    def _dropless(self, x_flat, experts, gates):
        n_tokens, dim = x_flat.shape
        device = x_flat.device
        first, local, _ = self._local_experts()
        assignment_expert = experts.reshape(-1)                      # [N*k]
        assignment_gate = gates.reshape(-1)
        assignment_token = torch.arange(n_tokens, device=device).repeat(
            self.top_k)
        # the held experts' assignments first, by expert; under 'expert'
        # the others' after them, past the groups (gmm writes zeros there)
        key = assignment_expert - first
        if local != self.num_experts:
            key = torch.where((key >= 0) & (key < local), key,
                              torch.full_like(key, local))
        order = torch.argsort(key, stable=True)
        token_sorted = assignment_token[order]
        # per-expert counts without reading the routing to the host
        group_sizes = torch.zeros(local + 1, dtype=torch.int32,
                                  device=device).index_add_(
            0, key, torch.ones_like(key, dtype=torch.int32))[:local]
        tensor_mesh = self._tensor_mesh()
        x_sorted = copy_to_tensor(x_flat[token_sorted].to(self.dtype),
                                  tensor_mesh)                       # [N*k, D]
        y = reduce_from_tensor(grouped_mlp(x_sorted, self.w_up, self.w_down,
                                           group_sizes, self.dtype),
                               tensor_mesh)
        # With top_k <= 2 each token's f32 sum is 0 + a + b, the same bits
        # in any order, so the unordered index_add_ on CUDA (and the
        # gather's backward) stays deterministic; top_k > 2 loses that.
        return torch.zeros((n_tokens, dim), dtype=torch.float32,
                           device=device).index_add(
            0, token_sorted, y * assignment_gate[order][:, None])
