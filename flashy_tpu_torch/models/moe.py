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
* 'dropless_ep' (expert parallelism) raises NotImplementedError.

'einsum' and 'sorted' are plain PyTorch (the JAX package has no kernel
there); they are the oracles of 'dropless' (with a capacity factor
large enough that nothing drops). Each forward records its Switch
load-balancing loss, `E * sum(mean(probs) * hard_density / k)`, on the
module (`aux`); `moe_aux_loss(model)` sums them over a model, in place
of flax's `sow('losses', 'moe_aux')` and `moe_aux_loss(mutated)`.
"""
import math
import typing as tp

import torch
from torch import nn

from ..parallel.moe_ep import (TODO_EXPERT_PARALLEL, _gelu, _topk_route,
                               grouped_mlp)

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


class MoEMLP(nn.Module):
    """Routed MoE MLP over [B, T, D] activations (see the module doc).
    Its `aux` counts in `moe_aux_loss` while `reports_aux` holds.

    Args:
        dim: model width.
        hidden: per-expert MLP hidden width.
        num_experts: expert count.
        top_k: experts per token.
        capacity_factor: slack over perfectly balanced routing ('einsum'
            and 'sorted').
        dtype: activation/compute dtype.
        dispatch: 'einsum', 'sorted', 'dropless' or 'dropless_ep'.
        generator, device: the random init (lecun-normal weights).
    """

    reports_aux = True

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 dispatch: str = "einsum", *,
                 generator: torch.Generator, device: tp.Any):
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown dispatch {dispatch!r}; expected one "
                             f"of {DISPATCHES}")
        if dispatch == "dropless_ep":
            raise NotImplementedError(
                f"dispatch='dropless_ep' is not ported yet: "
                f"{TODO_EXPERT_PARALLEL}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.dispatch = dispatch
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, dim = x.shape
        n_tokens = batch * seq
        # capacity scales with top_k: there are N*k assignments to fill
        capacity = max(1, int(self.capacity_factor * n_tokens * self.top_k
                              / self.num_experts))
        x_flat = x.reshape(n_tokens, dim)
        probs = torch.softmax(x_flat.float() @ self.router.kernel, dim=-1)
        experts, gates, hard_density = _topk_route(probs, self.num_experts,
                                                   self.top_k)
        self.aux = self.num_experts * torch.sum(
            probs.mean(0) * hard_density / self.top_k)
        if self.dispatch == "sorted":
            out = self._sorted(x_flat, experts, gates, capacity)
        elif self.dispatch == "dropless":
            out = self._dropless(x_flat, experts, gates)
        else:
            out = self._einsum(x_flat, experts, gates, capacity)
        return out.reshape(batch, seq, dim)

    def _expert_mlp(self, slab: torch.Tensor) -> torch.Tensor:
        """[E, C, D] capacity buffers -> [E, C, D], in the compute dtype."""
        h = _gelu(torch.einsum("ecd,edf->ecf", slab,
                               self.w_up.to(self.dtype)))
        return torch.einsum("ecf,efd->ecd", h, self.w_down.to(self.dtype))

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
        dispatch = (combine > 0.0).to(self.dtype)
        expert_in = torch.einsum("nec,nd->ecd", dispatch,
                                 x_flat.to(self.dtype))
        expert_out = self._expert_mlp(expert_in)
        return torch.einsum("nec,ecd->nd", combine.to(self.dtype),
                            expert_out)

    def _sorted(self, x_flat, experts, gates, capacity):
        n_tokens, dim = x_flat.shape
        num_experts = self.num_experts
        device = x_flat.device
        counts = torch.zeros(num_experts, dtype=torch.long, device=device)
        # one spare row takes the dropped tokens (JAX: mode='drop' /
        # mode='fill'); the destinations of kept tokens are disjoint
        # across rounds, so all rounds share one slab
        slab = torch.zeros((num_experts * capacity + 1, dim),
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
            dest = torch.where(keep, idx_sorted * capacity + pos,
                               torch.full_like(pos, num_experts * capacity))
            slab = slab.index_put((dest,), x_flat[order].to(self.dtype))
            rounds.append((order, dest, gate[order] * keep))
            kept = torch.zeros(num_experts + 1, dtype=torch.long,
                               device=device).index_add_(
                0, torch.where(keep, idx_sorted,
                               torch.full_like(idx_sorted, num_experts)),
                torch.ones_like(idx_sorted))
            counts = counts + kept[:-1]
        expert_out = self._expert_mlp(
            slab[:-1].reshape(num_experts, capacity, dim))
        flat_out = torch.cat([expert_out.reshape(-1, dim),
                              expert_out.new_zeros((1, dim))])
        out = torch.zeros((n_tokens, dim), dtype=torch.float32, device=device)
        for order, dest, gate_kept in rounds:
            y_sorted = flat_out[dest].float() * gate_kept[:, None]
            out = out + y_sorted[torch.argsort(order)]
        return out.to(self.dtype)

    def _dropless(self, x_flat, experts, gates):
        n_tokens, dim = x_flat.shape
        device = x_flat.device
        assignment_expert = experts.reshape(-1)                      # [N*k]
        assignment_gate = gates.reshape(-1)
        assignment_token = torch.arange(n_tokens, device=device).repeat(
            self.top_k)
        order = torch.argsort(assignment_expert, stable=True)
        token_sorted = assignment_token[order]
        # per-expert counts without reading the routing to the host
        group_sizes = torch.zeros(self.num_experts, dtype=torch.int32,
                                  device=device).index_add_(
            0, assignment_expert,
            torch.ones_like(assignment_expert, dtype=torch.int32))
        x_sorted = x_flat[token_sorted].to(self.dtype)               # [N*k, D]
        y = grouped_mlp(x_sorted, self.w_up, self.w_down, group_sizes,
                        self.dtype)
        # With top_k <= 2 each token's f32 sum is 0 + a + b, the same bits
        # in any order, so the unordered index_add_ on CUDA (and the
        # gather's backward) stays deterministic; top_k > 2 loses that.
        out = torch.zeros((n_tokens, dim), dtype=torch.float32,
                          device=device).index_add(
            0, token_sorted, y * assignment_gate[order][:, None])
        return out.to(self.dtype)
