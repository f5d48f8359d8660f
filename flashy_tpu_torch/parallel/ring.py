"""Sequence-parallel exact attention by K/V ring rotation: the port of
flashy_tpu/parallel/ring.py.

Each of the n ranks of the mesh's `seq` axis holds one sequence block of
Q, K and V ([B, T/n, H, D]); rank r's block covers global rows [r * T/n,
(r + 1) * T/n). At ring step s rank r holds the K/V block of owner
(r - s) mod n: where the JAX package moves the blocks with `ppermute`,
the port's ranks share one card and index the owner's block directly.
Causal attention skips the steps s > r (the future) and masks step 0,
the rank's own block, in-block.

* `ring_attention` ('scan', the JAX `ring_attention`): each visible
  step runs the flash forward kernel on one block pair (`_block_forward`,
  an f32 block output and its logsumexp) and the blocks merge by
  logaddexp weights (`_merge`).
* `parallel.ring_fused.fused_ring_attention` ('fused'): one Hopper
  kernel per rank does the whole forward.
* Both share the backward (`_ring_backward_pass`): each visible (rank,
  step) pair runs the split flash backward kernels with the forward's
  GLOBAL logsumexp and D = rowsum(dO.O), dQ summed per rank in step
  order and dK/dV per owner in ring order (ranks j, j+1, ..., the order
  in which the accumulator travels the JAX ring), all in f32.

`ring_self_attention` takes global [B, T, H, D] tensors, cuts them into
the ranks' contiguous blocks (shard_map's placement) and returns the
global output. On CUDA tensors every block product is a kernel; on the
CPU the kernels' plain versions run.
"""
import typing as tp

import torch

from ..ops.attention import flash_backward_split, flash_delta, flash_forward
from .mesh import AXES, Mesh, default_mesh


def visible_steps(rank: int, n: int, causal: bool) -> range:
    """The ring steps whose K/V block rank `rank` attends to."""
    return range(rank + 1 if causal else n)


def owner(rank: int, step: int, n: int) -> int:
    """The rank whose K/V block rank `rank` holds at ring step `step`."""
    return (rank - step) % n


def _block_forward(q, k, v, *, causal_diag: bool):
    """One ring block on the flash forward kernel: (out [B, T, H, D] f32,
    lse [B, H, T]). `causal_diag` masks the own block (offset 0)."""
    out, lse = flash_forward(q, k, v, causal_diag)
    return out.float(), lse


def _block_backward(q, k, v, do, lse, delta, *, causal_diag: bool):
    """(dq, dk, dv) of one block pair on the split flash backward kernels,
    from the GLOBAL logsumexp and D = rowsum(dO.O): P = exp(S - lse) are
    the exact global attention weights of this block, so the pairs'
    gradients sum to the whole gradient."""
    return flash_backward_split(q, k, v, do, lse, delta, causal_diag)


def _merge(out_acc, lse_acc, out_blk, lse_blk):
    """logaddexp merge of two normalized partial attentions."""
    new_lse = torch.logaddexp(lse_acc, lse_blk)          # [B, H, T]
    w_acc = torch.exp(lse_acc - new_lse).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_blk - new_lse).transpose(1, 2)[..., None]
    return out_acc * w_acc + out_blk * w_blk, new_lse


def _ring_forward_pass(qs, ks, vs, causal: bool):
    """Per-rank (outs in q's dtype, lses [B, H, T]) of the scan ring."""
    n = len(qs)
    outs, lses = [], []
    for rank in range(n):
        out, lse = _block_forward(qs[rank], ks[rank], vs[rank],
                                  causal_diag=causal)
        for step in visible_steps(rank, n, causal)[1:]:
            j = owner(rank, step, n)
            out_b, lse_b = _block_forward(qs[rank], ks[j], vs[j],
                                          causal_diag=False)
            out, lse = _merge(out, lse, out_b, lse_b)
        outs.append(out.to(qs[rank].dtype))
        lses.append(lse)
    return outs, lses


def _ring_backward_pass(qs, ks, vs, outs, lses, dos, causal: bool):
    """Per-rank (dqs, dks, dvs) in the blocks' dtypes."""
    n = len(qs)
    deltas = [flash_delta(do, out) for do, out in zip(dos, outs)]
    dq: tp.List[tp.Optional[torch.Tensor]] = [None] * n
    dk: tp.List[tp.Optional[torch.Tensor]] = [None] * n
    dv: tp.List[tp.Optional[torch.Tensor]] = [None] * n

    def add(acc, grad):
        return grad.float() if acc is None else acc + grad.float()

    # step-major: rank r's dQ adds its steps in order, and owner j's dK/dV
    # the ranks j, j+1, ..., j+n-1 that visit it, in order
    for step in range(n):
        for rank in range(n):
            if step not in visible_steps(rank, n, causal):
                continue
            j = owner(rank, step, n)
            dq_b, dk_b, dv_b = _block_backward(
                qs[rank], ks[j], vs[j], dos[rank], lses[rank], deltas[rank],
                causal_diag=causal and step == 0)
            dq[rank] = add(dq[rank], dq_b)
            dk[j] = add(dk[j], dk_b)
            dv[j] = add(dv[j], dv_b)
    return ([g.to(x.dtype) for g, x in zip(dq, qs)],
            [g.to(x.dtype) for g, x in zip(dk, ks)],
            [g.to(x.dtype) for g, x in zip(dv, vs)])


class RingFunction(torch.autograd.Function):
    """Ring attention over the ranks' blocks, flattened as (*qs, *ks,
    *vs): `forward_pass` computes the per-rank (outs, lses), the backward
    is `_ring_backward_pass`, as the JAX custom VJPs of both rings do."""

    @staticmethod
    def forward(ctx, forward_pass, causal, *blocks):
        n = len(blocks) // 3
        qs, ks, vs = blocks[:n], blocks[n:2 * n], blocks[2 * n:]
        outs, lses = forward_pass(qs, ks, vs, causal)
        ctx.save_for_backward(*blocks, *outs, *lses)
        ctx.n, ctx.causal = n, causal
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grad_outs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dos = [do.to(out.dtype) for do, out in zip(grad_outs, outs)]
        dqs, dks, dvs = _ring_backward_pass(qs, ks, vs, outs, lses, dos,
                                            ctx.causal)
        return (None, None, *dqs, *dks, *dvs)


def run_ring(forward_pass, qs, ks, vs, causal):
    """The ranks' output blocks of `RingFunction` with `forward_pass`."""
    if not len(qs) == len(ks) == len(vs) >= 1:
        raise ValueError(f"ring attention needs one q, k and v block per "
                         f"rank, got {len(qs)}, {len(ks)}, {len(vs)}")
    return list(RingFunction.apply(forward_pass, causal, *qs, *ks, *vs))


def ring_attention(qs: tp.Sequence[torch.Tensor],
                   ks: tp.Sequence[torch.Tensor],
                   vs: tp.Sequence[torch.Tensor],
                   causal: bool = False) -> tp.List[torch.Tensor]:
    """Attention over a sequence held as the ranks' blocks.

    `qs`, `ks`, `vs`: one [B, T_local, H, D] block per rank, in ring
    order (block r covers global rows [r * T_local, (r + 1) * T_local)).
    Returns each rank's output block of exact (optionally causal) softmax
    attention over the global sequence; differentiable.
    """
    return run_ring(_ring_forward_pass, qs, ks, vs, causal)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mesh: tp.Optional[Mesh] = None, axis: str = "seq",
                        causal: bool = False,
                        batch_axes: tp.Sequence[str] = ("data", "fsdp"),
                        impl: str = "scan") -> torch.Tensor:
    """Global [B, T, H, D] tensors, T cut over the mesh's `axis`.

    Each rank gets its contiguous block of T / n rows; the ranks run the
    ring and the output comes back global. `impl` selects the per-rank
    construction: 'scan' (the flash kernels per block, `ring_attention`)
    or 'fused' (one ring kernel per rank, `ring_fused`). `batch_axes`
    name the axes the JAX package shards the batch over; they are all of
    size 1 on a port mesh (`make_mesh`), so the argument is accepted for
    the JAX signature's sake: its names are checked and it changes
    nothing that runs. The tensors must lie on the mesh's device.
    """
    mesh = mesh or default_mesh()
    for name in (axis, *batch_axes):
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; valid: {AXES}")
    if impl == "fused":
        from .ring_fused import fused_ring_attention as fn
    elif impl == "scan":
        fn = ring_attention
    else:
        raise ValueError(f"impl must be 'scan' or 'fused', got {impl!r}")
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} does not split into "
                         f"{n} equal blocks over mesh axis {axis!r}")
    device = mesh.device(q)
    if any(x.device != device for x in (q, k, v)):
        raise ValueError(f"ring_self_attention: the mesh's ranks run on "
                         f"{device}, the tensors lie on {q.device}, "
                         f"{k.device}, {v.device}")
    t_local = q.shape[1] // n
    qs, ks, vs = ([block.contiguous() for block in x.split(t_local, dim=1)]
                  for x in (q, k, v))
    return torch.cat(fn(qs, ks, vs, causal=causal), dim=1)
