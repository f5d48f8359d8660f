"""GPipe and 1F1B (interleaved, packed) pipeline schedules over the 'pipe'
process axis: the port of flashy_tpu/parallel/pipeline.py.

The JAX package runs a pipeline as one SPMD program: every stage is a
slice of the 'pipe' mesh axis, and activations hop between stages with
`lax.ppermute` inside a `lax.scan` over ticks. The port's pipe stages
are processes (`Mesh.coord('pipe')`, `Mesh.pipe_peers()`), so each rank
runs only its own stage and the hops are point-to-point sends between
ranks (`distrib.isend` / `irecv`: under gloo a CUDA tensor is staged
through the host, under NCCL it travels directly).

* `pipeline` is GPipe's fill-drain, kept as the oracle: each rank runs
  its stage over the M microbatches and keeps their autograd graphs.
  The hops are `torch.autograd.Function`s whose backward is the reverse
  hop, and the schedule is differentiable with one `.backward()` on
  every rank: the input is replicated (its gradient summed over the
  pipe ranks) and the output is the last stage's, broadcast (its
  gradient read from one copy), as the reference's shard_map reads them.
  Residency is O(M) microbatches of activations.
* `pipeline_1f1b` is PipeDream-flush with interleaved virtual stages:
  each rank walks its own column of the reference's tables
  (`schedules.build_1f1b_schedule`) tick by tick, banks arriving
  activations into a `[stash_depth]` ring, runs at most one forward and
  one backward a tick, and recomputes the chunk forward from the stashed
  input in the backward (O(S) stash, flat in M). Gradients accumulate in
  f32, chunk by chunk in the backward's order, so the packed schedule
  (forward and backward in one tick) is bit-identical to the unpacked
  one. `overlap=True` runs the hop-latency-2 tables: a tick starts the
  sends of the previous tick's outputs and waits for its receives after
  its own compute.

`run_pipeline_bench` / `python -m flashy_tpu_torch.parallel.pipeline
--workers=2` measures GPipe against the 1F1B family on a small dense and
MoE LM over two ranks (the reference's gates; `tensor_compose` at a
world size divisible by 4). The schedule's fault sites
(`pipeline.tick`, `pipeline.packed_tick`) fire on every rank before its
first hop, so an injected raise surfaces before any send.
"""
import typing as tp

import numpy as np
import torch

from .. import distrib
from ..resilience import chaos
from .mesh import Mesh, default_mesh
from .schedules import (PACKED_FORWARD_ERROR, PipelineSchedule,
                        build_1f1b_schedule, validate_pipeline_args)

Tree = tp.Any


# ----------------------------------------------------------------------
# tree helpers (the stage parameters are any tree of dicts, lists and
# tuples of tensors, as the reference's pytrees)
# ----------------------------------------------------------------------
def _leaves(tree: Tree) -> tp.Tuple[tp.List[tp.Any], tp.Callable]:
    return distrib._flatten(tree)


def _tree_map(fn: tp.Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, rebuild = _leaves(tree)
    others = [_leaves(other)[0] for other in rest]
    return rebuild([fn(leaf, *(other[i] for other in others))
                    for i, leaf in enumerate(leaves)])


def _check_axis(mesh: Mesh, axis: str) -> int:
    if axis != "pipe":
        raise ValueError(f"the port's pipeline runs over the 'pipe' process "
                         f"axis, got axis={axis!r}")
    return int(mesh.shape["pipe"])


class _Hop:
    """A rank's ring over the mesh's pipe group: its stage, the stages'
    count, the next and previous stages' global ranks and the group."""

    def __init__(self, mesh: Mesh):
        self.stage = mesh.coord("pipe")
        self.stages = mesh.shape["pipe"]
        self.next, self.prev = mesh.pipe_peers()
        self.group = mesh.group("pipe")
        self.last_rank = next(group for group in mesh.group_ranks("pipe")
                              if distrib.rank() in group)[-1]


# ----------------------------------------------------------------------
# GPipe: autograd through the hops
# ----------------------------------------------------------------------
_pending_sends: tp.List[distrib.Pending] = []


def _wait_sends() -> None:
    """Finish every send the hops started (their host copies are kept
    alive until then)."""
    while _pending_sends:
        _pending_sends.pop().wait()


def _queue_wait_sends() -> None:
    """Finish the backward's sends when the backward pass ends."""
    torch.autograd.Variable._execution_engine.queue_callback(_wait_sends)


class _ReplicatedInput(torch.autograd.Function):
    """The pipeline's input, replicated over the pipe ranks: the
    identity; the gradient summed over them (only stage 0 reads it)."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, hop: _Hop) -> torch.Tensor:
        ctx.hop = hop
        return x.view_as(x)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        _wait_sends()
        return distrib.all_reduce(grad.contiguous(), "sum",
                                  ctx.hop.group), None


class _RecvActivation(torch.autograd.Function):
    """A stage's input from the previous stage (a blocking receive); the
    backward sends its gradient back (a send, finished at the end of the
    backward). `anchor` ties the node to the replicated input, so every
    rank's backward reaches the input's all-reduce."""

    @staticmethod
    def forward(ctx: tp.Any, anchor: torch.Tensor, like: torch.Tensor,
                hop: _Hop, tag: int) -> torch.Tensor:
        ctx.hop, ctx.tag = hop, tag
        ctx.anchor_shape = anchor.shape
        return distrib.recv(like, hop.prev, hop.group, tag)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        _pending_sends.append(distrib.isend(grad.contiguous(), ctx.hop.prev,
                                            ctx.hop.group, ctx.tag + 1))
        _queue_wait_sends()
        return grad.new_zeros(ctx.anchor_shape), None, None, None


class _SendActivation(torch.autograd.Function):
    """A stage's output sent to the next stage; returns a scalar zero that
    the rank's output depends on. The backward receives the output's
    gradient from the next stage (a blocking receive)."""

    @staticmethod
    def forward(ctx: tp.Any, y: torch.Tensor, hop: _Hop, tag: int
                ) -> torch.Tensor:
        ctx.hop, ctx.tag = hop, tag
        ctx.like = (y.shape, y.dtype, y.device)
        _pending_sends.append(distrib.isend(y.contiguous(), hop.next,
                                            hop.group, tag))
        return y.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        shape, dtype, device = ctx.like
        dy = distrib.recv(torch.empty(shape, dtype=dtype, device=device),
                          ctx.hop.next, ctx.hop.group, ctx.tag + 1)
        return dy, None, None


class _BroadcastLast(torch.autograd.Function):
    """The last stage's output on every pipe rank; the backward hands the
    last stage its own cotangent (the output is one replicated value: its
    gradient is one copy, not the ranks' sum)."""

    @staticmethod
    def forward(ctx: tp.Any, local: torch.Tensor, hop: _Hop) -> torch.Tensor:
        _wait_sends()
        return distrib.broadcast(local.contiguous(), hop.last_rank,
                                 hop.group)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        return grad, None


class _SumOverPipe(torch.autograd.Function):
    """A per-stage scalar summed over the pipe ranks (the aux losses);
    the backward passes the gradient through."""

    @staticmethod
    def forward(ctx: tp.Any, value: torch.Tensor, hop: _Hop) -> torch.Tensor:
        return distrib.all_reduce(value, "sum", hop.group)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        return grad, None


def _stage_slice(stage_params: Tree, num_stages: int, stage: int) -> Tree:
    """This rank's stage parameters: `leaf[stage]` of leaves leading with
    `num_stages` (the reference's layout), `leaf[0]` of leaves leading
    with 1 (the rank's own stage)."""
    def pick(leaf: torch.Tensor) -> torch.Tensor:
        lead = leaf.shape[0] if leaf.dim() else None
        if lead == num_stages:
            return leaf[stage]
        if lead == 1:
            return leaf[0]
        raise ValueError(
            f"pipeline stage_params leaves need a leading num_stages="
            f"{num_stages} dim (or 1: this rank's stage), got shape "
            f"{tuple(leaf.shape)}")

    return _tree_map(pick, stage_params)


def pipeline(stage_fn: tp.Callable, stage_params: Tree, x: torch.Tensor, *,
             mesh: tp.Optional[Mesh] = None, axis: str = "pipe",
             num_microbatches: tp.Optional[int] = None,
             has_aux: bool = False) -> tp.Any:
    """Run a shape-preserving stage function as a GPipe pipeline.

    Args:
        stage_fn: `(params, activations) -> activations` (the same
            shape), or `-> (activations, aux_scalar)` with
            `has_aux=True`: the scalars are summed over every stage and
            microbatch (MoE load-balancing losses).
        stage_params: a tree whose leaves lead with `num_stages` (rank s
            uses `leaf[s]`, the reference's layout) or with 1 (the rank's
            own stage's parameters).
        x: the batch [B, ...], the same on every pipe rank.
        num_microbatches: how finely to split B (must divide it);
            defaults to the number of stages.

    Returns the activations after all stages (the shape of `x`) on every
    pipe rank, or `(activations, aux_total)` with `has_aux=True`.
    Differentiable with one `.backward()` on every pipe rank: the hops'
    backward is the reverse hop, the microbatches' backward runs in
    reverse order, `x`'s gradient is summed over the ranks and the
    output's read from one copy. Every microbatch's activations live
    until the backward: O(M) residency (see `pipeline_1f1b`).
    """
    mesh = mesh or default_mesh()
    num_stages = _check_axis(mesh, axis)
    if num_stages == 1:
        only = _tree_map(lambda p: p[0], stage_params)
        return stage_fn(only, x)
    num_micro = num_microbatches or num_stages
    batch = x.shape[0]
    validate_pipeline_args(num_stages, num_micro, batch)
    hop = _Hop(mesh)
    local = _stage_slice(stage_params, num_stages, hop.stage)
    x = _ReplicatedInput.apply(x, hop)
    micro = x.reshape(num_micro, batch // num_micro, *x.shape[1:]).unbind(0)
    last = hop.stage == num_stages - 1
    outputs, tokens, aux_total = [], [], None
    for m, x_m in enumerate(micro):
        tag = 2 * m
        # the receive's node must be on the graph for its backward (the
        # send back) to run, whether or not x wants a gradient
        anchor = x_m if x_m.requires_grad else \
            torch.zeros((), device=x.device, requires_grad=True)
        h = x_m if hop.stage == 0 else _RecvActivation.apply(
            anchor, x_m.detach(), hop, tag)
        if has_aux:
            h, aux = stage_fn(local, h)
            aux = aux.float()
            aux_total = aux if aux_total is None else aux_total + aux
        else:
            h = stage_fn(local, h)
        if last:
            outputs.append(h)
        else:
            tokens.append(_SendActivation.apply(h, hop, tag))
    if last:
        out_local = torch.cat(outputs)
    else:
        # the rank's stand-in for the output: zeros, tied to the sends so
        # the backward reaches them
        out_local = torch.zeros(x.shape, dtype=h.dtype, device=h.device) \
            + torch.stack(tokens).sum().to(h.dtype)
    out = _BroadcastLast.apply(out_local, hop)
    if has_aux:
        return out, _SumOverPipe.apply(aux_total, hop)
    return out


# ----------------------------------------------------------------------
# 1F1B + interleaved virtual stages
# ----------------------------------------------------------------------
def _check_chunk_params(stage_params: Tree, num_chunks: int,
                        interleave: int, num_stages: int) -> bool:
    """Whether `stage_params` is the whole chunk stack ([C, ...] leaves,
    the reference's layout: True) or this rank's chunks ([v, ...]: its
    chunks d, d + S, ..., in order; False). Anything else raises."""
    full = None
    for leaf in _leaves(stage_params)[0]:
        lead = leaf.shape[0] if getattr(leaf, "dim", lambda: 0)() else None
        kind = True if lead == num_chunks else \
            False if lead == interleave else None
        if kind is None or (full is not None and kind != full):
            raise ValueError(
                f"pipeline_1f1b stage_params leaves need a leading "
                f"[num_stages*interleave]={num_chunks} chunk dim "
                f"(S={num_stages}, interleave={interleave}), or "
                f"[interleave]={interleave} of this rank's chunks; a leaf "
                f"has shape {tuple(getattr(leaf, 'shape', ()))}. Restack "
                f"the layer params into {num_chunks} equal chunks (chunk c "
                f"= layers [c*L/C, (c+1)*L/C)).")
        full = kind
    return bool(full)


def default_overlap(packed: bool, interleave: int = 1,
                    mesh: tp.Optional[Mesh] = None,
                    device: tp.Any = None) -> bool:
    """The `overlap=None` resolution of `pipeline_1f1b`: the double-
    buffered packed ring pays off only where a hop can run beside the
    stage compute (a CUDA mesh or device) and only at interleave=1 (see
    `schedules.build_1f1b_schedule`); False on the CPU. The device is the
    mesh's, else `device`'s, else CUDA when a card is present."""
    if not packed or interleave != 1:
        return False
    if mesh is not None and mesh.devices is not None:
        kind = mesh.devices[0].type
    elif device is not None:
        kind = torch.device(device).type
    else:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    return kind == "cuda"


def _single_stage_1f1b(stage_fn, stage_params, x, loss_fn, loss_params,
                       targets, interleave, has_aux, aux_weight):
    """Degenerate pipe=1 path: chain the chunks sequentially; training
    differentiates the full-batch objective directly (identical by the
    mean-reduction contract on `loss_fn`)."""
    def apply_chunks(params: Tree, xx: torch.Tensor):
        h = xx
        aux_total = torch.zeros((), dtype=torch.float32, device=xx.device)
        for c in range(interleave):
            chunk = _tree_map(lambda a, c=c: a[c], params)
            if has_aux:
                h, aux = stage_fn(chunk, h)
                aux_total = aux_total + aux.float()
            else:
                h = stage_fn(chunk, h)
        return h, aux_total

    if loss_fn is None:
        with torch.no_grad():
            out, aux_total = apply_chunks(stage_params, x)
        return (out, aux_total) if has_aux else out
    if loss_params is None:
        loss_params = {}
    p_leaves, p_rebuild = _leaves(stage_params)
    lp_leaves, lp_rebuild = _leaves(loss_params)
    with torch.enable_grad():
        ps = [leaf.detach().requires_grad_(True) for leaf in p_leaves]
        lps = [torch.as_tensor(leaf).detach().requires_grad_(True)
               for leaf in lp_leaves]
        xx = x.detach().requires_grad_(True)
        h, aux_total = apply_chunks(p_rebuild(ps), xx)
        lp = lp_rebuild(lps)
        loss = loss_fn(lp, h, targets) if targets is not None \
            else loss_fn(lp, h)
        objective = loss + aux_weight * aux_total
        grads = torch.autograd.grad(objective, ps + lps + [xx],
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, ps + lps + [xx])]
    out = {"stage_params": p_rebuild(grads[:len(ps)]),
           "loss_params": lp_rebuild(grads[len(ps):len(ps) + len(lps)]),
           "x": grads[-1]}
    loss = loss.detach()
    if has_aux:
        return (loss, aux_total.detach()), out
    return loss, out


class _Run(tp.NamedTuple):
    """One rank's share of a 1F1B run: its chunks' f32 gradients
    (`stage`, one list of leaves per local chunk), the loss parameters'
    f32 gradients (nonzero on the last stage), `x`'s gradient (on stage
    0; None elsewhere), the sums of its losses and aux scalars (f32), and
    in forward mode its outputs (on the last stage)."""
    stage: tp.Optional[tp.List[tp.List[torch.Tensor]]]
    loss_params: tp.Optional[tp.List[torch.Tensor]]
    x: tp.Optional[torch.Tensor]
    loss: torch.Tensor
    aux: torch.Tensor
    out: tp.Optional[torch.Tensor]


def _run_1f1b(stage_fn: tp.Callable, chunks: tp.Sequence[Tree],
              x_micro: tp.Sequence[torch.Tensor], loss_fn: tp.Optional[
                  tp.Callable], loss_params: Tree,
              targets_micro: tp.Optional[tp.Sequence[Tree]],
              hop: _Hop, schedule: PipelineSchedule, has_aux: bool,
              aux_weight: float) -> _Run:
    """This rank's 1F1B program: its column of the schedule's tables,
    tick by tick.

    Each tick starts the sends of the previous tick's outputs (the
    activation to the next stage where the next stage banks one this
    tick, the cotangent to the previous stage likewise) and the
    receives the tables bank this tick; at hop latency 1 it banks them
    before its compute (the steady state consumes same-tick arrivals),
    at hop latency 2 after it. The forward reads its input from the
    stash ring (or the microbatched input on chunk 0) and runs without
    a graph; the backward recomputes the chunk forward from the stashed
    input under `torch.enable_grad()`, seeds it from the arrived
    cotangent or, on the last chunk, from the loss (its gradient at
    1/M), and adds the chunk's parameter gradients into f32 sums in the
    order of the chunk's backward items, which the packed timeline keeps.
    """
    S, M = schedule.num_stages, schedule.num_micro
    train = schedule.mode == "train"
    bank_late = schedule.hop_latency > 1
    d = hop.stage
    nxt, prv = (d + 1) % S, (d - 1) % S
    tables = {name: np.asarray(table) for name, table in
              schedule.tables.items()}
    like = x_micro[0].detach()
    f32 = torch.float32
    act: tp.List[tp.Optional[torch.Tensor]] = [None] * schedule.stash_depth
    brx: tp.List[tp.Optional[torch.Tensor]] = [None] * schedule.brx_depth
    chunk_leaves = [_leaves(chunk) for chunk in chunks]
    lp_leaves, lp_rebuild = _leaves(loss_params if loss_params is not None
                                    else {})
    lp_leaves = [torch.as_tensor(leaf) for leaf in lp_leaves]
    gs = [[torch.zeros(leaf.shape, dtype=f32, device=leaf.device)
           for leaf in leaves] for leaves, _ in chunk_leaves] if train \
        else None
    glp = [torch.zeros(leaf.shape, dtype=f32, device=leaf.device)
           for leaf in lp_leaves] if train else None
    gx: tp.List[tp.Optional[torch.Tensor]] = [None] * M
    outs: tp.List[tp.Optional[torch.Tensor]] = [None] * M
    loss_sum = torch.zeros((), dtype=f32, device=like.device)
    aux_sum = torch.zeros((), dtype=f32, device=like.device)
    y_prev: tp.Optional[torch.Tensor] = None
    dx_prev: tp.Optional[torch.Tensor] = None
    sends: tp.List[distrib.Pending] = []

    def chunk_params(k: int, grad: bool) -> tp.Tuple[Tree, tp.List]:
        leaves, rebuild = chunk_leaves[k]
        held = [leaf.detach().requires_grad_(grad) for leaf in leaves]
        return rebuild(held), held

    for t in range(schedule.num_ticks):
        col = {name: int(table[t, d]) for name, table in tables.items()}
        # 1. the hops: this tick's sends are the previous tick's outputs
        if t and tables["rxf_do"][t, nxt]:
            sends.append(distrib.isend(y_prev, hop.next, hop.group, 2 * t))
        if train and t and tables["rxb_do"][t, prv]:
            sends.append(distrib.isend(dx_prev, hop.prev, hop.group,
                                       2 * t + 1))
        recv_f = distrib.irecv(like, hop.prev, hop.group, 2 * t) \
            if col["rxf_do"] else None
        recv_b = distrib.irecv(like, hop.next, hop.group, 2 * t + 1) \
            if train and col["rxb_do"] else None

        def bank() -> None:
            if recv_f is not None:
                act[col["rxf_slot"]] = recv_f.wait()
            if recv_b is not None:
                brx[col["rxb_slot"]] = recv_b.wait()

        if not bank_late:
            bank()
        y_prev = dx_prev = None
        # 2. forward: from the stash ring or the microbatched input
        if col["f_do"]:
            if col["f_from_x"]:
                x_f = x_micro[col["f_micro"]].detach()
                act[col["f_slot"]] = x_f
            else:
                x_f = act[col["f_slot"]]
            params, _ = chunk_params(col["f_chunk"], False)
            with torch.no_grad():
                if has_aux:
                    y, aux_f = stage_fn(params, x_f)
                    aux_sum = aux_sum + aux_f.float()
                else:
                    y = stage_fn(params, x_f)
            if not train and col["f_last"]:
                outs[col["f_micro"]] = y
            y_prev = y.contiguous()
        # 3. backward: recompute the chunk from its stashed input
        if train and col["b_do"]:
            m, k = col["b_micro"], col["b_chunk"]
            x_b = act[col["b_slot"]]
            with torch.enable_grad():
                params, held = chunk_params(k, True)
                x_b = x_b.detach().requires_grad_(True)
                if has_aux:
                    h_b, aux_b = stage_fn(params, x_b)
                else:
                    h_b, aux_b = stage_fn(params, x_b), None
                if col["b_last"]:
                    # the loss leg: its gradient at 1/M (the per-microbatch
                    # means average into the batch mean)
                    h_loss = h_b.detach().requires_grad_(True)
                    lps = [leaf.detach().requires_grad_(True)
                           for leaf in lp_leaves]
                    lp = lp_rebuild(lps)
                    loss_val = loss_fn(lp, h_loss, targets_micro[m]) \
                        if targets_micro is not None else loss_fn(lp, h_loss)
                    seed = torch.full((), 1.0 / M, dtype=loss_val.dtype,
                                      device=loss_val.device)
                    found = torch.autograd.grad(loss_val, lps + [h_loss],
                                                seed, allow_unused=True)
                    for acc, g in zip(glp, found[:-1]):
                        if g is not None:
                            acc.add_(g.float())
                    loss_sum = loss_sum + loss_val.detach().float()
                    dy = found[-1]
                else:
                    dy = brx[col["b_rx"]]
                outputs, seeds = [h_b], [dy.to(h_b.dtype)]
                if has_aux:
                    outputs.append(aux_b)
                    seeds.append(torch.full((), aux_weight / M,
                                            dtype=aux_b.dtype,
                                            device=aux_b.device))
                found = torch.autograd.grad(outputs, held + [x_b], seeds,
                                            allow_unused=True)
            for acc, g in zip(gs[k], found[:-1]):
                if g is not None:
                    acc.add_(g.float())
            dx = found[-1]
            if col["b_first"]:
                gx[m] = dx
            else:
                dx_prev = dx.contiguous()
        if bank_late:
            bank()
    for pending in sends:
        pending.wait()
    x_grad = None
    if train and d == 0:
        x_grad = torch.cat(gx)
    out = None
    if not train and d == S - 1:
        out = torch.cat(outs)
    return _Run(gs, glp, x_grad, loss_sum, aux_sum, out)


def _local_chunks(stage_params: Tree, full: bool, num_stages: int,
                  interleave: int, stage: int) -> tp.List[Tree]:
    """This rank's chunks, local index k = global chunk k*S + stage."""
    if full:
        return [_tree_map(lambda a, c=k * num_stages + stage: a[c],
                          stage_params) for k in range(interleave)]
    return [_tree_map(lambda a, k=k: a[k], stage_params)
            for k in range(interleave)]


def resolve_schedule(num_stages: int, num_micro: int, batch: int,
                     interleave: int, mode: str, packed: bool,
                     overlap: bool,
                     override: tp.Optional[PipelineSchedule] = None
                     ) -> PipelineSchedule:
    """Validate the (S, M, B, v) combination and build (or check an
    explicit) schedule; then the fault sites, on every rank before its
    first hop."""
    validate_pipeline_args(num_stages, num_micro, batch,
                           interleave=interleave,
                           require_fill=(mode == "train"),
                           schedule="packed_1f1b" if packed else "1f1b",
                           mode=mode)
    if override is not None:
        if (override.num_stages, override.num_micro, override.interleave,
                override.mode) != (num_stages, num_micro, interleave, mode):
            raise ValueError(
                f"_schedule override is for (S={num_stages}, M={num_micro}, "
                f"v={interleave}, mode={mode!r}); got (S="
                f"{override.num_stages}, M={override.num_micro}, "
                f"v={override.interleave}, mode={override.mode!r})")
        schedule = override
    else:
        schedule = build_1f1b_schedule(num_stages, num_micro, interleave,
                                       mode, packed=packed, overlap=overlap)
    # a fault here surfaces before any hop: never a hang inside the
    # schedule
    chaos.fault_point("pipeline.tick", mode=mode, ticks=schedule.num_ticks)
    if packed:
        chaos.fault_point("pipeline.packed_tick", mode=mode,
                          ticks=schedule.num_ticks, overlap=bool(overlap))
    return schedule


def run_local_1f1b(stage_fn: tp.Callable, stage_params: Tree,
                   x: torch.Tensor, *, loss_fn: tp.Optional[tp.Callable],
                   loss_params: Tree, targets: Tree, mesh: Mesh,
                   num_microbatches: int, interleave: int, has_aux: bool,
                   aux_weight: float, packed: bool, overlap: bool,
                   full: bool,
                   _schedule: tp.Optional[PipelineSchedule] = None
                   ) -> tp.Tuple[_Run, _Hop]:
    """`pipeline_1f1b`'s run on this rank (S > 1), before any reduction
    over the pipe ranks: the schedule (validated, the fault sites
    ticked), the microbatches and this rank's chunks, then `_run_1f1b`.
    Returns the rank's `_Run` and its ring; `pipelined_value_and_grad`
    reduces the LM's replicated leaves in one collective from it."""
    num_stages = mesh.shape["pipe"]
    mode = "forward" if loss_fn is None else "train"
    batch = x.shape[0]
    schedule = resolve_schedule(num_stages, num_microbatches, batch,
                                interleave, mode, packed, overlap, _schedule)
    hop = _Hop(mesh)
    x_micro = x.reshape(num_microbatches, batch // num_microbatches,
                        *x.shape[1:]).unbind(0)
    targets_micro = None
    if targets is not None:
        split = _tree_map(lambda t: t.reshape(
            num_microbatches, t.shape[0] // num_microbatches, *t.shape[1:]),
            targets)
        targets_micro = [_tree_map(lambda t, m=m: t[m], split)
                         for m in range(num_microbatches)]
    chunks = _local_chunks(stage_params, full, num_stages, interleave,
                           hop.stage)
    run = _run_1f1b(stage_fn, chunks, x_micro, loss_fn, loss_params,
                    targets_micro, hop, schedule, has_aux, aux_weight)
    return run, hop


def pipeline_1f1b(stage_fn: tp.Callable, stage_params: Tree,
                  x: torch.Tensor, *, loss_fn: tp.Optional[tp.Callable] = None,
                  loss_params: Tree = None, targets: Tree = None,
                  mesh: tp.Optional[Mesh] = None, axis: str = "pipe",
                  num_microbatches: tp.Optional[int] = None,
                  interleave: int = 1, has_aux: bool = False,
                  aux_weight: float = 0.0, packed: bool = False,
                  overlap: tp.Optional[bool] = None,
                  _schedule: tp.Optional[PipelineSchedule] = None) -> tp.Any:
    """Run a stage function under the 1F1B (PipeDream-flush) schedule.

    Each pipe rank walks its column of `schedules.build_1f1b_schedule`'s
    tables (see `_run_1f1b`): arrivals banked into a `[stash_depth]`
    ring, at most one forward and one backward a tick, the backward a
    recompute of the chunk forward from the stashed input, activations
    sent to the next stage and cotangents to the previous one.
    `interleave=v > 1` places chunks {d, d+S, ...} on stage d (the
    bubble falls to (S-1)/(v*M+S-1)).

    Args:
        stage_fn: `(chunk_params, activations) -> activations` (or `->
            (activations, aux_scalar)` with `has_aux=True`), the same
            shape, applied per chunk.
        stage_params: a tree with a leading `[num_stages*interleave]`
            chunk dim (chunk c holds layers `[c*L/C, (c+1)*L/C)`; each
            rank takes its chunks), or with a leading `[interleave]` dim
            of the rank's own chunks d, d+S, ... in order.
        x: the batch `[B, ...]`, the same on every pipe rank.
        loss_fn: `loss_params, final_activations[, targets] -> scalar`,
            mean-reduced over its microbatch; None selects the
            forward-only schedule.
        loss_params: the tree the loss closes over (e.g. the LM head).
        targets: an optional tree with a leading batch dim, microbatched
            alongside `x`.
        num_microbatches: M (>= num_stages; a multiple of num_stages when
            interleave > 1). Defaults to num_stages.
        aux_weight: the weight of the summed aux scalars in the objective
            `mean_m loss + aux_weight * mean_m (sum_c aux)`.
        packed: co-schedule the steady state's forward and backward into
            one tick (training only); gradients BIT-IDENTICAL to unpacked.
        overlap: the hop-latency-2 tables (packed, interleave=1 only): a
            tick starts the sends of the previous tick's outputs and waits
            for its receives after its compute. None: `default_overlap`
            (on for a CUDA mesh, off on the CPU).

    Returns, on every pipe rank: in forward mode the final activations
    (`(out, aux_total)` with `has_aux=True`); in training `(loss,
    grads)` (`((loss, aux), grads)` with `has_aux=True`, both
    per-microbatch means) with `grads = {'stage_params', 'loss_params',
    'x'}` accumulated in f32 and cast back to the parameters' dtypes:
    `stage_params` in the layout given (the whole [C, ...] stack summed
    over the ranks, or the rank's own [v, ...] chunks), the loss
    parameters' and `x`'s summed over the ranks.
    """
    mesh = mesh or default_mesh()
    num_stages = _check_axis(mesh, axis)
    num_chunks = num_stages * interleave
    mode = "forward" if loss_fn is None else "train"
    if packed and mode == "forward":
        raise ValueError(PACKED_FORWARD_ERROR)
    if overlap is None:
        overlap = default_overlap(packed, interleave, mesh, x.device)
    if overlap and not packed:
        raise ValueError("overlap=True double-buffers the PACKED ring; "
                         "pass packed=True as well (the unpacked 1F1B "
                         "tables stay at hop latency 1)")
    full = _check_chunk_params(stage_params, num_chunks, interleave,
                               num_stages)
    if num_stages == 1:
        return _single_stage_1f1b(stage_fn, stage_params, x, loss_fn,
                                  loss_params, targets, interleave, has_aux,
                                  aux_weight)
    num_micro = num_microbatches or num_stages
    run, hop = run_local_1f1b(stage_fn, stage_params, x, loss_fn=loss_fn,
                              loss_params=loss_params, targets=targets,
                              mesh=mesh, num_microbatches=num_micro,
                              interleave=interleave, has_aux=has_aux,
                              aux_weight=aux_weight, packed=packed,
                              overlap=overlap, full=full,
                              _schedule=_schedule)
    aux = distrib.all_reduce(run.aux, "sum", hop.group)
    if mode == "forward":
        like = x if run.out is None else run.out
        out = distrib.broadcast(like.contiguous(), hop.last_rank, hop.group)
        return (out, aux) if has_aux else out

    loss = distrib.all_reduce(run.loss, "sum", hop.group) / num_micro
    aux = aux / num_micro
    leaves, rebuild = _leaves(stage_params)
    if full:
        stacked = []
        for i, leaf in enumerate(leaves):
            total = torch.zeros(leaf.shape, dtype=torch.float32,
                                device=leaf.device)
            for k in range(interleave):
                total[k * num_stages + hop.stage] = run.stage[k][i]
            stacked.append(distrib.all_reduce(total, "sum", hop.group)
                           .to(leaf.dtype))
        grads_stage = rebuild(stacked)
    else:
        grads_stage = rebuild([torch.stack([run.stage[k][i] for k in
                                            range(interleave)]).to(leaf.dtype)
                               for i, leaf in enumerate(leaves)])
    lp_leaves, lp_rebuild = _leaves(loss_params if loss_params is not None
                                    else {})
    grads_lp = lp_rebuild([
        distrib.all_reduce(g, "sum", hop.group).to(torch.as_tensor(p).dtype)
        for g, p in zip(run.loss_params, lp_leaves)])
    gx = run.x if run.x is not None else torch.zeros_like(x)
    grad_x = distrib.all_reduce(gx.contiguous(), "sum", hop.group) \
        .to(x.dtype)
    grads = {"stage_params": grads_stage, "loss_params": grads_lp,
             "x": grad_x}
    if has_aux:
        return (loss, aux), grads
    return loss, grads


# ----------------------------------------------------------------------
# Measurement harness: `python -m flashy_tpu_torch.parallel.pipeline
# --workers=2` runs this over the processes, GPipe vs 1F1B vs interleaved
# vs packed 1F1B on a small (MoE) LM over the 'pipe' ranks. Gates (the
# reference's): 1F1B gradients allclose to the GPipe oracle (MoE aux
# included), packed gradients BIT-identical to unpacked at equal (S, M,
# v), packed step_ms strictly below unpacked, the stash ring flat in M
# while GPipe's residency grows, the interleaved bubble strictly below
# GPipe's at equal M, zero post-warm-up recompiles.
# ----------------------------------------------------------------------
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pipeline_leg(*, moe: bool, mesh: Mesh, pipe: int, steps: int,
                  num_micro: int, interleave: int, dim: int, num_layers: int,
                  num_heads: int, vocab_size: int, seq: int, batch: int,
                  watchdog: tp.Any, device: torch.device
                  ) -> tp.Dict[str, tp.Any]:
    """One model's schedule measurement: GPipe vs 1F1B vs interleaved vs
    packed grad steps on the seed-0 scan-stacked LM (every rank holds
    the whole stack and runs its chunks), timed over `steps` steps after
    a warm one, each held to the GPipe oracle's gradients."""
    import time

    from ..models.pipelined import pipelined_value_and_grad
    from ..models.transformer import TransformerConfig, TransformerLM
    from ..observability import get_telemetry
    from .schedules import (build_1f1b_schedule, dead_compute_stats,
                            gpipe_bubble_fraction, gpipe_stash_bytes,
                            schedule_stats)

    aux_weight = 0.01 if moe else 0.0
    cfg = TransformerConfig(
        vocab_size=vocab_size, dim=dim, num_layers=num_layers,
        num_heads=num_heads, attention="dense", scan_layers=True,
        moe_experts=4 if moe else 0, moe_top_k=2 if moe else 1,
        moe_capacity_factor=8.0)
    model = TransformerLM(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, vocab_size, (batch, seq)))
               .long().to(device) for _ in range(max(steps, 2))]
    mb_shape = (batch // num_micro, seq, dim)
    tag = "moe" if moe else "dense"
    legs = {
        "gpipe": dict(schedule="gpipe", interleave=1),
        "1f1b": dict(schedule="1f1b", interleave=1),
        f"1f1b-int{interleave}": dict(schedule="1f1b",
                                      interleave=interleave),
        "packed_1f1b": dict(schedule="packed_1f1b", interleave=1),
        f"packed_1f1b-int{interleave}": dict(schedule="packed_1f1b",
                                             interleave=interleave),
    }
    packed_pairs = {"packed_1f1b": "1f1b",
                    f"packed_1f1b-int{interleave}": f"1f1b-int{interleave}"}
    leg: tp.Dict[str, tp.Any] = {"moe": moe, "oracle": "gpipe",
                                 "schedules": {}}
    grads_by_leg: tp.Dict[str, tp.Dict[str, torch.Tensor]] = {}
    loss_by_leg: tp.Dict[str, float] = {}
    telemetry = get_telemetry()
    for name, spec in legs.items():
        packed = spec["schedule"] == "packed_1f1b"
        grad_fn = pipelined_value_and_grad(
            model, mesh=mesh, num_microbatches=num_micro,
            interleave=spec["interleave"], schedule=spec["schedule"],
            aux_weight=aux_weight)
        watch = f"pipeline:{tag}:{name}"
        if spec["schedule"] == "gpipe":
            stats = {
                "schedule": "gpipe", "num_stages": pipe,
                "num_micro": num_micro, "interleave": 1,
                "bubble_frac": round(gpipe_bubble_fraction(pipe, num_micro),
                                     6),
                "peak_stash_bytes": gpipe_stash_bytes(pipe, num_micro,
                                                      mb_shape),
            }
        else:
            overlap = default_overlap(packed, spec["interleave"], mesh,
                                      device)
            stats = schedule_stats(pipe, num_micro, spec["interleave"],
                                   packed=packed, overlap=overlap,
                                   microbatch_shape=mb_shape)
            stats["dead_compute_frac"] = round(dead_compute_stats(
                build_1f1b_schedule(pipe, num_micro, spec["interleave"],
                                    packed=packed, overlap=overlap)
            )["dead_frac"], 6)
        # the warm step (the port runs eagerly: one "compile" a leg)
        loss, grads = grad_fn(None, batches[0])
        watchdog.note_compile(watch)
        _sync(device)
        grads_by_leg[name] = {k: g.detach().float().cpu()
                              for k, g in grads.items()}
        loss_by_leg[name] = float(loss)
        distrib.barrier()
        begin = time.perf_counter()
        for index in range(steps):
            loss, grads = grad_fn(None, batches[index % len(batches)])
            watchdog.note_call(watch)
        _sync(device)
        stats["step_ms"] = round(
            (time.perf_counter() - begin) / steps * 1e3, 2)
        if name != "gpipe":
            ref = grads_by_leg["gpipe"]
            stats["grad_drift"] = max(
                float((g - ref[k]).abs().max() / (ref[k].abs().max() + 1e-8))
                for k, g in grads_by_leg[name].items())
            stats["loss_delta"] = abs(loss_by_leg[name]
                                      - loss_by_leg["gpipe"])
        if name in packed_pairs:
            twin = packed_pairs[name]
            stats["grads_bitwise_vs_unpacked"] = bool(
                loss_by_leg[name] == loss_by_leg[twin] and all(
                    torch.equal(g, grads_by_leg[twin][k])
                    for k, g in grads_by_leg[name].items()))
            stats["step_ms_vs_unpacked"] = round(
                stats["step_ms"]
                / max(leg["schedules"][twin]["step_ms"], 1e-9), 4)
        if telemetry is not None and "idle_ticks_per_device" in stats:
            telemetry.counter("pipeline/bubble",
                              idle_ticks_per_device=float(
                                  stats["idle_ticks_per_device"]),
                              bubble_frac=float(stats["bubble_frac"]))
            telemetry.record({"type": "pipeline_schedule", "leg": tag,
                              **{k: v for k, v in stats.items()
                                 if not isinstance(v, dict)}})
        leg["schedules"][name] = stats

    # tick_efficiency: realized step_ms over the schedule-theoretic tick
    # bound, the per-tick cost calibrated on the unpacked 1f1b leg at the
    # same interleave (GPipe's backward runs the same 2(M+S-1) ticks)
    per_tick_ms = {}
    for name, stats in leg["schedules"].items():
        if name.startswith("1f1b") and stats.get("step_ms") \
                and stats.get("num_ticks"):
            per_tick_ms[stats["interleave"]] = (stats["step_ms"]
                                                / stats["num_ticks"])
    for name, stats in leg["schedules"].items():
        ticks = stats.get("num_ticks") or (
            2 * (num_micro + pipe - 1) if name == "gpipe" else None)
        cal = per_tick_ms.get(stats.get("interleave"))
        if ticks and cal and stats.get("step_ms"):
            stats["tick_efficiency"] = round(
                stats["step_ms"] / (ticks * cal), 4)
    return leg


def tensor_compose(device: tp.Any = None) -> tp.Dict[str, tp.Any]:
    """The tensor x pipe composition probe (four processes): the same
    1F1B schedule with the stage weight ALSO column-split over 'tensor'
    (pipe 2 x tensor 2, through `parallel.tensor`'s `copy_to_tensor` and
    `reduce_from_tensor`) against the pipe-only run (pipe 2 x data 2):
    `ok` when the losses are equal and the gathered gradients within
    1e-6."""
    import torch.nn.functional as F

    from ..utils import resolve_device
    from .mesh import make_mesh
    from .tensor import copy_to_tensor, reduce_from_tensor

    device = resolve_device(device)
    w = 0.1 * torch.randn((2, 16, 16), generator=torch.Generator()
                          .manual_seed(0)).to(device)
    x = torch.ones((4, 16), device=device)

    def loss_fn(lp, h):
        return (h ** 2).mean()

    base_mesh = make_mesh({"pipe": 2, "data": -1})
    base_loss, base_grads = pipeline_1f1b(
        lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x, loss_fn=loss_fn,
        mesh=base_mesh, num_microbatches=2)
    tmesh = make_mesh({"pipe": 2, "tensor": 2, "data": -1})
    cols = w.shape[-1] // 2
    start = tmesh.coord("tensor") * cols

    def tp_stage(p, h):
        # column-parallel: this rank's columns, placed and summed over
        # 'tensor' into the full activation
        part = copy_to_tensor(h, tmesh) @ p["w"]
        placed = F.pad(part, (start, w.shape[-1] - start - cols))
        return torch.tanh(reduce_from_tensor(placed, tmesh))

    tp_loss, tp_grads = pipeline_1f1b(
        tp_stage, {"w": w[..., start:start + cols].contiguous()}, x,
        loss_fn=loss_fn, mesh=tmesh, num_microbatches=2)
    gathered = distrib.all_gather(
        tp_grads["stage_params"]["w"].contiguous().reshape(-1),
        tmesh.group("tensor")).view(2, *tp_grads["stage_params"]["w"].shape)
    tp_w = torch.cat(list(gathered.unbind(0)), dim=-1)
    pairs = [(tp_w, base_grads["stage_params"]["w"]),
             (tp_grads["x"], base_grads["x"])]
    grad_delta = max(float((a - b).abs().max()) for a, b in pairs)
    return {"ok": bool(float(tp_loss) == float(base_loss)
                       and grad_delta < 1e-6),
            "loss_delta": abs(float(tp_loss) - float(base_loss)),
            "grad_delta": grad_delta}


def run_pipeline_bench(steps: int = 3, *, num_micro: int = 8,
                       interleave: int = 2, dim: int = 48,
                       num_layers: int = 8, num_heads: int = 4,
                       vocab_size: int = 128, seq: int = 24,
                       batch: int = 16, moe: bool = True,
                       pipe: tp.Optional[int] = None, device: tp.Any = None
                       ) -> tp.Dict[str, tp.Any]:
    """Measure the five pipeline schedules on dense and MoE LMs over the
    processes (`distrib.init()` first; pipe 4 when the world divides by
    4, else 2; the rest of the world on 'data').

    Returns per-schedule ``bubble_frac``, ``peak_stash_bytes``,
    ``step_ms``, ``grad_drift`` (vs the GPipe oracle; MoE aux in the
    objective on the ``moe`` leg), ``dead_compute_frac`` (the
    reference's FLOP-priced lane accounting of the tables) and
    ``tick_efficiency``, plus ``grads_bitwise_vs_unpacked`` /
    ``step_ms_vs_unpacked`` on the packed legs, ``recompiles`` (0: the
    port runs eagerly), the stash-flatness probe and, at a world size
    divisible by 4, ``tensor_compose``."""
    from ..observability import RecompileWatchdog
    from ..utils import resolve_device
    from .mesh import make_mesh
    from .schedules import gpipe_stash_bytes, schedule_stats

    device = resolve_device(device)
    world = distrib.world_size()
    pipe = pipe or (4 if world % 4 == 0 else 2)
    if world % pipe:
        raise ValueError(
            f"pipeline bench needs a process count divisible by pipe={pipe} "
            f"(got {world}); run it with --workers={pipe}.")
    mesh = make_mesh({"pipe": pipe, "data": -1})
    watchdog = RecompileWatchdog(warmup=1)
    common = dict(mesh=mesh, pipe=pipe, steps=steps, num_micro=num_micro,
                  interleave=interleave, dim=dim, num_layers=num_layers,
                  num_heads=num_heads, vocab_size=vocab_size, seq=seq,
                  batch=batch, watchdog=watchdog, device=device)
    mb_shape = (batch // num_micro, seq, dim)
    result: tp.Dict[str, tp.Any] = {
        "n_devices": world, "pipe": pipe, "num_micro": num_micro,
        "interleave": interleave, "batch": batch, "seq": seq,
        "dense": _pipeline_leg(moe=False, **common),
    }
    if moe:
        result["moe"] = _pipeline_leg(moe=True, **common)
    stash_m = schedule_stats(pipe, num_micro, 1, microbatch_shape=mb_shape)
    stash_2m = schedule_stats(pipe, 2 * num_micro, 1,
                              microbatch_shape=mb_shape)
    result["stash_bytes_at_m"] = stash_m["peak_stash_bytes"]
    result["stash_bytes_at_2m"] = stash_2m["peak_stash_bytes"]
    result["gpipe_stash_bytes_at_m"] = gpipe_stash_bytes(
        pipe, num_micro, mb_shape)
    result["gpipe_stash_bytes_at_2m"] = gpipe_stash_bytes(
        pipe, 2 * num_micro, mb_shape)
    result["stash_flat_in_m"] = (result["stash_bytes_at_2m"]
                                 == result["stash_bytes_at_m"])
    if world % 4 == 0:
        result["tensor_compose"] = tensor_compose(device)
    result["recompiles"] = sum(watchdog.summary().values())
    return result


def bench_problems(result: tp.Dict[str, tp.Any], *,
                   timing: bool = True) -> tp.List[str]:
    """The reference's gates on a `run_pipeline_bench` record (with
    `timing=False` all but packed's step_ms against unpacked)."""
    problems = []
    if result["recompiles"]:
        problems.append(f"{result['recompiles']} post-warm-up recompiles")
    for tag in ("dense", "moe"):
        leg = result.get(tag)
        if leg is None:
            continue
        gpipe = leg["schedules"]["gpipe"]
        for name, stats in leg["schedules"].items():
            if name == "gpipe":
                continue
            if stats["grad_drift"] > 1e-2:
                problems.append(
                    f"{tag}/{name} gradients drifted "
                    f"{stats['grad_drift']:.2e} from the "
                    f"{leg['oracle']} oracle")
            if not name.startswith("packed") and \
                    stats["interleave"] >= 2 and \
                    stats["bubble_frac"] >= gpipe["bubble_frac"]:
                problems.append(
                    f"{tag}/{name} bubble {stats['bubble_frac']} did not "
                    f"improve on GPipe's {gpipe['bubble_frac']} at equal M")
            if name.startswith("packed"):
                twin = leg["schedules"].get(name.replace("packed_", ""))
                if twin and not (stats.get("dead_compute_frac", 1.0)
                                 < twin.get("dead_compute_frac", 0.0)):
                    problems.append(
                        f"{tag}/{name} dead-compute fraction "
                        f"{stats.get('dead_compute_frac')} is not below "
                        f"the unpacked schedule's "
                        f"{twin.get('dead_compute_frac')}")
                if not stats.get("grads_bitwise_vs_unpacked"):
                    problems.append(
                        f"{tag}/{name} gradients are not bit-identical "
                        f"to the unpacked schedule at equal (S, M, v)")
                if timing and not stats.get("step_ms_vs_unpacked", 2.0) < 1.0:
                    problems.append(
                        f"{tag}/{name} realized step_ms did not beat the "
                        f"unpacked schedule: ratio "
                        f"{stats.get('step_ms_vs_unpacked')}")
                if "tick_efficiency" not in stats:
                    problems.append(
                        f"{tag}/{name} tick_efficiency missing (bench "
                        f"bookkeeping bug)")
    if not result["stash_flat_in_m"]:
        problems.append(
            f"1F1B stash grew with M: {result['stash_bytes_at_m']} -> "
            f"{result['stash_bytes_at_2m']} bytes (expected flat)")
    if result["gpipe_stash_bytes_at_2m"] <= result["gpipe_stash_bytes_at_m"]:
        problems.append("GPipe residency bound failed to grow with M "
                        "(bench bookkeeping bug)")
    if not result.get("bubble_track_recorded", True):
        problems.append("pipeline/bubble counter track missing from "
                        "telemetry.jsonl")
    compose = result.get("tensor_compose")
    if compose is not None and not compose["ok"]:
        problems.append(
            f"tensor x pipe composition diverged from the pipe-only "
            f"run: loss delta {compose['loss_delta']:.2e}, grad delta "
            f"{compose['grad_delta']:.2e}")
    return problems


def campaign_run(device: tp.Any = None) -> tp.Dict[str, tp.Any]:
    """The campaign's `pipeline` workload (the reference scenario's): a
    tanh stage over two ranks, weights 0.1, x ones [4, 4], 2
    microbatches, loss mean(h^2), unpacked then packed. Returns, by
    'unpacked' / 'packed', the loss and the gradients as nested lists
    (floats that round-trip exactly through JSON)."""
    from ..utils import resolve_device
    from .mesh import make_mesh

    device = resolve_device(device)
    mesh = make_mesh({"pipe": 2, "data": -1})
    w = torch.full((2, 4, 4), 0.1, device=device)
    x = torch.ones((4, 4), device=device)
    out = {}
    for packed in (False, True):
        loss, grads = pipeline_1f1b(
            lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
            loss_fn=lambda lp, h: (h ** 2).mean(), mesh=mesh,
            num_microbatches=2, packed=packed, overlap=False)
        out["packed" if packed else "unpacked"] = {
            "loss": float(loss),
            "grads": [grads["stage_params"]["w"].cpu().tolist(),
                      grads["x"].cpu().tolist()]}
    return out


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    """`python -m flashy_tpu_torch.parallel.pipeline [--workers N]
    [--steps N] ...`: run the five-schedule measurement over N processes
    (gloo ranks on the host with `--device cpu`) and print rank 0's JSON
    line (and write it to `--json`); exit 1 when the 1F1B gradients
    drift from the GPipe oracle, the packed gradients are not
    bit-identical to unpacked 1F1B at equal (S, M, v), packed realized
    step_ms is not strictly below unpacked, the stash ring grows with M,
    the interleaved bubble does not beat GPipe at equal M, the
    `pipeline/bubble` track is missing or any post-warm-up recompile was
    reported. `--faults PLAN` arms a campaign fault plan in every rank;
    `--campaign` runs the campaign's small workload instead of the bench.
    On a card the ranks run with deterministic algorithms (the
    embedding's scatter-add is otherwise unordered, and the packed gate
    is bitwise)."""
    import argparse
    import json
    import os
    import sys
    import tempfile

    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.parallel.pipeline",
        description="GPipe vs 1F1B vs interleaved-1F1B schedule bench.")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--micro", type=int, default=8,
                        help="microbatches per step (M)")
    parser.add_argument("--interleave", type=int, default=2)
    parser.add_argument("--seq", type=int, default=24)
    parser.add_argument("--no-moe", action="store_true",
                        help="drop the MoE blocks (pure dense LM)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--workers", type=int, default=1,
                        help="processes to run the pipeline over")
    parser.add_argument("--json", default=None,
                        help="also write rank 0's record to this file")
    parser.add_argument("--faults", default=None,
                        help="a JSON fault plan armed in every rank")
    parser.add_argument("--campaign", action="store_true",
                        help="run the campaign's pipeline workload")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.workers > 1 and "FLASHY_TPU_PROCESS_ID" not in os.environ:
        import subprocess
        from ..xp import _spawn_workers
        try:
            _spawn_workers(args.workers, argv)
        except subprocess.CalledProcessError as exc:
            print(f"pipeline bench FAILED: {exc}", file=sys.stderr)
            return 1
        return 0
    if args.device != "cpu":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    distrib.init(backend="gloo" if args.device == "cpu" else None)
    injector = None
    if args.faults:
        from .tensor import _arm_fault_plan
        injector = _arm_fault_plan(args.faults)
    from ..observability import disable_telemetry, enable_telemetry
    try:
        if args.campaign:
            result = campaign_run(args.device)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                telemetry = enable_telemetry(folder=tmp)
                try:
                    result = run_pipeline_bench(
                        steps=args.steps, num_micro=args.micro,
                        interleave=args.interleave, seq=args.seq,
                        moe=not args.no_moe, device=args.device)
                    trace = telemetry.export().read_text()
                    path = telemetry.tracer.jsonl_path
                    jsonl = path.read_text() if path.exists() else ""
                    result["bubble_track_recorded"] = (
                        "pipeline/bubble" in trace
                        and "pipeline_schedule" in jsonl)
                finally:
                    disable_telemetry()
    finally:
        if injector is not None:
            chaos.uninstall(verify=False)
    if injector is not None:
        result["faults"] = {"counts": dict(injector.counts),
                            "fired": [rule.fired_count
                                      for rule in injector._rules]}
    problems = [] if args.campaign else bench_problems(result)
    if distrib.is_rank_zero():
        print(json.dumps(result), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(result, f)
        for problem in problems:
            print(f"pipeline bench FAILED: {problem}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
