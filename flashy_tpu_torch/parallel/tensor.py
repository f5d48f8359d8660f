"""Megatron tensor parallelism over the 'tensor' axis: the port of
flashy_tpu/parallel/tensor.py.

The QKV, SSD `cbv` and MLP up-projections are split by column (each
tensor rank computes its heads or its slice of the hidden width, no
collective), the attention-out, SSD-out and MLP down-projections by row
(each rank holds partial sums), and one all-reduce over 'tensor' follows
each mixer and each MLP. The JAX package declares the layout and pins
it at the layer boundaries (`models.transformer._tp_boundary`), and
XLA's partitioner inserts that pair; the port's tensor ranks are
processes, so the layers call it themselves: `copy_to_tensor` (the
identity forward, an all-reduce of the gradient backward) before each
column-split product and `reduce_from_tensor` (an all-reduce forward,
the identity backward) after each row-split one. The embedding is
vocab-parallel (each rank holds `V / T` rows: a lookup masks the others
and all-reduces) and so is the tied head's loss
(`vocab_parallel_cross_entropy` over the rank's `[..., V / T]` logits:
the max, then the sum of exponentials and the target's logit,
all-reduced; the full logits are never gathered). An MoE block's experts
split by their hidden width the same way (`models.moe`), and the pair
also runs over the 'expert' axis (`axis='expert'`), where each expert
rank computes its own experts' assignments. Every all-reduce runs
in f32 through `distrib`'s counted collectives (gloo sums bf16 partial
sums as f32; the reference sums them in bf16).

`tensor_state_sharding` composes the Megatron parameter specs
(`transformer_shardings`) with a ZeRO-1 update shard over the data axis
through `axis_leaf_sharding(..., base=)`; `parallel.wrap(model,
mesh=..., state_sharding=...)` cuts the model over 'tensor' and shards
the update, or with `fsdp=True` the parameters, over the data-parallel
processes. `python -m flashy_tpu_torch.parallel.tensor --workers=N`
measures tensor widths {1, 2, 4} over N processes (`run_tp_bench`).
"""
import typing as tp

import numpy as np
import torch

from .. import distrib
from .data_parallel import axis_leaf_sharding
from .mesh import Mesh, default_mesh
from .sharding import NamedSharding
from .zero import _is_update_key, describe_state_sharding, per_device_bytes


def _divisor_hint(value: int) -> tp.List[int]:
    divisors = [d for d in range(1, value + 1) if value % d == 0]
    return divisors[:min(len(divisors), 6)]


def validate_tensor_args(num_heads: int, mlp_hidden: int, tensor: int, *,
                         num_devices: tp.Optional[int] = None) -> None:
    """Validate a (heads, hidden, tensor-width) combination with
    actionable messages, as the reference does.

    Column-parallel layers split the head axis (attention) and the MLP
    hidden axis over the tensor axis, so both must divide; a width that
    does not divide the device (process) count cannot be a mesh axis."""
    if tensor < 1:
        raise ValueError(f"tensor width must be >= 1, got {tensor}")
    if num_heads % tensor:
        raise ValueError(
            f"tensor width {tensor} does not divide num_heads="
            f"{num_heads}: column-parallel attention gives each chip "
            f"num_heads/tensor whole heads. Pick tensor from the "
            f"divisors of num_heads (e.g. {_divisor_hint(num_heads)}) "
            f"or pad the head count.")
    if mlp_hidden % tensor:
        raise ValueError(
            f"tensor width {tensor} does not divide the MLP hidden size "
            f"{mlp_hidden}: the column-split up-projection gives each "
            f"chip hidden/tensor columns. Pick tensor from the divisors "
            f"of the hidden size (e.g. {_divisor_hint(mlp_hidden)}) or "
            f"round the hidden size up.")
    if num_devices is not None and num_devices % tensor:
        raise ValueError(
            f"tensor width {tensor} does not divide the device count "
            f"{num_devices}; the mesh factors devices as "
            f"tensor x data, so pick tensor from the divisors of the "
            f"device count (e.g. {_divisor_hint(num_devices)}).")


def tensor_state_sharding(state: tp.Any, mesh: tp.Optional[Mesh] = None, *,
                          zero_axis: str = "data",
                          min_size: int = 2 ** 12) -> tp.Any:
    """NamedShardings for a whole `{'params', 'opt_state'}` train state
    under Megatron tensor parallelism, composed with a ZeRO-1 update
    shard.

    Parameter leaves get the `transformer_shardings` column/row specs
    verbatim (matched on the leaf's path, '.'-joined names read as
    '/'-joined, so `model_state(model)`'s names and the moments' paths
    below them both match). Update-state leaves (a key on the path
    naming optimizer state, `zero.UPDATE_KEY_MARKERS`) start from the
    same spec and are also sharded over `zero_axis` on the largest free
    divisible dim through `axis_leaf_sharding(..., base=...)`, riding
    along the split dim as `('tensor', zero_axis)` where every dim is
    claimed; scalar leaves stay replicated. On a (data=D, tensor=T) mesh
    the optimizer state lands at ~1/(D*T) of its replicated footprint a
    process. Consumable as `wrap(model, mesh=mesh,
    state_sharding=tensor_state_sharding(model_state(model), mesh))`.
    """
    from ..models.transformer import transformer_spec

    mesh = mesh or default_mesh()

    def for_leaf(path: tp.Tuple, leaf: tp.Any) -> NamedSharding:
        joined = "/".join(str(key).replace(".", "/") for key in path)
        spec = transformer_spec(joined)
        if not any(_is_update_key(str(key)) for key in path):
            return NamedSharding(mesh, spec)
        rule = axis_leaf_sharding(mesh, zero_axis, min_size,
                                  base=lambda _: spec)
        return rule(leaf)

    return _map_paths(for_leaf, state)


def _map_paths(fn: tp.Callable, tree: tp.Any,
               path: tp.Tuple[tp.Any, ...] = ()) -> tp.Any:
    """`fn(path, leaf)` over the leaves of dicts, lists and tuples."""
    if isinstance(tree, tp.Mapping):
        return type(tree)((key, _map_paths(fn, value, path + (key,)))
                          for key, value in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_paths(fn, value, path + (index,))
                          for index, value in enumerate(tree))
    return fn(path, tree)


# ----------------------------------------------------------------------
# the Megatron pair and the vocab-parallel embedding and loss
# ----------------------------------------------------------------------
def tensor_width(mesh: tp.Optional[Mesh]) -> int:
    """The mesh's 'tensor' size (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape["tensor"])


def _all_reduce_tensor(x: torch.Tensor, mesh: Mesh, op: str = "sum",
                       axis: str = "tensor") -> torch.Tensor:
    """`x` reduced over the mesh's `axis` group ('tensor' by default), in
    f32 (bf16 and f16 partial sums travel widened), returned in x's
    dtype."""
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    out = distrib.all_reduce(wide.contiguous(), op, mesh.group(axis))
    return out.to(x.dtype)


class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, mesh: Mesh,
                axis: str) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        return _all_reduce_tensor(grad, ctx.mesh, axis=ctx.axis), None, None


class _ReduceFromTensor(torch.autograd.Function):
    """All-reduce over the axis forward; the identity backward."""

    @staticmethod
    def forward(ctx: tp.Any, x: torch.Tensor, mesh: Mesh,
                axis: str) -> torch.Tensor:
        return _all_reduce_tensor(x, mesh, axis=axis)

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        return grad, None, None


def _width(mesh: tp.Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else int(mesh.shape[axis])


def copy_to_tensor(x: torch.Tensor, mesh: tp.Optional[Mesh],
                   axis: str = "tensor") -> torch.Tensor:
    """`x` entering a column-split product: the identity, whose backward
    sums the tensor ranks' partial gradients (one all-reduce). The
    identity both ways at tensor width 1. `axis='expert'` is the same
    pair's entry over the expert ranks of an MoE layer whose ranks each
    compute their own experts' assignments (`models.moe`)."""
    if _width(mesh, axis) == 1:
        return x
    return _CopyToTensor.apply(x, mesh, axis)


def reduce_from_tensor(x: torch.Tensor, mesh: tp.Optional[Mesh],
                       axis: str = "tensor") -> torch.Tensor:
    """A row-split product's partial sums `x` summed over the tensor
    ranks (one all-reduce); the backward passes the gradient through.
    The identity both ways at tensor width 1 (`axis`: as
    `copy_to_tensor`)."""
    if _width(mesh, axis) == 1:
        return x
    return _ReduceFromTensor.apply(x, mesh, axis)


def layer_mesh(mesh: tp.Optional[Mesh], local: int, full: int,
               what: str) -> tp.Optional[Mesh]:
    """The mesh a layer runs its Megatron collectives over: `mesh` when
    the layer holds a 'tensor' slice (`local` of `full` heads or hidden
    columns), None when it holds the whole width (an unwrapped model, or
    one whose full parameters are summoned). A slice that the mesh's
    'tensor' width does not explain raises."""
    if local == full:
        return None
    if local * tensor_width(mesh) != full:
        raise ValueError(
            f"{what}: the layer holds {local} of {full}, which a mesh with "
            f"tensor={tensor_width(mesh)} does not give; build the model "
            f"with the mesh it is wrapped over")
    return mesh


def vocab_parallel_embedding(tokens: torch.Tensor, embed: torch.Tensor,
                             mesh: Mesh) -> torch.Tensor:
    """The rows of `tokens` from a vocab-parallel table: `embed` holds
    this rank's `V / T` rows (rank t's rows start at `t * V / T`); a
    token outside them looks up zeros, and the all-reduce over 'tensor'
    adds the one rank's row (exact: the others add zeros). Gradients
    reach only the rank's own rows."""
    rows = embed.shape[0]
    start = mesh.coord("tensor") * rows
    local = tokens.long() - start
    inside = (local >= 0) & (local < rows)
    picked = embed[local.clamp(0, rows - 1)]
    picked = torch.where(inside[..., None], picked,
                         torch.zeros((), dtype=picked.dtype,
                                     device=picked.device))
    return reduce_from_tensor(picked, mesh)


def _vocab_stats(logits: torch.Tensor, labels: torch.Tensor,
                 mesh: Mesh) -> tp.Tuple[torch.Tensor, ...]:
    """(row max, log of the sum of exponentials past it, target logit
    past it) over the whole vocabulary, of f32 `logits` [N, V/T] (this
    rank's columns) and `labels` [N]: the row max all-reduced (max),
    then the sums of exponentials and the target's shifted logit (only
    its owner holds it) in one all-reduce (sum). `F.cross_entropy`'s
    terms: the loss is `log_sums - target`."""
    cols = logits.shape[-1]
    top = _all_reduce_tensor(logits.max(dim=-1).values, mesh, "max")
    shifted = logits - top[:, None]
    local = labels.long() - mesh.coord("tensor") * cols
    inside = (local >= 0) & (local < cols)
    target = torch.gather(shifted, -1, local.clamp(0, cols - 1)[:, None])
    target = torch.where(inside, target[:, 0], torch.zeros_like(top))
    sums = torch.exp(shifted).sum(dim=-1)
    sums, target = _all_reduce_tensor(torch.stack([sums, target]),
                                      mesh).unbind(0)
    return top, torch.log(sums), target


def _onehot_local(labels: torch.Tensor, cols: int, mesh: Mesh,
                  dtype: torch.dtype) -> torch.Tensor:
    """One-hot rows of `labels` over this rank's `cols` vocabulary
    columns (all zeros for a label another rank owns)."""
    local = labels.long() - mesh.coord("tensor") * cols
    inside = (local >= 0) & (local < cols)
    onehot = torch.nn.functional.one_hot(local.clamp(0, cols - 1), cols)
    return (onehot * inside[..., None]).to(dtype)


class _VocabParallelCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx: tp.Any, logits: torch.Tensor, labels: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
        top, log_sums, target = _vocab_stats(logits, labels, mesh)
        ctx.save_for_backward(logits, labels, top, log_sums)
        ctx.mesh = mesh
        return log_sums - target

    @staticmethod
    def backward(ctx: tp.Any, grad: torch.Tensor) -> tp.Any:
        logits, labels, top, log_sums = ctx.saved_tensors
        # d(lse - target)/dlogits = softmax - onehot, this rank's columns
        dlogits = torch.exp(logits - top[:, None] - log_sums[:, None])
        dlogits -= _onehot_local(labels, logits.shape[-1], ctx.mesh,
                                 dlogits.dtype)
        return dlogits * grad[:, None], None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mesh: tp.Optional[Mesh]) -> torch.Tensor:
    """Per-token cross entropy [...] of this rank's f32 logits [..., V/T]
    (the tied head's columns of a vocab-parallel embedding) against
    `labels` [...] over the whole vocabulary: `logsumexp - logit[label]`,
    the statistics all-reduced over 'tensor' (two all-reduces), the full
    logits never gathered. The backward is the rank's columns of `softmax
    - onehot` (no collective: the head's `copy_to_tensor` sums the
    hidden states' gradient). At tensor width 1 it is
    `F.cross_entropy(..., reduction='none')`."""
    if tensor_width(mesh) == 1:
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            labels.reshape(-1).long(), reduction="none").view(labels.shape)
    flat = logits.reshape(-1, logits.shape[-1]).float()
    out = _VocabParallelCrossEntropy.apply(flat, labels.reshape(-1), mesh)
    return out.view(labels.shape)


# ----------------------------------------------------------------------
# the fused against split flash backward gate
# ----------------------------------------------------------------------
def flash_bwd_parity(*, device: tp.Any = None,
                     dtype: torch.dtype = torch.float32) -> float:
    """Max |fused - split| over dq/dk/dv of one small flash-attention
    gradient ([2, 128, 2, 64], causal, seed 7): the bit-level oracle gate
    (0.0 means bit-identical). On the card the fused one-pass backward
    and the split dQ / dK,dV kernels (in f32 `flash_general.cu`); on the
    CPU their plain versions."""
    from ..ops.attention import flash_attention
    from ..utils import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(7)
    shape = (2, 128, 2, 64)  # [batch, time, heads, head_dim]
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device) for _ in range(3))

    def grads(fused: bool) -> tp.Tuple[torch.Tensor, ...]:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True, fused_backward=fused)
        (out.float() ** 2).sum().backward()
        return tuple(t.grad for t in leaves)

    fused, split = grads(True), grads(False)
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(fused, split))


# ---------------------------------------------------------------------------
# Measurement harness: `python -m flashy_tpu_torch.parallel.tensor` runs
# this over the processes: step time, achieved TFLOP/s and per-rank
# optimizer bytes at tensor widths {1, 2, 4} on one small LM, gradients
# held to a replicated one-process oracle.
# ---------------------------------------------------------------------------
def run_tp_bench(steps: int = 3, *, dim: int = 128, num_layers: int = 2,
                 num_heads: int = 4, vocab_size: int = 512,
                 batch: tp.Optional[int] = None, seq: int = 64,
                 widths: tp.Optional[tp.Sequence[int]] = None,
                 min_size: int = 2 ** 10, device: tp.Any = None
                 ) -> tp.Dict[str, tp.Any]:
    """Measure tensor-parallel training at several tensor widths over
    the processes (`distrib.init()` first; one process runs width 1).

    Each width that divides the world runs in the same start-up, on a
    (data = world / width, tensor = width) mesh: the seed-0 f32 dense
    model wrapped under `tensor_state_sharding` (tensor+zero1; zero1
    over data at width 1), each data-parallel process on its rows of the
    global batch, AdamW (lr 1e-3, optax.adamw's defaults). The first
    step's gradients, gathered to full shapes, are held to a replicated
    one-process oracle on the whole batch; then `steps` timed steps, each
    after the `tensor.step` fault site. Returns ``step_ms`` (the timed
    steps' mean), ``tflops_per_chip``, ``opt_state_bytes_per_chip``
    (rank 0's), ``sharding``, ``collectives`` (`collective_stats` of the
    last timed step) and ``loss_trajectory`` keyed by width (str),
    ``grads_max_delta`` by width and overall, ``opt_bytes_ratio`` (the
    widest width's optimizer bytes over the replicated footprint),
    ``flash_bwd_parity`` with the flash kernels it launched
    (``flash_bwd_parity_launches``) and ``recompiles`` (the watchdog's
    rebuilds past warm-up: 0, the port's steps run eagerly)."""
    import time

    from ..models.transformer import TransformerConfig, TransformerLM
    from ..observability import RecompileWatchdog
    from ..resilience import chaos
    from ..utils import resolve_device
    from .accounting import collective_stats, count_collectives
    from .data_parallel import wrap
    from .mesh import DATA_PARALLEL_AXES, make_mesh
    from .zero import model_state

    device = resolve_device(device)
    cuda = device.type == "cuda"
    world = distrib.world_size()
    if batch is None:
        batch = max(8, 2 * world)
    if batch % world:
        batch += world - batch % world
    mlp_hidden = dim * 4
    if widths is None:
        widths = [w for w in (1, 2, 4)
                  if world % w == 0 and num_heads % w == 0
                  and mlp_hidden % w == 0]
    for width in widths:
        validate_tensor_args(num_heads, mlp_hidden, width,
                             num_devices=world)

    cfg = TransformerConfig(vocab_size=vocab_size, dim=dim,
                            num_layers=num_layers, num_heads=num_heads,
                            attention="dense", dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens_host = torch.from_numpy(
        rng.integers(0, vocab_size, (batch, seq))).long()

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    def optimizer_for(params: tp.Iterable[torch.Tensor]
                      ) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    def loss_fn(model: tp.Callable, tokens: torch.Tensor,
                mesh: tp.Optional[Mesh]) -> torch.Tensor:
        logits = model(tokens)
        return vocab_parallel_cross_entropy(logits[:, :-1], tokens[:, 1:],
                                            mesh).mean()

    # the replicated one-process oracle: the same weights, the whole batch
    oracle = TransformerLM(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in oracle.parameters())
    # the standard 6ND training-FLOPs estimate (fwd matmuls + 2x bwd)
    step_flops = 6.0 * n_params * batch * seq
    loss_fn(oracle, tokens_host.to(device), None).backward()
    oracle_grads = {name: p.grad.detach().clone()
                    for name, p in oracle.named_parameters()}
    replicated = optimizer_for(oracle.parameters())
    replicated.step()
    replicated_opt_bytes = per_device_bytes(replicated.state_dict()["state"])
    del oracle, replicated

    watchdog = RecompileWatchdog(warmup=1)
    result: tp.Dict[str, tp.Any] = {
        "n_devices": world, "batch": batch, "seq": seq,
        "n_params": n_params, "widths": [int(w) for w in widths],
        "step_ms": {}, "tflops_per_chip": {},
        "opt_state_bytes_per_chip": {}, "sharding": {}, "collectives": {},
        "loss_trajectory": {}, "grads_max_delta": {},
    }
    wrapped_models = []
    for width in widths:
        key = str(int(width))
        mesh = make_mesh({"tensor": width, "data": world // width})
        tp_mesh = mesh if width > 1 else None
        model = TransformerLM(cfg, device=device, seed=0, mesh=mesh)
        spec = tensor_state_sharding(model_state(model), mesh,
                                     min_size=min_size)
        wrapped = wrap(model, mesh=mesh, state_sharding=spec)
        wrapped_models.append(wrapped)
        optimizer = optimizer_for(wrapped.parameters())
        rows = batch // mesh.data_parallel_size
        index = mesh.data_parallel_index()
        tokens = tokens_host[index * rows:(index + 1) * rows].to(device)

        def step() -> torch.Tensor:
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(wrapped, tokens, tp_mesh)
            loss.backward()
            optimizer.step()
            return loss.detach()

        def global_loss(loss: torch.Tensor) -> float:
            # the whole batch's mean, as the reference's loss reads it
            return float(distrib.all_reduce(loss, "mean", mesh.group(
                DATA_PARALLEL_AXES)))

        # step 1: its gradients (the update tensors', averaged over the
        # data-parallel processes) gathered to full shapes, then applied
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(wrapped, tokens, tp_mesh)
        loss.backward()
        delta = 0.0
        for name, update in wrapped.named_parameters():
            sharding = getattr(update, "sharding", None)
            grad = update.grad
            if sharding is not None and not sharding.is_replicated:
                grad = sharding.gather(grad)
            delta = max(delta, float((grad - oracle_grads[name]).abs().max()))
        result["grads_max_delta"][key] = delta
        optimizer.step()
        losses = [global_loss(loss.detach())]
        sync()
        distrib.barrier()
        begin = time.perf_counter()
        for index in range(steps):
            chaos.fault_point("tensor.step", width=int(width), step=index)
            with count_collectives() as record:
                loss = step()
            losses.append(global_loss(loss))
        sync()
        step_ms = (time.perf_counter() - begin) / steps * 1e3
        result["step_ms"][key] = step_ms
        result["tflops_per_chip"][key] = \
            step_flops / (step_ms / 1e3) / world / 1e12
        result["collectives"][key] = {
            op: entry for op, entry in collective_stats(record).items()
            if entry["count"]}
        result["opt_state_bytes_per_chip"][key] = per_device_bytes(
            optimizer.state_dict()["state"])
        result["sharding"][key] = describe_state_sharding(
            {"params": dict(model.named_parameters()),
             "opt_state": dict(wrapped.named_parameters())})["summary"]
        result["loss_trajectory"][key] = losses

    widest = str(int(max(widths)))
    result["opt_bytes_ratio"] = round(
        result["opt_state_bytes_per_chip"][widest] / replicated_opt_bytes, 4)
    result["grads_max_delta_overall"] = max(
        result["grads_max_delta"].values())
    from ..ops import attention
    before = dict(attention.launch_counts)
    result["flash_bwd_parity"] = flash_bwd_parity(device=device)
    # the kernels the gate launched (none on the CPU: the plain versions)
    result["flash_bwd_parity_launches"] = {
        name: count - before.get(name, 0)
        for name, count in attention.launch_counts.items()
        if count != before.get(name, 0)}
    result["recompiles"] = sum(watchdog.summary().values()) + sum(
        w.compile_stats()["recompiles"] for w in wrapped_models)
    return result


def _arm_fault_plan(path: str) -> tp.Any:
    """Install an injector armed with the faults of the JSON file `path`
    (a list of `campaign.FaultSpec` dicts), as the campaign arms its own:
    the fault plan of a run across processes reaches every rank."""
    import json

    from ..resilience import chaos
    from ..resilience.campaign import FaultSpec, Scenario

    with open(path, encoding="utf-8") as f:
        specs = [FaultSpec.from_dict(entry) for entry in json.load(f)]
    injector = chaos.install()
    for spec in specs:
        Scenario().arm(injector, spec)
    return injector


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    """`python -m flashy_tpu_torch.parallel.tensor [--workers N] [--steps
    N] ...`: run the tensor-width sweep (over N processes with
    `--workers`, gloo ranks on the host with `--device cpu`), print rank
    0's JSON line (and write it to `--json`); exit 1 when TP grads drift
    from the replicated oracle, the optimizer shard did not happen, the
    fused flash backward loses bit parity with the split oracle, or any
    post-warm-up recompile was reported. `--faults PLAN` arms the fault
    plan in every rank (the campaign's `tensor` scenario) and adds rank
    0's site counts and fired faults to the record."""
    import argparse
    import json
    import os
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.parallel.tensor",
        description="Megatron tensor-parallel training bench at widths "
                    "{1,2,4}.")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--widths", default=None,
                        help="comma-separated tensor widths (default: each "
                             "of 1, 2, 4 that divides the processes)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--workers", type=int, default=1,
                        help="processes to run the widths over")
    parser.add_argument("--json", default=None,
                        help="also write rank 0's record to this file")
    parser.add_argument("--faults", default=None,
                        help="a JSON fault plan armed in every rank")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.workers > 1 and "FLASHY_TPU_PROCESS_ID" not in os.environ:
        import subprocess
        from ..xp import _spawn_workers
        try:
            _spawn_workers(args.workers, argv)
        except subprocess.CalledProcessError as exc:
            print(f"tensor bench FAILED: {exc}", file=sys.stderr)
            return 1
        return 0
    distrib.init(backend="gloo" if args.device == "cpu" else None)
    injector = _arm_fault_plan(args.faults) if args.faults else None
    try:
        result = run_tp_bench(
            steps=args.steps, seq=args.seq, dim=args.dim,
            num_layers=args.layers, num_heads=args.heads,
            vocab_size=args.vocab, device=args.device,
            widths=[int(w) for w in args.widths.split(",")]
            if args.widths else None)
    finally:
        if injector is not None:
            from ..resilience import chaos
            chaos.uninstall(verify=False)
    if injector is not None:
        result["faults"] = {"counts": dict(injector.counts),
                            "fired": [rule.fired_count
                                      for rule in injector._rules]}
    problems = []
    if result["recompiles"]:
        problems.append(f"{result['recompiles']} post-warm-up recompiles")
    if result["grads_max_delta_overall"] > 1e-4:
        problems.append(
            f"TP grads drifted from the replicated oracle by "
            f"{result['grads_max_delta_overall']:.2e}")
    n = result["n_devices"]
    if n >= 2 and result["opt_bytes_ratio"] > (1.5 / n + 0.25):
        problems.append(
            f"opt-state per chip is {result['opt_bytes_ratio']}x the "
            f"replicated footprint on a {n}-process mesh — the "
            f"tensor x zero1 shard did not happen")
    if result["flash_bwd_parity"] != 0.0:
        problems.append(
            f"fused flash backward lost bit parity with the split "
            f"oracle: max delta {result['flash_bwd_parity']:.2e}")
    if distrib.is_rank_zero():
        print(json.dumps(result), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(result, f)
        for problem in problems:
            print(f"tensor bench FAILED: {problem}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
