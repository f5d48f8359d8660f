"""Data parallelism across processes: the port of
flashy_tpu/parallel/data_parallel.py.

The JAX package's `wrap` jits a step with the batch sharded over the
mesh's batch axes and lets XLA insert the gradient all-reduce. The
port's `wrap` plays the same role in PyTorch's idiom: it returns
`torch.nn.parallel.DistributedDataParallel` over the model when the
world holds more than one rank (one rank a process over the mesh's
process axes, `data` x `fsdp`), whose bucketed all-reduce averages the
gradients and overlaps the backward, and the model itself at one rank.
Each process feeds its own rows of the global batch (`shard_batch`,
`flashy_tpu_torch.data`).

The JAX package declares FSDP and ZeRO as shardings and lets XLA insert
the gathers and reduce-scatters. The port writes them out: `wrap(model,
fsdp=True)` holds each parameter as the process's shard and gathers a
block's parameters around its forward (and again for its backward),
`wrap(model, state_sharding=...)` keeps compute replicated and shards
the weight update; both reduce-scatter the gradients through
`distrib.reduce_scatter` and record their layout as the port's
`NamedSharding`s (`sharding.py`), whose specs come from the reference's
leaf rule (`axis_leaf_sharding`, `fsdp_sharding`). It uses neither
`torch.distributed.fsdp` nor DTensor: their collectives would reach gloo
with CUDA tensors, which gloo reduces only in all_reduce, where
`distrib` stages them through the host.

Under Megatron tensor parallelism (`mesh.shape['tensor'] > 1`) `wrap`
first cuts the model over the 'tensor' process axis
(`parallel.tensor`), and the forms above act on the slices over the
processes of each tensor rank: DDP over the `data x fsdp` group, FSDP
over 'fsdp', ZeRO-1 over 'data' (a leaf split over two axes,
`('tensor', 'data')`, nests: `sharding.py`).

Under expert parallelism (`mesh.shape['expert'] > 1`) `wrap` cuts the
expert-sharded leaves (an MoE block's `w_up` and `w_down`, dim 0) over
the 'expert' process axis the same way. Every other parameter stays
whole, and its gradients are equal on the ranks of an expert group up to
the order of a non-deterministic kernel's sums (`models.moe`): DDP
averages them over the `data x fsdp x expert` ranks, so that they are
one value there, and the experts' over the `data x fsdp` ranks of each
expert rank (`_expert_ddp`). FSDP and ZeRO-1 with 'expert' raise
(`mesh.TODO_EXPERT_COMPOSED`).

Under pipeline parallelism (`mesh.shape['pipe'] > 1`) `wrap` cuts the
scan-stacked block leaves over 'pipe' the same way (each stage keeps its
chunks of `interleave` virtual stages) and returns the model itself: the
pipelined model's schedule (`models.pipelined`) sets the gradients, and
`average_over_data` averages them over the `data x fsdp` ranks of each
stage. FSDP and ZeRO-1 with 'pipe' raise (`TODO_PIPE_SHARDED`).

`with_grad_accumulation` runs microbatches in sequence with f32 running
sums; under DDP and the sharded forms every microbatch but the last runs
in `no_sync()`, so the reduction happens once a step.
"""
import contextlib
import math
import typing as tp
import weakref

import numpy as np
import torch
from torch import nn

from .. import distrib
from .mesh import (DATA_PARALLEL_AXES, TODO_EXPERT_COMPOSED, Mesh,
                   default_mesh)
from .sharding import NamedSharding, P, join_pairs, place, split_pairs

BATCH_AXES = ("data", "fsdp")


def _batch_device(mesh: tp.Optional[Mesh], device: tp.Any) -> torch.device:
    """The process's device: `device`, else the mesh's, else `cuda`
    (raising without a card: pass device='cpu' to run on the host)."""
    from ..utils import resolve_device
    if device is None and mesh is not None and mesh.devices is not None:
        return mesh.devices[0]
    return resolve_device(device)


def _to_device(tree: tp.Any, device: torch.device) -> tp.Any:
    """Every array leaf (numpy, tensor, number) of dicts, lists and tuples
    as a tensor on `device`; strings and None pass through."""
    if isinstance(tree, dict):
        return type(tree)((key, _to_device(value, device))
                          for key, value in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_device(value, device) for value in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic, int, float, bool)):
        return torch.as_tensor(np.asarray(tree), device=device)
    return tree


def shard_batch(batch: tp.Any, mesh: tp.Optional[Mesh] = None,
                batch_axes: tp.Sequence[str] = BATCH_AXES,
                device: tp.Any = None) -> tp.Any:
    """Place this process's local batch (a tree of arrays, leading dim =
    batch) on its device. Across processes each contributes its own
    rows, as the JAX package's processes contribute their local shards:
    the global batch is the ranks' rows in rank order, which is
    `batch_spec(('data', 'fsdp'))`'s order (process `r` sits at
    `(r // fsdp, r % fsdp)`). `batch_axes` is kept for the JAX package's
    signature (only 'data' and 'fsdp' shard a batch)."""
    unknown = set(batch_axes) - set(BATCH_AXES)
    if unknown:
        raise ValueError(f"batch axes {sorted(unknown)} do not shard a "
                         f"batch; use {BATCH_AXES}")
    return _to_device(batch, _batch_device(mesh, device))


def replicate(tree: tp.Any, mesh: tp.Optional[Mesh] = None,
              device: tp.Any = None) -> tp.Any:
    """Every leaf broadcast from rank 0 and placed on this process's
    device, so all ranks hold rank 0's values."""
    placed = _to_device(tree, _batch_device(mesh, device))
    return distrib.broadcast_tensors(placed)


def batch_spec(batch_axes: tp.Sequence[str] = BATCH_AXES) -> P:
    """The spec sharding the leading (batch) dim over the batch axes."""
    return P(tuple(batch_axes))


def axis_leaf_sharding(mesh: Mesh, axis: str, min_size: int,
                       base: tp.Optional[tp.Callable[[tp.Any], P]] = None
                       ) -> tp.Callable[[tp.Any], NamedSharding]:
    """Leaf rule shared by `fsdp_sharding` (axis='fsdp') and
    `zero.zero_sharding` (axis='data'): shard the largest dimension
    divisible by the axis size; leaves below `min_size` elements stay
    replicated (sharding tiny arrays costs more in collective latency
    than it saves in memory).

    `base` composes a second parallelism dimension through the same
    seam: a callable returning the spec a leaf ALREADY carries (the
    megatron column/row splits of `transformer_shardings`). The rule
    then shards the largest divisible dim NOT claimed by the base spec
    and merges the two; where every divisible dim is claimed it rides
    along an already-sharded dim (the HSDP spelling ('fsdp', 'data'))
    wherever the composed shard still divides. The base spec's `pairs`
    carries over to the result."""
    axis_size = mesh.shape[axis]

    def leaf_sharding(x: tp.Any) -> NamedSharding:
        shape = tuple(np.shape(x))
        pairs = 1
        if base is None:
            spec: tp.List[tp.Any] = [None] * len(shape)
        else:
            base_spec = base(x)
            pairs = getattr(base_spec, "pairs", 1)
            spec = list(base_spec)
            spec += [None] * (len(shape) - len(spec))
        used = {name for part in spec if part is not None
                for name in (part if isinstance(part, tuple) else (part,))}
        if axis_size > 1 and math.prod(shape) >= min_size \
                and axis not in used:
            # prefer sharding the largest divisible dim
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for dim in order:
                if spec[dim] is None and shape[dim] % axis_size == 0:
                    spec[dim] = axis
                    break
            else:
                for dim in order:
                    part = spec[dim]
                    if part is None:
                        continue
                    parts = part if isinstance(part, tuple) else (part,)
                    span = axis_size * math.prod(mesh.shape[p]
                                                 for p in parts)
                    if shape[dim] % span == 0:
                        spec[dim] = (*parts, axis)
                        break
        if base is None and not any(part is not None for part in spec):
            # the reference's spelling: a replicated leaf is P(), not an
            # all-None spec of matching rank
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(*spec), pairs=pairs)

    return leaf_sharding


def tree_map(fn: tp.Callable, tree: tp.Any, *rest: tp.Any) -> tp.Any:
    """`fn` over the leaves of dicts, lists and tuples (a `state_dict`
    among them), and over the matching leaves of `rest`."""
    leaves, rebuild = distrib._flatten(tree)
    others = [distrib._flatten(other)[0] for other in rest]
    return rebuild([fn(leaf, *(other[i] for other in others))
                    for i, leaf in enumerate(leaves)])


def fsdp_sharding(tree: tp.Any, mesh: tp.Optional[Mesh] = None,
                  axis: str = "fsdp", min_size: int = 2 ** 16) -> tp.Any:
    """Per-leaf NamedShardings that split each large parameter over `axis`.

    The largest dimension divisible by the axis size is sharded; small
    leaves stay replicated. `wrap(model, fsdp=True)` holds each
    parameter as its rank's shard under these (or under a model's own
    spec tree), gathers a block's parameters for its forward and
    reduce-scatters their gradients. For the ZeRO-1 middle ground (shard
    only the update) see `flashy_tpu_torch.parallel.zero`."""
    mesh = mesh or default_mesh()
    return tree_map(axis_leaf_sharding(mesh, axis, min_size), tree)


def shard_params(params: tp.Any, mesh: tp.Optional[Mesh] = None,
                 axis: str = "fsdp", min_size: int = 2 ** 16) -> tp.Any:
    """This process's slices of a full parameter tree under
    `fsdp_sharding` (`sharding.place`): each leaf a contiguous tensor
    carrying its `sharding`."""
    return place(params, fsdp_sharding(params, mesh, axis, min_size))


def _accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The running sum's dtype for a gradient or loss dtype: f64 and
    complex stay as they are, every other float (bf16, f16 among them) is
    summed in f32."""
    if dtype == torch.float64 or dtype.is_complex:
        return dtype
    return torch.float32


def with_grad_accumulation(value_and_grad_fn: tp.Callable,
                           num_microbatches: int, *,
                           fold_rng: tp.Union[bool, str] = True
                           ) -> tp.Callable:
    """Split the batch into microbatches and accumulate the gradients.

    Wraps `value_and_grad_fn(model, batch, *rest, **kwargs) -> loss`, a
    function that runs the forward of a mean-reduced loss and its
    backward, adding the gradients into the parameters' `.grad`, into a
    function of the same signature and results whose peak activation
    memory is divided by `num_microbatches`: the microbatches run in
    sequence, the gradients and losses are summed in f32 (f64 stays f64;
    a bf16 or f16 `.grad` is moved into an f32 running sum after each
    microbatch) and scaled by 1/num_microbatches once, as the JAX
    package's scan does. The batch's leading dim must divide by
    `num_microbatches`. The caller zeroes the gradients before the call.

    With `fold_rng` (True or 'typed': the port's dropout seeds are
    explicit ints, so there is no heuristic to opt out of), a
    `dropout_seed` keyword has the microbatch index folded in
    (`fold_dropout_seed`), so each microbatch draws its own masks.

    Under DistributedDataParallel every microbatch but the last runs in
    `no_sync()`, so the last backward all-reduces the summed gradients
    once; with low-precision gradients every microbatch runs in
    `no_sync()` and the f32 sums are averaged across ranks before they
    are cast back. The sharded forms of `wrap` keep their own f32 sums
    under `no_sync()` and reduce them with the last microbatch's
    gradients, once. One microbatch returns `value_and_grad_fn` itself.
    """
    if fold_rng not in (True, False, "typed"):
        raise ValueError(
            f"fold_rng must be True, False or 'typed', got {fold_rng!r}")
    if num_microbatches <= 1:
        return value_and_grad_fn
    from ..models.transformer import fold_dropout_seed

    def wrapped(model, batch, *rest, **kwargs):
        if batch.shape[0] % num_microbatches:
            raise ValueError(f"batch {batch.shape[0]} does not split into "
                             f"{num_microbatches} microbatches")
        params = [p for p in model.parameters() if p.requires_grad]
        sharded = sharded_state(model) is not None
        low = [p for p in params
               if _accum_dtype(p.dtype) != p.dtype and not p.dtype.is_complex
               and not sharded]
        ddp = sharded or isinstance(model, nn.parallel.DistributedDataParallel)
        sums: tp.Dict[int, torch.Tensor] = {}
        total = None
        micro = batch.split(batch.shape[0] // num_microbatches)
        for index, microbatch in enumerate(micro):
            call_kwargs = dict(kwargs)
            if fold_rng and call_kwargs.get("dropout_seed") is not None:
                call_kwargs["dropout_seed"] = fold_dropout_seed(
                    call_kwargs["dropout_seed"], index)
            last = index == num_microbatches - 1
            sync = not ddp or (last and not low)
            with contextlib.nullcontext() if sync else model.no_sync():
                loss = value_and_grad_fn(model, microbatch, *rest,
                                         **call_kwargs)
            for param in low:
                if param.grad is not None:
                    grad = param.grad.to(_accum_dtype(param.dtype))
                    sums[id(param)] = grad if id(param) not in sums \
                        else sums[id(param)] + grad
                    param.grad = None
            loss = loss.detach()
            total = loss.to(_accum_dtype(loss.dtype)) if total is None \
                else total + loss.to(total.dtype)
        scale = 1.0 / num_microbatches
        with torch.no_grad():
            for param in params:
                if param.grad is not None:
                    param.grad.mul_(scale)
            held = [param for param in low if id(param) in sums]
            summed = [sums[id(param)] for param in held]
            if ddp and summed:
                summed = distrib._reduce_mean(summed)
            for param, value in zip(held, summed):
                param.grad = (value * scale).to(param.dtype)
        return (total * scale).to(loss.dtype)

    return wrapped


# ----------------------------------------------------------------------
# the sharded forms of `wrap`: FSDP (ZeRO-3) and a declared ZeRO layout
# ----------------------------------------------------------------------
class _Leaf:
    """One parameter of a sharded layout: its owner module and attribute,
    its qualified name, its NamedSharding (the layout of the tensor the
    process stores or updates), its full shape (the tensor the forward
    computes with: the whole parameter, or under tensor parallelism its
    'tensor' slice) and the one process axis (`data` or `fsdp`; None:
    not split there) and dim the stored tensor is cut over from it."""

    def __init__(self, owner: nn.Module, name: str, key: str,
                 sharding: NamedSharding, full_shape: tp.Sequence[int]):
        self.owner, self.name, self.key = owner, name, key
        self.sharding = sharding
        axes = tuple(axis for axis in sharding.axis_names()
                     if axis in DATA_PARALLEL_AXES)
        if len(axes) > 1:
            raise NotImplementedError(
                f"{key}: {sharding.spec!r} splits the parameter over the "
                f"process axes {axes}; the port's sharded forms gather and "
                f"reduce a parameter over one of data and fsdp")
        self.axis = axes[0] if axes else None
        self.dim = None if self.axis is None else next(
            dim for dim, part in enumerate(sharding.spec)
            if self.axis in (part if isinstance(part, tuple) else (part,)))
        self.pairs = 1 if self.dim is None else sharding._pairs_at(self.dim)
        self.full_shape = tuple(full_shape)
        self.shard_shape = self.full_shape if self.axis is None else \
            sharding.shard_shape(full_shape, (self.axis,), key)

    def piece(self, full: torch.Tensor, index: int) -> torch.Tensor:
        """Slice `index` over the leaf's process axis of `full`."""
        return split_pairs(full, self.dim, self.sharding.mesh.shape[
            self.axis], index, self.pairs)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This process's slice of `full` (the tensor it stores)."""
        if self.axis is None:
            return full
        return self.piece(full, self.sharding.mesh.coord(self.axis))


class _Layout:
    """The collectives of a sharded layout over its leaves: `gather`
    (stored tensors -> full tensors, one all-gather per (axis, dtype))
    and `reduce` (full gradients -> the stored tensors' gradients,
    averaged over the data-parallel processes as DistributedDataParallel
    averages them: divided by `data x fsdp`, then summed; a sharded
    leaf's by one reduce-scatter over its axis and an all-reduce over the
    other data-parallel axis, a replicated leaf's by one all-reduce over
    both; the ranks of a tensor group reduce apart, each its slices)."""

    def __init__(self, mesh: Mesh, leaves: tp.Sequence[_Leaf]):
        self.mesh = mesh
        self.leaves = list(leaves)
        groups: tp.Dict[tp.Any, tp.List[int]] = {}
        for index, leaf in enumerate(self.leaves):
            groups.setdefault((leaf.axis, leaf.owner._parameters[
                leaf.name].dtype), []).append(index)
        self.groups = groups

    def _other(self, axis: str) -> tp.Optional[str]:
        other = "data" if axis == "fsdp" else "fsdp"
        return other if self.mesh.shape[other] > 1 else None

    def gather(self, tensors: tp.Sequence[torch.Tensor]
               ) -> tp.List[torch.Tensor]:
        """Each sharded leaf's full tensor from this process's shard (a
        new tensor); a replicated leaf's tensor as it is (detached)."""
        out = [t.detach() for t in tensors]
        for (axis, _), indices in self.groups.items():
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            flat = torch.cat([tensors[i].detach().reshape(-1)
                              for i in indices])
            gathered = distrib.all_gather(flat, self.mesh.group(axis))
            gathered = gathered.view(n, flat.numel())
            offset = 0
            for i in indices:
                leaf, size = self.leaves[i], tensors[i].numel()
                out[i] = join_pairs(
                    [gathered[r, offset:offset + size].view(leaf.shard_shape)
                     for r in range(n)], leaf.dim, leaf.pairs)
                offset += size
        return out

    def reduce(self, grads: tp.Sequence[tp.Optional[torch.Tensor]]
               ) -> tp.List[torch.Tensor]:
        """The stored tensors' gradients from the full gradients (None:
        zeros; every process must still join the collectives)."""
        scale = float(self.mesh.data_parallel_size)
        full = [g if g is not None else torch.zeros(
            leaf.full_shape, dtype=leaf.owner._parameters[leaf.name].dtype,
            device=leaf.owner._parameters[leaf.name].device)
            for g, leaf in zip(grads, self.leaves)]
        out: tp.List[tp.Optional[torch.Tensor]] = [None] * len(full)
        for (axis, _), indices in self.groups.items():
            if axis is None:
                flat = torch.cat([full[i].reshape(-1) for i in indices])
                flat = distrib.all_reduce(flat.div_(scale), "sum",
                                          self.mesh.group(DATA_PARALLEL_AXES))
                sizes = [full[i].numel() for i in indices]
                for i, part in zip(indices, flat.split(sizes)):
                    out[i] = part.view(full[i].shape)
                continue
            n = self.mesh.shape[axis]
            flat = torch.cat([self.leaves[i].piece(full[i], r).reshape(-1)
                              for r in range(n) for i in indices])
            mine = distrib.reduce_scatter(flat.div_(scale),
                                          self.mesh.group(axis))
            other = self._other(axis)
            if other is not None:
                mine = distrib.all_reduce(mine, "sum",
                                          self.mesh.group(other))
            sizes = [math.prod(self.leaves[i].shard_shape) for i in indices]
            for i, part in zip(indices, mine.split(sizes)):
                out[i] = part.view(self.leaves[i].shard_shape)
        return tp.cast(tp.List[torch.Tensor], out)


class _SavedParam(tp.NamedTuple):
    """What a unit's saved full parameter packs to: re-gathered for the
    backward (`_Sharded.unpack`)."""
    unit: "_Unit"
    index: int
    size: torch.Size
    stride: tp.Tuple[int, ...]
    offset: int


class _Unit:
    """A group of leaves gathered together: a child module of an FSDP
    model (its parameters gathered on its forward pre-hook, released
    after its forward), the model's own parameters (the root unit,
    gathered across the whole forward: the tied head's embedding serves
    both its uses), or every parameter of a ZeRO-1 model (`gathers`
    False: the full copies are persistent; the optimizer's updates reach
    them through `_ZeroModel.gather_params`)."""

    def __init__(self, sharded: "_Sharded", leaves: tp.Sequence[_Leaf],
                 gathers: bool, updates: tp.Optional[tp.Sequence[
                     torch.Tensor]] = None):
        self.sharded = sharded
        self.leaves = list(leaves)
        self.layout = _Layout(sharded.mesh, self.leaves)
        self.gathers = gathers
        self.updates = updates
        self.accumulated: tp.Optional[tp.List[torch.Tensor]] = None
        self.regathered: tp.Optional[tp.List[torch.Tensor]] = None
        self.live: tp.List[int] = []

    def inputs(self) -> tp.List[torch.Tensor]:
        """The tensors the optimizer updates: an FSDP model's current
        parameters (its shards, or what `functional_call` put there), a
        ZeRO-1 model's update tensors."""
        if self.updates is not None:
            return list(self.updates)
        return [leaf.owner._parameters[leaf.name] for leaf in self.leaves]

    def full_values(self, inputs: tp.Sequence[torch.Tensor]
                    ) -> tp.List[torch.Tensor]:
        if self.gathers:
            return self.layout.gather(inputs)
        # ZeRO-1: the module's own (replicated) parameters
        return [leaf.owner._parameters[leaf.name].detach()
                for leaf in self.leaves]

    def regather(self) -> tp.List[torch.Tensor]:
        """The full parameters again, for the backward (once a backward:
        released when the unit's gradients are reduced)."""
        if self.regathered is None:
            with torch.no_grad():
                self.regathered = self.layout.gather(self.inputs())
        return self.regathered

    def enter(self) -> None:
        """Put the full parameters where the module's forward reads them
        (each owner's instance `__dict__`, which attribute lookup reads
        before the registered shard)."""
        if self.sharded.summoned:
            return
        self.regathered = None
        inputs = self.inputs()
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            fulls = _ShardedUse.apply(self, *inputs)
        else:
            with torch.no_grad():
                fulls = self.full_values(inputs)
        for leaf, full in zip(self.leaves, fulls):
            leaf.owner.__dict__[leaf.name] = full
        if self.gathers:
            for index, (leaf, full) in enumerate(zip(self.leaves, fulls)):
                if leaf.dim is not None and full.numel():
                    key = full.untyped_storage().data_ptr()
                    self.sharded.live[key] = (self, index)
                    self.live.append(key)

    def exit(self) -> None:
        """Release the full parameters (what autograd saved of them
        packs to `_SavedParam` and is re-gathered in the backward)."""
        if self.sharded.summoned:
            return
        for leaf in self.leaves:
            leaf.owner.__dict__.pop(leaf.name, None)
        for key in self.live:
            self.sharded.live.pop(key, None)
        self.live = []

    def backward(self, grads: tp.Sequence[tp.Optional[torch.Tensor]]
                 ) -> tp.List[tp.Optional[torch.Tensor]]:
        """Reduce the full gradients into the update tensors' gradients;
        under `no_sync()` add them to the unit's running sums instead."""
        self.regathered = None
        if self.accumulated is not None:
            grads = [acc if g is None else acc + g.to(acc.dtype)
                     for acc, g in zip(self.accumulated, grads)]
        if not self.sharded.sync:
            self.accumulated = [
                (g if g is not None else torch.zeros(
                    leaf.full_shape, device=leaf.owner._parameters[
                        leaf.name].device)).to(_accum_dtype(
                            leaf.owner._parameters[leaf.name].dtype))
                for g, leaf in zip(grads, self.leaves)]
            return [None] * len(grads)
        self.accumulated = None
        reduced = self.layout.reduce(
            [None if g is None else g.to(leaf.owner._parameters[
                leaf.name].dtype) for g, leaf in zip(grads, self.leaves)])
        return list(reduced)


class _ShardedUse(torch.autograd.Function):
    """A unit's full parameters from its update tensors: the forward
    gathers them (FSDP) or hands out the replicated copies (ZeRO-1);
    the backward reduces their gradients into the update tensors."""

    @staticmethod
    def forward(ctx: tp.Any, unit: _Unit, *inputs: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, ...]:
        ctx.unit = unit
        return tuple(unit.full_values(inputs))

    @staticmethod
    def backward(ctx: tp.Any, *grads: torch.Tensor) -> tp.Any:
        return (None,) + tuple(ctx.unit.backward(grads))


class _Sharded:
    """The sharded form's state on a model (`model._sharded`): its mesh,
    mode ('fsdp', 'zero1' or 'tensor': a tensor-parallel model's slices),
    the model it records, units, the NamedSharding of every stored or
    update tensor by parameter name (`shardings`, what
    `describe_state_sharding` and the checkpoint read), whether backward
    reduces (`no_sync` clears it), and the storages of the full
    parameters gathered right now (`live`)."""

    def __init__(self, mesh: Mesh, mode: str, model: nn.Module):
        self.mesh = mesh
        self.mode = mode
        self.model = model
        self.units: tp.List[_Unit] = []
        self.shardings: tp.Dict[str, NamedSharding] = {}
        self.sync = True
        self.live: tp.Dict[int, tp.Tuple[_Unit, int]] = {}
        self.summoned = False

    def pack(self, tensor: torch.Tensor) -> tp.Any:
        if self.live and isinstance(tensor, torch.Tensor) and tensor.numel():
            hit = self.live.get(tensor.untyped_storage().data_ptr())
            if hit is not None:
                return _SavedParam(hit[0], hit[1], tensor.size(),
                                   tensor.stride(), tensor.storage_offset())
        return tensor

    @staticmethod
    def unpack(saved: tp.Any) -> tp.Any:
        if isinstance(saved, _SavedParam):
            full = saved.unit.regather()[saved.index]
            return full.as_strided(saved.size, saved.stride, saved.offset)
        return saved

    @contextlib.contextmanager
    def summon_full_params(self) -> tp.Iterator[None]:
        """Inside the block a sharded model's registered parameters are
        the full ones (gathered once over every axis, 'pipe' and
        'tensor' included,
        no gradient), so code that reads `named_parameters()`, such as
        the decoder, sees the whole model and runs it without
        collectives; the shards are back after it. Collective: every
        process enters it together. A ZeRO-1 model's parameters are whole
        already (a tensor-parallel one's inner module summons its
        slices). An FSDP model gathers each unit as its forward does (one
        all-gather per axis and dtype), then each 'tensor' slice on its
        own."""
        if self.mode == "zero1" or self.summoned:
            yield
            return
        held = []
        with torch.no_grad():
            fulls = {leaf.key: full for unit in self.units
                     for leaf, full in zip(unit.leaves, unit.layout.gather(
                         unit.inputs()))}
            for name, sharding in self.shardings.items():
                if sharding.is_replicated:
                    continue
                owner_path, _, attr = name.rpartition(".")
                owner = self.model.get_submodule(owner_path) \
                    if owner_path else self.model
                shard = owner._parameters[attr]
                held.append((owner, attr, shard))
                full = fulls.get(name, shard)
                model_axes = [axis for axis in MODEL_AXES
                              if axis in sharding.axis_names()]
                if model_axes:
                    full = sharding.gather(full, model_axes)
                owner._parameters[attr] = nn.Parameter(
                    full.detach(), requires_grad=False)
        self.summoned = True
        try:
            yield
        finally:
            self.summoned = False
            for owner, attr, shard in held:
                owner._parameters[attr] = shard

    @contextlib.contextmanager
    def no_sync(self) -> tp.Iterator[None]:
        """Backward adds the full gradients to running sums (one per
        parameter, f32) instead of reducing them; the first backward
        after the block reduces the sums with its own gradients."""
        previous, self.sync = self.sync, False
        try:
            yield
        finally:
            self.sync = previous


def _resolve_shardings(model: nn.Module, mesh: Mesh, spec: tp.Any,
                       default: tp.Callable[[tp.Any], tp.Any],
                       axes: tp.Optional[tp.Sequence[str]] = None
                       ) -> tp.Dict[str, NamedSharding]:
    """Every parameter's NamedSharding: from `spec` (a mapping of
    parameter names to specs or NamedShardings, as `transformer_shardings`
    and `fsdp_sharding` give), else from `default` over the parameters.
    A dim that its axes among `axes` (default: every axis) do not divide
    raises ValueError naming the parameter and the dim's divisors."""
    params = dict(model.named_parameters())
    if spec is None:
        spec = default(params)
    out = {}
    for name, param in params.items():
        if name not in spec:
            raise KeyError(f"the sharding spec has no entry for parameter "
                           f"{name!r}")
        entry = spec[name]
        out[name] = entry if isinstance(entry, NamedSharding) \
            else NamedSharding(mesh, entry)
        out[name].shard_shape(param.shape, axes, name=name)
    return out


def _leaves(model: nn.Module, shardings: tp.Mapping[str, NamedSharding],
            names: tp.Sequence[str]) -> tp.List[_Leaf]:
    """The leaves of `model`'s parameters `names` (their full shapes:
    under tensor parallelism the 'tensor' slices the model holds)."""
    out = []
    for name in names:
        owner_path, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_path) if owner_path else model
        out.append(_Leaf(owner, attr, name, shardings[name],
                         owner._parameters[attr].shape))
    return out


def _param_specs(model: nn.Module, spec: tp.Any) -> tp.Any:
    """The parameters' specs in a declared layout: its 'params' entry
    (a `tensor_state_sharding` tree), the layout itself (a mapping of
    parameter names, as `transformer_shardings` gives), or None when it
    declares only update state."""
    if isinstance(spec, tp.Mapping) and "params" in spec:
        return spec["params"]
    if isinstance(spec, tp.Mapping) and not _has_update_keys(spec):
        return spec
    return None


def _has_update_keys(spec: tp.Any) -> bool:
    from .zero import _is_update_key
    return isinstance(spec, tp.Mapping) and any(
        _is_update_key(str(key)) for key in spec)


# the process axes a model is cut over (the model-parallel axes); the
# data-parallel forms act on the slices
MODEL_AXES = ("expert", "pipe", "tensor")
TODO_PIPE_SHARDED = ("ROADMAP.md queue A item 8f (pipe composed with "
                     "fsdp or ZeRO-1, and with tensor in the LM solver)")


def _split_model(model: nn.Module, mesh: Mesh, spec: tp.Any,
                 interleave: int = 1) -> None:
    """Cut `model` over the mesh's model-parallel axes ('expert', 'pipe',
    'tensor' above size 1) in place: every rank first takes rank 0's full
    parameters (the model is built identically on every rank, then
    sliced), then each parameter that its spec (`spec`, or the model's
    own `shardings()`) splits over those axes becomes this process's
    slice, an `nn.Parameter` carrying the slice's NamedSharding. Over
    'tensor' the model's layers read their widths from the slices they
    hold and run the Megatron collectives over the mesh's 'tensor' group
    (`parallel.tensor`); over 'pipe' a scan-stacked leaf [L, ...] keeps
    this stage's chunks of `interleave` virtual stages (chunks d, d +
    pipe, ...: the NamedSharding's `interleave`), which the pipelined
    model runs (`models.pipelined`); over 'expert' a leaf whose spec
    leads with 'expert' (the MoE experts) keeps this rank's E / e
    experts. Records the slices as `model._sharded` (mode 'expert',
    'tensor', 'pipe', 'expert+tensor' or 'pipe+tensor') with
    `summon_full_params` and `no_sync`."""
    axes = tuple(axis for axis in MODEL_AXES if mesh.shape[axis] > 1)

    def default(params: tp.Any) -> tp.Any:
        shardings = getattr(model, "shardings", None)
        if shardings is None:
            raise ValueError(
                f"wrap over {' x '.join(f'{a}={mesh.shape[a]}' for a in axes)}"
                f" needs the parameters' specs: pass state_sharding (e.g. "
                f"transformer_shardings or tensor_state_sharding) or wrap "
                f"a model with a shardings() method")
        return shardings()

    shardings = _resolve_shardings(model, mesh, spec, default,
                                   None if interleave == 1 else ("tensor",))
    distrib.broadcast_model(model)
    sharded = _Sharded(mesh, "+".join(axes), model)
    with torch.no_grad():
        for name, param in list(model.named_parameters()):
            local = shardings[name].over(axes)
            if interleave != 1:
                local = NamedSharding(mesh, local.spec, pairs=local.pairs,
                                      interleave=interleave)
            if local.is_replicated:
                continue
            local.shard_shape(param.shape, axes, name=name)
            owner_path, _, attr = name.rpartition(".")
            owner = model.get_submodule(owner_path) if owner_path else model
            sliced = nn.Parameter(local.shard(param.detach()).clone(),
                                  requires_grad=param.requires_grad)
            sliced.sharding = local
            owner._parameters[attr] = sliced
            sharded.shardings[name] = local
    model._sharded = sharded
    model.no_sync = sharded.no_sync
    model.summon_full_params = sharded.summon_full_params


def average_over_data(params: tp.Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Average the `.grad` of `params` over the mesh's `data x fsdp`
    processes in place (one flat all-reduce per dtype, divided by their
    count, as DistributedDataParallel's buckets average): the
    data-parallel step of a model cut over 'pipe', whose gradients its
    schedule sets itself. The identity on one data-parallel process."""
    if mesh.data_parallel_size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    group = mesh.group(DATA_PARALLEL_AXES)
    scale = float(mesh.data_parallel_size)
    by_dtype: tp.Dict[torch.dtype, tp.List[torch.Tensor]] = {}
    for grad in grads:
        by_dtype.setdefault(grad.dtype, []).append(grad)
    with torch.no_grad():
        for same in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in same])
            flat = distrib.all_reduce(flat.div_(scale), "sum", group)
            for grad, part in zip(same, flat.split([g.numel()
                                                    for g in same])):
                grad.copy_(part.view_as(grad))


def _fsdp(model: nn.Module, mesh: Mesh, spec: tp.Any) -> nn.Module:
    """Turn `model` into its FSDP form in place (see `wrap`); under
    tensor parallelism `model` holds its 'tensor' slices already."""
    from .mesh import PROCESS_AXES
    if mesh.shape["fsdp"] == 1 and mesh.shape["data"] == 1:
        return model
    # under tensor parallelism the parameters are the 'tensor' slices
    # already (their full shapes were checked over every axis then): only
    # the data-parallel axes cut them further
    shardings = _resolve_shardings(
        model, mesh, spec, lambda params: fsdp_sharding(params, mesh),
        DATA_PARALLEL_AXES if mesh.shape["tensor"] > 1 else None)
    for sharding in shardings.values():
        stray = set(sharding.axis_names()) - set(PROCESS_AXES)
        if stray:
            raise NotImplementedError(
                f"wrap(fsdp=True) shards over the process axes, not "
                f"{sorted(stray)}")
    if mesh.shape["tensor"] == 1:
        distrib.broadcast_model(model)
    sharded = _Sharded(mesh, "fsdp", model)
    sharded.shardings = shardings
    # the units' leaves, with their full shapes, before the shards replace
    # the parameters
    own = [name for name, _ in model.named_parameters(recurse=False)]
    children = [(child, [f"{child_name}.{name}" for name, _ in
                         child.named_parameters()])
                for child_name, child in model.named_children()]
    units = [(child, _leaves(model, shardings, names))
             for child, names in children if names]
    root_leaves = _leaves(model, shardings, own)
    with torch.no_grad():
        for leaf in root_leaves + [leaf for _, leaves in units
                                   for leaf in leaves]:
            param = leaf.owner._parameters[leaf.name]
            local = nn.Parameter(leaf.local(param.detach()).clone(),
                                 requires_grad=param.requires_grad)
            local.sharding = leaf.sharding
            leaf.owner._parameters[leaf.name] = local
    for child, leaves in units:
        unit = _Unit(sharded, leaves, True)
        sharded.units.append(unit)
        child.register_forward_pre_hook(
            lambda module, args, unit=unit: unit.enter())
        child.register_forward_hook(
            lambda module, args, output, unit=unit: unit.exit())
    root = _Unit(sharded, root_leaves, True)
    sharded.units.append(root)
    forward = model.forward

    def sharded_forward(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
        root.enter()
        try:
            with torch.autograd.graph.saved_tensors_hooks(sharded.pack,
                                                          sharded.unpack):
                return forward(*args, **kwargs)
        finally:
            root.exit()

    model.forward = sharded_forward
    model._sharded = sharded
    model.no_sync = sharded.no_sync
    model.summon_full_params = sharded.summon_full_params
    return model


# the live ZeRO-1 models, gathered after any optimizer step over their
# shards by one process-wide hook (registered once: a hook that removed
# itself while the optimizer iterates the hooks would break that step)
_zero_models: "weakref.WeakSet[_ZeroModel]" = weakref.WeakSet()
_zero_hook: tp.List[tp.Any] = []


def _register_zero_hook() -> None:
    if _zero_hook:
        return
    from torch.optim.optimizer import register_optimizer_step_post_hook

    def after_step(optimizer: torch.optim.Optimizer, args: tp.Any,
                   kwargs: tp.Any) -> None:
        ids = {id(p) for group in optimizer.param_groups
               for p in group["params"]}
        for model in list(_zero_models):
            if model._sharded_ids & ids:
                model.gather_params()

    _zero_hook.append(register_optimizer_step_post_hook(after_step))


class _ZeroModel(nn.Module):
    """A model under a declared ZeRO layout (`wrap(model,
    state_sharding=...)`): compute and `module`'s parameters stay
    replicated over the data-parallel processes (under tensor
    parallelism, each rank's 'tensor' slices); `parameters()` are the
    tensors the optimizer updates, this process's shard of each parameter
    whose update state the layout shards (a new `nn.Parameter` carrying
    its `.sharding`) and the parameter itself where it stays replicated.
    The backward reduce-scatters the gradients into the shards (one
    reduce-scatter and one all-reduce a step); after any optimizer's step
    over the shards the fresh parameters are all-gathered into `module`
    once."""

    def __init__(self, module: nn.Module, mesh: Mesh,
                 shardings: tp.Mapping[str, NamedSharding]):
        super().__init__()
        self.module = module
        if mesh.shape["tensor"] == 1:
            distrib.broadcast_model(module)
        sharded = _Sharded(mesh, "zero1", module)
        sharded.shardings = dict(shardings)
        names = [name for name, _ in module.named_parameters()]
        leaves = _leaves(module, shardings, names)
        updates = []
        with torch.no_grad():
            for leaf in leaves:
                param = leaf.owner._parameters[leaf.name]
                if leaf.dim is None:
                    updates.append(param)
                    continue
                local = nn.Parameter(leaf.local(param.detach()).clone(),
                                     requires_grad=param.requires_grad)
                local.sharding = leaf.sharding
                updates.append(local)
        self._names = names
        self._updates = updates
        self._unit = _Unit(sharded, leaves, False, updates)
        sharded.units.append(self._unit)
        self._sharded = sharded
        self.no_sync = sharded.no_sync
        self._sharded_ids = {id(u) for u, leaf in zip(updates, leaves)
                             if leaf.dim is not None}
        _zero_models.add(self)
        _register_zero_hook()

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True
                         ) -> tp.Iterator[tp.Tuple[str, nn.Parameter]]:
        for name, update in zip(self._names, self._updates):
            yield prefix + name, update

    def parameters(self, recurse: bool = True
                   ) -> tp.Iterator[nn.Parameter]:
        for _, update in self.named_parameters():
            yield update

    def gather_params(self) -> None:
        """All-gather the shards into the replicated parameters (one
        all-gather a step)."""
        unit = self._unit
        fulls = unit.layout.gather(self._updates)
        with torch.no_grad():
            for leaf, full in zip(unit.leaves, fulls):
                if leaf.dim is not None:
                    leaf.owner._parameters[leaf.name].copy_(full)

    def forward(self, *args: tp.Any, **kwargs: tp.Any) -> tp.Any:
        self._unit.enter()
        try:
            return self.module(*args, **kwargs)
        finally:
            self._unit.exit()


def sharded_state(model: tp.Any) -> tp.Optional[_Sharded]:
    """The sharded form's record of `model` (FSDP, ZeRO or a tensor
    parallel model's slices), or None."""
    return getattr(model, "_sharded", None)


def grad_norm(params: tp.Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the gradients of `params`, a 0-d f32 tensor
    on their device: each sharded update tensor's squares (a `.sharding`
    splitting it over a process axis) summed over that axis's group, a
    replicated one's counted once, as the norm over the full gradients
    (the gradients of replicated leaves are equal on every process)."""
    total, sharded = None, {}
    for param in params:
        if param.grad is None:
            continue
        square = param.grad.float().pow(2).sum()
        sharding = getattr(param, "sharding", None)
        axes = sharding.axis_names() if sharding is not None else ()
        if axes:
            key = (id(sharding.mesh), axes)
            value = sharded.get(key)
            sharded[key] = (sharding, square if value is None
                            else value[1] + square)
        else:
            total = square if total is None else total + square
    for sharding, square in sharded.values():
        for axis in sharding.axis_names():
            square = distrib.all_reduce(square, "sum",
                                        sharding.mesh.group(axis))
        total = square if total is None else total + square
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _ddp(model: nn.Module, group: tp.Any, **ddp_kwargs: tp.Any
         ) -> nn.Module:
    """`DistributedDataParallel(model)` over `group` (None: every
    process), its bucket all-reduces counted."""
    distrib._require_backend()
    device = next(model.parameters()).device
    if device.type == "cuda":
        ddp_kwargs.setdefault("device_ids", [device.index if device.index
                                             is not None else
                                             torch.cuda.current_device()])
    wrapped = nn.parallel.DistributedDataParallel(
        model, process_group=group, **ddp_kwargs)
    from .accounting import counting_allreduce_hook
    # the hook's state is the group it averages over (None: every process)
    wrapped.register_comm_hook(group, counting_allreduce_hook)
    return wrapped


def _expert_ddp(model: nn.Module, mesh: Mesh, **ddp_kwargs: tp.Any
                ) -> nn.Module:
    """The data-parallel form of a model cut over 'expert': DDP over the
    `data x fsdp x expert` processes for every leaf an expert rank holds
    whole, so that their gradients, equal on the ranks of an expert group
    up to the order of a non-deterministic kernel's sums, are averaged
    into one value there; the experts
    (leaves split over 'expert') are left out of it, and after the
    backward that syncs (not inside `no_sync()`) each one's gradient is
    averaged over the `data x fsdp` processes of its expert rank."""
    experts = [(name, param) for name, param in model.named_parameters()
               if name in model._sharded.shardings and "expert" in
               model._sharded.shardings[name].axis_names()]
    nn.parallel.DistributedDataParallel.\
        _set_params_and_buffers_to_ignore_for_model(
            model, [name for name, _ in experts])
    wrapped = _ddp(model, mesh.group(DATA_PARALLEL_AXES + ("expert",)),
                   **ddp_kwargs)
    if mesh.data_parallel_size > 1:
        group = mesh.group(DATA_PARALLEL_AXES)
        scale = float(mesh.data_parallel_size)

        def average(param: torch.Tensor) -> None:
            if wrapped.require_backward_grad_sync:
                param.grad.copy_(distrib.all_reduce(
                    param.grad.div_(scale), "sum", group))

        for _, param in experts:
            param.register_post_accumulate_grad_hook(average)
    return wrapped


def wrap(model: tp.Optional[nn.Module] = None, *,
         mesh: tp.Optional[Mesh] = None,
         batch_axes: tp.Sequence[str] = BATCH_AXES,
         fsdp: bool = False, state_sharding: tp.Any = None,
         interleave: int = 1, **ddp_kwargs: tp.Any) -> tp.Any:
    """Make a model data-parallel over the processes: the DDP role.

    Above one rank, by default, returns `DistributedDataParallel(model,
    **ddp_kwargs)` on the default group (`distrib.init()` first; a CUDA
    model gets `device_ids=[its card]`), which broadcasts rank 0's
    parameters and buffers at construction and averages the gradients in
    the backward (its comm hook counts every bucket's all-reduce for
    `accounting.count_collectives`). At one rank returns `model` itself.

    `fsdp=True` returns `model` itself in FSDP form (ZeRO-3) over the
    mesh's process axes: each parameter is held as this process's shard
    (an `nn.Parameter` carrying its `.sharding`) under `state_sharding`
    (a mapping of parameter names to specs, e.g. the model's
    `transformer_shardings`) or else `fsdp_sharding` of the parameters.
    Each child module's parameters are all-gathered on its forward
    pre-hook and released after its forward (the model's own, the tied
    embedding among them, across the whole forward); what autograd saved
    of them is re-gathered for the backward, and a recomputed (remat)
    block gathers again. Each gradient is reduce-scattered into its shard
    once a step, averaged as DDP averages it (divided by the process
    count, then summed). Build the optimizer over `model.parameters()`:
    its moments are then sharded too.

    `state_sharding` without `fsdp` applies a declared ZeRO layout
    (`zero.zero_sharding` of `{'params': ..., 'opt_state': ...}` keyed by
    parameter names, or of a bare tree of them): compute and the
    parameters stay replicated, the gradients are reduce-scattered, the
    optimizer built over the result's `parameters()` (each sharded
    parameter's shard) updates only this process's shard, and the fresh
    parameters are all-gathered once after its step.

    A `mesh` whose 'tensor' axis is above 1 first cuts the model over
    it (Megatron tensor parallelism; the model is built identically on
    every rank, then sliced): each parameter that its spec splits over
    'tensor' (the 'params' entry of a `tensor_state_sharding` layout, a
    mapping such as `transformer_shardings`, or the model's own
    `shardings()`) becomes this process's slice, and the model's layers
    run on their slices with the Megatron all-reduces over the 'tensor'
    group. The data-parallel form then acts on the slices over the
    processes of a tensor rank (`data x fsdp`): `fsdp=True` shards them
    over 'fsdp' (tensor+fsdp), a layout with update state shards their
    update over 'data' (tensor+zero1), and otherwise DDP averages their
    gradients over the `data x fsdp` group (the model itself when that
    group is one process). `model.summon_full_params()` lends the whole
    parameters, gathered over 'tensor' too. A mesh whose 'expert' axis is
    above 1 cuts the MoE experts over it the same way (expert
    parallelism; with 'tensor' too, both cuts), and DDP then averages the
    leaves held whole over the `data x fsdp x expert` ranks and the
    experts over the `data x fsdp` ranks of each expert rank (DDP even at
    one data-parallel rank); `fsdp=True` or a ZeRO-1 layout with it
    raises NotImplementedError (ROADMAP item 8f).

    The sharded forms have `no_sync()` (gradient accumulation reduces
    once a step) and record their layout (`sharded_state(...)`). Usable
    as a decorator (`@wrap`) or a call. The result's `compile_stats()`
    reports its forward calls; compiles and recompiles stay 0 (the port
    runs eagerly and keeps no compile cache, the deliberate difference
    of ROADMAP queue C's watchdog entry). `batch_axes` is kept for the
    JAX package's signature.
    """
    if model is None:
        return lambda module: wrap(module, mesh=mesh, batch_axes=batch_axes,
                                   fsdp=fsdp, state_sharding=state_sharding,
                                   interleave=interleave, **ddp_kwargs)
    if not isinstance(model, nn.Module):
        raise TypeError(f"wrap takes an nn.Module (the port's steps run "
                        f"eagerly), got {type(model).__name__}")
    wrapped = model
    tensor = mesh is not None and mesh.shape["tensor"] > 1
    pipe = mesh is not None and mesh.shape["pipe"] > 1
    expert = mesh is not None and mesh.shape["expert"] > 1
    for axis, on, todo in (("pipe", pipe, TODO_PIPE_SHARDED),
                           ("expert", expert, TODO_EXPERT_COMPOSED)):
        if on and (fsdp or _has_update_keys(state_sharding)):
            raise NotImplementedError(
                f"wrap over {axis}={mesh.shape[axis]} with "
                f"{'fsdp=True' if fsdp else 'a ZeRO-1 layout'} is not "
                f"ported yet: {todo}")
    if fsdp or state_sharding is not None or tensor or pipe or expert:
        mesh = mesh or default_mesh()
        if distrib.is_distributed():
            distrib._require_backend()
        if tensor or pipe or expert:
            _split_model(model, mesh, _param_specs(model, state_sharding),
                         interleave)
        if pipe:
            # the pipelined model's schedule sets the gradients itself:
            # no DDP hook (`average_over_data`)
            pass
        elif fsdp:
            wrapped = _fsdp(model, mesh, _param_specs(model, state_sharding))
        elif state_sharding is not None and (not (tensor or expert)
                                             or _has_update_keys(
                                                 state_sharding)):
            wrapped = _ZeroModel(model, mesh, _zero_shardings(
                model, state_sharding))
        elif expert:
            wrapped = _expert_ddp(model, mesh, **ddp_kwargs)
        elif mesh.data_parallel_size > 1:
            wrapped = _ddp(model, mesh.group(DATA_PARALLEL_AXES),
                           **ddp_kwargs)
    elif distrib.is_distributed():
        wrapped = _ddp(model, None, **ddp_kwargs)
    calls = [0]

    def count(module: nn.Module, args: tp.Any) -> None:
        calls[0] += 1

    wrapped.register_forward_pre_hook(count)

    def compile_stats() -> tp.Dict[str, int]:
        """{calls, compiles, recompiles} of the wrapped model."""
        return {"calls": calls[0], "compiles": 0, "recompiles": 0}

    wrapped.compile_stats = compile_stats
    return wrapped


def _zero_shardings(model: nn.Module, spec: tp.Any
                    ) -> tp.Dict[str, NamedSharding]:
    """Every parameter's update NamedSharding from a declared ZeRO layout:
    the entry of the update keys (those naming optimizer state, see
    `zero.UPDATE_KEY_MARKERS`) or, for a bare tree, the tree itself,
    looked up by parameter name (a nested entry under a name, such as
    {'exp_avg': ..., 'exp_avg_sq': ...}, gives its first sharding)."""
    from .zero import _is_update_key
    entries = [value for key, value in spec.items()
               if _is_update_key(str(key))] \
        if _has_update_keys(spec) else [spec]
    out = {}
    for name, _ in model.named_parameters():
        for entry in entries:
            if isinstance(entry, tp.Mapping) and name in entry:
                found = entry[name]
                if not isinstance(found, NamedSharding):
                    found = next(leaf for leaf in distrib._flatten(found)[0]
                                 if isinstance(leaf, NamedSharding))
                out[name] = found
                break
        else:
            raise KeyError(f"the ZeRO layout has no entry for parameter "
                           f"{name!r}")
    return out
