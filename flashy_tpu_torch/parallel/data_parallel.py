"""Data parallelism across processes: the port of
flashy_tpu/parallel/data_parallel.py.

The JAX package's `wrap` jits a step with the batch sharded over the
mesh's batch axes and lets XLA insert the gradient all-reduce. The
port's `wrap` plays the same role in PyTorch's idiom: it returns
`torch.nn.parallel.DistributedDataParallel` over the model when the
world holds more than one rank (one rank a process, the mesh's `data`
axis), whose bucketed all-reduce averages the gradients and overlaps
the backward, and the model itself at one rank. Each process feeds its
own rows of the global batch (`shard_batch`, `flashy_tpu_torch.data`).

`with_grad_accumulation` runs microbatches in sequence with f32 running
sums; under DDP every microbatch but the last runs in `no_sync()`, so
the all-reduce happens once a step. FSDP and declared state shardings
(`fsdp=True`, `state_sharding`, `batch_spec`, `axis_leaf_sharding`,
`fsdp_sharding`, `shard_params`) raise, naming ROADMAP.md queue A item 8.
"""
import contextlib
import typing as tp

import numpy as np
import torch
from torch import nn

from .. import distrib
from .mesh import Mesh

BATCH_AXES = ("data", "fsdp")
TODO_FSDP = ("ROADMAP.md queue A item 8 (FSDP / ZeRO parameter and "
             "state sharding)")


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
    the global batch is the ranks' rows in rank order. `batch_axes` is
    kept for the JAX package's signature (only 'data' and 'fsdp' shard a
    batch, and 'fsdp' above 1 is not ported)."""
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


def batch_spec(batch_axes: tp.Sequence[str] = BATCH_AXES) -> tp.NoReturn:
    raise NotImplementedError(f"batch_spec (a PartitionSpec) has no "
                              f"counterpart yet: {TODO_FSDP}")


def axis_leaf_sharding(*args: tp.Any, **kwargs: tp.Any) -> tp.NoReturn:
    raise NotImplementedError(f"axis_leaf_sharding is not ported yet: "
                              f"{TODO_FSDP}")


def fsdp_sharding(*args: tp.Any, **kwargs: tp.Any) -> tp.NoReturn:
    raise NotImplementedError(f"fsdp_sharding is not ported yet: "
                              f"{TODO_FSDP}")


def shard_params(*args: tp.Any, **kwargs: tp.Any) -> tp.NoReturn:
    raise NotImplementedError(f"shard_params is not ported yet: {TODO_FSDP}")


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
    are cast back. One microbatch returns `value_and_grad_fn` itself.
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
        low = [p for p in params
               if _accum_dtype(p.dtype) != p.dtype and not p.dtype.is_complex]
        ddp = isinstance(model, nn.parallel.DistributedDataParallel)
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


def wrap(model: tp.Optional[nn.Module] = None, *,
         mesh: tp.Optional[Mesh] = None,
         batch_axes: tp.Sequence[str] = BATCH_AXES,
         fsdp: bool = False, state_sharding: tp.Any = None,
         **ddp_kwargs: tp.Any) -> tp.Any:
    """Make a model data-parallel over the processes: the DDP role.

    Above one rank returns `DistributedDataParallel(model, **ddp_kwargs)`
    on the default group (`distrib.init()` first; a CUDA model gets
    `device_ids=[its card]`), which broadcasts rank 0's parameters and
    buffers at construction and averages the gradients in the backward.
    At one rank returns `model` itself. Usable as a decorator (`@wrap`)
    or a call. The result's `compile_stats()` reports its forward calls;
    compiles and recompiles stay 0 (the port runs eagerly and keeps no
    compile cache, the deliberate difference of ROADMAP queue C's
    watchdog entry). `mesh` and `batch_axes` are kept for the JAX
    package's signature; `fsdp=True` and `state_sharding` raise.
    """
    if model is None:
        return lambda module: wrap(module, mesh=mesh, batch_axes=batch_axes,
                                   fsdp=fsdp, state_sharding=state_sharding,
                                   **ddp_kwargs)
    if fsdp or state_sharding is not None:
        raise NotImplementedError(f"wrap(fsdp=True / state_sharding=) is "
                                  f"not ported yet: {TODO_FSDP}")
    if not isinstance(model, nn.Module):
        raise TypeError(f"wrap takes an nn.Module (the port's steps run "
                        f"eagerly), got {type(model).__name__}")
    wrapped = model
    if distrib.is_distributed():
        distrib._require_backend()
        device = next(model.parameters()).device
        if device.type == "cuda":
            ddp_kwargs.setdefault("device_ids", [device.index if device.index
                                                 is not None else
                                                 torch.cuda.current_device()])
        wrapped = nn.parallel.DistributedDataParallel(model, **ddp_kwargs)
    calls = [0]

    def count(module: nn.Module, args: tp.Any) -> None:
        calls[0] += 1

    wrapped.register_forward_pre_hook(count)

    def compile_stats() -> tp.Dict[str, int]:
        """{calls, compiles, recompiles} of the wrapped model."""
        return {"calls": calls[0], "compiles": 0, "recompiles": 0}

    wrapped.compile_stats = compile_stats
    return wrapped
