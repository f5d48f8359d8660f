"""Process-level helpers on torch.distributed (the port of
flashy_tpu/distrib.py).

`rank` and `world_size` read the launcher environment (the JAX
package's `FLASHY_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID`, set by
`--workers=N` and `launch.py`, or torchrun's `MASTER_ADDR/MASTER_PORT/
WORLD_SIZE/RANK`) and are 0 and 1 without one. `init()` joins the
process group those variables describe; every helper is the identity at
world size 1, so the same solver code runs in one process.

Backends: `nccl` when CUDA is present and each local rank has a card of
its own (`cuda:local_rank`, made the current device), `gloo` when ranks
share a card or run on the CPU; an explicit `backend` wins. Gloo takes
CUDA tensors for `all_reduce` and `broadcast` only, so host values
(metrics, the tree signature, objects) travel as CPU tensors under gloo
and as CUDA tensors under NCCL, and `all_gather` of CUDA leaves stages
them through the host under gloo.

The data-parallel training step itself is `wrap` (DistributedDataParallel,
`flashy_tpu_torch.parallel.wrap`): its bucketed all-reduce overlaps the
backward. The tree helpers here (`average_tensors`, `sync_gradients`,
`sync_model`) are the manual path, one flat collective per dtype.
`reduce_scatter` and `all_gather` move flat tensors over a group (a
process axis of the mesh: `Mesh.group`), for the FSDP and ZeRO forms of
`wrap` and `parallel.zero`; `all_to_all` exchanges equal row blocks over
a group (the expert-parallel exchange of `parallel.moe_ep`), staged
through the host under gloo with 2-byte floats as their bytes. `send`,
`recv`, `isend` and `irecv` move one tensor between two ranks
(`parallel.pipeline`'s hops between pipe stages): gloo takes CUDA
tensors for neither, so under gloo a CUDA tensor is staged through the
host (a copy to the host, the send, the receive into a host buffer and a
copy back), under NCCL it travels directly.
Every tensor collective and hop goes through `_collective`, which
`parallel.accounting.count_collectives` counts (a hop as the reference's
'collective-permute'), and every wait keeps the process group's timeout,
so a mismatched schedule fails with an error instead of hanging.
"""
import atexit
import contextlib
import datetime
import functools
import logging
import os
import typing as tp
import warnings

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# Above this many bytes `average_tensors` reduces (one all_reduce per
# dtype, O(N) on the wire) where below it gathers every copy (one
# all_gather, the lowest latency for metric-sized trees).
REDUCE_MIN_BYTES = 1 << 20


def _env(*names: str) -> tp.Optional[str]:
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def _launcher_rank_world() -> tp.Optional[tp.Tuple[int, int]]:
    """(rank, world_size) from a complete launcher environment, or None
    (a stray `RANK` without `MASTER_ADDR` and `WORLD_SIZE` does not
    count: it must not make `is_rank_zero()` False on a plain run)."""
    if _env("FLASHY_TPU_COORDINATOR") and _env("FLASHY_TPU_NUM_PROCESSES"):
        return (int(_env("FLASHY_TPU_PROCESS_ID") or 0),
                int(_env("FLASHY_TPU_NUM_PROCESSES") or 1))
    if _env("MASTER_ADDR") and _env("WORLD_SIZE"):
        return int(_env("RANK") or 0), int(_env("WORLD_SIZE") or 1)
    return None


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank: the launcher's, else the process group's (a
    group the caller initialized), else 0."""
    found = _launcher_rank_world()
    if found is not None:
        return found[0]
    return dist.get_rank() if _group_ready() else 0


def world_size() -> int:
    found = _launcher_rank_world()
    if found is not None:
        return found[1]
    return dist.get_world_size() if _group_ready() else 1


def is_rank_zero() -> bool:
    return rank() == 0


def is_distributed() -> bool:
    return world_size() > 1


def local_rank_world() -> tp.Tuple[int, int]:
    """(local rank, processes on this host): torchrun's `LOCAL_RANK` and
    `LOCAL_WORLD_SIZE` (`--workers` sets both), else (0, 1): one process
    a host, as `launch.py` starts them."""
    return (int(_env("LOCAL_RANK") or 0),
            int(_env("LOCAL_WORLD_SIZE") or 1))


def default_backend() -> str:
    """'nccl' when each local rank can have a card of its own, else
    'gloo' (ranks sharing a card, or no card)."""
    _, local_world = local_rank_world()
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _init_method() -> str:
    """The rendezvous: `FLASHY_TPU_COORDINATOR` as `host:port` (TCP) or a
    URL (`tcp://...`, `file:///path`), else torchrun's MASTER_ADDR/
    MASTER_PORT."""
    coordinator = _env("FLASHY_TPU_COORDINATOR")
    if coordinator and _env("FLASHY_TPU_NUM_PROCESSES"):
        return coordinator if "://" in coordinator else f"tcp://{coordinator}"
    return f"tcp://{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or '29500'}"


def init(backend: tp.Optional[str] = None,
         timeout: tp.Optional[float] = None) -> None:
    """Join the process group the launcher environment describes.

    A no-op for one process and when a group exists already (ours or
    the caller's). `backend` defaults to `default_backend()`; under
    NCCL the local rank's card becomes the current device, so 'cuda'
    names it. `timeout` (seconds) bounds every collective's wait.
    """
    if _group_ready():
        return
    found = _launcher_rank_world()
    if found is None or found[1] <= 1:
        return
    rank_, world = found
    backend = backend or default_backend()
    if backend == "nccl":
        torch.cuda.set_device(local_rank_world()[0])
    kwargs = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=_init_method(),
                            world_size=world, rank=rank_, **kwargs)
    atexit.register(_destroy)
    logger.info("torch.distributed initialized: rank %d of %d (%s)",
                rank_, world, backend)


def _destroy() -> None:
    """Leave the process group at exit (a `file://` rendezvous is removed
    once every rank has left)."""
    if _group_ready():
        dist.destroy_process_group()


def _require_backend() -> None:
    """Fail loud when a collective runs before `init()`: the launcher
    says world_size > 1, but no process group exists."""
    if not _group_ready():
        raise RuntimeError(
            f"This run is distributed (world_size={world_size()} from the "
            "launcher environment) but flashy_tpu_torch.distrib.init() was "
            "never called. Call distrib.init() at the start of your entry "
            "point, before any collective.")


def _host_device() -> torch.device:
    """Where host values travel: the CPU under gloo, the current card
    under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _collective_device(tensor: torch.Tensor, op: str) -> torch.device:
    """The device a collective takes `tensor` on: its own, unless the
    backend refuses it there (NCCL: CPU tensors; gloo: CUDA tensors for
    anything but all_reduce and broadcast)."""
    backend = dist.get_backend()
    if backend == "nccl" and tensor.device.type != "cuda":
        return _host_device()
    if backend == "gloo" and tensor.device.type == "cuda" \
            and op not in ("all_reduce", "broadcast"):
        return torch.device("cpu")
    return tensor.device


# the active `parallel.accounting.count_collectives` records: each gets
# every collective's (op, bytes) while it is open
_recorders: tp.List[tp.List[tp.Tuple[str, int]]] = []


def _collective(op: str, nbytes: int, call: tp.Callable[[], tp.Any]) -> tp.Any:
    """Run one collective, `call()`, after noting it in every open
    record: `op` under the JAX package's HLO names ('all-reduce',
    'all-gather', 'reduce-scatter', 'collective-broadcast') and `nbytes`
    the bytes of its output, as `accounting.collective_stats` counts an
    instruction's output shape."""
    for record in _recorders:
        record.append((op, int(nbytes)))
    return call()


@contextlib.contextmanager
def _recording() -> tp.Iterator[tp.List[tp.Tuple[str, int]]]:
    """Open a record of the collectives run inside the block."""
    record: tp.List[tp.Tuple[str, int]] = []
    _recorders.append(record)
    try:
        yield record
    finally:
        _recorders.remove(record)


def _nbytes(tensor: torch.Tensor) -> int:
    return tensor.numel() * tensor.element_size()


def _group_size(group: tp.Any) -> int:
    return dist.get_world_size(group) if group is not None else world_size()


def reduce_scatter(flat: torch.Tensor, group: tp.Any = None) -> torch.Tensor:
    """Sum the 1-D `flat` over the processes of `group` (None: every
    process) and return this process's 1/n of the sum, its contiguous
    slice in group-rank order; `flat.numel()` must divide by n. The
    identity for a group of one. `reduce_scatter_tensor` on every
    backend (gloo has it for host tensors in the torch releases the port
    runs on, 2.11 and 2.13); under gloo a CUDA tensor is staged through
    the host and bf16 and f16 travel as f32."""
    n = _group_size(group)
    if n == 1:
        return flat
    _require_backend()
    if flat.dim() != 1 or flat.numel() % n:
        raise ValueError(f"reduce_scatter takes a flat tensor whose size "
                         f"divides by {n}, got {tuple(flat.shape)}")
    device, dtype = flat.device, flat.dtype
    gloo = dist.get_backend() == "gloo"
    work = (_wide(flat) if gloo else flat).to(
        _collective_device(flat, "reduce_scatter"))
    out = torch.empty(flat.numel() // n, dtype=work.dtype, device=work.device)

    def call() -> None:
        with warnings.catch_warnings():
            # torch 2.13 names reduce_scatter_single its successor, which
            # the card's 2.11 lacks
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, work, group=group)

    _collective("reduce-scatter", _nbytes(out), call)
    return out.to(device, dtype)


def all_gather(flat: torch.Tensor, group: tp.Any = None) -> torch.Tensor:
    """The 1-D `flat` of every process of `group` (None: every process),
    concatenated in group-rank order. The identity for a group of one.
    A CUDA tensor is staged through the host under gloo."""
    n = _group_size(group)
    if n == 1:
        return flat
    _require_backend()
    if flat.dim() != 1:
        raise ValueError(f"all_gather takes a flat tensor, got "
                         f"{tuple(flat.shape)}")
    work = flat.to(_collective_device(flat, "all_gather")).contiguous()
    out = torch.empty(flat.numel() * n, dtype=work.dtype, device=work.device)

    def call() -> None:
        with warnings.catch_warnings():
            # torch 2.13 names all_gather_single its successor, which the
            # card's 2.11 lacks
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, work, group=group)

    _collective("all-gather", _nbytes(out), call)
    return out.to(flat.device)


def all_to_all(tensor: torch.Tensor, group: tp.Any = None) -> torch.Tensor:
    """Block j of `tensor`'s n equal row blocks (dim 0; n the size of
    `group`, None: every process) goes to the group's j-th process; the
    result holds the blocks received, in group-rank order (`tensor`'s
    shape and dtype, on its device). The identity for a group of one.
    `all_to_all_single` on every backend; the exchange moves bits and
    never sums, so under gloo a CUDA tensor is staged through the host
    and a bf16 or f16 tensor travels as its bytes (gloo refuses int16
    and, in some releases, bf16), never widened."""
    n = _group_size(group)
    if n == 1:
        return tensor
    _require_backend()
    if tensor.dim() < 1 or tensor.shape[0] % n:
        raise ValueError(f"all_to_all takes a tensor whose dim 0 splits "
                         f"into {n} blocks, got {tuple(tensor.shape)}")
    work = tensor.to(_collective_device(tensor, "all_to_all")).contiguous()
    as_bytes = dist.get_backend() == "gloo" and work.element_size() == 2 \
        and work.is_floating_point()
    if as_bytes:
        work = work.view(torch.uint8)
    out = torch.empty_like(work)
    _collective("all-to-all", _nbytes(out),
                lambda: dist.all_to_all_single(out, work, group=group))
    if as_bytes:
        out = out.view(tensor.dtype)
    return out.to(tensor.device)


class Pending:
    """A point-to-point op in flight (`isend`, `irecv`): `wait()`
    finishes it under the process group's timeout and returns the
    received tensor on the receiver's device (None for a send)."""

    def __init__(self, work: tp.Any, buffer: tp.Optional[torch.Tensor],
                 device: tp.Optional[torch.device], staged: tp.Any = None):
        self.work = work
        self.buffer = buffer
        self.device = device
        # a send's host copy, kept alive until the send completes
        self.staged = staged

    def wait(self) -> tp.Optional[torch.Tensor]:
        if self.work is not None:
            self.work.wait()
            self.work = None
            self.staged = None
        if self.buffer is None:
            return None
        return self.buffer.to(self.device)


def _p2p_device(tensor_device: torch.device) -> torch.device:
    """Where a hop's bytes travel: the host under gloo, the card under
    NCCL (a CPU tensor goes through the current card there)."""
    if dist.get_backend() == "nccl":
        return _host_device() if tensor_device.type != "cuda" \
            else tensor_device
    return torch.device("cpu")


def isend(tensor: torch.Tensor, dst: int, group: tp.Any = None,
          tag: int = 0) -> Pending:
    """Start sending `tensor` to the global rank `dst` (a member of
    `group`; None: the default group). Under gloo a CUDA tensor is
    copied to the host first. `wait()` the result before the next use
    of the same tag between the same ranks."""
    _require_backend()
    work = tensor.detach().to(_p2p_device(tensor.device)).contiguous()
    handle = _collective("collective-permute", _nbytes(work),
                         lambda: dist.isend(work, dst, group=group, tag=tag))
    return Pending(handle, None, None, staged=work)


def irecv(like: torch.Tensor, src: int, group: tp.Any = None,
          tag: int = 0) -> Pending:
    """Start receiving a tensor of `like`'s shape and dtype from the
    global rank `src`; `wait()` returns it on `like`'s device (under gloo
    received on the host, then copied there)."""
    _require_backend()
    buffer = torch.empty(like.shape, dtype=like.dtype,
                         device=_p2p_device(like.device))
    handle = _collective("collective-permute", _nbytes(buffer),
                         lambda: dist.irecv(buffer, src, group=group,
                                            tag=tag))
    return Pending(handle, buffer, like.device)


def send(tensor: torch.Tensor, dst: int, group: tp.Any = None,
         tag: int = 0) -> None:
    """Send `tensor` to the global rank `dst` and wait for it (`isend`)."""
    isend(tensor, dst, group, tag).wait()


def recv(like: torch.Tensor, src: int, group: tp.Any = None,
         tag: int = 0) -> torch.Tensor:
    """Receive a tensor of `like`'s shape and dtype from the global rank
    `src`, on `like`'s device (`irecv`)."""
    out = irecv(like, src, group, tag).wait()
    assert out is not None
    return out


def broadcast(tensor: torch.Tensor, src: int, group: tp.Any = None
              ) -> torch.Tensor:
    """`tensor` of the global rank `src`, on every rank of `group` (a new
    tensor on the caller's device; the identity for a group of one)."""
    if _group_size(group) == 1:
        return tensor
    _require_backend()
    work = tensor.detach().to(_collective_device(tensor, "broadcast"),
                              copy=True).contiguous()
    _collective("collective-broadcast", _nbytes(work),
                lambda: dist.broadcast(work, src=src, group=group))
    return work.to(tensor.device)


def rank_zero_only(fn: tp.Callable) -> tp.Callable:
    """Run `fn` on rank zero only; other ranks get None. Wrap host-side
    IO only, never a collective (the other ranks would wait for ever)."""

    @functools.wraps(fn)
    def wrapped(*args: tp.Any, **kwargs: tp.Any) -> tp.Optional[tp.Any]:
        if is_rank_zero():
            return fn(*args, **kwargs)
        return None

    return wrapped


def _flatten(tree: tp.Any) -> tp.Tuple[tp.List[tp.Any], tp.Callable]:
    """The leaves of dicts (a `state_dict` among them), lists and tuples,
    in order, and a function rebuilding the tree from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[key]) for key in keys]

        def rebuild(leaves):
            out, offset = type(tree)(), 0
            for key, (sub, unflat) in zip(keys, parts):
                out[key] = unflat(leaves[offset:offset + len(sub)])
                offset += len(sub)
            return out
        return [leaf for sub, _ in parts for leaf in sub], rebuild
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        parts = [_flatten(item) for item in tree]

        def rebuild(leaves):
            out, offset = [], 0
            for sub, unflat in parts:
                out.append(unflat(leaves[offset:offset + len(sub)]))
                offset += len(sub)
            return type(tree)(out)
        return [leaf for sub, _ in parts for leaf in sub], rebuild
    return [tree], lambda leaves: leaves[0]


def _is_float(leaf: tp.Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() or leaf.is_complex()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.issubdtype(leaf.dtype, np.floating) \
            or np.issubdtype(leaf.dtype, np.complexfloating)
    return False


def _as_tensor(leaf: tp.Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf))


def _like(value: torch.Tensor, leaf: tp.Any) -> tp.Any:
    """`value` in `leaf`'s kind: a tensor on its device and dtype, or a
    numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return value.to(leaf.device, leaf.dtype).reshape(leaf.shape)
    out = value.cpu().numpy().astype(np.asarray(leaf).dtype, copy=False)
    return out.reshape(np.shape(leaf))


def _check_tree_sizes(tree: tp.Any) -> None:
    """Anti-deadlock guard: every process must bring the same tree.

    All-gathers the leaf count and element count before any tensor
    collective, so a structure mismatch raises a RuntimeError on every
    rank instead of hanging the group (a list or dict of tensors, or a
    `state_dict`)."""
    if not is_distributed():
        return
    _require_backend()
    leaves, _ = _flatten(tree)
    signature = torch.tensor(
        [len(leaves), sum(int(np.prod(np.shape(leaf))) for leaf in leaves)],
        dtype=torch.int64, device=_host_device())
    gathered = [torch.empty_like(signature) for _ in range(world_size())]
    _collective("all-gather", _nbytes(signature) * world_size(),
                lambda: dist.all_gather(gathered, signature))
    table = torch.stack(gathered).cpu()
    if not bool((table == signature.cpu()[None]).all()):
        raise RuntimeError(
            f"Mismatch in synced tree across processes: ours has "
            f"{int(signature[0])} leaves / {int(signature[1])} elements, "
            f"gathered {table.tolist()}.")


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(value: tp.Any, op: str = "sum", group: tp.Any = None
               ) -> tp.Any:
    """Reduce a tensor, numpy array or number over the processes of
    `group` (None: all of them) and return the result (a new value, as
    the JAX package returns one; torch's in-place `all_reduce` is not
    exposed); the identity for one process. `op`: 'sum', 'mean', 'max'
    or 'min'."""
    if op not in _OPS:
        raise ValueError(f"Unsupported reduce op: {op}")
    if not is_distributed() or _group_size(group) == 1:
        return value
    _require_backend()
    tensor = _as_tensor(value)
    work = tensor.to(_collective_device(tensor, "all_reduce"), copy=True)
    _collective("all-reduce", _nbytes(work),
                lambda: dist.all_reduce(work, op=_OPS[op], group=group))
    if op == "mean":
        work = (work if work.is_floating_point() else work.double()) \
            / _group_size(group)
    if isinstance(value, torch.Tensor):
        return work.to(value.device)
    out = work.cpu().numpy()
    return out[()] if out.ndim == 0 else out


def all_reduce_max(value: int) -> int:
    """The largest `value` over the processes (every rank must call it
    at the same point): the value itself at world size 1."""
    if not is_distributed():
        return value
    return int(all_reduce(np.int64(value), "max"))


def average_metrics(metrics: tp.Dict[str, float],
                    count: float = 1.0) -> tp.Dict[str, float]:
    """Average a dict of metrics across processes, weighted by `count`:
    one collective moves `[v * count for v in values] + [count]`, and
    the weighted mean is the ratio. The identity at world size 1."""
    if not is_distributed():
        return metrics
    keys = list(metrics)
    vector = np.array([float(metrics[key]) for key in keys] + [1.0],
                      dtype=np.float64) * count
    total = all_reduce(vector, "sum")
    return dict(zip(keys, (total[:-1] / total[-1]).tolist()))


def _by_dtype(tensors: tp.Sequence[torch.Tensor]
              ) -> tp.Dict[tp.Tuple[torch.dtype, torch.device], tp.List[int]]:
    groups: tp.Dict[tp.Tuple[torch.dtype, torch.device], tp.List[int]] = {}
    for index, tensor in enumerate(tensors):
        groups.setdefault((tensor.dtype, tensor.device), []).append(index)
    return groups


def _wide(flat: torch.Tensor) -> torch.Tensor:
    """bf16 and f16 travel and sum as f32: not every backend reduces
    them, and the mean rounds to their dtype once, at the end."""
    if flat.dtype in (torch.bfloat16, torch.float16):
        return flat.float()
    return flat


def _reduce_mean(tensors: tp.List[torch.Tensor]) -> tp.List[torch.Tensor]:
    """The mean of each tensor over the processes: one flat all_reduce
    per (dtype, device), the sum divided by the world size."""
    out: tp.List[tp.Optional[torch.Tensor]] = [None] * len(tensors)
    for (dtype, device), indices in _by_dtype(tensors).items():
        flat = torch.cat([tensors[i].reshape(-1) for i in indices])
        work = _wide(flat).to(_collective_device(flat, "all_reduce"))
        _collective("all-reduce", _nbytes(work),
                    lambda: dist.all_reduce(work, op=dist.ReduceOp.SUM))
        work = (work / world_size()).to(device, dtype)
        offset = 0
        for i in indices:
            size = tensors[i].numel()
            out[i] = work[offset:offset + size].reshape(tensors[i].shape)
            offset += size
    return tp.cast(tp.List[torch.Tensor], out)


def _gather_mean(tensors: tp.List[torch.Tensor]) -> tp.List[torch.Tensor]:
    """The mean of each tensor over the processes from every copy: one
    flat all_gather per (dtype, device), staged through the host where
    the backend takes no CUDA all_gather (gloo)."""
    out: tp.List[tp.Optional[torch.Tensor]] = [None] * len(tensors)
    for (dtype, device), indices in _by_dtype(tensors).items():
        flat = torch.cat([tensors[i].reshape(-1) for i in indices])
        work = _wide(flat).to(_collective_device(flat, "all_gather"))
        gathered = [torch.empty_like(work) for _ in range(world_size())]
        _collective("all-gather", _nbytes(work) * world_size(),
                    lambda: dist.all_gather(gathered, work))
        mean = torch.stack(gathered).mean(dim=0).to(device, dtype)
        offset = 0
        for i in indices:
            size = tensors[i].numel()
            out[i] = mean[offset:offset + size].reshape(tensors[i].shape)
            offset += size
    return tp.cast(tp.List[torch.Tensor], out)


def _partition_floats(tree: tp.Any):
    """The float leaves as tensors, and what puts new ones back."""
    leaves, rebuild = _flatten(tree)
    mask = [_is_float(leaf) for leaf in leaves]
    floats = [_as_tensor(leaf) for leaf, is_float in zip(leaves, mask)
              if is_float]

    def combine(new_floats: tp.Sequence[torch.Tensor]) -> tp.Any:
        new = iter(new_floats)
        return rebuild([_like(next(new), leaf) if is_float else leaf
                        for leaf, is_float in zip(leaves, mask)])

    return floats, combine


def average_tensors(tree: tp.Any, *, method: str = "auto") -> tp.Any:
    """The mean of every float leaf across processes; returns a new tree
    (tensors stay on their devices, numpy leaves stay numpy). Non-float
    leaves (step counters, int buffers) pass through untouched.

    `method`: 'allgather' (every process receives all copies: the
    lowest latency for small metric trees), 'reduce' (one all_reduce
    per dtype, O(N) bytes on the wire: model-sized trees), or 'auto'
    (reduce from REDUCE_MIN_BYTES on). The identity at world size 1.
    """
    if not is_distributed():
        return tree
    if method not in ("auto", "reduce", "allgather"):
        raise ValueError(f"unknown method {method!r}")
    floats, combine = _partition_floats(tree)
    _check_tree_sizes(floats)
    total = sum(leaf.numel() * leaf.element_size() for leaf in floats)
    _note_host_sync(total)
    if method == "auto":
        method = "reduce" if total >= REDUCE_MIN_BYTES else "allgather"
    averaged = _reduce_mean(floats) if method == "reduce" \
        else _gather_mean(floats)
    return combine(averaged)


_host_sync_big_calls = 0


def _note_host_sync(total_bytes: int) -> None:
    """Warn once, on the third call that moves a tree of at least
    REDUCE_MIN_BYTES: a model-sized tree through here every step is the
    manual sync that DistributedDataParallel does better."""
    global _host_sync_big_calls
    if total_bytes < REDUCE_MIN_BYTES:
        return
    _host_sync_big_calls += 1
    if _host_sync_big_calls == 3:
        logger.warning(
            "average_tensors has now moved a >%d-byte tree %d times; if "
            "this is a per-step gradient/model sync, switch to "
            "DistributedDataParallel (distrib.wrap / parallel.wrap), whose "
            "bucketed all-reduce overlaps the backward.",
            REDUCE_MIN_BYTES, _host_sync_big_calls)


def broadcast_tensors(tree: tp.Any, src: int = 0) -> tp.Any:
    """Broadcast the float leaves of `tree` from process `src` (one flat
    broadcast per dtype); returns a new tree. Makes sure every worker
    starts from the same init."""
    if not is_distributed():
        return tree
    _require_backend()
    floats, combine = _partition_floats(tree)
    _check_tree_sizes(floats)
    out: tp.List[tp.Optional[torch.Tensor]] = [None] * len(floats)
    for (_, device), indices in _by_dtype(floats).items():
        flat = torch.cat([floats[i].reshape(-1) for i in indices])
        work = flat.to(_collective_device(flat, "broadcast"))
        _collective("collective-broadcast", _nbytes(work),
                    lambda: dist.broadcast(work, src=src))
        work = work.to(device)
        offset = 0
        for i in indices:
            size = floats[i].numel()
            out[i] = work[offset:offset + size].reshape(floats[i].shape)
            offset += size
    return combine(tp.cast(tp.List[torch.Tensor], out))


def _module_tensors(module: torch.nn.Module, buffers: bool = True
                    ) -> tp.List[torch.Tensor]:
    tensors = [p.data for p in module.parameters()]
    if buffers:
        tensors += [b for b in module.buffers()]
    return tensors


def _copy_into(targets: tp.Sequence[torch.Tensor],
               values: tp.Sequence[torch.Tensor]) -> None:
    with torch.no_grad():
        for target, value in zip(targets, values):
            target.copy_(value)


def broadcast_model(model: tp.Any, src: int = 0) -> tp.Any:
    """Broadcast a model from process `src`: an `nn.Module`'s parameters
    and buffers in place (returns the module), or a parameter tree
    (returns the new tree)."""
    if not isinstance(model, torch.nn.Module):
        return broadcast_tensors(model, src)
    if is_distributed():
        tensors = _module_tensors(model)
        _copy_into(tensors, broadcast_tensors(tensors, src))
    return model


def sync_gradients(grads: tp.Any) -> tp.Any:
    """Average gradients across processes, the manual alternative to
    `wrap`: an `nn.Module` has every `.grad` averaged in place and is
    returned; a gradient tree gives a new averaged tree."""
    if isinstance(grads, torch.nn.Module):
        if is_distributed():
            tensors = [p.grad for p in grads.parameters()
                       if p.grad is not None]
            _copy_into(tensors, average_tensors(tensors))
        return grads
    return average_tensors(grads)


def sync_model(params: tp.Any, batch_stats: tp.Any = None, *,
               average_buffers: bool = True) -> tp.Any:
    """Average a model across processes. An `nn.Module`: its parameters
    averaged in place, its buffers averaged or, with
    `average_buffers=False`, broadcast from process 0 (DDP's behavior);
    returns the module. Trees: `params` averaged and, given
    `batch_stats`, the buffers too; returns `params` or `(params,
    batch_stats)`."""
    if isinstance(params, torch.nn.Module):
        if is_distributed():
            weights = _module_tensors(params, buffers=False)
            _copy_into(weights, average_tensors(weights))
            buffers = list(params.buffers())
            if buffers:
                _copy_into(buffers, average_tensors(buffers)
                           if average_buffers else broadcast_tensors(buffers))
        return params
    params = average_tensors(params)
    if batch_stats is None:
        return params
    if average_buffers:
        batch_stats = average_tensors(batch_stats)
    else:
        batch_stats = broadcast_tensors(batch_stats)
    return params, batch_stats


def eager_sync_gradients(grads: tp.Any) -> tp.Any:
    """The reference's eager variant starts its all-reduces from backward
    hooks; DistributedDataParallel (`wrap`) is that overlap in PyTorch,
    so this is `sync_gradients`."""
    return sync_gradients(grads)


def eager_sync_model(params: tp.Any, batch_stats: tp.Any = None, *,
                     average_buffers: bool = True) -> tp.Any:
    """`sync_model` under the reference's eager name; see
    `eager_sync_gradients`."""
    return sync_model(params, batch_stats, average_buffers=average_buffers)


def broadcast_object(obj: tp.Any = None, src: int = 0) -> tp.Any:
    """Share any picklable object from process `src` with every process
    (`broadcast_object_list`); the object itself at world size 1."""
    if not is_distributed():
        return obj
    _require_backend()
    box = [obj if rank() == src else None]
    device = _host_device() if dist.get_backend() == "nccl" else None
    dist.broadcast_object_list(box, src=src, device=device)
    return box[0]


def barrier(name: str = "flashy_tpu_barrier") -> None:
    """Block until every process reaches this point (`name` is kept for
    the JAX package's signature)."""
    del name
    if is_distributed():
        _require_backend()
        dist.barrier()


def loader(dataset, *args, shuffle: bool = False, klass=None, **kwargs):
    """A data loader sharded over the processes: training
    (`shuffle=True`) an epoch-seeded shuffling sampler padded to equal
    shards, eval a strided shard with no sample repeated (or, with
    `pad_to_even=True`, equal step counts with `(batch, valid_mask)`
    pairs). See `flashy_tpu_torch.data.DataLoader`."""
    from .data import DataLoader
    klass = klass or DataLoader
    return klass(dataset, *args, shuffle=shuffle,
                 num_shards=world_size(), shard_index=rank(), **kwargs)


def wrap(model=None, **kwargs):
    """The DDP role: `flashy_tpu_torch.parallel.wrap` (a
    DistributedDataParallel module above one rank, the model itself at
    one)."""
    from .parallel.data_parallel import wrap as _wrap
    return _wrap(model, **kwargs)
