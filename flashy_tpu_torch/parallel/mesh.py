"""Device meshes: the port of flashy_tpu/parallel/mesh.py.

One mesh with named axes describes every parallelism dimension, as in the
JAX package:

  'data'   - batch (data parallel)
  'fsdp'   - batch + parameter sharding
  'expert' - expert parallelism (MoE)
  'pipe'   - pipeline stages
  'tensor' - intra-layer model parallelism
  'seq'    - sequence parallelism (ring attention)

The port's mesh is a small record: the six axis sizes and the devices of
this process's ranks. `data` and `fsdp` are the process axes: `data x
fsdp` processes make the world (`distrib.world_size()`), and process `r`
sits at `(data, fsdp) = (r // fsdp, r % fsdp)`, the JAX package's
(data, fsdp, ...) order, so a global batch splits over both axes as
`batch_spec` says (each process takes its contiguous rows). `coord(axis)`
is the process's index on an axis and `group(axis)` the
`torch.distributed` group of the processes that differ only there (one
group per axis, built on every process in the same order, cached).
`devices` names the device of each of this process's ranks on the axes
inside a process (`seq`: the ranks of a ring share the process's card),
in AXES order; a device may repeat. `devices=None` records no device, and
every rank then runs on the device of the tensors it is given.
`make_mesh({"data": -1})` takes the world. What runs today: the process
axes (`--workers`, `parallel.wrap`, its FSDP and ZeRO forms) composed
with a `seq` ring inside each process (`parallel.ring`). A process axis
that differs from the world inside one process, a mesh whose ranks name
two devices, and `tensor`, `pipe` or `expert` above 1 raise
NotImplementedError naming the ROADMAP item that brings them.
"""
import dataclasses
import math
import typing as tp

import torch

from .. import distrib

AXES = ("data", "fsdp", "expert", "pipe", "tensor", "seq")

# Where each part the port does not have yet is scheduled (ROADMAP.md).
TODO_DATA_PARALLEL = ("ROADMAP.md queue A item 5: data and fsdp ranks "
                      "are processes; launch them with --workers=N (or "
                      "launch.py / torchrun)")
TODO_AXES = {"tensor": "ROADMAP.md queue A item 8b (tensor parallelism)",
             "pipe": "ROADMAP.md queue A item 8c (pipeline parallelism)",
             "expert": "ROADMAP.md queue A item 8d (expert parallelism)"}
TODO_DEVICES = ("ROADMAP.md queue A items 5 and 8d (ranks on several "
                "cards: a process a card over the process axes, item 5; "
                "the ring's ranks on several processes or cards, item 8d)")
PROCESS_AXES = ("data", "fsdp")

# (sizes, axis) -> the torch.distributed group of that process axis
_groups: tp.Dict[tp.Tuple[tp.Tuple[int, ...], str], tp.Any] = {}

_default_mesh: tp.Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (`shape`, every axis of AXES; `data` and `fsdp` count
    processes) and this process's ranks' devices (one per rank of the
    axes inside a process, in AXES order; None: the caller's device)."""
    shape: tp.Mapping[str, int]
    devices: tp.Optional[tp.Tuple[torch.device, ...]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def device(self, like: torch.Tensor) -> torch.device:
        """The device every rank runs on: the mesh's, or `like`'s where
        the mesh names none."""
        return like.device if self.devices is None else self.devices[0]

    @property
    def processes(self) -> int:
        """How many processes the mesh spans (`data x fsdp`)."""
        return self.shape["data"] * self.shape["fsdp"]

    def coord(self, axis: str) -> int:
        """This process's index on `axis`: `(rank // fsdp, rank % fsdp)`
        on the process axes, 0 on an axis of size 1."""
        if self.shape[axis] == 1:
            return 0
        if axis not in PROCESS_AXES:
            raise NotImplementedError(
                f"axis {axis}={self.shape[axis]} has no per-process index: "
                f"its ranks live inside a process")
        rank = distrib.rank()
        return rank // self.shape["fsdp"] if axis == "data" \
            else rank % self.shape["fsdp"]

    def group_ranks(self, axis: str) -> tp.Tuple[tp.Tuple[int, ...], ...]:
        """Every group of the process axis `axis`: the process ranks that
        differ only in their index on it."""
        data, fsdp = self.shape["data"], self.shape["fsdp"]
        if axis == "data":
            return tuple(tuple(d * fsdp + f for d in range(data))
                         for f in range(fsdp))
        if axis == "fsdp":
            return tuple(tuple(d * fsdp + f for f in range(fsdp))
                         for d in range(data))
        raise ValueError(f"{axis!r} is not a process axis {PROCESS_AXES}")

    def group(self, axis: str) -> tp.Any:
        """The `torch.distributed` group of this process's `axis` (None,
        the default group, when the axis spans the world). Every process
        builds every group of the axis, in the same order, on its first
        call (`new_group` is collective): call it on every process."""
        groups = self.group_ranks(axis)
        if len(groups[0]) == distrib.world_size():
            return None
        key = (tuple(self.shape[a] for a in AXES), axis)
        if key not in _groups:
            import torch.distributed as dist
            _groups[key] = [dist.new_group(list(ranks)) for ranks in groups]
        rank = distrib.rank()
        index = next(i for i, ranks in enumerate(groups) if rank in ranks)
        return _groups[key][index]


def _device(device: tp.Any) -> torch.device:
    """`device` as a torch.device with its index: a bare 'cuda' is the
    current card, so that 'cuda' and 'cuda:0' name one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_shape_from_devices(n_devices: int,
                            tensor: int = 1, seq: int = 1,
                            fsdp: int = 1, expert: int = 1,
                            pipe: int = 1) -> tp.Dict[str, int]:
    """Fill the 'data' axis with whatever devices the others don't use."""
    used = tensor * seq * fsdp * expert * pipe
    if n_devices % used:
        raise ValueError(
            f"{n_devices} devices not divisible by "
            f"tensor*seq*fsdp*expert*pipe={used}")
    return {"data": n_devices // used, "fsdp": fsdp, "expert": expert,
            "pipe": pipe, "tensor": tensor, "seq": seq}


def make_mesh(shape: tp.Optional[tp.Mapping[str, int]] = None,
              devices: tp.Optional[tp.Sequence[tp.Any]] = None) -> Mesh:
    """Build a mesh over `devices`, this process's ranks (default: every
    rank on the caller's device).

    `shape` maps axis name -> size; missing axes get size 1, and a single
    axis size may be -1: it takes the devices the others leave, counting
    `distrib.world_size()` processes of `devices` each (of one rank per
    rank of the axes inside a process when `devices` is None). Default:
    everything on 'data'. The JAX package's errors come first (unknown
    axes, two -1s); then process axes whose product is not the world
    size (NotImplementedError in one process: their ranks are
    processes), a shape that does not cover the devices, and what the
    port cannot run yet (NotImplementedError).
    """
    shape = dict(shape or {"data": -1})
    sizes = {axis: int(shape.get(axis, 1)) for axis in AXES}
    unknown = [axis for axis in shape if axis not in AXES]
    if unknown:
        raise ValueError(f"Unknown mesh axes {unknown}; valid: {AXES}")
    inferred = [axis for axis, size in sizes.items() if size == -1]
    if len(inferred) > 1:
        raise ValueError("At most one mesh axis may be -1")
    world = distrib.world_size()
    known = math.prod(size for size in sizes.values() if size != -1)
    if devices is not None:
        devices = tuple(_device(d) for d in devices)
        count = world * len(devices)
    else:
        count = world * math.prod(size for axis, size in sizes.items()
                                  if axis not in PROCESS_AXES and size != -1)
    if inferred:
        sizes[inferred[0]] = count // known
    processes = sizes["data"] * sizes["fsdp"]
    if processes != world:
        if world == 1:
            raise NotImplementedError(
                f"mesh axes data={sizes['data']} x fsdp={sizes['fsdp']} "
                f"inside one process: {TODO_DATA_PARALLEL}")
        raise ValueError(f"mesh axes data={sizes['data']} x "
                         f"fsdp={sizes['fsdp']} must make the world size "
                         f"{world}: their ranks are processes")
    if math.prod(sizes.values()) != count:
        raise ValueError(f"Mesh shape {sizes} does not cover {count} devices")
    for axis, todo in TODO_AXES.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={sizes[axis]} is not ported yet: {todo}")
    if devices is not None and len(set(devices)) > 1:
        raise NotImplementedError(
            f"the mesh's ranks span {len(set(devices))} devices "
            f"({', '.join(sorted(map(str, set(devices))))}); a process's "
            f"ranks share one device today: {TODO_DEVICES}")
    return Mesh(sizes, devices)


def set_default_mesh(mesh: tp.Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def default_mesh() -> Mesh:
    """The process-global mesh; lazily a pure data-parallel one (a rank a
    process, each on the caller's device)."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh({"data": -1})
    return _default_mesh
