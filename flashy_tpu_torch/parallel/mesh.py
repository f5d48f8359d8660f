"""Device meshes: the port of flashy_tpu/parallel/mesh.py.

One mesh with named axes describes every parallelism dimension, as in the
JAX package:

  'data'   - batch (data parallel)
  'fsdp'   - batch + parameter sharding
  'expert' - expert parallelism (MoE)
  'pipe'   - pipeline stages
  'tensor' - intra-layer model parallelism (Megatron column/row splits)
  'seq'    - sequence parallelism (ring attention)

The port's mesh is a small record: the six axis sizes and the devices of
this process's ranks. `data`, `fsdp`, `expert`, `pipe` and `tensor` are
the process axes: `data x fsdp x expert x pipe x tensor` processes make
the world (`distrib.world_size()`), and process `r` sits at `data = r //
(fsdp * expert * pipe * tensor)`, `fsdp = r // (expert * pipe * tensor) %
fsdp`, `expert = r // (pipe * tensor) % expert`, `pipe = r // tensor %
pipe`, `tensor = r % tensor`: the JAX package's AXES order, with `tensor`
innermost, so a tensor group is a run of adjacent ranks (Megatron's
placement), every layout at `expert=1` and `pipe=1` is the one without
the axis, and a global batch splits over `data` and `fsdp` as
`batch_spec` says (each data-parallel process takes its contiguous rows;
the ranks of an expert, tensor or pipe group take the same rows; an
expert group's MoE layers then cut those rows among themselves,
`parallel.moe_ep`). `coord(axis)` is the process's index on an axis,
`group(axis)` the `torch.distributed` group of the processes that differ
only there (or only on the axes of a tuple; one group per axis, built on
every process in the same order, cached), and `pipe_peers()` the global
ranks of a pipe stage's ring neighbours (`parallel.pipeline` sends
activations to the next stage and cotangents to the previous one, the
last stage wrapping to stage 0). `devices` names the device of each of
this process's ranks on the axes inside a process (`seq`: the ranks of a
ring share the process's card), in AXES order; a device may repeat.
`devices=None` records no device, and every rank then runs on the device
of the tensors it is given. `make_mesh({"data": -1})` takes the world.
What runs today: the process axes (`--workers`, `parallel.wrap`, its
FSDP, ZeRO, expert-parallel, tensor-parallel and pipeline forms) composed
with a `seq` ring inside each process (`parallel.ring`). Process axes
that differ from the world inside one process, a mesh whose ranks name
two devices, `seq` above 1 together with `tensor` above 1, and `expert`
above 1 together with `fsdp`, `pipe` or `seq` above 1 raise
NotImplementedError naming the ROADMAP item that brings them.
"""
import dataclasses
import itertools
import math
import typing as tp

import torch

from .. import distrib

AXES = ("data", "fsdp", "expert", "pipe", "tensor", "seq")

# Where each part the port does not have yet is scheduled (ROADMAP.md).
TODO_DATA_PARALLEL = ("ROADMAP.md queue A item 5: data, fsdp, expert, "
                      "pipe and tensor ranks are processes; launch them "
                      "with --workers=N "
                      "(or launch.py / torchrun)")
TODO_SEQ_TENSOR = ("ROADMAP.md queue A item 8g (the ring's ranks across "
                   "processes: seq composed with tensor)")
TODO_DEVICES = ("ROADMAP.md queue A items 5 and 8g (ranks on several "
                "cards: a process a card over the process axes, item 5; "
                "the ring's ranks on several processes or cards, item 8g)")
TODO_EXPERT_COMPOSED = ("ROADMAP.md queue A item 8f (expert composed with "
                        "fsdp, ZeRO-1, pipe or seq)")
PROCESS_AXES = ("data", "fsdp", "expert", "pipe", "tensor")
# the processes that hold different rows of a batch
DATA_PARALLEL_AXES = ("data", "fsdp")

# (sizes, axes) -> the torch.distributed groups of those process axes
_groups: tp.Dict[tp.Tuple[tp.Tuple[int, ...], tp.Tuple[str, ...]],
                 tp.Any] = {}

_default_mesh: tp.Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (`shape`, every axis of AXES; `data`, `fsdp`, `expert`,
    `pipe` and `tensor` count processes) and this process's ranks'
    devices (one per rank of the axes inside a process, in AXES order;
    None: the caller's device)."""
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
        """How many processes the mesh spans (`data x fsdp x expert x pipe
        x tensor`)."""
        return math.prod(self.shape[axis] for axis in PROCESS_AXES)

    @property
    def data_parallel_size(self) -> int:
        """How many processes hold different rows of a batch (`data x
        fsdp`): the count gradients are averaged over."""
        return math.prod(self.shape[axis] for axis in DATA_PARALLEL_AXES)

    def data_parallel_index(self) -> int:
        """This process's index among the `data x fsdp` row holders (the
        ranks of an expert, tensor or pipe group share it)."""
        return self.coord("data") * self.shape["fsdp"] + self.coord("fsdp")

    def _stride(self, axis: str) -> int:
        return math.prod(self.shape[other] for other in
                         PROCESS_AXES[PROCESS_AXES.index(axis) + 1:])

    def coord(self, axis: str) -> int:
        """This process's index on `axis` (`data = rank // (fsdp * expert
        * pipe * tensor)`, ..., `pipe = (rank // tensor) % pipe`, `tensor
        = rank % tensor`), 0 on an axis of size 1."""
        if self.shape[axis] == 1:
            return 0
        if axis not in PROCESS_AXES:
            raise NotImplementedError(
                f"axis {axis}={self.shape[axis]} has no per-process index: "
                f"its ranks live inside a process")
        return distrib.rank() // self._stride(axis) % self.shape[axis]

    def group_ranks(self, axes: tp.Union[str, tp.Sequence[str]]
                    ) -> tp.Tuple[tp.Tuple[int, ...], ...]:
        """Every group of the process axis `axes` (or of a tuple of
        them): the process ranks that differ only in their indices there,
        each group in rank order (the first axis outermost), the groups
        in the order of the other axes' indices."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = [axis for axis in axes if axis not in PROCESS_AXES]
        if bad:
            raise ValueError(f"{bad[0]!r} is not a process axis "
                             f"{PROCESS_AXES}")
        others = [axis for axis in PROCESS_AXES if axis not in axes]
        ordered = [axis for axis in PROCESS_AXES if axis in axes]
        groups = []
        for rest in itertools.product(*(range(self.shape[a])
                                        for a in others)):
            base = sum(i * self._stride(a) for a, i in zip(others, rest))
            groups.append(tuple(
                base + sum(i * self._stride(a) for a, i in zip(ordered, own))
                for own in itertools.product(*(range(self.shape[a])
                                               for a in ordered))))
        return tuple(groups)

    def group(self, axes: tp.Union[str, tp.Sequence[str]]) -> tp.Any:
        """The `torch.distributed` group of this process's `axes` (None,
        the default group, when they span the world). Every process
        builds every group of the axes, in the same order, on its first
        call (`new_group` is collective): call it on every process."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        groups = self.group_ranks(axes)
        if len(groups[0]) == distrib.world_size():
            return None
        key = (tuple(self.shape[a] for a in AXES), axes)
        if key not in _groups:
            import torch.distributed as dist
            _groups[key] = [dist.new_group(list(ranks)) for ranks in groups]
        rank = distrib.rank()
        index = next(i for i, ranks in enumerate(groups) if rank in ranks)
        return _groups[key][index]

    def pipe_peers(self) -> tp.Tuple[int, int]:
        """The global ranks of this process's pipe-ring neighbours: (the
        next stage, which its activations go to, the previous stage,
        which its cotangents go to), wrapping around the ring (equal at
        pipe=2)."""
        ranks = next(group for group in self.group_ranks("pipe")
                     if distrib.rank() in group)
        stage, stages = self.coord("pipe"), self.shape["pipe"]
        return ranks[(stage + 1) % stages], ranks[(stage - 1) % stages]


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
    axes, two -1s); then `seq` with `tensor` (NotImplementedError, item
    8g) and `expert` with `fsdp`, `pipe` or `seq` (NotImplementedError,
    item 8f), process axes whose product is not the world size
    (NotImplementedError in one process: their ranks are processes), a
    shape that does not cover the devices, and ranks on several devices
    (NotImplementedError).
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
    if sizes["seq"] > 1 and sizes["tensor"] > 1:
        raise NotImplementedError(
            f"mesh axes seq={sizes['seq']} and tensor={sizes['tensor']} "
            f"together are not ported yet: {TODO_SEQ_TENSOR}")
    composed = [f"{axis}={sizes[axis]}" for axis in ("fsdp", "pipe", "seq")
                if sizes[axis] > 1]
    if sizes["expert"] > 1 and composed:
        raise NotImplementedError(
            f"mesh axis expert={sizes['expert']} with {', '.join(composed)} "
            f"is not ported yet: {TODO_EXPERT_COMPOSED}")
    processes = math.prod(sizes[axis] for axis in PROCESS_AXES)
    named = " x ".join(f"{axis}={sizes[axis]}" for axis in PROCESS_AXES)
    if processes != world:
        if world == 1:
            raise NotImplementedError(
                f"mesh axes {named} inside one process: "
                f"{TODO_DATA_PARALLEL}")
        raise ValueError(f"mesh axes {named} must make the world size "
                         f"{world}: their ranks are processes")
    if math.prod(sizes.values()) != count:
        raise ValueError(f"Mesh shape {sizes} does not cover {count} devices")
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
