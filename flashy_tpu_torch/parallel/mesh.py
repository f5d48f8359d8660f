"""Device meshes: the port of flashy_tpu/parallel/mesh.py.

One mesh with named axes describes every parallelism dimension, as in the
JAX package:

  'data'   - batch (data parallel)
  'fsdp'   - batch + parameter sharding
  'expert' - expert parallelism (MoE)
  'pipe'   - pipeline stages
  'tensor' - intra-layer model parallelism
  'seq'    - sequence parallelism (ring attention)

The port's mesh is a small record: the six axis sizes and one
`torch.device` per rank, in the JAX package's (data, fsdp, expert, pipe,
tensor, seq) order. A device may repeat: that is how several ranks share
one card. `devices=None` records no device, and every rank then runs on
the device of the tensors it is given. What runs today is a `seq` ring
whose ranks all live on one device (`parallel.ring`); a mesh whose ranks
name two devices, or any axis other than `seq` above 1, raises
NotImplementedError naming the ROADMAP item that brings it.
"""
import dataclasses
import math
import typing as tp

import torch

AXES = ("data", "fsdp", "expert", "pipe", "tensor", "seq")

# Where each part the port does not have yet is scheduled (ROADMAP.md).
TODO_DATA_PARALLEL = "ROADMAP.md queue A item 5 (data parallelism)"
TODO_MESH = "ROADMAP.md queue A item 8 (parallelism beyond data)"
TODO_DEVICES = ("ROADMAP.md queue A items 5 and 8 (ranks on several "
                "cards: a process group or peer pointers)")

_default_mesh: tp.Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (`shape`, every axis of AXES) and the ranks' devices
    (one per rank in AXES order; None: the caller's device)."""
    shape: tp.Mapping[str, int]
    devices: tp.Optional[tp.Tuple[torch.device, ...]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def device(self, like: torch.Tensor) -> torch.device:
        """The device every rank runs on: the mesh's, or `like`'s where
        the mesh names none."""
        return like.device if self.devices is None else self.devices[0]


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
    """Build a mesh over `devices`, one per rank (default: every rank on
    the caller's device).

    `shape` maps axis name -> size; missing axes get size 1, and a single
    axis size may be -1: it takes the devices the others leave, or 1 when
    `devices` is None. Default: everything on 'data'. The JAX package's
    errors come first (unknown axes, two -1s, a shape that does not cover
    the devices); then what the port cannot run yet raises
    NotImplementedError.
    """
    shape = dict(shape or {})
    sizes = {axis: int(shape.get(axis, 1)) for axis in AXES}
    unknown = [axis for axis in shape if axis not in AXES]
    if unknown:
        raise ValueError(f"Unknown mesh axes {unknown}; valid: {AXES}")
    inferred = [axis for axis, size in sizes.items() if size == -1]
    if len(inferred) > 1:
        raise ValueError("At most one mesh axis may be -1")
    known = math.prod(size for size in sizes.values() if size != -1)
    if devices is not None:
        devices = tuple(_device(d) for d in devices)
    count = known if devices is None else len(devices)
    if inferred:
        sizes[inferred[0]] = count // known
    if math.prod(sizes.values()) != count:
        raise ValueError(f"Mesh shape {sizes} does not cover {count} devices")
    for axis, size in sizes.items():
        if axis != "seq" and size > 1:
            todo = TODO_DATA_PARALLEL if axis == "data" else TODO_MESH
            raise NotImplementedError(
                f"mesh axis {axis}={size} is not ported yet: {todo}")
    if devices is not None and len(set(devices)) > 1:
        raise NotImplementedError(
            f"the mesh's ranks span {len(set(devices))} devices "
            f"({', '.join(sorted(map(str, set(devices))))}); ranks share "
            f"one device today: {TODO_DEVICES}")
    return Mesh(sizes, devices)


def set_default_mesh(mesh: tp.Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def default_mesh() -> Mesh:
    """The process-global mesh; lazily a pure data-parallel one (one rank
    on the caller's device)."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh({"data": -1})
    return _default_mesh
