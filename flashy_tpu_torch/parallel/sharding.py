"""The port's record of a layout: `P` and `NamedSharding`.

The JAX package takes these from `jax.sharding`: a `PartitionSpec` names,
for each dim of an array, the mesh axes it is split over (None: not
split), and a `NamedSharding` binds a spec to a mesh. The port's ranks
are processes, each holding its own slice of a sharded tensor, so the
port keeps the same two records and does the slicing itself
(`NamedSharding.shard`). Spec trees then compare with the JAX package's
leaf for leaf (`tuple(spec)` of either).
"""
import math
import typing as tp

import torch

from .mesh import Mesh

Part = tp.Union[None, str, tp.Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per leading dim, each None (not
    split), an axis name, or a tuple of axis names (split over their
    product, the first axis outermost). A replicated leaf is `P()`.
    A spec is a leaf of the port's trees (`distrib._flatten` keeps
    tuples with `_fields`, namedtuples among them, whole)."""

    _fields = ()

    def __new__(cls, *parts: Part) -> "P":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"

    def axes(self) -> tp.Tuple[str, ...]:
        """Every axis name the spec uses, in order."""
        return tuple(name for part in self if part is not None
                     for name in (part if isinstance(part, tuple)
                                  else (part,)))


def _names(part: Part) -> tp.Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


class NamedSharding:
    """A spec bound to a mesh: how a tensor of the global shape is cut
    over the mesh's axes, and which slice this process holds."""

    def __init__(self, mesh: Mesh, spec: tp.Sequence[Part] = ()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    def __eq__(self, other: tp.Any) -> bool:
        return isinstance(other, NamedSharding) and other.spec == self.spec \
            and dict(other.mesh.shape) == dict(self.mesh.shape)

    def __hash__(self) -> int:
        return hash((self.spec, tuple(sorted(self.mesh.shape.items()))))

    @property
    def is_replicated(self) -> bool:
        """True when no dim is split over an axis of size above 1."""
        return all(self.mesh.shape[name] == 1 for name in self.spec.axes())

    def _ways(self, part: Part) -> int:
        return math.prod(self.mesh.shape[name] for name in _names(part))

    def shard_shape(self, shape: tp.Sequence[int]) -> tp.Tuple[int, ...]:
        """The shape of one rank's slice of a tensor of `shape`."""
        out = list(shape)
        for dim, part in enumerate(self.spec):
            ways = self._ways(part)
            if out[dim] % ways:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split {ways} ways ({self.spec!r})")
            out[dim] //= ways
        return tuple(out)

    def index(self, part: Part) -> int:
        """This process's index among the `part` slices of a dim: its
        coordinates on the part's axes, the first axis outermost."""
        index = 0
        for name in _names(part):
            index = index * self.mesh.shape[name] + self.mesh.coord(name)
        return index

    def shard(self, tensor: torch.Tensor) -> torch.Tensor:
        """This process's slice of the full `tensor` (a view)."""
        self.shard_shape(tensor.shape)
        for dim, part in enumerate(self.spec):
            ways = self._ways(part)
            if ways > 1:
                tensor = tensor.chunk(ways, dim)[self.index(part)]
        return tensor

    def split_dim(self) -> tp.Optional[int]:
        """The one dim this sharding splits (None when replicated); a
        spec splitting several dims raises (the port's FSDP and ZeRO
        gather and reduce one dim a leaf)."""
        dims = [dim for dim, part in enumerate(self.spec)
                if self._ways(part) > 1]
        if len(dims) > 1:
            raise NotImplementedError(
                f"{self.spec!r} splits dims {dims} over axes above 1; the "
                f"port gathers one dim a leaf (tensor splits are ROADMAP.md "
                f"queue A item 8b)")
        return dims[0] if dims else None

    def axis_names(self) -> tp.Tuple[str, ...]:
        """The axes above size 1 the sharding splits over."""
        return tuple(name for name in self.spec.axes()
                     if self.mesh.shape[name] > 1)


def place(tree: tp.Any, shardings: tp.Any) -> tp.Any:
    """The port's `jax.device_put(tree, shardings)`: each leaf of `tree`
    (tensors or numpy arrays, in dicts, lists and tuples) replaced by
    this process's slice under the matching NamedSharding of
    `shardings`, a contiguous tensor of its own carrying the sharding as
    `.sharding`; a leaf whose sharding splits nothing stays as it is."""
    from .. import distrib
    leaves, rebuild = distrib._flatten(tree)
    specs, _ = distrib._flatten(shardings)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} shardings for {len(leaves)} leaves")
    out = []
    for leaf, sharding in zip(leaves, specs):
        if sharding is None or sharding.is_replicated:
            out.append(leaf)
            continue
        tensor = leaf.detach() if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(leaf)
        local = sharding.shard(tensor).clone()
        local.sharding = sharding
        out.append(local)
    return rebuild(out)
