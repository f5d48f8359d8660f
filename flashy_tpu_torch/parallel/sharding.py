"""The port's record of a layout: `P` and `NamedSharding`.

The JAX package takes these from `jax.sharding`: a `PartitionSpec` names,
for each dim of an array, the mesh axes it is split over (None: not
split), and a `NamedSharding` binds a spec to a mesh. The port's ranks
are processes, each holding its own slice of a sharded tensor, so the
port keeps the same two records and does the slicing itself
(`NamedSharding.shard`) and its inverse (`NamedSharding.gather`). Spec
trees then compare with the JAX package's leaf for leaf (`tuple(spec)`
of either).
"""
import math
import typing as tp

import torch

from .mesh import Mesh

Part = tp.Union[None, str, tp.Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per leading dim, each None (not
    split), an axis name, or a tuple of axis names (split over their
    product, the first axis outermost, as jax orders it). A replicated
    leaf is `P()`. `pairs` (default 1) records a dim made of `pairs`
    equal blocks split block by block (see `NamedSharding`); it is not
    part of the tuple, so a spec compares with the JAX package's leaf for
    leaf. A spec is a leaf of the port's trees (`distrib._flatten` keeps
    tuples with `_fields`, namedtuples among them, whole)."""

    _fields = ()
    pairs = 1

    def __new__(cls, *parts: Part, pairs: int = 1) -> "P":
        spec = super().__new__(cls, parts)
        if pairs != 1:
            spec.pairs = int(pairs)
        return spec

    def __repr__(self) -> str:
        extra = f", pairs={self.pairs}" if self.pairs != 1 else ""
        return f"P({', '.join(map(repr, self))}{extra})"

    def axes(self) -> tp.Tuple[str, ...]:
        """Every axis name the spec uses, in order."""
        return tuple(name for part in self if part is not None
                     for name in (part if isinstance(part, tuple)
                                  else (part,)))


def _names(part: Part) -> tp.Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _divisors(value: int) -> tp.List[int]:
    return [d for d in range(1, value + 1) if value % d == 0][:6]


def split_pairs(tensor: torch.Tensor, dim: int, ways: int, index: int,
                pairs: int = 1) -> torch.Tensor:
    """Slice `index` of `ways` of `tensor` along `dim`: a contiguous chunk,
    or with `pairs` > 1 the `index`-th chunk of each of the dim's `pairs`
    equal blocks, concatenated (a new tensor)."""
    if ways == 1:
        return tensor
    if pairs == 1:
        return tensor.chunk(ways, dim)[index]
    return torch.cat([block.chunk(ways, dim)[index]
                      for block in tensor.chunk(pairs, dim)], dim)


def join_pairs(pieces: tp.Sequence[torch.Tensor], dim: int,
               pairs: int = 1) -> torch.Tensor:
    """The inverse of `split_pairs` over every index: the slices in index
    order put back together along `dim`."""
    if pairs == 1:
        return torch.cat(list(pieces), dim)
    blocks = [piece.chunk(pairs, dim) for piece in pieces]
    return torch.cat([torch.cat([block[k] for block in blocks], dim)
                      for k in range(pairs)], dim)


class NamedSharding:
    """A spec bound to a mesh: how a tensor of the global shape is cut
    over the mesh's axes, and which slice this process holds.

    `pairs` (default: the spec's) cuts the dim split over 'tensor' as
    `pairs` blocks, each split on its own: the gated MLP's fused `up`
    kernel [D, 2F] (`gate | value`, P('fsdp', 'tensor') with pairs=2)
    gives tensor rank t the columns t of `gate` and the same columns of
    `value`, the half of the hidden width whose rows of `down` it holds.
    Slices over a tuple of axes (`('tensor', 'data')`) nest: the tensor
    slice is split again over 'data', so a process's tensor-local tensor
    is the join of its 'data' slices. `shard` and `gather` take the axes
    to cut or join over (default: every axis above size 1).

    `interleave` (default 1) does the same for the dim split over 'pipe':
    a scan-stacked leaf [L, ...] under `interleave` virtual stages is
    `interleave` blocks of `pipe` chunks, and pipe rank d holds chunk d of
    each block (chunks d, d + pipe, ...; `parallel.pipeline`)."""

    def __init__(self, mesh: Mesh, spec: tp.Sequence[Part] = (),
                 pairs: tp.Optional[int] = None, interleave: int = 1):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        self.pairs = int(pairs if pairs is not None
                         else getattr(spec, "pairs", 1))
        self.pairs_dim = next((dim for dim, part in enumerate(self.spec)
                               if "tensor" in _names(part)), None)
        self.interleave = int(interleave)
        self.pipe_dim = next((dim for dim, part in enumerate(self.spec)
                              if "pipe" in _names(part)), None)

    def __repr__(self) -> str:
        extra = f", pairs={self.pairs}" if self.pairs != 1 else ""
        if self.interleave != 1:
            extra += f", interleave={self.interleave}"
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r}{extra})"

    def __eq__(self, other: tp.Any) -> bool:
        return isinstance(other, NamedSharding) and other.spec == self.spec \
            and dict(other.mesh.shape) == dict(self.mesh.shape) \
            and other.pairs == self.pairs \
            and other.interleave == self.interleave

    def __hash__(self) -> int:
        return hash((self.spec, tuple(sorted(self.mesh.shape.items())),
                     self.pairs, self.interleave))

    @property
    def is_replicated(self) -> bool:
        """True when no dim is split over an axis of size above 1."""
        return all(self.mesh.shape[name] == 1 for name in self.spec.axes())

    def _selected(self, part: Part, axes: tp.Optional[tp.Sequence[str]]
                  ) -> tp.Tuple[str, ...]:
        """The names of `part` above size 1 among `axes` (None: all)."""
        return tuple(name for name in _names(part)
                     if self.mesh.shape[name] > 1
                     and (axes is None or name in axes))

    def _ways(self, part: Part,
              axes: tp.Optional[tp.Sequence[str]] = None) -> int:
        return math.prod(self.mesh.shape[name]
                         for name in self._selected(part, axes))

    def _pairs_at(self, dim: int) -> int:
        if dim == self.pairs_dim:
            return self.pairs
        return self.interleave if dim == self.pipe_dim else 1

    def shard_shape(self, shape: tp.Sequence[int],
                    axes: tp.Optional[tp.Sequence[str]] = None,
                    name: tp.Optional[str] = None) -> tp.Tuple[int, ...]:
        """The shape of one rank's slice of a tensor of `shape` over
        `axes` (default every axis); ValueError naming `name` and the
        dim's divisors where the axes do not divide it."""
        out = list(shape)
        for dim, part in enumerate(self.spec):
            ways = self._ways(part, axes)
            split = ways * (self._pairs_at(dim) if ways > 1 else 1)
            if out[dim] % split:
                raise ValueError(
                    f"{name or 'leaf'}: dim {dim} of {tuple(shape)} "
                    f"({out[dim]}) does not split {split} ways over "
                    f"{self._selected(part, axes)} ({self.spec!r}); pick "
                    f"axis sizes from its divisors (e.g. "
                    f"{_divisors(out[dim])})")
            out[dim] //= ways
        return tuple(out)

    def index(self, part: Part,
              axes: tp.Optional[tp.Sequence[str]] = None) -> int:
        """This process's index among the `part` slices of a dim over
        `axes`: its coordinates there, the first axis outermost."""
        index = 0
        for name in self._selected(part, axes):
            index = index * self.mesh.shape[name] + self.mesh.coord(name)
        return index

    def shard(self, tensor: torch.Tensor,
              axes: tp.Optional[tp.Sequence[str]] = None) -> torch.Tensor:
        """This process's slice of `tensor` over `axes` (default every
        axis: `tensor` is the full tensor). Cutting the tensor-local
        tensor over the process axes takes `tensor` already cut over
        'tensor' (the axes before them in each part)."""
        self.shard_shape(tensor.shape, axes)
        for dim, part in enumerate(self.spec):
            tensor = split_pairs(tensor, dim, self._ways(part, axes),
                                 self.index(part, axes), self._pairs_at(dim))
        return tensor

    def gather(self, local: torch.Tensor,
               axes: tp.Optional[tp.Sequence[str]] = None) -> torch.Tensor:
        """The inverse of `shard`: this process's slice joined with the
        other processes' over `axes` (default every axis), innermost axis
        first, one all-gather over each axis's group (collective: every
        process of the groups calls it)."""
        from .. import distrib
        for dim, part in enumerate(self.spec):
            for name in reversed(self._selected(part, axes)):
                n = self.mesh.shape[name]
                flat = distrib.all_gather(
                    local.detach().reshape(-1).contiguous(),
                    self.mesh.group(name))
                local = join_pairs(list(flat.view(n, *local.shape)
                                        .unbind(0)), dim,
                                   self._pairs_at(dim))
        return local

    def axis_names(self) -> tp.Tuple[str, ...]:
        """The axes above size 1 the sharding splits over."""
        return tuple(name for name in self.spec.axes()
                     if self.mesh.shape[name] > 1)

    def over(self, axes: tp.Sequence[str]) -> "NamedSharding":
        """This sharding restricted to `axes`: every other axis dropped
        from the spec (the layout of a slice cut over `axes` alone)."""
        parts = []
        for part in self.spec:
            kept = tuple(name for name in _names(part) if name in axes)
            parts.append(None if not kept else
                         kept[0] if len(kept) == 1 else kept)
        return NamedSharding(self.mesh, P(*parts), pairs=self.pairs,
                             interleave=self.interleave)


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
