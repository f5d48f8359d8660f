"""Checkpoint IO: single files, A/B slots on one process, asynchronous
slot saves, and the torch state-dict interop (the port of
flashy_tpu/checkpoint.py).

* `save_state` / `load_state`: one `torch.save` file written through
  `write_and_rename` (a process killed mid-write never leaves a
  truncated checkpoint) with an integrity sidecar; loading verifies the
  sidecar, then reads onto the CPU with `torch.load(weights_only=True)`,
  which unpickles only tensors and plain containers.
* `save_state_sharded` / `load_state_sharded`: two alternating slots
  under a directory and a `CURRENT` pointer renamed over only once the
  new slot is complete: the tensors in `arrays.pt`, the rest of the
  state (a skeleton with an `ArraySlot` marker where each tensor was) in
  `state.pkl`, a sha256 manifest of both, then the pointer flip. A crash
  mid-save leaves the previous slot active; a corrupt active slot falls
  back to its sibling.
* `AsyncShardedCheckpointer`: the same slots, the tensor write in a
  background thread. The snapshot copies every CUDA tensor to pinned
  host memory on the current stream before `save` returns, so the next
  in-place `optimizer.step()` runs after the copy in stream order; the
  commit (skeleton, manifest, pointer) waits for `finalize_pending`.

Module and optimizer state dicts load into their live objects, which
puts the tensors back on their devices. Under replicated data
parallelism every rank holds the same state: rank 0 writes the single
file (`run_on_rank_zero`, every rank meeting it there) and every rank
loads it. Across ranks with a sharded state (FSDP, ZeRO, the slices of
the expert, tensor and pipe axes: a `layout`
mapping the key of each rank-local tensor to its NamedSharding), slots
and asynchronous saves run on every rank: each writes `arrays-<rank>.pt`
with its shards, rank 0 also `arrays.pt` with the replicated tensors and
the skeleton; once every rank's write succeeded rank 0 writes the
manifest (every rank's file with its digest, plus the world and the
layout) and flips the pointer. A restore reads `arrays.pt` and its own
rank's file. `gather_state` and `shard_state` move a sharded state to
and from a single file's full tensors. Restoring onto another world size
or layout raises (`TODO_ELASTIC`).

`to_torch_state_dict` / `from_torch_state_dict` flatten a nested tree to
'.'-joined keys and back, and `import_flashy_checkpoint` reads a
checkpoint of the original flashy (a `torch.save` file) for the port's
`BaseSolver.load_state_dict`.
"""
import json
import logging
import threading
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from . import distrib
from .resilience import chaos
from .resilience.integrity import (MANIFEST_NAME, CheckpointCorrupted,
                                   CheckpointError, file_digest, sidecar_path,
                                   verify_file, verify_slot, write_manifest,
                                   write_sidecar)
from .resilience.retry import call_with_retry
from .utils import AnyPath, write_and_rename

logger = logging.getLogger(__name__)

TODO_ELASTIC = ("ROADMAP.md queue A item 8e (elastic restore: resharding "
                "a checkpoint onto another world size or layout)")

POINTER = "CURRENT"
SLOTS = ("slot0", "slot1")
SKELETON_NAME = "state.pkl"
ARRAYS_NAME = "arrays.pt"

# the key of a rank-local tensor of the state (`_extract_tensors`' keys)
# -> its NamedSharding
Layout = tp.Mapping[str, tp.Any]


def rank_arrays_name(rank: int) -> str:
    """The slot file holding rank `rank`'s shards."""
    return f"arrays-{rank}.pt"


class NumpyArray:
    """A numpy array (or numpy scalar) of the state, held as a tensor copy
    so that `weights_only` loading accepts it; loading gives the numpy
    value back."""

    def __init__(self, tensor: torch.Tensor, scalar: bool = False):
        self.tensor = tensor
        self.scalar = scalar

    def numpy(self) -> tp.Any:
        value = self.tensor.numpy()
        return value[()] if self.scalar else value


def _plain(value: tp.Any) -> tp.Any:
    """Mappings (the attribute-access `xp.Config` among them) as plain
    dicts, numpy values as `NumpyArray` copies and tensors detached (a
    new tensor object: no Python attribute, such as a shard's
    `.sharding`, is pickled with it), so the file holds only what
    `weights_only` loading accepts."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    if isinstance(value, dict):
        return {key: _plain(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(item) for item in value)
    if isinstance(value, (np.ndarray, np.generic)) \
            and not isinstance(value, (np.str_, np.bytes_, np.object_)):
        return NumpyArray(torch.from_numpy(np.array(value)),
                          scalar=isinstance(value, np.generic))
    return value


def _unplain(value: tp.Any) -> tp.Any:
    """The inverse of `_plain`'s numpy step, after loading."""
    if isinstance(value, NumpyArray):
        return value.numpy()
    if isinstance(value, dict):
        return {key: _unplain(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_unplain(item) for item in value)
    return value


def _sharded_only(layout: tp.Optional[Layout]) -> tp.Dict[str, tp.Any]:
    """The entries of `layout` that split their tensor."""
    return {key: sharding for key, sharding in (layout or {}).items()
            if sharding is not None and not sharding.is_replicated}


def layout_record(layout: tp.Optional[Layout]) -> tp.Dict[str, tp.Any]:
    """`layout` as JSON: each key's spec (a list, tuples as lists), mesh
    axis sizes and, for a dim cut block by block, its `pairs` (over
    'tensor') or `interleave` (over 'pipe')."""
    return {key: {"spec": [list(part) if isinstance(part, tuple) else part
                           for part in sharding.spec],
                  "mesh": {axis: int(size) for axis, size
                           in sharding.mesh.shape.items()},
                  **({"pairs": sharding.pairs} if sharding.pairs != 1
                     else {}),
                  **({"interleave": sharding.interleave}
                     if getattr(sharding, "interleave", 1) != 1 else {})}
            for key, sharding in sorted(_sharded_only(layout).items())}


def _agree(error: tp.Optional[BaseException], what: str) -> None:
    """Every rank learns whether any rank failed `what` (one all-reduce):
    the failed rank re-raises its error, the others raise
    CheckpointError, so no rank commits what another did not write."""
    failed = distrib.all_reduce_max(int(error is not None))
    if error is not None:
        raise error
    if failed:
        raise CheckpointError(f"another rank failed {what}")


def _write_state_file(path: AnyPath, payload: tp.Any,
                      sidecar: bool = True) -> None:
    """Atomic `torch.save`, retried on transient IO failure (the
    `ckpt.write` fault site). The retried unit is idempotent. `sidecar`
    writes the integrity sidecar of a single-file checkpoint (slots get
    a manifest instead, written by `_commit_slot`)."""

    def write() -> None:
        chaos.fault_point("ckpt.write", path=str(path))
        with write_and_rename(path, "wb") as f:
            torch.save(payload, f)
        if sidecar:
            write_sidecar(path)

    call_with_retry(write, name="ckpt.write", retry_on=(OSError,))


def _read_state_file(path: AnyPath, what: str) -> tp.Any:
    """`torch.load(weights_only=True)` onto the CPU, retrying transient
    IO (the `ckpt.load` fault site); a file that does not unpickle
    raises CheckpointError naming `what` and the path."""

    def read() -> tp.Any:
        chaos.fault_point("ckpt.load", path=str(path))
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except OSError:
            raise
        except Exception as exc:
            raise CheckpointError(
                f"failed to unpickle {what} at {path}: "
                f"{type(exc).__name__}: {exc}") from exc

    return call_with_retry(read, name="ckpt.load", retry_on=(OSError,))


def save_state(state: tp.Any, path: AnyPath) -> None:
    """Write a state dict to one file, atomically, with its sidecar (from
    the process that calls it; on several ranks, rank 0 through
    `run_on_rank_zero`)."""
    _write_state_file(path, _plain(state))


def run_on_rank_zero(fn: tp.Callable[[], tp.Any], what: str) -> None:
    """`fn()` on rank 0, with every process calling together: every rank
    then learns whether it succeeded (a broadcast that is also the
    barrier), so a failure raises on every rank instead of leaving the
    others waiting in the next collective."""
    error: tp.Optional[BaseException] = None
    if distrib.is_rank_zero():
        try:
            fn()
        except BaseException as exc:  # re-raised below, on every rank
            error = exc
    failed = distrib.broadcast_object(
        None if error is None else f"{type(error).__name__}: {error}")
    if error is not None:
        raise error
    if failed is not None:
        raise CheckpointError(f"rank 0 failed {what}: {failed}")


def load_state(path: AnyPath) -> tp.Any:
    """Load a state dict written by `save_state`, tensors on the CPU.

    A file with a sidecar is verified before unpickling (a mismatch
    raises `CheckpointCorrupted`); a file that does not unpickle raises
    `CheckpointError` naming the path; a missing file stays a
    `FileNotFoundError` (absence is not corruption)."""
    if not Path(path).exists():
        raise FileNotFoundError(f"No checkpoint at {path}")
    problems = verify_file(path)
    if problems:
        raise CheckpointCorrupted(
            f"single-file checkpoint {path} failed integrity verification: "
            + "; ".join(problems))
    return _unplain(_read_state_file(path, "single-file checkpoint"))


class ArraySlot:
    """Marker left in a slot's skeleton where a tensor was taken out into
    the slot's `arrays.pt` (keyed by its path in the state)."""

    def __init__(self, key: str):
        self.key = key

    def __repr__(self) -> str:
        return f"ArraySlot({self.key!r})"

    def __eq__(self, other: tp.Any) -> bool:
        return isinstance(other, ArraySlot) and other.key == self.key

    def __hash__(self) -> int:
        return hash(("ArraySlot", self.key))


# files load with weights_only=True: the two markers are allow-listed
torch.serialization.add_safe_globals([ArraySlot, NumpyArray])


def _extract_tensors(state: tp.Any
                     ) -> tp.Tuple[tp.Any, tp.Dict[str, torch.Tensor]]:
    """Split `state` into (skeleton, tensors): every tensor leaf moves
    into the flat `tensors` dict, keyed by its path (`['model']['w']`,
    `['optimizer']['state'][0]['exp_avg']`), and leaves an `ArraySlot`
    behind; every other value stays in the skeleton."""
    tensors: tp.Dict[str, torch.Tensor] = {}

    def visit(node: tp.Any, key: str) -> tp.Any:
        if isinstance(node, torch.Tensor):
            tensors[key] = node
            return ArraySlot(key)
        if isinstance(node, dict):
            return {k: visit(v, f"{key}[{k!r}]") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, f"{key}[{i}]")
                              for i, v in enumerate(node))
        return node

    return visit(state, ""), tensors


def _fill(skeleton: tp.Any, tensors: tp.Mapping[str, torch.Tensor]
          ) -> tp.Any:
    """The inverse of `_extract_tensors`."""
    if isinstance(skeleton, ArraySlot):
        return tensors[skeleton.key]
    if isinstance(skeleton, dict):
        return {k: _fill(v, tensors) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(v, tensors) for v in skeleton)
    return skeleton


def tensor_bytes(state: tp.Any) -> int:
    """Total bytes of the tensor leaves of `state` (commit's 'auto' mode
    compares it with `sharded_checkpoint_min_bytes`)."""
    _, tensors = _extract_tensors(state)
    return sum(t.numel() * t.element_size() for t in tensors.values())


def read_slot_pointer(directory: AnyPath) -> tp.Optional[str]:
    """The active slot named by `CURRENT`, or None."""
    pointer = Path(directory) / POINTER
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    return name if name in SLOTS else None


def sharded_checkpoint_exists(directory: AnyPath) -> bool:
    """True when `directory` holds a committed slot save that at least
    one slot could restore: the pointer must exist, but an active slot
    whose payload went missing does not hide a restorable sibling."""
    directory = Path(directory)
    if read_slot_pointer(directory) is None:
        return False
    return any((directory / s / SKELETON_NAME).exists() for s in SLOTS)


def _prepare_slot(directory: Path, names: tp.Sequence[str]
                  = (SKELETON_NAME, MANIFEST_NAME, ARRAYS_NAME)) -> str:
    """Pick the inactive slot and clear `names` in it: an aborted earlier
    write must leave neither a complete look (the skeleton) nor a stale
    manifest; the old tensors go first too, to free their disk."""
    active = read_slot_pointer(directory)
    target = SLOTS[1] if active == SLOTS[0] else SLOTS[0]
    slot_dir = directory / target
    slot_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        stale = slot_dir / name
        if stale.exists():
            stale.unlink()
    return target


def _commit_slot(directory: Path, target: str, skeleton: tp.Any,
                 on_commit: tp.Optional[tp.Callable[[], None]] = None,
                 known: tp.Optional[tp.Mapping[str, tp.Tuple[str, int]]]
                 = None, extra: tp.Optional[tp.Mapping[str, tp.Any]] = None
                 ) -> None:
    """Make slot `target` the active checkpoint: write the skeleton (the
    commit marker), then the manifest (`ckpt.manifest`), then flip the
    CURRENT pointer atomically (`ckpt.pointer`), each retried on
    transient IO. `known` passes digests the writer already took.
    `on_commit` runs after the flip: cleanup that must not precede
    durability."""
    _write_state_file(directory / target / SKELETON_NAME, skeleton,
                      sidecar=False)

    def write_slot_manifest() -> None:
        chaos.fault_point("ckpt.manifest", slot=target)
        write_manifest(directory / target, known=known, extra=extra)

    call_with_retry(write_slot_manifest, name="ckpt.manifest",
                    retry_on=(OSError,))

    def flip_pointer() -> None:
        chaos.fault_point("ckpt.pointer", slot=target)
        with write_and_rename(directory / POINTER, "w") as f:
            f.write(target)

    call_with_retry(flip_pointer, name="ckpt.pointer", retry_on=(OSError,))
    if on_commit is not None:
        on_commit()


def gather_state(state: tp.Any, layout: tp.Optional[Layout]) -> tp.Any:
    """`state` with each rank-local tensor of `layout` all-gathered into
    its full tensor over every axis of its sharding, 'tensor' included
    (collective: every rank calls it with its shards, in the same order);
    what a single file of a sharded state holds."""
    layout = _sharded_only(layout)
    if not layout:
        return state
    skeleton, tensors = _extract_tensors(state)
    for key in sorted(layout):
        if key in tensors:
            tensors[key] = layout[key].gather(tensors[key])
    return _fill(skeleton, tensors)


def shard_state(state: tp.Any, layout: tp.Optional[Layout]) -> tp.Any:
    """`state` (full tensors, as a single file holds them) with each
    tensor of `layout` replaced by this rank's slice."""
    layout = _sharded_only(layout)
    if not layout:
        return state
    skeleton, tensors = _extract_tensors(state)
    for key, sharding in layout.items():
        if key in tensors:
            tensors[key] = sharding.shard(tensors[key]).clone()
    return _fill(skeleton, tensors)


def _slot_files(tensors: tp.Mapping[str, torch.Tensor],
                layout: tp.Mapping[str, tp.Any]
                ) -> tp.Dict[str, tp.Dict[str, torch.Tensor]]:
    """What this rank writes into a slot: its shards (`arrays-<rank>.pt`)
    and, on rank 0, the replicated tensors (`arrays.pt`)."""
    files: tp.Dict[str, tp.Dict[str, torch.Tensor]] = {}
    local = {key: t for key, t in tensors.items() if key in layout}
    shared = {key: t for key, t in tensors.items() if key not in layout}
    if local:
        files[rank_arrays_name(distrib.rank())] = local
    if shared and distrib.is_rank_zero():
        files[ARRAYS_NAME] = shared
    return files


def _manifest_extra(layout: tp.Mapping[str, tp.Any]
                    ) -> tp.Optional[tp.Dict[str, tp.Any]]:
    """The world and the layout, for a save across ranks or of a sharded
    state (a one-process replicated save keeps the JAX package's
    manifest)."""
    if distrib.world_size() == 1 and not layout:
        return None
    return {"world": distrib.world_size(), "layout": layout_record(layout)}


def _prepare_rank_slot(directory: Path, names: tp.Sequence[str]) -> str:
    """`_prepare_slot` on every rank: rank 0 clears `names`, each rank
    its own shard file."""
    own = (rank_arrays_name(distrib.rank()),)
    return _prepare_slot(directory, (tuple(names) if distrib.is_rank_zero()
                                     else ()) + own)


def save_state_sharded(state: tp.Any, directory: AnyPath,
                       layout: tp.Optional[Layout] = None,
                       on_commit: tp.Optional[tp.Callable[[], None]] = None
                       ) -> None:
    """Write `state` into the inactive slot of `directory` and make it
    active (the tensors in `arrays.pt`, the rest in the skeleton). Costs
    twice the disk of one checkpoint, the A/B trade. On several ranks
    every rank calls it together: each writes its shards of `layout`'s
    tensors (`arrays-<rank>.pt`), rank 0 the rest and, once every rank
    succeeded, commits (`on_commit` runs there, after the flip)."""
    directory = Path(directory).absolute()
    layout = _sharded_only(layout)
    skeleton, tensors = _extract_tensors(_plain(state))
    target = _prepare_rank_slot(directory, (SKELETON_NAME, MANIFEST_NAME,
                                            ARRAYS_NAME))
    error = None
    try:
        for name, payload in _slot_files(tensors, layout).items():
            _write_state_file(directory / target / name, payload,
                              sidecar=False)
    except BaseException as exc:  # re-raised by _agree, on this rank
        error = exc
    _agree(error, "to write its slot files")
    extra = _manifest_extra(layout)
    run_on_rank_zero(lambda: _commit_slot(directory, target, skeleton,
                                          on_commit, extra=extra),
                     "to commit the slot")


class AsyncShardedCheckpointer:
    """Asynchronous `save_state_sharded`.

    `save()` snapshots the tensors to host memory and returns while a
    background thread writes `arrays.pt` (and takes its digest); the
    commit (skeleton, manifest, pointer flip) is deferred to
    `finalize_pending()`, called at the start of the next `save()` and
    by `wait()` / `close()`, so a crash mid-write leaves the previous
    slot active. A write failure surfaces there.

    The snapshot copies each CUDA tensor into a pinned host buffer with
    `non_blocking=True` on the current stream and records an event the
    writer waits on: the copy precedes any later in-place update of the
    live tensor in stream order. CPU tensors are cloned. The pinned
    buffers are kept and reused by the next save of the same shapes.
    """

    def __init__(self) -> None:
        self._pending: tp.Optional[tp.Tuple[tp.Any, ...]] = None
        self._pinned: tp.Dict[str, torch.Tensor] = {}
        # seconds the last finished background write took (event wait,
        # write and digest), for the records
        self.last_background_seconds: tp.Optional[float] = None

    def _snapshot(self, tensors: tp.Mapping[str, torch.Tensor]
                  ) -> tp.Tuple[tp.Dict[str, torch.Tensor], tp.Any]:
        host: tp.Dict[str, torch.Tensor] = {}
        on_cuda = False
        for key, tensor in tensors.items():
            tensor = tensor.detach()
            if tensor.device.type != "cuda":
                host[key] = tensor.clone()
                continue
            buffer = self._pinned.get(key)
            if buffer is None or buffer.shape != tensor.shape \
                    or buffer.dtype != tensor.dtype:
                buffer = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
                self._pinned[key] = buffer
            buffer.copy_(tensor, non_blocking=True)
            host[key] = buffer
            on_cuda = True
        event = None
        if on_cuda:
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def _write(directory: Path, files: tp.Dict[str, tp.Dict[str, torch.Tensor]],
               event: tp.Any, box: tp.Dict[str, tp.Any]) -> None:
        begin = time.perf_counter()
        try:
            # the slot's old tensors: freeing a large file takes a
            # while, which the caller of save() does not wait for
            for name in files:
                if (directory / name).exists():
                    (directory / name).unlink()
            if event is not None:
                event.synchronize()
            box["digests"] = {}
            for name, host in files.items():
                _write_state_file(directory / name, host, sidecar=False)
                box["digests"][name] = file_digest(directory / name)
        except BaseException as exc:  # re-raised by finalize_pending
            box["error"] = exc
        box["seconds"] = time.perf_counter() - begin

    def save(self, state: tp.Any, directory: AnyPath,
             on_commit: tp.Optional[tp.Callable[[], None]] = None,
             layout: tp.Optional[Layout] = None) -> None:
        """Start an asynchronous save. `on_commit` runs once the
        checkpoint is durable and active (on rank 0): put the cleanup of
        superseded checkpoints there, never before. On several ranks
        every rank calls it together, each writing its shards of
        `layout`'s tensors in its own background thread; the commit
        waits for all of them."""
        self.finalize_pending()
        directory = Path(directory).absolute()
        layout = _sharded_only(layout)
        skeleton, tensors = _extract_tensors(_plain(state))
        host, event = self._snapshot(tensors)
        files = _slot_files(host, layout)
        target = _prepare_rank_slot(directory, (SKELETON_NAME,
                                                MANIFEST_NAME))
        box: tp.Dict[str, tp.Any] = {}
        thread = None
        if files:
            thread = threading.Thread(
                target=self._write, name="flashy-ckpt-writer", daemon=True,
                args=(directory / target, files, event, box))
            thread.start()
        self._pending = (directory, target, skeleton, on_commit, thread, box,
                         _manifest_extra(layout))

    def finalize_pending(self) -> None:
        """Block until the in-flight save is durable on every rank, then
        commit it (collective on several ranks: every rank calls it at
        the same point)."""
        if self._pending is None:
            return
        (directory, target, skeleton, on_commit, thread, box,
         extra) = self._pending
        self._pending = None
        known = None
        if thread is not None:
            thread.join()
            self.last_background_seconds = box["seconds"]
            known = box.get("digests")
        _agree(box.get("error"), "to write its asynchronous slot files")
        run_on_rank_zero(lambda: _commit_slot(
            directory, target, skeleton, on_commit, known=known, extra=extra),
            "to commit the asynchronous slot")

    # `wait` reads naturally at call sites that just need durability.
    wait = finalize_pending

    def close(self) -> None:
        self.finalize_pending()
        self._pinned.clear()


def slot_manifest(slot_dir: Path) -> tp.Dict[str, tp.Any]:
    """A slot's manifest (`{}` when missing or unreadable)."""
    try:
        return json.loads((slot_dir / MANIFEST_NAME).read_text())
    except (OSError, ValueError):
        return {}


def _load_slot(directory: Path, slot: str) -> tp.Any:
    """Verify one slot against its manifest and load it (skeleton, then
    its tensors: `arrays.pt` and, for a save across ranks, this rank's
    `arrays-<rank>.pt`). Raises CheckpointError naming the slot on a
    mismatch, a missing commit marker or a file that does not unpickle:
    the signal `load_state_sharded` falls back on."""
    slot_dir = directory / slot
    if not (slot_dir / SKELETON_NAME).exists():
        raise CheckpointError(f"slot {slot!r} of {directory} has no "
                              f"committed {SKELETON_NAME}")
    problems = verify_slot(slot_dir)
    if problems:
        raise CheckpointError(
            f"slot {slot!r} of {directory} failed integrity verification: "
            + "; ".join(problems))
    skeleton = _read_state_file(slot_dir / SKELETON_NAME,
                                f"slot {slot!r} skeleton")
    tensors: tp.Dict[str, torch.Tensor] = {}
    if (slot_dir / ARRAYS_NAME).exists():
        tensors = _read_state_file(slot_dir / ARRAYS_NAME,
                                   f"slot {slot!r} tensors")
    own = slot_dir / rank_arrays_name(distrib.rank())
    if own.exists():
        tensors.update(_read_state_file(own, f"slot {slot!r} rank "
                                        f"{distrib.rank()}'s tensors"))
    try:
        return _unplain(_fill(skeleton, tensors))
    except KeyError as exc:
        raise CheckpointError(f"slot {slot!r} of {directory}: the skeleton "
                              f"names tensor {exc} that arrays.pt lacks"
                              ) from exc


def _check_topology(slot_dir: Path, layout: tp.Optional[Layout],
                    mesh: tp.Any = None) -> None:
    """Refuse a slot saved on another world size with a sharded layout,
    under another layout than `layout` (when given), or over another
    mesh than `mesh` (when given: a sharded tensor's record names the
    mesh it was cut over, so a restore onto another tensor or fsdp width
    at the same world size is caught too): resharding at restore is item
    8e's."""
    manifest = slot_manifest(slot_dir)
    saved = manifest.get("layout", {})
    world = int(manifest.get("world", 1))
    # an optimizer builds its state at its first step: the live layout
    # may lack keys the saved one has, never the other way round
    current = layout_record(layout)
    if layout is not None and any(saved.get(key) != record
                                  for key, record in current.items()):
        raise NotImplementedError(
            f"{slot_dir} was saved under another layout than this run's "
            f"({len(saved)} against {len(current)} sharded tensors): "
            f"{TODO_ELASTIC}")
    if saved and world != distrib.world_size():
        raise NotImplementedError(
            f"{slot_dir} was saved across {world} ranks; this run has "
            f"{distrib.world_size()}: {TODO_ELASTIC}")
    if isinstance(getattr(mesh, "shape", None), tp.Mapping):
        shape = {axis: int(size) for axis, size in mesh.shape.items()}
        other = next((record["mesh"] for record in saved.values()
                      if record["mesh"] != shape), None)
        if other is not None:
            raise NotImplementedError(
                f"{slot_dir} was saved over the mesh {other}; this run's is "
                f"{shape}: {TODO_ELASTIC}")


def load_state_sharded(directory: AnyPath,
                       layout: tp.Optional[Layout] = None,
                       mesh: tp.Any = None) -> tp.Any:
    """Restore a `save_state_sharded` checkpoint, tensors on the CPU.

    Each slot is verified against its manifest before unpickling. When
    the active slot is corrupt or unreadable, restore falls back to the
    sibling with a loud WARN (the run resumes from the previous
    committed epoch, its history rolled back with it) and repoints
    CURRENT at it, so the next save overwrites the bad slot and not the
    only good copy. Only when both slots are bad does it raise
    `CheckpointCorrupted`. Across ranks each rank reads its own shards
    (every rank verifies every file, so all take the same slot); a slot
    saved on another world size with a sharded layout, under another
    `layout` than the given one, or over another `mesh` than the given
    one, raises NotImplementedError naming item 8e.
    """
    directory = Path(directory).absolute()
    active = read_slot_pointer(directory)
    if active is None:
        raise FileNotFoundError(
            f"No committed sharded checkpoint in {directory}")
    _check_topology(directory / active, layout, mesh)
    sibling = SLOTS[1] if active == SLOTS[0] else SLOTS[0]
    errors: tp.List[str] = []
    for candidate in (active, sibling):
        try:
            state = _load_slot(directory, candidate)
        except CheckpointError as exc:
            errors.append(str(exc))
            logger.warning(
                "checkpoint slot %r of %s is unreadable or corrupt: %s%s",
                candidate, directory, exc,
                " — falling back to the sibling A/B slot"
                if candidate == active else "")
            continue
        if candidate != active:
            logger.warning(
                "RESTORED FROM FALLBACK SLOT %r of %s: the active slot %r "
                "was corrupt; the run resumes from the previously committed "
                "epoch.", candidate, directory, active)
            if distrib.is_rank_zero():
                with write_and_rename(directory / POINTER, "w") as f:
                    f.write(candidate)
        return state
    raise CheckpointCorrupted(
        f"no restorable checkpoint slot in {directory} "
        "(both A/B slots failed): " + " | ".join(errors))


def to_torch_state_dict(tree: tp.Any, prefix: str = ""
                        ) -> tp.Dict[str, tp.Any]:
    """Flatten a nested tree (dicts, lists, tuples) into a torch-style
    flat state dict: keys joined with '.', list and tuple items keyed by
    their index. Tensors stay tensors, numpy arrays become tensors
    sharing their memory where it is contiguous, None leaves are
    dropped and other leaves pass through."""
    flat: tp.Dict[str, tp.Any] = {}

    def visit(node: tp.Any, path: str) -> None:
        if isinstance(node, dict):
            for key, value in node.items():
                visit(value, f"{path}.{key}" if path else str(key))
        elif isinstance(node, (list, tuple)):
            for index, value in enumerate(node):
                visit(value, f"{path}.{index}" if path else str(index))
        elif isinstance(node, np.ndarray):
            flat[path] = torch.from_numpy(np.ascontiguousarray(node))
        elif node is not None:
            flat[path] = node

    visit(tree, prefix)
    return flat


def from_torch_state_dict(state_dict: tp.Mapping[str, tp.Any]
                          ) -> tp.Dict[str, tp.Any]:
    """Unflatten a torch-style state dict ('.'-joined keys) into nested
    dicts, the leaves as they are (tensors stay tensors)."""
    out: tp.Dict[str, tp.Any] = {}
    for dotted, value in state_dict.items():
        *path, leaf = dotted.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def import_flashy_checkpoint(path: AnyPath) -> tp.Dict[str, tp.Any]:
    """Load a checkpoint of the original flashy (`checkpoint.th`, a
    `torch.save` file) as a solver state dict for the port's
    `BaseSolver.load_state_dict`: every tensor, at any depth (optimizer
    states nest them), detached on the CPU; module state dicts stay flat
    ('.'-joined keys, the port's own format); 'history', 'xp.cfg' and
    'xp.sig' pass through.

    The file is unpickled in full (`weights_only=False`), as flashy's
    files hold plain Python objects beside the tensors: unpickling runs
    code the file names, so load only files you trust.
    """
    if not Path(path).exists():
        raise FileNotFoundError(f"No checkpoint at {path}")
    raw = torch.load(str(path), map_location="cpu", weights_only=False)

    def convert(node: tp.Any) -> tp.Any:
        if isinstance(node, torch.Tensor):
            return node.detach().cpu()
        if isinstance(node, tp.Mapping):
            return {key: convert(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(value) for value in node)
        return node

    return {name: convert(entry) for name, entry in raw.items()}
