"""Collective accounting: the port of flashy_tpu/parallel/accounting.py.

The JAX package parses a compiled step's HLO into {collective: (count,
bytes)}, because XLA's partitioner inserts the collectives and a spec
that silently falls back to replication changes them unseen. The port's
steps call their collectives from Python (`distrib._collective`, through
which every tensor collective of `distrib` runs, and DDP's bucketed
all-reduce through the comm hook `wrap` installs), so the port counts
those calls instead: `count_collectives()` records every collective run
inside it, and `collective_stats(record)` gives the reference's dict
under the reference's op names, bytes being each call's output bytes
(the reference's sync convention: a reduce-scatter counts its shard, an
all-gather its whole result, an all-to-all the blocks it received). The
expert-parallel exchange (`moe_ep`) shows as 'all-to-all' over the
'expert' group, three a MoE layer forward and two backward. This is a
count of the calls a step made and the bytes they returned, not a
compiler's view of a program.
"""
import contextlib
import typing as tp

import torch

from .. import distrib

COLLECTIVE_OPS = ("ragged-all-to-all", "all-gather", "all-reduce",
                  "reduce-scatter", "collective-permute", "all-to-all",
                  "collective-broadcast")

Record = tp.List[tp.Tuple[str, int]]


@contextlib.contextmanager
def count_collectives() -> tp.Iterator[Record]:
    """Record every collective run inside the block: yields the list of
    (op, output bytes) that `collective_stats` reads."""
    with distrib._recording() as record:
        yield record


def collective_stats(record: Record) -> tp.Dict[str, tp.Dict[str, int]]:
    """Per-collective call counts and output-byte totals of `record` (a
    `count_collectives` record), every op of COLLECTIVE_OPS present."""
    stats = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}
    for op, nbytes in record:
        stats[op]["count"] += 1
        stats[op]["bytes"] += nbytes
    return stats


def total_collective_bytes(record: Record) -> int:
    """Sum of `collective_stats` bytes over every collective kind."""
    return sum(e["bytes"] for e in collective_stats(record).values())


def compare_collective_stats(record: Record, baseline: Record
                             ) -> tp.Dict[str, tp.Dict[str, int]]:
    """Per-collective (count, bytes) DELTA of `record` minus `baseline`;
    ops with a zero delta in both fields are omitted."""
    ours, theirs = collective_stats(record), collective_stats(baseline)
    delta = {}
    for op in COLLECTIVE_OPS:
        entry = {field: ours[op][field] - theirs[op][field]
                 for field in ("count", "bytes")}
        if entry["count"] or entry["bytes"]:
            delta[op] = entry
    return delta


def counting_allreduce_hook(state, bucket):  # DDP checks the annotations
    """DDP's default `allreduce_hook` (divide by the size of the group
    `state`, every process when None, then sum over it), with the
    bucket's all-reduce noted where
    `count_collectives` sees it. `wrap` registers it on every
    DistributedDataParallel it builds."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
    buffer = bucket.buffer()
    return distrib._collective(
        "all-reduce", buffer.numel() * buffer.element_size(),
        lambda: default_hooks.allreduce_hook(state, bucket))


def memory_stats(args: tp.Any = None, state: tp.Any = None,
                 device: tp.Any = None) -> tp.Dict[str, int]:
    """A rank's memory footprint, in bytes: `arguments`, the local bytes
    of the tensors in `args` (a tree); `state`, the `per_device_bytes` of
    `state` (a rank's shards count their local size); and, for a CUDA
    `device`, the caching allocator's `peak` (`max_memory_allocated`)
    and `current`. The reference reads XLA's buffer assignment instead;
    the port has no compiled program to ask."""
    from .zero import per_device_bytes
    out: tp.Dict[str, int] = {}
    if args is not None:
        out["arguments"] = per_device_bytes(args)
    if state is not None:
        out["state"] = per_device_bytes(state)
    if device is not None and torch.device(device).type == "cuda":
        out["peak"] = int(torch.cuda.max_memory_allocated(device))
        out["current"] = int(torch.cuda.memory_allocated(device))
    return out
