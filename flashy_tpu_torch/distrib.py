"""Process-level helpers, single-process part (the port of
flashy_tpu/distrib.py).

`rank` and `world_size` read the launcher environment (the JAX
package's `FLASHY_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID`, or
torchrun's `MASTER_ADDR/WORLD_SIZE/RANK`) and are 0 and 1 without one.
A world size above 1 needs `torch.distributed`, which the port does not
have yet: `init()` raises there, and every helper is the identity at
world size 1.
"""
import functools
import os
import typing as tp

TODO_MULTIPROCESS = ("ROADMAP.md queue A item 5 (multi-process distrib on "
                     "torch.distributed)")


def _env(name: str) -> tp.Optional[str]:
    return os.environ.get(name)


def _launcher_rank_world() -> tp.Optional[tp.Tuple[int, int]]:
    """(rank, world_size) from a complete launcher environment, or None
    (a stray `RANK` without `WORLD_SIZE` does not count)."""
    if _env("FLASHY_TPU_COORDINATOR") and _env("FLASHY_TPU_NUM_PROCESSES"):
        return (int(_env("FLASHY_TPU_PROCESS_ID") or 0),
                int(_env("FLASHY_TPU_NUM_PROCESSES") or 1))
    if _env("MASTER_ADDR") and _env("WORLD_SIZE"):
        return int(_env("RANK") or 0), int(_env("WORLD_SIZE") or 1)
    return None


def rank() -> int:
    found = _launcher_rank_world()
    return found[0] if found else 0


def world_size() -> int:
    found = _launcher_rank_world()
    return found[1] if found else 1


def is_rank_zero() -> bool:
    return rank() == 0


def is_distributed() -> bool:
    return world_size() > 1


def init(backend: tp.Optional[str] = None) -> None:
    """No-op for one process; raises for a multi-process launch."""
    del backend
    if is_distributed():
        raise NotImplementedError(
            f"world size {world_size()} > 1 is not ported yet: "
            f"{TODO_MULTIPROCESS}")


def rank_zero_only(fn: tp.Callable) -> tp.Callable:
    """Run `fn` on rank zero only; other ranks get None."""

    @functools.wraps(fn)
    def wrapped(*args: tp.Any, **kwargs: tp.Any) -> tp.Optional[tp.Any]:
        if is_rank_zero():
            return fn(*args, **kwargs)
        return None

    return wrapped


def average_metrics(metrics: tp.Dict[str, float],
                    count: float = 1.0) -> tp.Dict[str, float]:
    """Average metrics across processes, weighted by `count`: the
    identity at world size 1."""
    del count
    if is_distributed():
        raise NotImplementedError(
            f"average_metrics across {world_size()} processes is not "
            f"ported yet: {TODO_MULTIPROCESS}")
    return metrics
