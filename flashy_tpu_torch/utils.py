"""Small host-side helpers shared across the port: metric averaging,
atomic file writes, percentiles, frozen parameter trees and device
resolution (the port's own copy of what it needs from
flashy_tpu/utils.py)."""
import os
import typing as tp
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

AnyPath = tp.Union[Path, str]


def averager(beta: float = 1.0) -> tp.Callable[..., tp.Dict[str, float]]:
    """Exponential moving average over dicts of metrics.

    Returns `update(metrics, weight=1)`, which folds the metrics into the
    running average and returns the averaged dict; `beta=1` is a plain
    weighted mean. Values may be Python numbers or one-element tensors
    (read to the host here, once per metric).
    """
    num: tp.Dict[str, float] = defaultdict(float)
    den: tp.Dict[str, float] = defaultdict(float)

    def _update(metrics: tp.Dict[str, tp.Any],
                weight: float = 1.0) -> tp.Dict[str, float]:
        for key, value in metrics.items():
            num[key] = num[key] * beta + weight * float(value)
            den[key] = den[key] * beta + weight
        return {key: value / den[key] for key, value in num.items()}

    return _update


@contextmanager
def write_and_rename(path: AnyPath, mode: str = "wb", suffix: str = ".tmp",
                     pid: bool = False):
    """Write to a temporary file, then rename it over `path`.

    The rename is atomic on POSIX filesystems, so a process killed
    mid-write never leaves a truncated file at `path`.
    """
    tmp_path = str(path) + suffix
    if pid:
        tmp_path += f".{os.getpid()}"
    with open(tmp_path, mode) as f:
        yield f
    os.rename(tmp_path, path)


def freeze(tree: tp.Any) -> tp.Any:
    """The tree (dicts, lists and tuples, any nesting) with every tensor
    leaf detached: the values are shared, not copied, and no gradient
    reaches them through the returned tree. Other leaves pass through
    unchanged. The port of the JAX package's `freeze`
    (`jax.lax.stop_gradient` over a pytree): apply an adversary with
    `functional_call(model, freeze(params), x)` and its parameters get
    no gradient from the enclosing backward."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return type(tree)({key: freeze(value) for key, value in tree.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(freeze(value) for value in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(freeze(value) for value in tree)
    return tree


# the reference's name for the same thing
readonly = freeze


def percentile(samples: tp.Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy semantics, stdlib-only).

    q is in [0, 100]; empty input returns 0.0 so summaries of an idle
    run stay well-formed.
    """
    if not samples:
        return 0.0
    ordered = sorted(samples)
    if len(ordered) == 1:
        return float(ordered[0])
    rank = (q / 100.0) * (len(ordered) - 1)
    low = int(rank)
    high = min(low + 1, len(ordered) - 1)
    frac = rank - low
    return float(ordered[low] * (1.0 - frac) + ordered[high] * frac)


def resolve_device(device: tp.Any = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless asked otherwise.

    With no explicit `device` and no CUDA device present this raises
    instead of quietly running on the CPU: a serving or measurement run
    that silently lands on the host would report host numbers under a
    device's name.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly "
            "to run on the host")
    return torch.device("cuda")


def check_same_device(what: str, tensor: torch.Tensor,
                      device: torch.device) -> None:
    """Raise when `tensor` does not live on `device` (type and index)."""
    want = torch.device(device)
    got = tensor.device
    if got.type != want.type or (want.index is not None
                                 and got.index != want.index):
        raise ValueError(f"{what} lives on {got}, expected {want}")
