"""Small host-side helpers shared across the port."""
import typing as tp

import torch


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
