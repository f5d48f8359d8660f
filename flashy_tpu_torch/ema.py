"""Exponential moving average of parameters (the port of
flashy_tpu/ema.py).

`ema_update` folds the live parameters into an f32 shadow in place, as
foreach ops over the parameter list: `s * d`, then `+ p * (1 - d)`, both
in f32, the JAX package's rounding (`lerp` rounds otherwise). `EMA` wraps
a shadow in the solver's stateful protocol (`state_dict` /
`load_state_dict`), so `register_stateful` checkpoints it. The update
is elementwise work that the JAX package runs outside any Pallas kernel:
here it is plain PyTorch, no hand-written kernel.
"""
import logging
import typing as tp

import numpy as np
import torch

logger = logging.getLogger(__name__)

Tensors = tp.Union[tp.Sequence[torch.Tensor], tp.Mapping[str, torch.Tensor]]


def effective_decay(decay: float, step: tp.Optional[int] = None
                    ) -> np.float32:
    """The decay of one fold, in f32: `decay`, or with `step` (the
    optimizer's step count before its increment, from 0) the warm-up
    `min(decay, (1 + step) / (10 + step))`, which keeps the first folds
    from holding on to the random init."""
    if step is None:
        return np.float32(decay)
    step = np.float32(step)
    return min(np.float32(decay),
               (np.float32(1) + step) / (np.float32(10) + step))


def _as_list(tensors: Tensors) -> tp.List[torch.Tensor]:
    return list(tensors.values()) if isinstance(tensors, tp.Mapping) \
        else list(tensors)


@torch.no_grad()
def ema_update(shadow: Tensors, params: Tensors, decay: float = 0.999,
               step: tp.Optional[int] = None) -> Tensors:
    """One EMA fold, in place: `shadow <- shadow * d + params * (1 - d)`
    with `d = effective_decay(decay, step)`, in f32. `shadow` and
    `params` are sequences (or mappings, in the same order) of tensors
    of matching shapes on one device; the shadow is f32. Returns
    `shadow`."""
    d = effective_decay(decay, step)
    live = _as_list(shadow)
    sources = [p.detach().float() for p in _as_list(params)]
    if len(live) != len(sources):
        raise ValueError(f"EMA update: {len(live)} shadow tensors for "
                         f"{len(sources)} parameters")
    torch._foreach_mul_(live, float(d))
    torch._foreach_add_(live, sources, alpha=float(np.float32(1) - d))
    return shadow


class EMA:
    """A solver-checkpointable parameter EMA.

    Usage inside a solver::

        self.ema = EMA(dict(model.named_parameters()), decay=0.999)
        self.register_stateful("ema")
        ...
        optimizer.step()
        self.ema.update(dict(model.named_parameters()), step)

    The shadow (`self.shadow`, name -> tensor) starts as an f32 copy of
    the parameters on their devices: in bf16 the small per-step
    increments ((1 - decay) * update) fall below the resolution once
    decay > 0.995.
    """

    def __init__(self, params: tp.Mapping[str, torch.Tensor],
                 decay: float = 0.999, dtype: torch.dtype = torch.float32):
        self.decay = float(decay)
        self.shadow: tp.Dict[str, torch.Tensor] = {
            name: p.detach().to(dtype, copy=True) for name, p in
            params.items()}

    def update(self, params: tp.Mapping[str, torch.Tensor],
               step: tp.Optional[int] = None) -> tp.Dict[str, torch.Tensor]:
        """Fold `params` (the same names) in and return the shadow."""
        ema_update(self.shadow, [params[name] for name in self.shadow],
                   self.decay, step)
        return self.shadow

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {"decay": self.decay, "shadow": self.shadow}

    def load_state_dict(self, state: tp.Mapping[str, tp.Any]) -> None:
        """Copy a checkpointed shadow into the live one (its devices and
        dtypes). The live decay wins over the checkpointed one, with a
        warning when they differ; a different leaf count or shape
        raises."""
        checkpoint_decay = float(state["decay"])
        if abs(checkpoint_decay - self.decay) > 1e-12:
            logger.warning(
                "EMA decay mismatch on restore: checkpoint has %.6g, live "
                "config has %.6g; keeping the live value.",
                checkpoint_decay, self.decay)
        restored = _as_list(state["shadow"])
        live = list(self.shadow.values())
        if len(live) != len(restored):
            raise ValueError(
                f"EMA restore: checkpointed shadow has {len(restored)} "
                f"leaves, live shadow has {len(live)} — the model "
                f"structure changed since the checkpoint was written.")
        mismatched = [
            f"leaf {i}: checkpoint {tuple(r.shape)} vs live "
            f"{tuple(l.shape)}"
            for i, (r, l) in enumerate(zip(restored, live))
            if tuple(r.shape) != tuple(l.shape)]
        if mismatched:
            raise ValueError(
                "EMA restore: shadow leaf shapes differ from the live "
                "shadow (shape-blind restoring would corrupt the EMA):\n  "
                + "\n  ".join(mismatched))
        with torch.no_grad():
            for target, source in zip(live, restored):
                target.copy_(torch.as_tensor(source))
