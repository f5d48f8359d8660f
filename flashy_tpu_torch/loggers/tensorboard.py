"""TensorboardLogger: a SummaryWriter-based experiment backend (the port
of flashy_tpu/loggers/tensorboard.py).

The writer's package is imported when a logger is built, not when this
module is: `torch.utils.tensorboard` (which needs the `tensorboard`
package), else `tensorboardX`. Where neither is installed, building a
logger raises ImportError naming them; nothing logs nothing quietly.
"""
import typing as tp

import numpy as np

from ..distrib import is_rank_zero, rank_zero_only
from . import utils
from .base import ExperimentLogger, Prefix


def summary_writer_class() -> type:
    """`SummaryWriter` of the first TensorBoard writer that imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter
    except ImportError as first:
        try:
            from tensorboardX import SummaryWriter  # type: ignore
            return SummaryWriter
        except ImportError:
            raise ImportError(
                "the TensorBoard backend needs the `tensorboard` package "
                "(for torch.utils.tensorboard) or `tensorboardX`; neither "
                f"imports here ({first})") from first


class TensorboardLogger(ExperimentLogger):
    """Log scalars, hyperparameters and media to TensorBoard. Only rank
    zero opens a writer; the other ranks' calls do nothing."""

    def __init__(self, save_dir: str, with_media_logging: bool = False,
                 name: str = "tensorboard", **kwargs: tp.Any):
        self._save_dir = save_dir
        self._with_media_logging = with_media_logging
        self._name = name
        writer = summary_writer_class()
        self._writer = (writer(log_dir=save_dir, **kwargs)
                        if is_rank_zero() else None)

    @rank_zero_only
    def log_hyperparams(self, params, metrics: tp.Optional[dict] = None
                        ) -> None:
        if self._writer is None:
            return
        params = utils.sanitize_params(
            utils.flatten_dict(utils.convert_params(params)))
        self._writer.add_hparams(params,
                                 dict(metrics or {"hparams_metrics": -1}))
        self._writer.flush()

    @rank_zero_only
    def log_metrics(self, prefix: Prefix, metrics: dict,
                    step: tp.Optional[int] = None) -> None:
        if self._writer is None:
            return
        named = utils.add_prefix(metrics, prefix, self.group_separator)
        for key, value in named.items():
            if isinstance(value, dict):
                self._writer.add_scalars(key, value, global_step=step)
            else:
                self._writer.add_scalar(
                    key, float(utils.to_numpy_media(value)),
                    global_step=step)
        self._writer.flush()

    @rank_zero_only
    def log_audio(self, prefix: Prefix, key: str, audio: tp.Any,
                  sample_rate: int, step: tp.Optional[int] = None,
                  **kwargs: tp.Any) -> None:
        if self._writer is None or not self.with_media_logging:
            return
        data = utils.to_numpy_media(audio)
        if data.ndim == 2:
            data = data.mean(axis=0)  # mono for the TensorBoard widget
        data = np.clip(data, -1.0, 1.0)
        self._writer.add_audio(
            utils.join_prefix(prefix, key, self.group_separator),
            data[None, :], global_step=step, sample_rate=int(sample_rate))
        self._writer.flush()

    @rank_zero_only
    def log_image(self, prefix: Prefix, key: str, image: tp.Any,
                  step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        if self._writer is None or not self.with_media_logging:
            return
        data = utils.to_numpy_media(image)
        dataformats = ("CHW" if data.ndim == 3 and data.shape[0] in (1, 3, 4)
                       else "HWC")
        self._writer.add_image(
            utils.join_prefix(prefix, key, self.group_separator), data,
            global_step=step, dataformats=dataformats)
        self._writer.flush()

    @rank_zero_only
    def log_text(self, prefix: Prefix, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        if self._writer is None or not self.with_media_logging:
            return
        self._writer.add_text(
            utils.join_prefix(prefix, key, self.group_separator), text,
            global_step=step)
        self._writer.flush()

    @property
    def with_media_logging(self) -> bool:
        return self._with_media_logging

    @property
    def save_dir(self) -> tp.Optional[str]:
        return self._save_dir

    @property
    def name(self) -> str:
        return self._name

    @classmethod
    def from_xp(cls, with_media_logging: bool = True,
                name: str = "tensorboard", sub_dir: str = "tensorboard",
                **kwargs: tp.Any) -> "TensorboardLogger":
        from ..xp import get_xp
        return cls(str(get_xp().folder / sub_dir),
                   with_media_logging=with_media_logging, name=name,
                   **kwargs)
