"""ExperimentLogger: the interface every logging backend implements (the
port of flashy_tpu/loggers/base.py). Every media method takes `(prefix,
key, ...)` in that order."""
from abc import ABC, abstractmethod
from argparse import Namespace
import typing as tp

Prefix = tp.Union[str, tp.List[str]]


class ExperimentLogger(ABC):
    """Base interface for logging to experiment management tools."""

    @abstractmethod
    def log_hyperparams(self, params: tp.Union[tp.Dict[str, tp.Any],
                                               Namespace],
                        metrics: tp.Optional[dict] = None) -> None:
        """Record the hyperparameters (and optionally final metrics)."""
        ...

    @abstractmethod
    def log_metrics(self, prefix: Prefix, metrics: dict,
                    step: tp.Optional[int] = None) -> None:
        """Record scalar metrics under the given prefix at `step`."""
        ...

    @abstractmethod
    def log_audio(self, prefix: Prefix, key: str, audio: tp.Any,
                  sample_rate: int, step: tp.Optional[int] = None,
                  **kwargs: tp.Any) -> None:
        """Record an audio waveform shaped [C, T] (tensor or array)."""
        ...

    @abstractmethod
    def log_image(self, prefix: Prefix, key: str, image: tp.Any,
                  step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        """Record an image ([C, H, W] or [H, W, C], tensor or array)."""
        ...

    @abstractmethod
    def log_text(self, prefix: Prefix, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        """Record a text snippet."""
        ...

    @property
    @abstractmethod
    def with_media_logging(self) -> bool:
        """Whether media calls are honored (vs ignored)."""
        ...

    @property
    @abstractmethod
    def save_dir(self) -> tp.Optional[str]:
        """Directory where the data is saved, if any."""
        ...

    @property
    @abstractmethod
    def name(self) -> str:
        """Name of this backend."""
        ...

    @property
    def group_separator(self) -> str:
        """Character joining prefix groups in metric names."""
        return "/"
