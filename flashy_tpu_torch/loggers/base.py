"""ExperimentLogger: the interface every logging backend implements (the
port of flashy_tpu/loggers/base.py, as far as the ported solvers use it:
metrics and text). Every method takes `(prefix, key, ...)` in that
order."""
from abc import ABC, abstractmethod
import typing as tp

Prefix = tp.Union[str, tp.List[str]]


class ExperimentLogger(ABC):
    """Base interface for logging to experiment management tools."""

    @abstractmethod
    def log_metrics(self, prefix: Prefix, metrics: dict,
                    step: tp.Optional[int] = None) -> None:
        """Record scalar metrics under the given prefix at `step`."""
        ...

    @abstractmethod
    def log_text(self, prefix: Prefix, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        """Record a text snippet."""
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
