"""LocalFSLogger: persist experiment outputs next to the checkpoints (the
port of flashy_tpu/loggers/localfs.py, text only). Writes into
`<xp.folder>/outputs/`."""
from pathlib import Path
import typing as tp

from ..distrib import rank_zero_only
from ..utils import write_and_rename
from .base import ExperimentLogger, Prefix


class LocalFSLogger(ExperimentLogger):
    """Logger storing assets directly into the experiment folder.

    Layout: `<save_dir>/{prefix}_{step}/{key}.{suffix}`. Scalar metrics
    are deliberately *not* re-written here — they already land in the
    log file, the stage summaries, and `history.json`.

    Writes are rank-zero gated: only process 0 touches the shared
    filesystem.
    """

    def __init__(self, save_dir: str, name: str = "local"):
        self._save_dir = save_dir
        self._name = name
        Path(save_dir).mkdir(parents=True, exist_ok=True)

    def _path(self, prefix: Prefix, key: str, step: tp.Optional[int],
              suffix: str) -> Path:
        parts = [prefix] if isinstance(prefix, str) else list(prefix)
        if step is not None:
            parts.append(str(step))
        folder = Path(self._save_dir)
        if parts:
            folder = folder / "_".join(parts)
        folder.mkdir(parents=True, exist_ok=True)
        return folder / f"{key}.{suffix}"

    def log_metrics(self, prefix: Prefix, metrics: dict,
                    step: tp.Optional[int] = None) -> None:
        # Intentional no-op: metrics already reach the log file and
        # history.json; duplicating them here adds nothing.
        return None

    @rank_zero_only
    def log_text(self, prefix: Prefix, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        path = self._path(prefix, key, step, "txt")
        with write_and_rename(path, "w") as f:
            f.write(text)

    @property
    def save_dir(self) -> tp.Optional[str]:
        return self._save_dir

    @property
    def name(self) -> str:
        return self._name

    @classmethod
    def from_xp(cls, name: str = "local", sub_dir: str = "outputs"
                ) -> "LocalFSLogger":
        from ..xp import get_xp
        return cls(str(get_xp().folder / sub_dir), name=name)
