"""LocalFSLogger: persist experiment outputs next to the checkpoints (the
port of flashy_tpu/loggers/localfs.py). Writes hyperparameters, text,
wav audio (the stdlib `wave` module) and png images (PIL) into
`<xp.folder>/outputs/`."""
import json
from pathlib import Path
import typing as tp
import wave

import numpy as np

from ..distrib import rank_zero_only
from ..utils import write_and_rename
from . import utils
from .base import ExperimentLogger, Prefix


class LocalFSLogger(ExperimentLogger):
    """Logger storing assets directly into the experiment folder.

    Layout: `<save_dir>/{prefix}_{step}/{key}.{suffix}`, or real
    subdirectories with `use_subdirs=True`. Scalar metrics are
    deliberately *not* re-written here: they already land in the log
    file, the stage summaries and `history.json`.

    Writes are rank-zero gated: only process 0 touches the shared
    filesystem.
    """

    def __init__(self, save_dir: str, with_media_logging: bool = True,
                 name: str = "local", use_subdirs: bool = False):
        self._save_dir = save_dir
        self._with_media_logging = with_media_logging
        self._name = name
        self._use_subdirs = use_subdirs
        Path(save_dir).mkdir(parents=True, exist_ok=True)

    def _media_path(self, prefix: Prefix, key: str, step: tp.Optional[int],
                    suffix: str) -> Path:
        parts = [prefix] if isinstance(prefix, str) else list(prefix)
        if step is not None:
            parts.append(str(step))
        folder = Path(self._save_dir)
        if self._use_subdirs:
            for part in parts:
                folder = folder / part
        elif parts:
            folder = folder / "_".join(parts)
        folder.mkdir(parents=True, exist_ok=True)
        return folder / f"{key}.{suffix}"

    @rank_zero_only
    def log_hyperparams(self, params, metrics: tp.Optional[dict] = None
                        ) -> None:
        params = utils.sanitize_params(
            utils.flatten_dict(utils.convert_params(params)))
        with write_and_rename(Path(self._save_dir) / "hyperparams.json",
                              "w") as f:
            json.dump(params, f, indent=2)

    def log_metrics(self, prefix: Prefix, metrics: dict,
                    step: tp.Optional[int] = None) -> None:
        # Intentional no-op: metrics already reach the log file and
        # history.json; duplicating them here adds nothing.
        return None

    @rank_zero_only
    def log_audio(self, prefix: Prefix, key: str, audio: tp.Any,
                  sample_rate: int, step: tp.Optional[int] = None,
                  **kwargs: tp.Any) -> None:
        if not self.with_media_logging:
            return
        data = utils.to_numpy_media(audio)
        if data.ndim == 1:
            data = data[None, :]
        # [C, T] float in [-1, 1] -> 16-bit PCM
        pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype("<i2")
        path = self._media_path(prefix, key, step, "wav")
        with write_and_rename(path, "wb") as f:
            with wave.open(f, "wb") as w:
                w.setnchannels(pcm.shape[0])
                w.setsampwidth(2)
                w.setframerate(int(sample_rate))
                w.writeframes(pcm.T.tobytes())

    @rank_zero_only
    def log_image(self, prefix: Prefix, key: str, image: tp.Any,
                  step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        if not self.with_media_logging:
            return
        from PIL import Image
        data = utils.to_numpy_media(image)
        if data.ndim == 3 and data.shape[0] in (1, 3, 4) \
                and data.shape[-1] not in (1, 3, 4):
            data = np.moveaxis(data, 0, -1)  # [C, H, W] -> [H, W, C]
        if data.dtype != np.uint8:
            data = (np.clip(data, 0.0, 1.0) * 255.0).astype(np.uint8)
        if data.ndim == 3 and data.shape[-1] == 1:
            data = data[..., 0]
        Image.fromarray(data).save(self._media_path(prefix, key, step, "png"))

    @rank_zero_only
    def log_text(self, prefix: Prefix, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        if not self.with_media_logging:
            return
        path = self._media_path(prefix, key, step, "txt")
        with write_and_rename(path, "w") as f:
            f.write(text)

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
    def from_xp(cls, with_media_logging: bool = True, name: str = "local",
                sub_dir: str = "outputs", **kwargs: tp.Any
                ) -> "LocalFSLogger":
        from ..xp import get_xp
        return cls(str(get_xp().folder / sub_dir),
                   with_media_logging=with_media_logging, name=name,
                   **kwargs)
