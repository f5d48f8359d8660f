"""WandbLogger: the Weights & Biases experiment backend (the port of
flashy_tpu/loggers/wandb.py).

`wandb` is imported when a logger is built, not when this module is;
where it is not installed, building a logger raises ImportError.
"""
import logging
from pathlib import Path
import typing as tp

from ..distrib import is_rank_zero, rank_zero_only
from . import utils
from .base import ExperimentLogger, Prefix

logger = logging.getLogger(__name__)


def wandb_module() -> tp.Any:
    """The `wandb` package; ImportError naming it where it is missing."""
    try:
        import wandb
    except ImportError as error:
        raise ImportError(f"the wandb backend needs the `wandb` package, "
                          f"which does not import here ({error})") from error
    return wandb


class WandbLogger(ExperimentLogger):
    """Log to Weights & Biases.

    The run id is the XP signature, so re-running the same config resumes
    the same wandb run; the marker file `wandb_flag` in the XP folder
    records that a run was started from this experiment. Only rank zero
    starts a run; the other ranks' calls do nothing.
    """

    def __init__(self, save_dir: str, with_media_logging: bool = True,
                 name: str = "wandb", project: tp.Optional[str] = None,
                 group: tp.Optional[str] = None,
                 run_id: tp.Optional[str] = None,
                 run_name: tp.Optional[str] = None, **kwargs: tp.Any):
        self._save_dir = save_dir
        self._with_media_logging = with_media_logging
        self._name = name
        self._wandb = wandb_module()
        self._run = None
        if not is_rank_zero():
            return
        flag = Path(save_dir) / "wandb_flag"
        resume = flag.exists()
        flag.parent.mkdir(parents=True, exist_ok=True)
        flag.touch()
        self._run = self._wandb.init(project=project, group=group, id=run_id,
                                     name=run_name, dir=save_dir,
                                     resume="allow" if resume else None,
                                     **kwargs)

    @rank_zero_only
    def log_hyperparams(self, params, metrics: tp.Optional[dict] = None
                        ) -> None:
        if self._run is None:
            return
        params = utils.sanitize_params(
            utils.flatten_dict(utils.convert_params(params)))
        self._run.config.update(params, allow_val_change=True)
        if metrics:
            self._run.log(metrics)

    @rank_zero_only
    def log_metrics(self, prefix: Prefix, metrics: dict,
                    step: tp.Optional[int] = None) -> None:
        if self._run is None:
            return
        self._run.log(utils.add_prefix(utils.sanitize_params(metrics),
                                       prefix, self.group_separator),
                      step=step)

    @rank_zero_only
    def log_audio(self, prefix: Prefix, key: str, audio: tp.Any,
                  sample_rate: int, step: tp.Optional[int] = None,
                  **kwargs: tp.Any) -> None:
        if self._run is None or not self.with_media_logging:
            return
        data = utils.to_numpy_media(audio)
        if data.ndim == 2:
            data = data.T  # wandb takes [T, C]
        tag = utils.join_prefix(prefix, key, self.group_separator)
        self._run.log({tag: self._wandb.Audio(
            data, sample_rate=int(sample_rate))}, step=step)

    @rank_zero_only
    def log_image(self, prefix: Prefix, key: str, image: tp.Any,
                  step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        if self._run is None or not self.with_media_logging:
            return
        tag = utils.join_prefix(prefix, key, self.group_separator)
        self._run.log({tag: self._wandb.Image(utils.to_numpy_media(image))},
                      step=step)

    @rank_zero_only
    def log_text(self, prefix: Prefix, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        if self._run is None or not self.with_media_logging:
            return
        tag = utils.join_prefix(prefix, key, self.group_separator)
        self._run.log({tag: self._wandb.Html(f"<pre>{text}</pre>")},
                      step=step)

    @property
    def with_media_logging(self) -> bool:
        return self._with_media_logging

    @property
    def save_dir(self) -> tp.Optional[str]:
        return self._save_dir

    @property
    def name(self) -> str:
        return self._name

    @staticmethod
    def _lookup_prior_run(sig: str, project: tp.Optional[str]):
        """The wandb run an earlier run of this XP created, through the
        public API (entity/project/sig), so that a resumed experiment
        keeps its group, display name and config; None where it cannot
        be read (offline, no login, first run)."""
        wandb = wandb_module()
        try:
            api = wandb.Api()
            project = (project or api.settings.get("project")
                       or "uncategorized")
            entity = api.default_entity
            path = (f"{entity}/{project}/{sig}" if entity
                    else f"{project}/{sig}")
            return api.run(path)
        except Exception as exc:  # no login, offline, no such run
            logger.info("wandb: could not recover prior run identity for "
                        "%s (%s); resuming with marker-file identity only.",
                        sig, exc)
            return None

    @classmethod
    def from_xp(cls, with_media_logging: bool = True, name: str = "wandb",
                project: tp.Optional[str] = None,
                **kwargs: tp.Any) -> "WandbLogger":
        """A logger for the active XP: run id = its signature. When the
        marker file says an earlier run exists, its group, name and
        config are read back (rank zero only)."""
        from ..xp import get_xp
        xp = get_xp()
        group = kwargs.pop("group", None)
        run_name = kwargs.pop("run_name", None)
        prior = None
        if is_rank_zero() and (Path(xp.folder) / "wandb_flag").exists():
            prior = cls._lookup_prior_run(xp.sig, project)
        if prior is not None:
            group, run_name = prior.group, prior.name
            if prior.config and "config" not in kwargs:
                kwargs["config"] = dict(prior.config)
        return cls(str(xp.folder), with_media_logging=with_media_logging,
                   name=name, project=project, group=group, run_id=xp.sig,
                   run_name=run_name, **kwargs)
