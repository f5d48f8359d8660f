"""BaseSolver: inherit, register stateful attributes, implement run() (the
port of flashy_tpu/solver.py, single-process and single-file).

A solver owns the experiment (`self.xp`), a registry of stateful
attributes (`register_stateful`) and a result logger. Time is organized
in epochs of named stages; `commit()` appends the epoch's stage metrics
to the history and writes the checkpoint, both atomically, so an
interrupted run resumes exactly at the last committed epoch. Results
(metrics, hyperparameters, text, audio, images) fan out to the XP
folder and, once `init_tensorboard` / `init_wandb` attached them, to
TensorBoard and wandb.

Not ported yet, each raising `NotImplementedError` that names its
ROADMAP entry: telemetry and profiling, the preemption guard, the hang
watchdog, elastic resume, declared state shardings, and sharded or
asynchronous checkpoints.
"""
import logging
import time
import typing as tp
from pathlib import Path

from . import checkpoint as _checkpoint
from .distrib import is_rank_zero
from .formatter import Formatter
from .logging import LogProgressBar, ResultLogger
from .state import AttributeWrapper, StateManager
from .xp import get_xp

logger = logging.getLogger(__name__)

TODO_OPERATIONS = ("ROADMAP.md queue A item 2, T6 (telemetry, profiling, "
                   "preemption guard, hang watchdog)")


class BaseSolver:
    """Base class for training solvers. Subclasses implement `run()`,
    typically::

        def run(self):
            self.restore()
            for epoch in range(self.epoch, self.cfg.epochs + 1):
                self.run_stage('train', self.do_train)
                self.run_stage('valid', self.do_valid)
                self.commit()
    """

    checkpoint_name = "checkpoint.th"
    # How commit() persists state. Only 'single' (one file) is ported;
    # 'sharded' / 'auto' and asynchronous saves raise.
    checkpoint_mode = "single"
    checkpoint_async = False

    def __init__(self) -> None:
        self.stateful = StateManager()
        self.xp = get_xp()
        self.register_stateful("history")
        self.register_stateful("xp.cfg", "xp.sig", write_only=True)
        self.logger = logger
        self.result_logger = ResultLogger(self.logger)
        self._current_stage: tp.Optional[str] = None
        self._current_formatter: tp.Optional[Formatter] = None
        self._pending_metrics: tp.Dict[str, tp.Any] = {}

    @property
    def checkpoint_path(self) -> Path:
        return self.folder / self.checkpoint_name

    @property
    def history(self) -> tp.List[tp.Dict[str, tp.Any]]:
        """Per-epoch list of {stage_name: metrics} dicts."""
        return self.xp.link.history

    @property
    def folder(self) -> Path:
        return self.xp.folder

    @property
    def epoch(self) -> int:
        """Current epoch, starting at 1; resumes from the history length."""
        return len(self.history) + 1

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------
    def init_tensorboard(self, **kwargs: tp.Any) -> None:
        self.result_logger.init_tensorboard(**kwargs)

    def init_wandb(self, **kwargs: tp.Any) -> None:
        self.result_logger.init_wandb(**kwargs)

    def _check_in_stage(self) -> None:
        if self._current_stage is None:
            raise RuntimeError(
                "No stage is active: call this from within run_stage().")

    def log_hyperparams(self, params: dict,
                        metrics: tp.Optional[dict] = None) -> None:
        self.result_logger.log_hyperparams(params, metrics)

    def log_progress(self, stage_name: str, iterable: tp.Iterable,
                     total: tp.Optional[int] = None, updates: int = 5,
                     **kwargs: tp.Any) -> LogProgressBar:
        """Wrap an iterable in a progress-logging iterator for this stage."""
        return self.result_logger.get_log_progress_bar(
            stage_name, iterable, total=total, updates=updates,
            step=self.epoch, step_name="epoch", formatter=self.formatter,
            **kwargs)

    def log_metrics(self, stage_name: str, metrics: dict,
                    formatter: tp.Optional[Formatter] = None) -> None:
        """Log metrics for a stage of the current epoch (once per stage
        and epoch). Outside a stage, pass `formatter` explicitly."""
        if stage_name in self._pending_metrics:
            raise RuntimeError(
                f"Metrics for stage {stage_name!r} were already logged "
                f"during epoch {self.epoch}; each stage may be logged once "
                f"per epoch.")
        self._pending_metrics[stage_name] = metrics
        if formatter is None:
            formatter = self.formatter
        self.result_logger.log_metrics(stage_name, metrics, step=self.epoch,
                                       step_name="epoch", formatter=formatter)

    def log_audio(self, stage_name: str, key: str, audio: tp.Any,
                  sample_rate: int, **kwargs: tp.Any) -> None:
        self.result_logger.log_audio(stage_name, key, audio, sample_rate,
                                     self.epoch, **kwargs)

    def log_image(self, stage_name: str, key: str, image: tp.Any,
                  **kwargs: tp.Any) -> None:
        self.result_logger.log_image(stage_name, key, image, self.epoch,
                                     **kwargs)

    def log_text(self, stage_name: str, key: str, text: str,
                 **kwargs: tp.Any) -> None:
        self.result_logger.log_text(stage_name, key, text, self.epoch,
                                    **kwargs)

    # ------------------------------------------------------------------
    # state / checkpointing
    # ------------------------------------------------------------------
    def register_stateful(self, *args: str, write_only: bool = False) -> None:
        """Track attributes (dotted paths allowed) in the checkpoint:
        `nn.Module`s, optimizers and anything with state_dict /
        load_state_dict, lists, dicts or plain values. `write_only=True`
        records the value but never restores it (`xp.cfg`, `xp.sig`)."""
        for name in args:
            owner = self
            *path, leaf = name.split(".")
            for part in path:
                owner = getattr(owner, part)
            self.stateful.register(name, AttributeWrapper(owner, leaf),
                                   write_only)

    def set_state_sharding(self, name: str, shardings: tp.Any) -> None:
        raise NotImplementedError(
            f"declared state shardings are not ported yet: "
            f"{_checkpoint.TODO_SHARDED}")

    def state_dict(self) -> tp.Any:
        return self.stateful.state_dict()

    def load_state_dict(self, state: tp.Any) -> None:
        self.stateful.load_state_dict(state)

    def commit(self, save_checkpoint: bool = True) -> None:
        """Close the epoch: append the pending metrics to the history,
        write the checkpoint, then persist the history, both atomically.

        A failed save rolls the history append back (and `history.json`
        is only written after the save): `epoch` never runs ahead of what
        is restorable.
        """
        if self.checkpoint_mode != "single" or self.checkpoint_async:
            raise NotImplementedError(
                f"checkpoint_mode={self.checkpoint_mode!r}, checkpoint_async="
                f"{self.checkpoint_async}: only synchronous single-file "
                f"checkpoints are ported: {_checkpoint.TODO_SHARDED}")
        pending = self._pending_metrics
        self.history.append(pending)
        self._pending_metrics = {}
        try:
            if save_checkpoint and is_rank_zero():
                # the snapshot follows the append, so the checkpointed
                # history includes the epoch being committed
                _checkpoint.save_state(self.state_dict(),
                                       self.checkpoint_path)
                self.logger.debug("Checkpoint saved under %s", self.folder)
        except BaseException:
            self.history.pop()
            self._pending_metrics = pending
            raise
        if is_rank_zero():
            self.xp.link.update_history(self.history)

    def restore(self) -> bool:
        """Load the checkpoint if one exists. Returns True on success."""
        if not self.checkpoint_path.exists():
            return False
        self.load_state_dict(_checkpoint.load_state(self.checkpoint_path))
        self.logger.debug("Checkpoint restored from %s", self.folder)
        return True

    # ------------------------------------------------------------------
    # what the port does not have yet
    # ------------------------------------------------------------------
    def enable_profiling(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"profiling is not ported yet: "
                                  f"{TODO_OPERATIONS}")

    def enable_telemetry(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"telemetry is not ported yet: "
                                  f"{TODO_OPERATIONS}")

    def enable_preemption_guard(self, *args: tp.Any,
                                **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"the preemption guard is not ported "
                                  f"yet: {TODO_OPERATIONS}")

    def enable_hang_watchdog(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"the hang watchdog is not ported yet: "
                                  f"{TODO_OPERATIONS}")

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def get_formatter(self, stage_name: str) -> Formatter:
        """Override to customize metric display per stage."""
        return Formatter()

    @property
    def formatter(self) -> Formatter:
        self._check_in_stage()
        assert self._current_formatter is not None
        return self._current_formatter

    @property
    def current_stage(self) -> str:
        self._check_in_stage()
        assert self._current_stage is not None
        return self._current_stage

    def run_stage(self, stage_name: str, method: tp.Callable,
                  *args: tp.Any, **kwargs: tp.Any) -> tp.Dict[str, tp.Any]:
        """Run one named stage of the current epoch. The returned metrics
        (or {}) get a `duration` entry and are logged under
        `stage_name`; a failed stage's metrics are never committed."""
        if self._current_stage is not None:
            raise RuntimeError("stages cannot nest")
        self._current_stage = stage_name
        self._current_formatter = self.get_formatter(stage_name)
        begin = time.time()
        try:
            metrics = method(*args, **kwargs)
            if metrics is None:
                metrics = {}
            metrics["duration"] = time.time() - begin
            self.log_metrics(stage_name, metrics)
        finally:
            self._current_stage = None
            self._current_formatter = None
        return metrics

    def run(self) -> None:
        raise NotImplementedError()
