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

`enable_telemetry` turns the runtime telemetry on (host spans, the
data-wait / host / device split of every step, the recompile watchdog,
heartbeats and, when asked for, the roofline); `enable_profiling` wraps
the selected stages in `torch.profiler` and writes a Chrome trace of
each into `<xp>/profiles/`.

Not ported yet, each raising `NotImplementedError` that names its
ROADMAP entry: the preemption guard, the hang watchdog, elastic resume,
declared state shardings, and sharded or asynchronous checkpoints.
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

TODO_RESILIENCE = ("ROADMAP.md queue A item 9, resilience half (the "
                   "preemption guard and the hang watchdog)")


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
        self._profile_folder: tp.Optional[Path] = None
        self._profile_stages: tp.Optional[tp.Set[str]] = None
        self._step_timers: tp.Dict[str, tp.Any] = {}
        self._recompiles_reported = 0

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
        """Wrap an iterable in a progress-logging iterator for this stage.

        With telemetry enabled the bar also drives a `StepTimer`: every
        iteration is split into data-wait / host / device time, journaled
        per step, and the summary lands in the stage metrics when the
        stage ends. Call `progress.observe(outputs)` with the step's
        outputs to bound the device time.
        """
        from . import observability
        telemetry = observability.get_telemetry()
        if telemetry is not None and "step_timer" not in kwargs:
            previous = self._step_timers.get(stage_name)
            if previous is not None:
                # a second loader in the same stage: journal the first
                # loader's in-flight step before handing over the slot
                previous.finish()
            timer = telemetry.step_timer(stage_name)
            self._step_timers[stage_name] = timer
            kwargs["step_timer"] = timer
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
    # telemetry and profiling
    # ------------------------------------------------------------------
    def enable_profiling(self, folder: tp.Optional[tp.Union[str, Path]]
                         = None,
                         stages: tp.Optional[tp.Sequence[str]] = None
                         ) -> None:
        """Profile each (selected) stage with `torch.profiler` (host and,
        with CUDA, device activity) and write its Chrome trace into
        `<xp.folder>/profiles/` (or `folder`) on rank 0, one file per
        stage and epoch. Call once before `run()`."""
        self._profile_folder = Path(folder) if folder \
            else self.folder / "profiles"
        self._profile_stages = set(stages) if stages else None

    def _should_profile(self, stage_name: str) -> bool:
        if self._profile_folder is None or not is_rank_zero():
            return False
        return self._profile_stages is None \
            or stage_name in self._profile_stages

    def enable_telemetry(self, **kwargs: tp.Any) -> tp.Any:
        """Turn runtime telemetry on for this run (host spans, the per-step
        data-wait / host / device split, the recompile watchdog, per-rank
        heartbeats; `roofline=True` adds the roofline profiler). The
        artifacts land in the XP folder: `trace.json` (Perfetto),
        `telemetry.jsonl` and `heartbeats/`. Call once before `run()`;
        returns the `observability.Telemetry`."""
        from . import observability
        kwargs.setdefault("folder", self.folder)
        return observability.enable_telemetry(**kwargs)

    # ------------------------------------------------------------------
    # what the port does not have yet
    # ------------------------------------------------------------------
    def enable_preemption_guard(self, *args: tp.Any,
                                **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"the preemption guard is not ported "
                                  f"yet: {TODO_RESILIENCE}")

    def enable_hang_watchdog(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"the hang watchdog is not ported yet: "
                                  f"{TODO_RESILIENCE}")

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
        `stage_name`; a failed stage's metrics are never committed.

        With telemetry enabled the stage beats the heartbeat at both
        edges (forced), runs inside a `stage/<name>` span, and its metrics
        take the step timer's summary, the roofline's stage summary (when
        the roofline is on) and the recompiles since the previous stage.
        With profiling on for this stage it runs under `torch.profiler`.
        """
        if self._current_stage is not None:
            raise RuntimeError("stages cannot nest")
        self._current_stage = stage_name
        self._current_formatter = self.get_formatter(stage_name)

        from . import observability
        telemetry = observability.get_telemetry()
        begin = time.time()
        # call-count snapshot: the roofline's stage summary prices only
        # this stage's calls
        roofline_mark = (telemetry.roofline.mark()
                         if telemetry is not None
                         and telemetry.roofline.enabled else None)
        try:
            if telemetry is not None:
                telemetry.heartbeat.beat(epoch=self.epoch, stage=stage_name,
                                         force=True)
            if self._should_profile(stage_name):
                metrics = self._run_stage_profiled(telemetry, stage_name,
                                                   method, *args, **kwargs)
            else:
                metrics = self._run_stage_traced(telemetry, stage_name,
                                                 method, *args, **kwargs)
            if metrics is None:
                metrics = {}
            if telemetry is not None:
                timer = self._step_timers.pop(stage_name, None)
                if timer is not None:
                    timer.finish()
                    for key, value in timer.summary().items():
                        metrics.setdefault(key, value)
                    if roofline_mark is not None:
                        # realized TFLOP/s and MFU over the stage: this
                        # stage's priced calls over its steps' summed wall
                        # clock (the device share is only the backlog at
                        # each step's end, see observability.steptimer)
                        wall = sum(r["total"] for r in timer.records)
                        for key, value in telemetry.roofline.stage_summary(
                                wall, since=roofline_mark).items():
                            metrics.setdefault(key, value)
                # the delta since the previous stage, not the run's total
                recompiles = sum(telemetry.watchdog.summary().values())
                if recompiles > self._recompiles_reported:
                    metrics.setdefault(
                        "recompiles", recompiles - self._recompiles_reported)
                self._recompiles_reported = recompiles
            metrics["duration"] = time.time() - begin
            self.log_metrics(stage_name, metrics)
        finally:
            self._current_stage = None
            self._current_formatter = None
            if telemetry is not None:
                # on a raising stage: journal the crashing step before the
                # export (a no-op on success, the timer was popped above)
                timer = self._step_timers.pop(stage_name, None)
                if timer is not None:
                    timer.finish()
                telemetry.heartbeat.beat(epoch=self.epoch, stage=stage_name,
                                         force=True)
                telemetry.record({"type": "stage", "stage": stage_name,
                                  "epoch": self.epoch,
                                  "duration": time.time() - begin})
                telemetry.export()
        return metrics

    def _run_stage_traced(self, telemetry: tp.Any, stage_name: str,
                          method: tp.Callable, *args: tp.Any,
                          **kwargs: tp.Any) -> tp.Any:
        if telemetry is None:
            return method(*args, **kwargs)
        with telemetry.span(f"stage/{stage_name}", epoch=self.epoch):
            return method(*args, **kwargs)

    def _run_stage_profiled(self, telemetry: tp.Any, stage_name: str,
                            method: tp.Callable, *args: tp.Any,
                            **kwargs: tp.Any) -> tp.Any:
        import torch
        from torch.profiler import ProfilerActivity, profile
        assert self._profile_folder is not None
        self._profile_folder.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            metrics = self._run_stage_traced(telemetry, stage_name, method,
                                             *args, **kwargs)
        prof.export_chrome_trace(str(
            self._profile_folder / f"{stage_name}-epoch{self.epoch}.json"))
        return metrics

    def run(self) -> None:
        raise NotImplementedError()
