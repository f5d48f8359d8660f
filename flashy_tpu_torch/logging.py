"""Logging: process-wide setup, progress bars as log lines, the serving
metrics' display rules, and per-epoch result fan-out to the experiment
logger backends (the port of flashy_tpu/logging.py).

`ResultLogger` always owns the local filesystem backend; TensorBoard
(`init_tensorboard`) and wandb (`init_wandb`) attach on demand, each
importing its package then and raising ImportError where it is missing.
"""
import logging
from argparse import Namespace
import sys
import time
import typing as tp
from collections.abc import Iterable, Sized
from pathlib import Path

from .formatter import Formatter
from .utils import AnyPath

_LEVEL_COLORS = {"DEBUG": "36", "INFO": "32", "WARNING": "33",
                 "ERROR": "31", "CRITICAL": "1;31"}


def colorize(text: str, color: str) -> str:
    """Wrap `text` in an ANSI escape sequence (e.g. color='1' for bold)."""
    return f"\033[{color}m{text}\033[0m"


def bold(text: str) -> str:
    """Render text in bold in the terminal."""
    return colorize(text, "1")


def serve_formatter() -> Formatter:
    """The display rules of the serving metrics: latencies (`*_ms*` keys)
    with an ms suffix, occupancy and acceptance as percentages, request
    and token tallies as integers; the JAX package's patterns and
    renderings."""
    def as_ms(value: float) -> str:
        return f"{value:.1f}ms"

    def as_percent(value: float) -> str:
        return f"{value * 100:.0f}%"

    return Formatter(formats={
        "*_ms_p*": as_ms, "*_ms": as_ms,
        "occupancy*": as_percent, "acceptance_rate": as_percent,
        "queue_depth*": ".1f", "accepted_per_step*": ".1f",
        "requests": "d", "completed": "d", "rejected": "d", "expired": "d",
        "tokens": "d", "finish_*": "d",
        "spec_drafted": "d", "spec_emitted": "d",
    })


class _AnsiFormatter(logging.Formatter):
    """Log line formatter, colorized for a terminal."""

    def __init__(self, use_color: bool = True):
        super().__init__(datefmt="%m-%d %H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        when = self.formatTime(record, self.datefmt)
        level = record.levelname
        message = record.getMessage()
        if record.exc_info and not record.exc_text:
            record.exc_text = self.formatException(record.exc_info)
        if self.use_color:
            when = colorize(when, "36")
            name = colorize(record.name, "34")
            level = colorize(level, _LEVEL_COLORS.get(record.levelname, "0"))
        else:
            name = record.name
        line = f"[{when}][{name}][{level}] - {message}"
        if record.exc_text:
            line = f"{line}\n{record.exc_text}"
        return line


def setup_logging(with_file_log: bool = True,
                  folder: tp.Optional[AnyPath] = None,
                  log_name: str = "solver.log.{rank}",
                  level: int = logging.INFO) -> None:
    """Configure root logging: stderr plus a per-rank file in the XP
    folder (`folder` defaults to the active XP's)."""
    from . import distrib
    root = logging.getLogger()
    root.setLevel(level)
    for handler in root.handlers[:]:
        root.removeHandler(handler)
        handler.close()

    stream = logging.StreamHandler(sys.stderr)
    stream.setLevel(level)
    stream.setFormatter(_AnsiFormatter(use_color=sys.stderr.isatty()))
    root.addHandler(stream)

    if with_file_log:
        if folder is None:
            from .xp import get_xp
            folder = get_xp().folder
        path = Path(folder) / log_name.format(rank=distrib.rank())
        file_handler = logging.FileHandler(path)
        file_handler.setLevel(level)
        file_handler.setFormatter(_AnsiFormatter(use_color=False))
        root.addHandler(file_handler)


class LogProgressBar:
    """tqdm-like progress reporting, as plain log lines.

    Wraps an iterable; every `total // updates` iterations emits one log
    line with the latest metrics (set via `update(**metrics)`) and a
    speed readout (it/sec, sec/it or ms/it). Logging is delayed one
    iteration so `update()`'s metrics are populated.

    `step_timer`, an `observability.StepTimer`, is driven from the
    iteration boundary: the time spent waiting on `next()` is the step's
    data wait, the rest of the loop body host time, minus the wait in
    `observe()`, which is device time. `BaseSolver.log_progress` attaches
    one when telemetry is enabled.
    """

    def __init__(self, logger: logging.Logger, iterable: Iterable,
                 updates: int = 5, min_interval: int = 1,
                 time_per_it: bool = False, total: tp.Optional[int] = None,
                 name: str = "LogProgressBar", level: int = logging.INFO,
                 delimiter: str = "|", items_delimiter: str = " ",
                 formatter: tp.Optional[Formatter] = None,
                 step_timer: tp.Optional[tp.Any] = None):
        self._iterable = iterable
        if total is None:
            if not isinstance(iterable, Sized):
                raise ValueError("pass total= for unsized iterables")
            total = len(iterable)
        self._total = total
        self._updates = updates
        self._min_interval = min_interval
        self._time_per_it = time_per_it
        self._name = name
        self._logger = logger
        self._level = level
        self._delimiter = delimiter
        self._items_delimiter = items_delimiter
        self._formatter = formatter or Formatter()
        self._step_timer = step_timer
        self._metrics: tp.Dict[str, str] = {}
        self._will_log = False

    def update(self, **metrics: tp.Any) -> bool:
        """Set the metrics for the next log line. Returns True if a line
        will be emitted at the end of this iteration."""
        self._metrics = self._formatter(metrics)
        return self._will_log

    def observe(self, *outputs: tp.Any) -> None:
        """Wait for the card to finish the step's outputs through the
        attached StepTimer (`torch.cuda.synchronize` on their devices),
        the wait charged to the step's device time. No-op without a timer
        or on CPU tensors, which have nothing to wait for."""
        if self._step_timer is not None:
            self._step_timer.observe(*outputs)

    def __iter__(self):
        self._iterator = iter(self._iterable)
        self._will_log = False
        self._index = -1
        self._metrics = {}
        self._begin = time.time()
        return self

    def __next__(self):
        if self._will_log:
            self._emit()
            self._will_log = False
        if self._step_timer is not None:
            # the step boundary: close the previous step, then time the
            # wait on next()
            self._step_timer.begin_data()
            try:
                value = next(self._iterator)
            except StopIteration:
                self._step_timer.finish()
                raise
            self._step_timer.end_data()
        else:
            value = next(self._iterator)
        self._index += 1
        if self._updates > 0:
            cadence = max(self._min_interval, self._total // self._updates)
            if self._index >= 1 and self._index % cadence == 0:
                self._will_log = True
        return value

    def _speed_text(self, speed: float) -> str:
        if speed < 1e-4:
            return "oo sec/it"
        if self._time_per_it:
            if speed < 1:
                return f"{1 / speed:.2f} sec/it"
            return f"{1000 / speed:.1f} ms/it"
        if speed < 0.1:
            return f"{1 / speed:.1f} sec/it"
        return f"{speed:.2f} it/sec"

    def _emit(self) -> None:
        speed = (1 + self._index) / (time.time() - self._begin)
        fields = [self._name, f"{self._index}/{self._total}",
                  self._speed_text(speed)]
        fields += [f"{k}{self._items_delimiter}{v}"
                   for k, v in self._metrics.items()]
        self._logger.log(self._level, f" {self._delimiter} ".join(fields))


class ResultLogger:
    """Fans experiment results out to every logger backend (always the
    local filesystem one, writing into the XP folder; TensorBoard and
    wandb once initialized) and prints the bold one-line stage
    summary."""

    def __init__(self, logger: logging.Logger, level: int = logging.INFO,
                 delimiter: str = "|"):
        from .loggers.localfs import LocalFSLogger
        self._logger = logger
        self._level = level
        self._delimiter = delimiter
        self._experiment_loggers: tp.Dict[str, tp.Any] = {
            "local": LocalFSLogger.from_xp(with_media_logging=True)}

    def init_tensorboard(self, **kwargs: tp.Any) -> None:
        """Attach a TensorBoard backend writing under the XP folder;
        raises ImportError when no TensorBoard package is installed."""
        from .loggers.tensorboard import TensorboardLogger
        self._experiment_loggers["tensorboard"] = \
            TensorboardLogger.from_xp(**kwargs)

    def init_wandb(self, **kwargs: tp.Any) -> None:
        """Attach a wandb backend whose run id is the XP signature;
        raises ImportError when `wandb` is not installed."""
        from .loggers.wandb import WandbLogger
        self._experiment_loggers["wandb"] = WandbLogger.from_xp(**kwargs)

    def _fanout(self, method: str, *args: tp.Any, **kwargs: tp.Any) -> None:
        """Call `method` on every backend (the `logger.<name>` fault
        site): a failure is retried once after a short backoff, and a
        backend that stays broken degrades to a WARNING: a wandb outage
        or a TensorBoard disk hiccup must never kill the run it
        observes."""
        from .resilience import chaos
        from .resilience.retry import call_with_retry
        for name, backend in self._experiment_loggers.items():
            bound = getattr(backend, method)

            def call(bound=bound, name=name) -> None:
                chaos.fault_point(f"logger.{name}", method=method)
                bound(*args, **kwargs)

            call_with_retry(call, name=f"logger.{name}.{method}",
                            attempts=2, base_delay=0.05, max_delay=0.5,
                            retry_on=(Exception,), on_exhausted="warn")

    def log_hyperparams(self, params: tp.Union[tp.Dict[str, tp.Any],
                                               Namespace],
                        metrics: tp.Optional[dict] = None) -> None:
        self._fanout("log_hyperparams", params, metrics)

    def get_log_progress_bar(self, stage: str, iterable: Iterable,
                             updates: int = 5,
                             total: tp.Optional[int] = None,
                             step: tp.Optional[int] = None,
                             step_name: tp.Optional[str] = None,
                             **kwargs: tp.Any) -> LogProgressBar:
        parts = [stage.capitalize()]
        if step is not None and step_name is not None:
            parts.append(f"{step_name.capitalize()} {step}")
        name = f" {self._delimiter} ".join(parts)
        return LogProgressBar(self._logger, iterable, updates=updates,
                              total=total, name=name,
                              delimiter=self._delimiter, **kwargs)

    def log_metrics(self, stage: str, metrics: dict,
                    step: tp.Optional[int] = None, step_name: str = "epoch",
                    formatter: tp.Optional[Formatter] = None) -> None:
        formatter = formatter or Formatter()
        parts = [f"{stage.capitalize()} Summary"]
        if step is not None:
            parts.append(f"{step_name.capitalize()} {step}")
        parts += [f"{key}={value}".strip()
                  for key, value in formatter(metrics).items()]
        self._logger.log(self._level,
                         bold(f" {self._delimiter} ".join(parts)))
        self._fanout("log_metrics", stage, metrics, step)

    def log_audio(self, stage: str, key: str, audio: tp.Any,
                  sample_rate: int, step: tp.Optional[int] = None,
                  **kwargs: tp.Any) -> None:
        self._fanout("log_audio", stage, key, audio, sample_rate, step,
                     **kwargs)

    def log_image(self, stage: str, key: str, image: tp.Any,
                  step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        self._fanout("log_image", stage, key, image, step, **kwargs)

    def log_text(self, stage: str, key: str, text: str,
                 step: tp.Optional[int] = None, **kwargs: tp.Any) -> None:
        self._fanout("log_text", stage, key, text, step, **kwargs)
