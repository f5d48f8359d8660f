"""Telemetry: per-process observability aggregate + global enable switch
(the port of flashy_tpu/observability/telemetry.py).

One object owns this process's tracer, recompile watchdog, heartbeat and
roofline profiler, and a module-global switch (`get_telemetry()`) lets
the solver, LogProgressBar and the serving engine pick it up without an
object threaded through every constructor. Disabled (the default), it
costs one `is None` check per call site.
"""
from pathlib import Path
import typing as tp

from ..xp import HEARTBEAT_DIR_NAME, TELEMETRY_NAME, TRACE_NAME  # noqa
from .heartbeat import Heartbeat
from .roofline import RooflineProfiler
from .steptimer import StepTimer
from .tracer import Tracer
from .watchdog import RecompileWatchdog


def _rank_name(name: str, rank: int) -> str:
    """Rank 0 owns the unsuffixed names; rank r writes
    `telemetry.{r}.jsonl` and `trace.{r}.json`."""
    if rank == 0:
        return name
    stem, dot, suffix = name.rpartition(".")
    return f"{stem}.{rank}.{suffix}" if dot else f"{name}.{rank}"


class Telemetry:
    """Everything one process records about a run.

    Built by `enable_telemetry()` (or `BaseSolver.enable_telemetry`):

    * `tracer`: host spans -> `trace.json` + `telemetry.jsonl`;
    * `watchdog`: rebuilds past warm-up, reported by the serving
      CompileCache (every build and CUDA-graph capture);
    * `heartbeat`: per-rank liveness files under `heartbeats/`, beaten
      at step boundaries (throttled) and stage edges (forced);
    * `roofline`: per-step aten FLOPs + time -> realized MFU (OFF unless
      `roofline=True`: timing a serving step waits for the card after
      every call, a price an un-asked-for profiler must not charge).

    Args:
        max_journal_bytes: size cap on `telemetry.jsonl` (rotates to
            `.1..N` siblings past it); None keeps it unbounded.
        roofline: enable the RooflineProfiler.
    """

    def __init__(self, folder: tp.Union[str, Path], rank: int = 0,
                 world_size: int = 1, heartbeat_interval: float = 10.0,
                 recompile_warmup: int = 1, max_events: int = 200_000,
                 with_device_stats: bool = True,
                 max_journal_bytes: tp.Optional[int] = None,
                 roofline: bool = False):
        self.folder = Path(folder)
        self.rank = rank
        self.tracer = Tracer(
            trace_path=self.folder / _rank_name(TRACE_NAME, rank),
            jsonl_path=self.folder / _rank_name(TELEMETRY_NAME, rank),
            rank=rank, max_events=max_events,
            max_journal_bytes=max_journal_bytes)
        self.watchdog = RecompileWatchdog(warmup=recompile_warmup,
                                          tracer=self.tracer)
        self.heartbeat = Heartbeat(self.folder / HEARTBEAT_DIR_NAME,
                                   rank=rank, world_size=world_size,
                                   interval=heartbeat_interval,
                                   with_device_stats=with_device_stats)
        self.roofline = RooflineProfiler(tracer=self.tracer,
                                         enabled=roofline)

    @classmethod
    def from_xp(cls, **kwargs: tp.Any) -> "Telemetry":
        """Build against the active XP folder and the process' rank."""
        from .. import distrib
        from ..xp import get_xp
        kwargs.setdefault("folder", get_xp().folder)
        kwargs.setdefault("rank", distrib.rank())
        kwargs.setdefault("world_size", distrib.world_size())
        return cls(**kwargs)

    def span(self, name: str, **args: tp.Any):
        return self.tracer.span(name, **args)

    def record(self, record: tp.Dict[str, tp.Any]) -> None:
        self.tracer.record(record)

    def counter(self, name: str, **values: float) -> None:
        """Sample a Perfetto counter track."""
        self.tracer.counter(name, **values)

    def instant(self, name: str, category: str = "host",
                **args: tp.Any) -> None:
        """Drop a zero-duration marker."""
        self.tracer.instant(name, category=category, **args)

    def watch(self, fn: tp.Callable, name: tp.Optional[str] = None,
              warmup: tp.Optional[int] = None) -> tp.Callable:
        """`RecompileWatchdog.watch` on this telemetry's watchdog."""
        return self.watchdog.watch(fn, name=name, warmup=warmup)

    def step_timer(self, stage: str) -> StepTimer:
        """A StepTimer journaling through this telemetry's tracer, with
        the heartbeat beaten (throttled) at every step boundary."""
        def on_step(record: tp.Dict[str, float]) -> None:
            self.heartbeat.beat(step=int(record["step"]) + 1, stage=stage)

        return StepTimer(stage=stage, tracer=self.tracer, on_step=on_step)

    def export(self) -> Path:
        """Write or refresh the Chrome trace; returns its path."""
        return self.tracer.export_chrome_trace()

    def close(self) -> None:
        if self.roofline.enabled and self.roofline.profiles:
            self.roofline.record()
        self.tracer.close()


_current: tp.Optional[Telemetry] = None


def enable_telemetry(folder: tp.Optional[tp.Union[str, Path]] = None,
                     **kwargs: tp.Any) -> Telemetry:
    """Turn runtime telemetry on for this process and return it.

    `folder` defaults to the active XP folder; rank and world_size
    default from `flashy_tpu_torch.distrib`. Calling again replaces (and
    closes) the previous instance.
    """
    global _current
    if _current is not None:
        _current.close()
    from .. import distrib
    kwargs.setdefault("rank", distrib.rank())
    kwargs.setdefault("world_size", distrib.world_size())
    if folder is None:
        from ..xp import get_xp
        folder = get_xp().folder
    _current = Telemetry(folder=folder, **kwargs)
    return _current


def disable_telemetry() -> None:
    """Flush and turn the global telemetry off."""
    global _current
    if _current is not None:
        _current.close()
    _current = None


def get_telemetry() -> tp.Optional[Telemetry]:
    """The process-wide Telemetry, or None when disabled (the default)."""
    return _current
