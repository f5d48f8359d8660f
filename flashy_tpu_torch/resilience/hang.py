"""HangWatchdog: WARN, then optionally abort, on stalled heartbeats (the
port of flashy_tpu/resilience/hang.py).

A run that crashes is cheap: the scheduler requeues it. A run that hangs
(a rank stuck in a device wait or a collective) bills every card-hour
until someone notices. The heartbeats (`observability.heartbeat`) leave
per-rank liveness files because a hung process cannot report itself;
this monitor reads them from a side thread, which keeps running while
the main thread waits on the card (CUDA's synchronizing calls release
the GIL), WARNs with a straggler report when a rank stalls past a
threshold and optionally aborts the process: a silent hang becomes a
loud, requeueable crash.
"""
from pathlib import Path
import logging
import os
import threading
import time
import typing as tp

from ..observability.heartbeat import (format_straggler_report,
                                       straggler_report)
from ..utils import AnyPath

logger = logging.getLogger(__name__)

# EX_SOFTWARE: distinct from the preemption guard's EX_TEMPFAIL (75), so
# a requeue wrapper can tell "stop and resubmit me" from "I aborted a
# hung run".
EXIT_HUNG = 70


def _default_abort(exit_code: int, report: tp.Dict[str, tp.Any]) -> None:
    """Kill the process at once: `os._exit`, not `sys.exit`, as the main
    thread is presumed stuck and would never unwind a SystemExit raised
    on this monitor thread."""
    del report
    os._exit(exit_code)


class HangWatchdog:
    """Monitors the per-rank heartbeat files under `folder` for stalls.

    Args:
        folder: the heartbeat directory (`<xp.folder>/heartbeats`).
        warn_after: seconds of heartbeat staleness before a rank is
            reported stalled (WARN + straggler report).
        abort_after: optional; past this staleness `on_abort` runs
            (default `os._exit(EXIT_HUNG)`) with the report. None (the
            default) warns only.
        interval: the polling period of `start()`.
        on_warn / on_abort: injectable for tests and custom policy.

    `check()` is the one-shot core (a pure read); `start()` / `stop()`
    run it on a daemon thread.
    """

    def __init__(self, folder: AnyPath, warn_after: float = 120.0,
                 abort_after: tp.Optional[float] = None,
                 interval: float = 10.0,
                 exit_code: int = EXIT_HUNG,
                 on_warn: tp.Optional[tp.Callable[[str], None]] = None,
                 on_abort: tp.Optional[
                     tp.Callable[[int, tp.Dict[str, tp.Any]], None]] = None):
        if abort_after is not None and abort_after < warn_after:
            raise ValueError(f"abort_after ({abort_after}) must be >= "
                             f"warn_after ({warn_after})")
        self.folder = Path(folder)
        self.warn_after = warn_after
        self.abort_after = abort_after
        self.interval = interval
        self.exit_code = exit_code
        self.on_warn = on_warn or (lambda msg: logger.warning(msg))
        self.on_abort = on_abort or _default_abort
        self._warned: tp.Set[int] = set()
        self._stop = threading.Event()
        self._thread: tp.Optional[threading.Thread] = None

    def check(self, now: tp.Optional[float] = None) -> tp.Dict[str, tp.Any]:
        """One inspection pass: the straggler report with `stalled` (the
        ranks past warn_after) and `action` (None | 'warn' | 'abort').
        WARNs once per rank per stall (a rank that beats again re-arms
        its warning)."""
        now = time.time() if now is None else now
        report = straggler_report(self.folder, now=now)
        report["stalled"] = []
        report["action"] = None
        if not report.get("ranks"):
            return report
        stalled = []
        for beat in report["per_rank"]:
            age = now - beat["time"] if "time" in beat else 0.0
            if age > self.warn_after:
                stalled.append((beat.get("rank", 0), age))
        report["stalled"] = [rank for rank, _ in stalled]
        fresh = [r for r in report["stalled"] if r not in self._warned]
        self._warned.intersection_update(report["stalled"])
        if fresh:
            report["action"] = "warn"
            self._warned.update(fresh)
            self.on_warn(
                f"hang watchdog: rank(s) {fresh} heartbeat stalled past "
                f"{self.warn_after:.0f}s — {format_straggler_report(report)}")
        if (self.abort_after is not None and stalled
                and max(age for _, age in stalled) > self.abort_after):
            report["action"] = "abort"
            logger.critical(
                "hang watchdog: aborting (exit %d): rank(s) %s stalled past "
                "%.0fs — %s", self.exit_code, report["stalled"],
                self.abort_after, format_straggler_report(report))
            self.on_abort(self.exit_code, report)
        return report

    # ------------------------------------------------------------------
    # background thread
    # ------------------------------------------------------------------
    def start(self) -> "HangWatchdog":
        """Poll `check()` every `interval` seconds on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="flashy-hang-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception:
                logger.exception("hang watchdog check failed (continuing)")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None
