"""PreemptionGuard: SIGTERM/SIGINT -> a cooperative stop at a boundary
(the port of flashy_tpu/resilience/preemption.py).

A preempted cloud machine gets SIGTERM and a short notice; without a
guard the run dies wherever it happens to be, possibly with an
asynchronous checkpoint half written. The guard turns the signal into a
cooperative stop: the handler only sets a flag (a signal handler must
not do IO), every rank agrees on the flag at step and stage boundaries
(`distrib.all_reduce_max`; on one process the local flag), and the
solver then finishes or abandons the stage in flight, finalizes any
asynchronous checkpoint and exits with a requeue-friendly code.
"""
import logging
import signal
import threading
import typing as tp

logger = logging.getLogger(__name__)

# 75 = EX_TEMPFAIL ("temporary failure; user is invited to retry"): the
# exit code a requeue wrapper keys on to resubmit instead of marking the
# job failed. Distinct from any Python default (1, 2, 130).
EXIT_PREEMPTED = 75


class PreemptionInterrupt(BaseException):
    """Raised at a cooperative boundary once all ranks agreed to stop.

    A BaseException (like KeyboardInterrupt), so a stage's `except
    Exception` cannot swallow the stop decision.
    """


class PreemptionGuard:
    """Cooperative preemption flag with agreement across ranks.

    * The signal handler (SIGTERM and SIGINT by default) only sets a
      local flag. A second delivery of the same signal restores the
      previous handler and re-raises it, so a double Ctrl-C still kills
      a stuck run.
    * `should_stop()` is the collective agreement: every rank brings its
      local flag to one max-reduction and all see the same verdict, so
      it must be called where every rank arrives the same number of
      times (stage and commit boundaries, every N steps).
    * The verdict is sticky.

    `simulate_signal()` sets the same flag the handler would: the hook
    the FaultInjector's `preempt_at` uses.
    """

    def __init__(self, signals: tp.Sequence[int] = (signal.SIGTERM,
                                                    signal.SIGINT),
                 exit_code: int = EXIT_PREEMPTED):
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self._requested = False
        self._agreed = False
        self._signal_name: tp.Optional[str] = None
        self._previous: tp.Dict[int, tp.Any] = {}
        self._check_calls = 0

    # ------------------------------------------------------------------
    # signal plumbing (local, per process)
    # ------------------------------------------------------------------
    def install(self) -> bool:
        """Register the handlers; returns False when that is not possible
        (only the main thread may set signal handlers; the guard still
        works through `simulate_signal`)."""
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionGuard.install() outside the main "
                           "thread: signal handlers not registered "
                           "(simulate_signal still works).")
            return False
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return True

    def uninstall(self) -> None:
        """Restore the previous signal handlers."""
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous.clear()

    def _handle(self, signum: int, frame: tp.Any) -> None:
        del frame
        if self._requested:
            logger.warning("preemption: second signal %d — restoring the "
                           "default handler and re-raising.", signum)
            self.uninstall()
            signal.raise_signal(signum)
            return
        self._requested = True
        self._signal_name = signal.Signals(signum).name
        logger.warning(
            "preemption: received %s; the run will stop cooperatively at "
            "the next stage/commit boundary (signal again to force-kill).",
            self._signal_name)

    def simulate_signal(self, name: str = "SIMULATED") -> None:
        """Set the local preemption flag as a real signal would."""
        if not self._requested:
            self._requested = True
            self._signal_name = name
            logger.warning("preemption: simulated signal %s; stopping at "
                           "the next boundary.", name)

    @property
    def requested(self) -> bool:
        """This process' local flag (no agreement)."""
        return self._requested

    @property
    def signal_name(self) -> tp.Optional[str]:
        return self._signal_name

    # ------------------------------------------------------------------
    # agreement across ranks (collective)
    # ------------------------------------------------------------------
    def should_stop(self) -> bool:
        """Do all ranks agree to stop? Collective: every rank calls it at
        the same boundary. Sticky once True."""
        if self._agreed:
            return True
        from .. import distrib  # lazy: the guard imports before the run
        if distrib.all_reduce_max(int(self._requested)):
            self._agreed = True
            logger.warning("preemption: stop agreed (local signal: %s).",
                           self._signal_name or "peer")
        return self._agreed

    def check(self, every: int = 1) -> bool:
        """Step-loop `should_stop`, throttled by call count (never by
        wall time, which would desynchronize the collective)."""
        self._check_calls += 1
        if self._agreed:
            return True
        if every > 1 and self._check_calls % every:
            return False
        return self.should_stop()


_current: tp.Optional[PreemptionGuard] = None


def enable_preemption_guard(install: bool = True,
                            **kwargs: tp.Any) -> PreemptionGuard:
    """Create (and install) the process-wide PreemptionGuard; calling
    again replaces the previous guard (uninstalling its handlers). See
    `BaseSolver.enable_preemption_guard` for the solver's side."""
    global _current
    if _current is not None:
        _current.uninstall()
    _current = PreemptionGuard(**kwargs)
    if install:
        _current.install()
    return _current


def disable_preemption_guard() -> None:
    """Uninstall and forget the process-wide guard."""
    global _current
    if _current is not None:
        _current.uninstall()
    _current = None


def get_preemption_guard() -> tp.Optional[PreemptionGuard]:
    """The process-wide guard, or None when disabled (the default)."""
    return _current
