"""Retry with exponential backoff for transient-failure IO (the port of
flashy_tpu/resilience/retry.py).

The dominant IO failure of a long run is transient: an NFS attribute
hiccup, a full-then-freed disk, a wandb API timeout. The rule encoded
here: retry only exceptions the caller declared transient (an
allow-list, never bare Exception on a critical path), back off
exponentially with jitter so many ranks do not hammer a recovering
service in lockstep, journal every failed attempt through the telemetry
tracer, and choose per site whether exhaustion raises (checkpoint
writes: losing durability is fatal) or degrades to a warning (metric
backends: losing a point is not).
"""
import functools
import logging
import random
import time
import typing as tp

logger = logging.getLogger(__name__)

# One module-level PRNG for the jitter: reseeding per call would
# correlate the very ranks the jitter exists to decorrelate.
_jitter_rng = random.Random()

# Module-level so tests can stub the wait out; `sleep=None` and
# `clock=None` arguments resolve here at call time.
_sleep = time.sleep
_clock = time.monotonic


def backoff_delay(attempt: int, base_delay: float, max_delay: float,
                  jitter: float,
                  rng: tp.Optional[random.Random] = None) -> float:
    """Delay before retry number `attempt` (1-based): exponential growth
    capped at `max_delay`, plus up to `jitter` fraction of random extra."""
    delay = min(base_delay * (2 ** (attempt - 1)), max_delay)
    if jitter > 0.0:
        delay *= 1.0 + (rng or _jitter_rng).random() * jitter
    return delay


def _note_attempt(name: str, attempt: int, attempts: int,
                  error: BaseException, outcome: str) -> None:
    """Journal one failed attempt through the telemetry tracer (when
    telemetry is on), so retries are reconstructible post-mortem."""
    from ..observability import get_telemetry  # lazy: no import cycle
    telemetry = get_telemetry()
    if telemetry is not None:
        telemetry.record({"type": "retry", "site": name, "attempt": attempt,
                          "attempts": attempts, "outcome": outcome,
                          "error": f"{type(error).__name__}: {error}"})


def call_with_retry(fn: tp.Callable, *args: tp.Any,
                    attempts: int = 4,
                    base_delay: float = 0.1,
                    max_delay: float = 5.0,
                    jitter: float = 0.5,
                    retry_on: tp.Tuple[tp.Type[BaseException], ...]
                    = (OSError,),
                    name: tp.Optional[str] = None,
                    on_exhausted: str = "raise",
                    sleep: tp.Optional[tp.Callable[[float], None]] = None,
                    deadline: tp.Optional[float] = None,
                    clock: tp.Optional[tp.Callable[[], float]] = None,
                    **kwargs: tp.Any) -> tp.Any:
    """Call `fn(*args, **kwargs)`, retrying declared-transient failures.

    Only exceptions matching `retry_on` are retried; anything else is a
    bug or corruption and propagates at once. After `attempts` tries,
    `on_exhausted='raise'` re-raises the last error and `'warn'` logs a
    warning and returns None. Every failed attempt is WARNed and
    journaled as a `retry` record.

    `deadline=` caps the total seconds across all attempts: when the
    elapsed time plus the next delay would cross it, the failure counts
    as exhausted (honoring `on_exhausted`).
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if deadline is not None and deadline <= 0:
        raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
    if on_exhausted not in ("raise", "warn"):
        raise ValueError(f"on_exhausted must be 'raise' or 'warn', "
                         f"got {on_exhausted!r}")
    site = name or getattr(fn, "__qualname__", repr(fn))
    now = clock or _clock
    start = now()
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            delay = backoff_delay(attempt, base_delay, max_delay, jitter)
            over_deadline = (deadline is not None
                             and now() - start + delay > deadline)
            last = attempt == attempts or over_deadline
            _note_attempt(site, attempt, attempts, exc,
                          "exhausted" if last else "retrying")
            if last:
                why = (f"deadline {deadline:.2f}s exhausted after "
                       f"{now() - start:.2f}s" if over_deadline
                       else f"failed {attempt}/{attempts} attempts")
                if on_exhausted == "warn":
                    logger.warning(
                        "%s %s; degrading to a warning (last error: %s)",
                        site, why, exc)
                    return None
                if over_deadline:
                    logger.warning("%s %s; raising", site, why)
                raise
            logger.warning("%s failed (attempt %d/%d): %s — retrying in "
                           "%.2fs", site, attempt, attempts, exc, delay)
            (sleep or _sleep)(delay)
    raise AssertionError("unreachable")  # pragma: no cover


def retry(attempts: int = 4, base_delay: float = 0.1, max_delay: float = 5.0,
          jitter: float = 0.5,
          retry_on: tp.Tuple[tp.Type[BaseException], ...] = (OSError,),
          name: tp.Optional[str] = None, on_exhausted: str = "raise",
          sleep: tp.Optional[tp.Callable[[float], None]] = None,
          deadline: tp.Optional[float] = None,
          clock: tp.Optional[tp.Callable[[], float]] = None) -> tp.Callable:
    """Decorator form of `call_with_retry`. The wrapped unit must be
    idempotent (an atomic write-and-rename is; a collective is not)."""

    def decorator(fn: tp.Callable) -> tp.Callable:
        @functools.wraps(fn)
        def wrapped(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            return call_with_retry(
                fn, *args, attempts=attempts, base_delay=base_delay,
                max_delay=max_delay, jitter=jitter, retry_on=retry_on,
                name=name or getattr(fn, "__qualname__", repr(fn)),
                on_exhausted=on_exhausted, sleep=sleep, deadline=deadline,
                clock=clock, **kwargs)

        return wrapped

    return decorator
