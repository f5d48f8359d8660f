"""Tracer: host-side spans -> Chrome/Perfetto trace + telemetry.jsonl (the
port of flashy_tpu/observability/tracer.py).

The host-side complement of the device profiler: a zero-dependency span
recorder whose output loads into Perfetto or chrome://tracing (the
Chrome trace-event JSON format), plus an append-only `telemetry.jsonl`
journal of structured records (a crash keeps every line written so far).
Every event is a Python dict appended under a lock; nothing here touches
a CUDA device, so spans may wrap a graph capture or a replay.
"""
from contextlib import contextmanager
from pathlib import Path
import functools
import json
import threading
import time
import typing as tp

from ..utils import AnyPath, write_and_rename


class JsonlJournal:
    """Append-only JSONL file with an optional size-capped rotation.

    When `max_bytes` is set and the next line would push the current
    file past it, the file is rotated to `<name>.1` (older generations
    shift to `.2..keep`, the oldest is dropped) and a fresh file is
    opened whose first record documents the rotation.

    Not thread-safe on its own: callers (Tracer, RequestTracer) hold
    their own lock around `write_line`.
    """

    def __init__(self, path: AnyPath, max_bytes: tp.Optional[int] = None,
                 keep: int = 3):
        if max_bytes is not None and max_bytes < 1024:
            raise ValueError(f"max_bytes must be >= 1024, got {max_bytes}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.path = Path(path)
        self.max_bytes = max_bytes
        self.keep = keep
        self.rotations = 0
        self._file: tp.Optional[tp.IO[str]] = None
        self._size = 0

    def write_line(self, line: str) -> None:
        """Append one line (flushed); rotates first when it would not fit."""
        data = line + "\n"
        if self._file is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "a")
            self._size = self._file.tell()
        if (self.max_bytes is not None and self._size > 0
                and self._size + len(data) > self.max_bytes):
            self._rotate()
        self._file.write(data)
        self._file.flush()
        self._size += len(data)

    def _rotate(self) -> None:
        assert self._file is not None
        self._file.close()
        sibling = self.path.with_name
        oldest = sibling(f"{self.path.name}.{self.keep}")
        if oldest.exists():
            oldest.unlink()
        for i in range(self.keep - 1, 0, -1):
            src = sibling(f"{self.path.name}.{i}")
            if src.exists():
                src.rename(sibling(f"{self.path.name}.{i + 1}"))
        self.path.rename(sibling(f"{self.path.name}.1"))
        self.rotations += 1
        self._file = open(self.path, "a")
        self._size = 0
        note = json.dumps({"time": time.time(), "type": "journal_rotated",
                           "rotation": self.rotations, "keep": self.keep,
                           "max_bytes": self.max_bytes})
        self._file.write(note + "\n")
        self._file.flush()
        self._size = len(note) + 1

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def _tid() -> int:
    return threading.get_ident() % (1 << 31)


class Tracer:
    """Records host-side monotonic events and exports them.

    Spans nest by time containment within one pid/tid (the Chrome trace
    format's rule); other threads get their own tid lanes. All methods
    are thread-safe.

    Args:
        trace_path: where `export_chrome_trace()` writes by default.
        jsonl_path: the append-only journal; each `record()` writes one
            JSON line and flushes.
        rank: process index, the trace `pid` and a field of every
            journal record.
        max_events: in-memory event cap; past it new events are counted
            in `dropped` instead of recorded (the journal is unaffected).
        max_journal_bytes, journal_keep: the journal's rotation (see
            `JsonlJournal`); None keeps it unbounded.
    """

    def __init__(self, trace_path: tp.Optional[AnyPath] = None,
                 jsonl_path: tp.Optional[AnyPath] = None,
                 rank: int = 0, max_events: int = 200_000,
                 max_journal_bytes: tp.Optional[int] = None,
                 journal_keep: int = 3):
        self.trace_path = Path(trace_path) if trace_path else None
        self.jsonl_path = Path(jsonl_path) if jsonl_path else None
        self.rank = rank
        self.max_events = max_events
        self.dropped = 0
        self._events: tp.List[tp.Dict[str, tp.Any]] = []
        self._lock = threading.Lock()
        self._journal = (JsonlJournal(self.jsonl_path,
                                      max_bytes=max_journal_bytes,
                                      keep=journal_keep)
                         if self.jsonl_path else None)
        self._t0 = time.perf_counter()
        self._add_meta("process_name", {"name": f"rank{rank}"})

    # ------------------------------------------------------------------
    # event recording
    # ------------------------------------------------------------------
    def _add_meta(self, name: str, args: tp.Dict[str, tp.Any]) -> None:
        with self._lock:
            self._events.append({"name": name, "ph": "M", "pid": self.rank,
                                 "tid": _tid(), "args": args})

    def _add(self, event: tp.Dict[str, tp.Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    def _ts(self, at: tp.Optional[float] = None) -> float:
        return ((time.perf_counter() if at is None else at) - self._t0) * 1e6

    def complete(self, name: str, start: float, duration: float,
                 category: str = "host", **args: tp.Any) -> None:
        """Record a completed span from raw `time.perf_counter()` times
        (for callers that measured a phase themselves, e.g. StepTimer)."""
        self._add({"name": name, "cat": category, "ph": "X",
                   "ts": self._ts(start), "dur": duration * 1e6,
                   "pid": self.rank, "tid": _tid(), "args": args})

    @contextmanager
    def span(self, name: str, category: str = "host", **args: tp.Any):
        """Context manager recording one complete ('X') event."""
        start = time.perf_counter()
        try:
            yield self
        finally:
            duration = time.perf_counter() - start
            self.complete(name, start, duration, category=category, **args)

    def wrap(self, fn: tp.Optional[tp.Callable] = None, *,
             name: tp.Optional[str] = None) -> tp.Callable:
        """Decorator form of `span`: `@tracer.wrap` or
        `@tracer.wrap(name=...)`."""
        if fn is None:
            return functools.partial(self.wrap, name=name)

        span_name = name or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapped(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            with self.span(span_name):
                return fn(*args, **kwargs)

        return wrapped

    def instant(self, name: str, category: str = "host",
                **args: tp.Any) -> None:
        """Record a zero-duration marker event."""
        self._add({"name": name, "cat": category, "ph": "i", "s": "p",
                   "ts": self._ts(), "pid": self.rank, "tid": _tid(),
                   "args": args})

    def counter(self, name: str, **values: float) -> None:
        """Record a counter sample (a track in Perfetto)."""
        self._add({"name": name, "ph": "C", "ts": self._ts(),
                   "pid": self.rank, "args": dict(values)})

    # ------------------------------------------------------------------
    # async spans (request-scoped tracing)
    # ------------------------------------------------------------------
    def _async(self, ph: str, name: str, span_id: int, category: str,
               args: tp.Dict[str, tp.Any]) -> None:
        self._add({"name": name, "cat": category, "ph": ph,
                   "id": f"0x{span_id:x}", "ts": self._ts(),
                   "pid": self.rank, "tid": _tid(), "args": args})

    def async_begin(self, name: str, span_id: int, category: str = "serve",
                    **args: tp.Any) -> None:
        """Open an async ('b') span keyed by `(category, id)`: a span that
        crosses call stacks, as a serving request does (submitted in one
        stack, retired many scheduler steps later). Nested begin/end
        pairs under one id render as sub-phases."""
        self._async("b", name, span_id, category, args)

    def async_instant(self, name: str, span_id: int, category: str = "serve",
                      **args: tp.Any) -> None:
        """An async instant ('n') marker inside an open async span."""
        self._async("n", name, span_id, category, args)

    def async_end(self, name: str, span_id: int, category: str = "serve",
                  **args: tp.Any) -> None:
        """Close the async span `async_begin` opened (same name and id)."""
        self._async("e", name, span_id, category, args)

    @property
    def events(self) -> tp.List[tp.Dict[str, tp.Any]]:
        """Snapshot of the recorded trace events."""
        with self._lock:
            return list(self._events)

    # ------------------------------------------------------------------
    # journal
    # ------------------------------------------------------------------
    def record(self, record: tp.Dict[str, tp.Any]) -> None:
        """Append one structured record to `telemetry.jsonl` (flushed),
        with `time` (unix seconds) and `rank` stamped in."""
        if self._journal is None:
            return
        line = json.dumps({"time": time.time(), "rank": self.rank, **record},
                          default=float)
        with self._lock:
            self._journal.write_line(line)

    @property
    def journal_rotations(self) -> int:
        """How many times the telemetry journal rotated (0 = never)."""
        return self._journal.rotations if self._journal is not None else 0

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def export_chrome_trace(self, path: tp.Optional[AnyPath] = None) -> Path:
        """Write the Chrome trace-event JSON (an atomic full rewrite: the
        file is always a complete trace of everything recorded so far)."""
        target = Path(path) if path else self.trace_path
        if target is None:
            raise ValueError("no trace path: pass `path` or set `trace_path`")
        payload: tp.Dict[str, tp.Any] = {"traceEvents": self.events,
                                         "displayTimeUnit": "ms"}
        if self.dropped:
            payload["metadata"] = {"dropped_events": self.dropped}
        target.parent.mkdir(parents=True, exist_ok=True)
        with write_and_rename(target, "w") as f:
            json.dump(payload, f)
        return target

    def close(self) -> None:
        """Export the trace (when a path is set) and close the journal."""
        if self.trace_path is not None:
            self.export_chrome_trace()
        with self._lock:
            if self._journal is not None:
                self._journal.close()
