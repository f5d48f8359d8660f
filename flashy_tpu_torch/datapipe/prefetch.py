"""prefetch(): a bounded background-thread pipeline stage with telemetry
(the port of flashy_tpu/datapipe/prefetch.py).

A background thread runs the upstream stages (read, mix, pack: host
work) while the training step runs, and `StepTimer`'s data wait
measures whatever overlap failed to hide. Exact resume across the
buffer: the worker snapshots the source cursor after producing each
batch and the snapshot travels with the batch through the queue, so
`state_dict()` describes the last batch the consumer received; batches
fetched ahead but never consumed are replayed after restore, not lost.
"""
import queue
import threading
import time
import typing as tp

from .iterator import PipelineStage

_WAIT = 0.1  # seconds; stop-flag poll granularity for blocking put/get


def _tracer():
    """The active telemetry tracer, or None (a lazy lookup: no hard
    dependency on observability)."""
    from ..observability import get_telemetry
    telemetry = get_telemetry()
    return None if telemetry is None else telemetry.tracer


def _batch_tokens(batch: tp.Any) -> int:
    """Token count of a batch for the throughput counter (packed-batch
    dicts report their `tokens` field; anything else counts 0)."""
    if isinstance(batch, dict) and hasattr(batch.get("tokens"), "size"):
        return int(batch["tokens"].size)
    return 0


class PrefetchIterator(PipelineStage):
    """Run `source` in a background thread, `size` batches ahead.

    `state_dict()` returns the source's cursor as of the last batch
    YIELDED to the caller (the worker attaches a post-batch snapshot to
    every queue entry); before any yield it is the cursor at
    construction/restore time. `load_state_dict` stops the worker,
    repositions the source, and restarts lazily on the next `__next__`.

    With telemetry enabled, every yield samples a Perfetto counter
    track ``datapipe/prefetch`` (queue depth and cumulative host-side
    tokens/s); `stats()` exposes the same numbers programmatically.
    """

    def __init__(self, source: tp.Any, size: int = 2):
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        self.source = source
        self.size = size
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._thread: tp.Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._last_state = source.state_dict()
        self._done = False
        self._batches = 0
        self._tokens = 0
        self._first_yield: tp.Optional[float] = None

    # ----------------------------------------------------------- worker
    def _work(self) -> None:
        try:
            while not self._stopping.is_set():
                try:
                    item = next(self.source)
                except StopIteration:
                    self._put(("done", None, None))
                    return
                # snapshot AFTER the batch: this is the cursor a resumed
                # run needs to produce the batch AFTER `item`.
                self._put(("item", item, self.source.state_dict()))
        except BaseException as exc:  # propagate into the consumer
            self._put(("error", exc, None))

    def _put(self, entry: tp.Any) -> None:
        while not self._stopping.is_set():
            try:
                self._queue.put(entry, timeout=_WAIT)
                return
            except queue.Full:
                continue

    def _ensure_worker(self) -> None:
        if self._thread is None and not self._done:
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._work, name="datapipe-prefetch", daemon=True)
            self._thread.start()

    def _stop_worker(self) -> None:
        if self._thread is None:
            return
        self._stopping.set()
        while self._thread.is_alive():
            try:  # drain so a blocked put can observe the stop flag
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=_WAIT)
        self._thread = None
        while True:  # leftover entries belong to the abandoned position
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        # The worker advanced the source past the drained read-ahead;
        # rewind to the last CONSUMED cursor so resuming iteration (e.g.
        # a persistent pipe re-wrapped by a device prefetcher next
        # epoch, whose early-stop close() lands here) replays those batches
        # instead of silently dropping them.
        self.source.load_state_dict(self._last_state)

    # --------------------------------------------------------- consumer
    def __next__(self) -> tp.Any:
        if self._done:
            raise StopIteration
        self._ensure_worker()
        kind, item, state = self._queue.get()
        if kind == "done":
            self._done = True
            self._thread = None
            raise StopIteration
        if kind == "error":
            self._done = True
            self._thread = None
            raise item
        self._last_state = state
        self._batches += 1
        self._tokens += _batch_tokens(item)
        now = time.perf_counter()
        if self._first_yield is None:
            self._first_yield = now
        tracer = _tracer()
        if tracer is not None:
            tracer.counter("datapipe/prefetch",
                           queue_depth=float(self._queue.qsize()),
                           tokens_per_s=self.stats()["tokens_per_s"])
        return item

    def stats(self) -> tp.Dict[str, float]:
        """Throughput counters: batches/tokens yielded and host-side
        tokens/s since the first yield."""
        elapsed = (time.perf_counter() - self._first_yield
                   if self._first_yield is not None else 0.0)
        return {"batches": float(self._batches),
                "tokens": float(self._tokens),
                "tokens_per_s": self._tokens / elapsed if elapsed > 0 else 0.0,
                "queue_depth": float(self._queue.qsize())}

    # ------------------------------------------------------------ state
    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {"source": self._last_state}

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        self._stop_worker()
        self.source.load_state_dict(state["source"])
        self._last_state = self.source.state_dict()
        self._done = False

    def close(self) -> None:
        self._stop_worker()
        super().close()


def prefetch(source: tp.Any, size: int = 2) -> PrefetchIterator:
    """Wrap `source` in a background-thread `PrefetchIterator` keeping
    `size` batches in flight. The batches stay numpy on the host;
    `data.prefetch_to_device` over this iterator keeps their uploads in
    flight to the card (and rewinds it past undelivered batches on an
    early stop)."""
    return PrefetchIterator(source, size=size)
