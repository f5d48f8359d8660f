"""StepTimer: per-step data-wait / host / device wall-clock split (the port
of flashy_tpu/observability/steptimer.py).

A training step's wall clock is data-wait (the loader did not have the
next batch ready) + host (Python between the batch's arrival and the
last launch) + device (work still in flight on the card when the step's
outputs are observed). The split names the bottleneck: a data-bound
stage needs loader workers, a host-bound one less Python per step, a
device-bound one runs as fast as the kernels allow.

The reference dispatches a whole compiled step at once, so its host
phase is short and `device` is nearly all of the card's work. The port
launches a step op by op from Python and the card runs each launch as it
arrives: the card's work overlaps `host`, and `device` is only the
backlog left when the launches end. A large host share then says the
launch loop takes about as long as the card's work or longer (the card
kept pace with it), not that the card sat idle; the card's busy time
comes from the profiler (`BaseSolver.enable_profiling`).
"""
import time
import typing as tp

from ..utils import percentile as _percentile
from .tracer import Tracer


def _wait_for(outputs: tp.Sequence[tp.Any]) -> None:
    """Wait until the card has finished the work producing `outputs`:
    one `torch.cuda.synchronize` per CUDA device among the tensors (the
    launches are asynchronous; CPU tensors are already complete)."""
    import torch
    devices = set()

    def visit(node: tp.Any) -> None:
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                devices.add(node.device)
        elif isinstance(node, dict):
            for value in node.values():
                visit(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                visit(value)

    visit(outputs)
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Splits each loop iteration into data-wait / host / device time.

    Driven from the step boundary (LogProgressBar does this when a timer
    is attached)::

        timer.begin_data()        # closes the previous step, if any
        batch = next(iterator)
        timer.end_data()          # host phase starts
        out = step_fn(batch)      # asynchronous launches on the card
        timer.observe(out)        # wait here; the wait is device time

    `observe()` waits for the card with `torch.cuda.synchronize` on the
    devices of the given tensors and charges the wait to `device`,
    subtracted from the surrounding host segment. Waiting at the observe
    call (not at the next step boundary) keeps the split honest in the
    usual loop, where the next host statement reads the same outputs
    into a metrics averager: without `observe()` the device work
    completes inside that read and is charged to `host`.

    Per-step records land in the tracer's journal as
    ``{"type": "step", "stage": ..., "step": i, "data_wait": s,
    "host": s, "device": s, "total": s}`` and as three trace spans.
    """

    def __init__(self, stage: str = "", tracer: tp.Optional[Tracer] = None,
                 on_step: tp.Optional[
                     tp.Callable[[tp.Dict[str, float]], None]] = None,
                 percentiles: tp.Sequence[float] = (50, 95, 99)):
        if not percentiles or not all(0 < p < 100 for p in percentiles):
            raise ValueError(
                f"percentiles must be a non-empty sequence in (0, 100), "
                f"got {percentiles!r}")
        self.stage = stage
        self.tracer = tracer
        self.on_step = on_step
        self.percentiles = tuple(percentiles)
        self.records: tp.List[tp.Dict[str, float]] = []
        self._device: float = 0.0
        self._device_at: tp.Optional[float] = None
        self._data_start: tp.Optional[float] = None
        self._data_wait: float = 0.0
        self._host_start: tp.Optional[float] = None
        self._step_start: tp.Optional[float] = None
        # The journal and heartbeat IO of closing step N happens after
        # N's timings are frozen; it is carried into step N+1's host time
        # so the per-step splits still tile the stage wall clock.
        self._carry_overhead: float = 0.0

    def begin_data(self) -> None:
        """Mark a step boundary: close the in-flight step, start data wait."""
        self._close_step()
        self._data_start = time.perf_counter()

    def end_data(self) -> None:
        """The batch arrived: data wait ends, the host phase begins."""
        now = time.perf_counter()
        if self._data_start is None:
            self._data_start = now
        self._data_wait = now - self._data_start
        self._step_start = self._data_start
        self._host_start = now
        self._data_start = None

    def observe(self, *outputs: tp.Any) -> None:
        """Wait for the card to finish the step's outputs; the wait is
        charged to `device`."""
        if self._host_start is None or not outputs:
            return
        start = time.perf_counter()
        _wait_for(outputs)
        if self._device_at is None:
            self._device_at = start
        self._device += time.perf_counter() - start

    def finish(self) -> None:
        """Close the final step; drop a dangling data segment (the
        exhausted iterator's last `next()` produced no step)."""
        self._close_step()
        self._data_start = None

    def _close_step(self) -> None:
        if self._host_start is None:
            return
        now = time.perf_counter()
        device = self._device
        host = now - self._host_start - device + self._carry_overhead
        io_start = time.perf_counter()
        record = {"step": len(self.records), "data_wait": self._data_wait,
                  "host": host, "device": device,
                  "total": self._data_wait + host + device}
        self.records.append(record)
        if self.tracer is not None:
            assert self._step_start is not None
            self.tracer.complete("step/data_wait", self._step_start,
                                 self._data_wait, category="step",
                                 stage=self.stage)
            self.tracer.complete("step/host", self._host_start, host,
                                 category="step", stage=self.stage)
            if device > 0.0:
                assert self._device_at is not None
                self.tracer.complete("step/device", self._device_at, device,
                                     category="step", stage=self.stage)
            self.tracer.record({"type": "step", "stage": self.stage,
                                **record})
        if self.on_step is not None:
            self.on_step(record)
        self._carry_overhead = time.perf_counter() - io_start
        self._host_start = None
        self._step_start = None
        self._data_wait = 0.0
        self._device = 0.0
        self._device_at = None

    def summary(self) -> tp.Dict[str, float]:
        """Percentile step times (p50/p95/p99 by default), the max and
        where the time went, for the stage metrics (empty when no step
        completed)."""
        if not self.records:
            return {}
        totals = [r["total"] for r in self.records]
        out: tp.Dict[str, float] = {"steps": float(len(self.records))}
        for p in self.percentiles:
            out[f"step_p{p:g}"] = _percentile(totals, p)
        out["step_max"] = max(totals)
        grand = sum(totals)
        for key in ("data_wait", "host", "device"):
            part = sum(r[key] for r in self.records)
            out[f"{key}_frac"] = part / grand if grand > 0 else 0.0
        return out
