"""Continuous batching (port of flashy_tpu/serve/scheduler.py).

Each request retires the moment it finishes (EOS or length budget) and
the next queued request is admitted into the freed slot while decode
keeps streaming for everyone else. Admission takes the highest priority
first, FIFO among equals, under a hard queue-depth cap (`QueueFull` is
the backpressure signal). On the paged engine admission also waits for
block-pool headroom; a blocked higher-priority request preempts a
strictly-lower running one, which re-queues with its tokens kept and
resumes token-exact. The ssd layout has no pool, and an unbounded
(pure-SSD) engine no length ceiling at the door. Prompts prefill in
fixed slices interleaved with decode steps.

Left out for later slices (ROADMAP.md queue A item 3): speculative
drafts (L2), request tracing (L5), the chaos fault point (L6), and the
fleet's re-routing hooks.
"""
import collections
import dataclasses
import itertools
import logging
import time
import typing as tp

import numpy as np

from .engine import DecodeEngine
from .metrics import ServeMetrics
from .paged import PoolExhausted

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Raised by `submit()` when the admission queue is at capacity."""


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record.

    States: queued -> prefilling -> running -> done. `output` is
    prompt + generated (an emitted EOS included, as `generate` does).
    """
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token: tp.Optional[int] = None
    tenant: str = "default"
    priority: int = 0
    state: str = "queued"
    slot: tp.Optional[int] = None
    generated: tp.List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    deadline: tp.Optional[float] = None  # absolute; None = no TTL
    admitted_at: tp.Optional[float] = None
    first_token_at: tp.Optional[float] = None
    finished_at: tp.Optional[float] = None
    finish_reason: tp.Optional[str] = None  # 'eos' | 'length' | 'expired'
    preemptions: int = 0

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def output(self) -> np.ndarray:
        """prompt + generated tokens, as one int32 array."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])

    @property
    def resume_prompt(self) -> np.ndarray:
        """What admission must prefill: the prompt plus any tokens
        generated before a preemption (re-prefilling them re-derives the
        evicted K/V exactly)."""
        return self.output if self.generated \
            else np.asarray(self.prompt, np.int32)

    @property
    def remaining_budget(self) -> int:
        return self.max_new_tokens - len(self.generated)


class ContinuousBatchingScheduler:
    """Request queue feeding a DecodeEngine's slots.

    One `step()` = shed expired + admit (reserve blocks, advance at
    most `prefill_chunks_per_step` prefill slices) + one engine decode
    over all S slots + retire finished requests. The scheduler runs on
    its engine's device.

    Args:
        engine: the DecodeEngine supplying slots and steps.
        max_queue: admission-queue depth; `submit()` past it raises
            QueueFull.
        metrics: a ServeMetrics; one is created when not given.
        prefill_chunks_per_step: prefill slices advanced per step (the
            prefill/decode interleave ratio).
    """

    def __init__(self, engine: DecodeEngine, max_queue: int = 128,
                 metrics: tp.Optional[ServeMetrics] = None,
                 prefill_chunks_per_step: int = 1):
        self.engine = engine
        self.max_queue = max_queue
        self.metrics = metrics or ServeMetrics()
        for key, value in (("cache_layout", engine.cache_layout),
                           ("kv_dtype", engine.kv_dtype),
                           ("kernel", engine.kernel),
                           ("state_bytes_per_slot",
                            engine.state_bytes_per_slot())):
            self.metrics.static_info.setdefault(key, value)
        if prefill_chunks_per_step < 1:
            raise ValueError(f"prefill_chunks_per_step must be >= 1, "
                             f"got {prefill_chunks_per_step}")
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self._queue: tp.Deque[Request] = collections.deque()
        self._running: tp.Dict[int, Request] = {}  # slot -> request
        # slot -> [request, next chunk start, prompt being prefilled];
        # insertion order == FIFO
        self._prefilling: tp.Dict[int, tp.List[tp.Any]] = {}
        self._uid = itertools.count()
        self.admitted_order: tp.List[int] = []  # uids, admission sequence
        self.prefill_tokens_last_step = 0
        self.max_prefill_tokens_per_step = 0

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_count(self) -> int:
        return len(self._running)

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._running
                and not self._prefilling)

    def submit(self, prompt: tp.Any, max_new_tokens: int,
               eos_token: tp.Optional[int] = None,
               ttl: tp.Optional[float] = None,
               tenant: str = "default",
               priority: int = 0) -> Request:
        """Queue one request; returns its Request handle.

        Raises QueueFull at the depth cap and ValueError for a request
        that could never fit (`prompt + max_new_tokens` beyond
        `max_seq_len`; an unbounded pure-SSD engine has no such ceiling),
        so it fails at the door. `ttl` (seconds) bounds
        the queue wait; `priority` picks the admission class (higher
        first, may preempt strictly-lower running requests).
        """
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(f"tenant must be a non-empty string, "
                             f"got {tenant!r}")
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise ValueError(f"priority must be an int, got {priority!r}")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be 1-D non-empty, "
                             f"got {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = prompt.size + max_new_tokens
        if not self.engine.unbounded and total > self.engine.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"engine's max_seq_len {self.engine.max_seq_len}")
        if ttl is not None and ttl <= 0:
            raise ValueError(f"ttl must be positive (seconds), got {ttl}")
        if len(self._queue) >= self.max_queue:
            self.metrics.on_reject(tenant=tenant)
            raise QueueFull(
                f"admission queue is at capacity ({self.max_queue}); "
                f"retry after in-flight requests drain")
        now = time.perf_counter()
        request = Request(uid=next(self._uid), prompt=prompt,
                          max_new_tokens=max_new_tokens, eos_token=eos_token,
                          tenant=tenant, priority=priority,
                          submitted_at=now,
                          deadline=now + ttl if ttl is not None else None)
        self._queue.append(request)
        self.metrics.on_submit(tenant=tenant)
        return request

    def _expire(self, request: Request, now: float) -> None:
        request.state = "done"
        request.finish_reason = "expired"
        request.finished_at = now
        self.metrics.on_expired(tenant=request.tenant)

    def _shed_expired(self) -> int:
        """Drop queued requests whose TTL deadline passed; returns #shed."""
        if not any(r.deadline is not None for r in self._queue):
            return 0
        now = time.perf_counter()
        kept: tp.Deque[Request] = collections.deque()
        for request in self._queue:
            if request.deadline is not None and now >= request.deadline:
                self._expire(request, now)
            else:
                kept.append(request)
        shed = len(self._queue) - len(kept)
        self._queue = kept
        return shed

    def _first_token(self, slot: int, request: Request, first: int) -> None:
        """Prefill completed: record TTFT (once per request, a resumed
        request already has it) and retire or start decoding."""
        now = time.perf_counter()
        request.state = "running"
        request.generated.append(first)
        if request.first_token_at is None:
            request.first_token_at = now
            self.metrics.on_first_token(now - request.submitted_at)
        if request.eos_token is not None and first == request.eos_token:
            self._finish(request, "eos")
        elif len(request.generated) >= request.max_new_tokens:
            self._finish(request, "length")
        else:
            self._running[slot] = request

    def _pop_next(self) -> Request:
        """Remove and return the highest-priority, earliest-queued
        request."""
        best = 0
        for i in range(1, len(self._queue)):
            if self._queue[i].priority > self._queue[best].priority:
                best = i
        request = self._queue[best]
        del self._queue[best]
        return request

    def _try_preempt(self, priority: int) -> bool:
        """Evict the lowest-priority running request strictly below
        `priority` (latest uid among ties); returns whether one existed."""
        victim: tp.Optional[Request] = None
        for request in self._running.values():
            if request.priority >= priority:
                continue
            if victim is None or (request.priority, -request.uid) \
                    < (victim.priority, -victim.uid):
                victim = request
        if victim is None:
            return False
        self.preempt(victim.slot)
        return True

    def preempt(self, slot: int) -> Request:
        """Evict the running request in `slot` and re-queue it at the
        front with its generated tokens kept; returns it."""
        request = self._running.pop(slot)
        self.engine.preempt_slot(slot)
        request.state = "queued"
        request.slot = None
        request.preemptions += 1
        self._queue.appendleft(request)
        self.metrics.on_preempt(tenant=request.tenant)
        logger.debug("request %d preempted with %d tokens generated",
                     request.uid, len(request.generated))
        return request

    def _admit(self) -> int:
        """Assign queued requests to free slots and advance prefill;
        returns #admitted this step."""
        admitted = 0
        while self._queue:
            request = self._pop_next()
            if (request.deadline is not None
                    and time.perf_counter() >= request.deadline):
                self._expire(request, time.perf_counter())
                continue
            prompt = request.resume_prompt
            budget = request.remaining_budget
            if not self.engine.free_count \
                    or not self.engine.can_admit(prompt, budget):
                # no slot, or the pool lacks headroom for the head's
                # whole budget: preempt a strictly-lower request and
                # retry, or wait at the front
                self._queue.appendleft(request)
                if self._try_preempt(request.priority):
                    continue
                break
            slot = self.engine.acquire_slot()
            try:
                start = self.engine.admit(slot, prompt, budget)
            except PoolExhausted as exc:
                # headroom lost since the check: keep it queued
                logger.warning("admission of request %d shed: %s",
                               request.uid, exc)
                self.engine.allocator.release(slot)
                self._queue.appendleft(request)
                break
            if self.engine.cache_layout == "paged":
                self.metrics.on_prefix(start, int(prompt.size))
            request.slot = slot
            request.admitted_at = time.perf_counter()
            self.metrics.on_queue_wait(
                request.admitted_at - request.submitted_at)
            self.admitted_order.append(request.uid)
            admitted += 1
            # prefill resumes where the prefix cache left off
            request.state = "prefilling"
            self._prefilling[slot] = [request, start, prompt]
        self.prefill_tokens_last_step = 0
        budget = self.prefill_chunks_per_step
        for slot in list(self._prefilling):
            if budget <= 0:
                break
            request, start, prompt = self._prefilling[slot]
            new_start, first = self.engine.prefill_chunk(slot, prompt, start)
            budget -= 1
            self.prefill_tokens_last_step += new_start - start
            if first is None:
                self._prefilling[slot][1] = new_start
            else:
                del self._prefilling[slot]
                self._first_token(slot, request, first)
        self.max_prefill_tokens_per_step = max(
            self.max_prefill_tokens_per_step, self.prefill_tokens_last_step)
        return admitted

    def _finish(self, request: Request, reason: str) -> None:
        request.state = "done"
        request.finish_reason = reason
        request.finished_at = time.perf_counter()
        self.engine.retire(request.slot)
        self.metrics.on_done(request.finished_at - request.submitted_at,
                             reason, tenant=request.tenant,
                             tokens=len(request.generated))

    def _feed(self, slot: int, request: Request, token: int,
              gap: float) -> bool:
        """Append one emitted token; returns whether the request finished
        (EOS or length budget)."""
        request.generated.append(token)
        self.metrics.on_token(gap)
        if request.eos_token is not None and token == request.eos_token:
            del self._running[slot]
            self._finish(request, "eos")
            return True
        if len(request.generated) >= request.max_new_tokens:
            del self._running[slot]
            self._finish(request, "length")
            return True
        return False

    def step(self) -> int:
        """Shed expired + admit/advance prefill + one decode step +
        retire; returns #tokens emitted by the decode."""
        self._shed_expired()
        self._admit()
        self.metrics.on_gauges(queue_depth=len(self._queue),
                               live=self.engine.live_count,
                               capacity=self.engine.slots)
        pool = self.engine.pool_stats()
        if pool is not None:
            self.metrics.on_pool(occupancy=pool["occupancy"],
                                 bytes_per_token=pool["kv_bytes_per_token"])
        if not self._running:
            return 0
        step_start = time.perf_counter()
        tokens = self.engine.decode()
        gap = time.perf_counter() - step_start
        running = list(self._running.items())
        for slot, request in running:
            self._feed(slot, request, int(tokens[slot]), gap)
        return len(running)

    def run(self, max_steps: int = 1_000_000) -> None:
        """Step until every queued/running request finished; raises after
        `max_steps` (a request that can never retire is a bug)."""
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(
            f"scheduler did not drain in {max_steps} steps: "
            f"{len(self._queue)} queued, {len(self._running)} running")
