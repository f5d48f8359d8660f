"""Continuous batching (port of flashy_tpu/serve/scheduler.py).

Each request retires the moment it finishes (EOS or length budget) and
the next queued request is admitted into the freed slot while decode
keeps streaming for everyone else. Admission takes the highest priority
first, FIFO among equals, under a hard queue-depth cap (`QueueFull` is
the backpressure signal). On the paged engine admission also waits for
block-pool headroom; a blocked higher-priority request preempts a
strictly-lower running one, which re-queues with its tokens kept and
resumes token-exact. The dense and ssd layouts have no pool, and an
unbounded (pure-SSD) engine no length ceiling at the door. Prompts
prefill whole at admission (an engine without `chunk`) or in fixed
slices interleaved with decode steps. With a draft provider
(serve/draft.py) each step verifies k drafted tokens a slot in one
[S, k+1] engine call and emits accepted + 1 tokens a live slot.

Every lifecycle transition is mirrored to an optional
`serve.tracing.RequestTracer` (`tracing=`), and the decode step passes
the `serve.step` fault point inside the window its inter-token latency
measures, so an injected stall lands in the samples the SLO engine
reads. The fleet (`serve/fleet/`) shares one uid source across its
member schedulers (`uid_source=`) and re-routes through `enqueue`,
`cancel_queued`, `advance_uids` and `drain_for_reroute`.
"""
import collections
import dataclasses
import itertools
import logging
import time
import typing as tp

import numpy as np

from ..resilience import chaos
from .engine import DecodeEngine
from .metrics import ServeMetrics
from .paged import PoolExhausted

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Raised by `submit()` when the admission queue is at capacity."""


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record.

    States: queued -> (prefilling ->) running -> done; 'prefilling' only
    on engines that prefill in slices. `generated` grows by one token a
    step, or by up to k+1 under speculative decoding. `output` is
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

    One `step()` = shed expired + admit (reserve blocks; prefill whole,
    or advance at most `prefill_chunks_per_step` prefill slices) + one
    engine decode (or speculative verify) over all S slots + retire
    finished requests. The scheduler runs on its engine's device.

    Args:
        engine: the DecodeEngine supplying slots and steps.
        max_queue: admission-queue depth; `submit()` past it raises
            QueueFull.
        metrics: a ServeMetrics; one is created (sharing the engine's
            tracer) when not given.
        draft: a DraftProvider (serve/draft.py) enabling speculative
            decoding; its `k` must match `engine.spec_k` when that is set
            (the warm-up captured exactly that verify step).
        prefill_chunks_per_step: prefill slices advanced per step (the
            prefill/decode interleave ratio).
        tracing: a `serve.tracing.RequestTracer`; every request lifecycle
            transition is mirrored to it (async Perfetto spans and
            requests.jsonl), subject to its sampling.
        uid_source: an iterator yielding request uids; by default each
            scheduler counts privately from 0. A fleet passes ONE shared
            `itertools.count` to every member scheduler, so uids stay
            unique across engines (routing and re-routing key on them).
    """

    def __init__(self, engine: DecodeEngine, max_queue: int = 128,
                 metrics: tp.Optional[ServeMetrics] = None,
                 draft: tp.Optional[tp.Any] = None,
                 prefill_chunks_per_step: int = 1,
                 tracing: tp.Optional[tp.Any] = None,
                 uid_source: tp.Optional[tp.Iterator[int]] = None):
        self.engine = engine
        self.max_queue = max_queue
        self.metrics = metrics or ServeMetrics(tracer=engine.tracer)
        self.tracing = tracing
        for key, value in (("cache_layout", engine.cache_layout),
                           ("kv_dtype", engine.kv_dtype),
                           ("kernel", engine.kernel),
                           ("state_bytes_per_slot",
                            engine.state_bytes_per_slot())):
            self.metrics.static_info.setdefault(key, value)
        self.draft = draft
        if draft is not None and engine.spec_k is not None \
                and draft.k != engine.spec_k:
            raise ValueError(
                f"draft proposes k={draft.k} tokens but the engine warmed "
                f"its verify step for spec_k={engine.spec_k}; a mismatch "
                f"would capture after the warm-up")
        if prefill_chunks_per_step < 1:
            raise ValueError(f"prefill_chunks_per_step must be >= 1, "
                             f"got {prefill_chunks_per_step}")
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self._queue: tp.Deque[Request] = collections.deque()
        self._running: tp.Dict[int, Request] = {}  # slot -> request
        # slot -> [request, next chunk start, prompt being prefilled];
        # insertion order == FIFO
        self._prefilling: tp.Dict[int, tp.List[tp.Any]] = {}
        self._draft_slots: tp.Set[int] = set()  # slots the draft tracks
        self._uid = uid_source if uid_source is not None \
            else itertools.count()
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
        that could never fit (a prompt past the largest prefill bucket, or
        `prompt + max_new_tokens` beyond `max_seq_len`; an unbounded
        pure-SSD engine that prefills in slices has neither ceiling), so
        it fails at the door. `ttl` (seconds) bounds
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
        if not self.engine.unbounded or self.engine.chunk is None:
            # the bucketed prefill caps prompts at its largest bucket
            largest = self.engine.bucket_for(self.engine.max_seq_len)
            if prompt.size > largest:
                raise ValueError(
                    f"prompt length {prompt.size} exceeds the largest "
                    f"prefill bucket ({largest}); it can never be prefilled")
        total = prompt.size + max_new_tokens
        if not self.engine.unbounded and total > self.engine.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"engine's max_seq_len {self.engine.max_seq_len}")
        if ttl is not None and ttl <= 0:
            raise ValueError(f"ttl must be positive (seconds), got {ttl}")
        if len(self._queue) >= self.max_queue:
            self.metrics.on_reject(tenant=tenant)
            if self.tracing is not None:
                self.tracing.on_reject(len(self._queue))
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
        if self.tracing is not None:
            self.tracing.on_submit(request)
        return request

    def _expire(self, request: Request, now: float) -> None:
        request.state = "done"
        request.finish_reason = "expired"
        request.finished_at = now
        self.metrics.on_expired(tenant=request.tenant)
        if self.tracing is not None:
            self.tracing.on_finish(request, "expired")

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
        request already has it), and retire, or start decoding and seed
        the draft."""
        now = time.perf_counter()
        request.state = "running"
        request.generated.append(first)
        if request.first_token_at is None:
            request.first_token_at = now
            self.metrics.on_first_token(now - request.submitted_at)
        if self.tracing is not None:
            # on a resume too: preemption reopened the queued span, and
            # this transition closes its prefill phase
            self.tracing.on_first_token(request)
        if request.eos_token is not None and first == request.eos_token:
            self._finish(request, "eos")
        elif len(request.generated) >= request.max_new_tokens:
            self._finish(request, "length")
        else:
            self._running[slot] = request
            if self.draft is not None:
                self.draft.begin(slot, request.prompt, first)
                self._draft_slots.add(slot)

    def _retire_draft(self, slot: int) -> None:
        if slot in self._draft_slots:
            self._draft_slots.discard(slot)
            self.draft.retire(slot)

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
        self._retire_draft(slot)
        self.engine.preempt_slot(slot)
        request.state = "queued"
        request.slot = None
        request.preemptions += 1
        self._queue.appendleft(request)
        self.metrics.on_preempt(tenant=request.tenant)
        if self.tracing is not None:
            self.tracing.on_preempt(request)
        logger.debug("request %d preempted with %d tokens generated",
                     request.uid, len(request.generated))
        return request

    def enqueue(self, request: Request, front: bool = False) -> None:
        """Re-inject an existing Request (no new uid, no submit metrics):
        the re-route path after an engine death and WAL recovery. The
        depth cap is NOT applied: these requests were admitted once and
        must not be dropped by the door."""
        request.state = "queued"
        request.slot = None
        if front:
            self._queue.appendleft(request)
        else:
            self._queue.append(request)

    def cancel_queued(self, uid: int) -> Request:
        """Remove a still-queued request by uid and return it: the
        admission rollback when the fleet door's WAL append exhausts its
        retries (an unacknowledged request leaves the queue rather than
        run unlogged). Raises ValueError once it left the queue."""
        for i, request in enumerate(self._queue):
            if request.uid == uid:
                del self._queue[i]
                return request
        raise ValueError(f"request {uid} is not in the admission queue "
                         f"(already admitted, finished, or never here)")

    def advance_uids(self, beyond: int) -> None:
        """Fast-forward the uid source past `beyond` (inclusive): WAL
        recovery re-admits requests under their original uids, so a
        freshly built fleet's next submit must not collide with one.
        Draws and discards values (uniqueness, not density, is the
        contract)."""
        while next(self._uid) < beyond:
            pass

    def drain_for_reroute(self) -> tp.List[Request]:
        """Pull every unfinished request out of this scheduler without
        touching the engine (presumed dead: no retire or release against
        it). Requests come back 'queued' with their generated tokens kept,
        running and prefilling first by uid, then the queue in order;
        re-admission elsewhere prefills `resume_prompt`, which re-derives
        the lost K/V exactly."""
        in_flight = sorted(
            list(self._running.values())
            + [entry[0] for entry in self._prefilling.values()],
            key=lambda r: r.uid)
        requests = in_flight + list(self._queue)
        self._queue.clear()
        self._running.clear()
        self._prefilling.clear()
        self._draft_slots.clear()
        for request in requests:
            request.state = "queued"
            request.slot = None
        return requests

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
                # headroom lost since the check, or an injected failure
                # (the `serve.pool` fault point): keep it queued at the
                # head; backpressure sheds, the run never crashes
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
            if self.tracing is not None:
                self.tracing.on_admit(request, slot, start)
            self.admitted_order.append(request.uid)
            admitted += 1
            if self.engine.chunk is None:
                self._first_token(slot, request,
                                  self.engine.prefill(slot, prompt))
            else:
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
            if self.tracing is not None:
                self.tracing.on_prefill_chunk(request, start, new_start)
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
        self._retire_draft(request.slot)
        self.metrics.on_done(request.finished_at - request.submitted_at,
                             reason, tenant=request.tenant,
                             tokens=len(request.generated))
        if self.tracing is not None:
            self.tracing.on_finish(request, reason)

    def _feed(self, slot: int, request: Request, tokens: tp.Sequence[int],
              gap: float) -> tp.Tuple[int, bool]:
        """Append emitted tokens, stopping at EOS or the length budget;
        returns (#kept, finished). The first token of a span carries the
        step's latency as its inter-token gap, the rest arrive in the same
        burst (gap 0)."""
        kept = 0
        for token in tokens:
            token = int(token)
            request.generated.append(token)
            kept += 1
            self.metrics.on_token(gap if kept == 1 else 0.0)
            if request.eos_token is not None and token == request.eos_token:
                del self._running[slot]
                self._finish(request, "eos")
                return kept, True
            if len(request.generated) >= request.max_new_tokens:
                del self._running[slot]
                self._finish(request, "length")
                return kept, True
        return kept, False

    def step(self) -> int:
        """Shed expired + admit/advance prefill + one decode (or
        speculative verify) step + retire; returns #tokens emitted.

        A crash anywhere in the step closes every in-flight request span
        first (`tracing.finalize('crashed')`: the trace stays loadable
        and the journal records how far each request got), then
        propagates."""
        try:
            return self._step()
        except Exception:
            if self.tracing is not None:
                self.tracing.finalize("crashed")
            raise

    def _step(self) -> int:
        self._shed_expired()
        self._admit()
        self.metrics.on_gauges(queue_depth=len(self._queue),
                               live=self.engine.live_count,
                               capacity=self.engine.slots)
        pool = self.engine.pool_stats()
        if pool is not None:
            self.metrics.on_pool(occupancy=pool["occupancy"],
                                 in_use=int(pool["in_use"]),
                                 capacity=int(pool["capacity"]),
                                 cached=int(pool["cached"]),
                                 bytes_per_token=pool["kv_bytes_per_token"])
        if not self._running:
            return 0
        step_start = time.perf_counter()
        # inside the ITL-measured window on purpose: an injected delay
        # lands in the per-token gap the SLO engine samples, and an
        # injected raise unwinds through step()'s finalize
        chaos.fault_point("serve.step", queue_depth=len(self._queue),
                          live=len(self._running))
        if self.draft is None:
            tokens = self.engine.decode()
            gap = time.perf_counter() - step_start
            emitted = 0
            for slot, request in list(self._running.items()):
                kept, finished = self._feed(slot, request, [tokens[slot]],
                                            gap)
                emitted += kept
                if not finished and self.tracing is not None:
                    self.tracing.on_step_tokens(request, kept)
            return emitted
        # k drafted tokens a slot verified in one [S, k+1] call; each live
        # slot emits accepted + 1 (EOS or the budget may cut the span:
        # the slot is retired then, and the rest lands nowhere)
        drafts = self.draft.propose()
        out, accepted = self.engine.decode_speculative(drafts)
        gap = time.perf_counter() - step_start
        emitted = 0
        accepted_counts: tp.List[int] = []
        for slot, request in list(self._running.items()):
            span = out[slot, :int(accepted[slot]) + 1]
            accepted_counts.append(int(accepted[slot]))
            kept, finished = self._feed(slot, request, span, gap)
            emitted += kept
            if not finished:
                if self.tracing is not None:
                    self.tracing.on_step_tokens(
                        request, kept, accepted=int(accepted[slot]))
                self.draft.observe(slot, span[:kept],
                                   self.engine.slot_length(slot))
        self.metrics.on_spec_step(drafted=int(drafts.shape[1]),
                                  accepted=accepted_counts, emitted=emitted)
        return emitted

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
