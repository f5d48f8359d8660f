"""RequestTracer: per-Request lifecycle spans + requests.jsonl journal (the
port of flashy_tpu/serve/tracing.py).

ServeMetrics says that p95 TTFT regressed; this module says why one
request took long: every lifecycle transition of a `Request.uid`
(queued -> admitted -> prefill slice k -> first token -> decode or
verify steps -> retired, expired or shed) lands as a Perfetto async span
(the Chrome trace 'b'/'n'/'e' events: spans that cross call stacks, as a
request does) and as a line of `requests.jsonl`.

A deterministic per-uid hash admits `sample_rate` of the requests to
full tracing, and the slow-tail rule (`slow_ttft` / `slow_latency`)
captures any unsampled request that finishes slow after the fact: its
phase timestamps were kept on the host (three floats), so at retirement
the tracer emits complete ('X') phase spans at their true times and a
full journal summary. All of it is host-side Python: nothing here waits
for or touches the card.
"""
import json
import logging
import threading
import time
import typing as tp

from ..observability import JsonlJournal, Tracer
from ..utils import AnyPath

logger = logging.getLogger(__name__)

# Async-span taxonomy (Perfetto groups by (category, uid); the nested
# begin/end pairs under one uid render as the request's phase bars).
SPAN_REQUEST = "serve/request"          # whole lifetime, submit -> retire
SPAN_QUEUED = "serve/request/queued"    # submit -> slot assignment
SPAN_PREFILL = "serve/request/prefill"  # slot assignment -> first token
SPAN_DECODE = "serve/request/decode"    # first token -> finish
TRACE_CATEGORY = "serve"

# Knuth multiplicative hash constants: a cheap, deterministic,
# well-mixed uid -> [0, 1) map (NOT python's salted hash(), which
# changes per process and would make sampling irreproducible).
_HASH_MULT = 2654435761
_HASH_SEED_MULT = 2246822519
_HASH_MOD = 1 << 32


class _RequestRecord:
    """Host-side phase timestamps for one in-flight request (kept for
    every request, sampled or not — this is what makes the slow-tail
    rule retroactive)."""

    __slots__ = ("uid", "sampled", "submitted_at", "admitted_at",
                 "first_token_at", "prefix_start", "prefill_chunks",
                 "tokens", "spec_accepted", "slot")

    def __init__(self, uid: int, sampled: bool, submitted_at: float):
        self.uid = uid
        self.sampled = sampled
        self.submitted_at = submitted_at
        self.admitted_at: tp.Optional[float] = None
        self.first_token_at: tp.Optional[float] = None
        self.prefix_start = 0
        self.prefill_chunks = 0
        self.tokens = 0
        self.spec_accepted = 0
        self.slot: tp.Optional[int] = None

    def phases(self, end: float) -> tp.Dict[str, float]:
        """(phase name -> seconds) for every phase entered by `end`."""
        out: tp.Dict[str, float] = {}
        admitted = self.admitted_at
        first = self.first_token_at
        out["queue_wait_s"] = (admitted if admitted is not None else end) \
            - self.submitted_at
        if admitted is not None:
            out["prefill_s"] = (first if first is not None else end) - admitted
        if first is not None:
            out["decode_s"] = end - first
            out["ttft_s"] = first - self.submitted_at
        out["latency_s"] = end - self.submitted_at
        return out


class RequestTracer:
    """Per-request lifecycle tracing with sampling + slow-tail capture.

    The scheduler calls the `on_*` hooks at each transition; this class
    owns which of them turn into trace events (sampling) and journals
    every retirement. All hooks tolerate `request` objects lacking
    optional fields and are thread-safe (one lock around the journal
    and the record table).

    Args:
        tracer: the `observability.Tracer` receiving async spans; None journals
            only (no Perfetto output).
        journal_path: `requests.jsonl` location; None disables the
            journal (spans only).
        sample_rate: fraction of requests fully traced, decided
            per-uid by a deterministic hash — the same uid is sampled
            or not on every run (reproducible) and across ranks.
        slow_ttft / slow_latency: seconds; an *unsampled* request
            finishing with TTFT or total latency past either threshold
            is captured retroactively (journal summary + historical
            'X' phase spans). None disables that rule.
        seed: perturbs the sampling hash (a different seed samples a
            different deterministic subset).
        max_journal_bytes / journal_keep: rotation cap for
            `requests.jsonl`, same contract as the telemetry journal.
    """

    def __init__(self, tracer: tp.Optional[Tracer] = None,
                 journal_path: tp.Optional[AnyPath] = None,
                 sample_rate: float = 1.0,
                 slow_ttft: tp.Optional[float] = None,
                 slow_latency: tp.Optional[float] = None,
                 seed: int = 0,
                 max_journal_bytes: tp.Optional[int] = None,
                 journal_keep: int = 3):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self.tracer = tracer
        self.sample_rate = sample_rate
        self.slow_ttft = slow_ttft
        self.slow_latency = slow_latency
        self.seed = seed
        self._journal = (JsonlJournal(journal_path,
                                      max_bytes=max_journal_bytes,
                                      keep=journal_keep)
                         if journal_path is not None else None)
        self._lock = threading.Lock()
        self._inflight: tp.Dict[int, _RequestRecord] = {}
        self.sampled_count = 0
        self.finished_count = 0
        self.slow_count = 0
        self.rejected_count = 0

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sampled(self, uid: int) -> bool:
        """Deterministic per-uid sampling decision (stable across runs)."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        mixed = ((uid + 1) * _HASH_MULT
                 ^ (self.seed + 1) * _HASH_SEED_MULT) % _HASH_MOD
        return mixed / _HASH_MOD < self.sample_rate

    # ------------------------------------------------------------------
    # journal
    # ------------------------------------------------------------------
    def _journal_event(self, event: str, **fields: tp.Any) -> None:
        if self._journal is None:
            return
        line = json.dumps({"time": time.time(), "type": "request",
                           "event": event, **fields}, default=float)
        with self._lock:
            self._journal.write_line(line)

    @property
    def journal_rotations(self) -> int:
        return self._journal.rotations if self._journal is not None else 0

    # ------------------------------------------------------------------
    # scheduler hooks
    # ------------------------------------------------------------------
    def on_submit(self, request: tp.Any) -> None:
        """Request entered the admission queue."""
        uid = request.uid
        sampled = self.sampled(uid)
        record = _RequestRecord(uid, sampled, request.submitted_at)
        with self._lock:
            self._inflight[uid] = record
        if sampled:
            self.sampled_count += 1
            if self.tracer is not None:
                prompt_tokens = int(getattr(request.prompt, "size", 0))
                self.tracer.async_begin(
                    SPAN_REQUEST, uid, TRACE_CATEGORY,
                    prompt_tokens=prompt_tokens,
                    max_new_tokens=request.max_new_tokens)
                self.tracer.async_begin(SPAN_QUEUED, uid, TRACE_CATEGORY)
            self._journal_event(
                "queued", uid=uid,
                prompt_tokens=int(getattr(request.prompt, "size", 0)),
                max_new_tokens=request.max_new_tokens)

    def on_reject(self, queue_depth: int) -> None:
        """A submit bounced off the full queue (no Request exists yet)."""
        self.rejected_count += 1
        self._journal_event("rejected", queue_depth=queue_depth)

    def on_admit(self, request: tp.Any, slot: int,
                 prefix_start: int = 0) -> None:
        """Queue head got a slot; prefill starts (chunked or whole)."""
        record = self._inflight.get(request.uid)
        if record is None:
            return
        record.admitted_at = time.perf_counter()
        record.slot = slot
        record.prefix_start = prefix_start
        if record.sampled:
            if self.tracer is not None:
                self.tracer.async_end(SPAN_QUEUED, record.uid,
                                      TRACE_CATEGORY)
                self.tracer.async_begin(SPAN_PREFILL, record.uid,
                                        TRACE_CATEGORY, slot=slot,
                                        prefix_start=prefix_start)
            self._journal_event(
                "admitted", uid=record.uid, slot=slot,
                prefix_start=prefix_start,
                queue_wait_s=record.admitted_at - record.submitted_at)

    def on_prefill_chunk(self, request: tp.Any, start: int,
                         new_start: int) -> None:
        """One chunked-prefill slice advanced [start, new_start)."""
        record = self._inflight.get(request.uid)
        if record is None:
            return
        record.prefill_chunks += 1
        if record.sampled and self.tracer is not None:
            self.tracer.async_instant(
                SPAN_PREFILL, record.uid, TRACE_CATEGORY,
                chunk=record.prefill_chunks, start=start, end=new_start)

    def on_first_token(self, request: tp.Any) -> None:
        """Prefill produced the first token: the TTFT moment."""
        record = self._inflight.get(request.uid)
        if record is None:
            return
        record.first_token_at = time.perf_counter()
        record.tokens += 1
        if record.sampled:
            ttft = record.first_token_at - record.submitted_at
            if self.tracer is not None:
                self.tracer.async_end(SPAN_PREFILL, record.uid,
                                      TRACE_CATEGORY)
                self.tracer.async_begin(SPAN_DECODE, record.uid,
                                        TRACE_CATEGORY)
            self._journal_event("first_token", uid=record.uid,
                                ttft_s=ttft)

    def on_step_tokens(self, request: tp.Any, tokens: int,
                       accepted: tp.Optional[int] = None) -> None:
        """One decode (or speculative-verify) step emitted `tokens`
        tokens for this request; `accepted` is the kept-draft count
        under speculation."""
        record = self._inflight.get(request.uid)
        if record is None:
            return
        record.tokens += tokens
        if accepted is not None:
            record.spec_accepted += accepted
        if record.sampled and self.tracer is not None:
            args = {"tokens": tokens}
            if accepted is not None:
                args["accepted"] = accepted
            self.tracer.async_instant(SPAN_DECODE, record.uid,
                                      TRACE_CATEGORY, **args)

    def on_preempt(self, request: tp.Any) -> None:
        """A running request was evicted for a higher-priority admission
        and re-queued: close the open phase span, reopen the queued
        span, and reset the phase clocks so the eventual re-admission's
        `on_admit`/`on_first_token` re-balance the span stack."""
        record = self._inflight.get(request.uid)
        if record is None:
            return
        if record.sampled and self.tracer is not None:
            if record.first_token_at is not None:
                self.tracer.async_end(SPAN_DECODE, record.uid,
                                      TRACE_CATEGORY)
            elif record.admitted_at is not None:
                self.tracer.async_end(SPAN_PREFILL, record.uid,
                                      TRACE_CATEGORY)
            self.tracer.async_begin(SPAN_QUEUED, record.uid,
                                    TRACE_CATEGORY, preempted=True)
        self._journal_event(
            "preempted", uid=record.uid,
            tokens=len(getattr(request, "generated", ()) or ()),
            priority=getattr(request, "priority", 0))
        record.admitted_at = None
        record.first_token_at = None

    def on_handoff(self, request: tp.Any, src: str, dst: str) -> None:
        """The request's K/V state moved engines (a prefill engine handing
        a slot to a decode engine): an instant on the request span plus a
        journal line naming both engines — the cross-engine hop is
        exactly what a per-engine trace alone cannot attribute."""
        record = self._inflight.get(request.uid)
        if record is not None and record.sampled \
                and self.tracer is not None:
            self.tracer.async_instant(SPAN_REQUEST, record.uid,
                                      TRACE_CATEGORY, handoff=True,
                                      src=src, dst=dst)
        self._journal_event("handoff", uid=request.uid, src=src, dst=dst)

    def on_finish(self, request: tp.Any, reason: str) -> None:
        """Request retired (eos/length), expired, or shed: close every
        open phase span and journal the summary. Slow unsampled
        requests are captured retroactively here."""
        with self._lock:
            record = self._inflight.pop(request.uid, None)
        if record is None:
            return
        generated = getattr(request, "generated", None)
        if generated is not None:
            # authoritative count: the final burst may have finished the
            # request inside the scheduler's feed loop, after the last
            # per-step hook this record saw
            record.tokens = len(generated)
        self._close(record, reason, time.perf_counter())

    def _slow(self, phases: tp.Dict[str, float]) -> bool:
        if self.slow_ttft is not None \
                and phases.get("ttft_s", 0.0) > self.slow_ttft:
            return True
        if self.slow_latency is not None \
                and phases.get("latency_s", 0.0) > self.slow_latency:
            return True
        return False

    def _close(self, record: _RequestRecord, reason: str,
               end: float) -> None:
        self.finished_count += 1
        phases = record.phases(end)
        slow = self._slow(phases)
        if slow:
            self.slow_count += 1
        if record.sampled and self.tracer is not None:
            # close whichever phase span is open, then the outer span
            if record.first_token_at is not None:
                self.tracer.async_end(SPAN_DECODE, record.uid,
                                      TRACE_CATEGORY)
            elif record.admitted_at is not None:
                self.tracer.async_end(SPAN_PREFILL, record.uid,
                                      TRACE_CATEGORY)
            else:
                self.tracer.async_end(SPAN_QUEUED, record.uid,
                                      TRACE_CATEGORY)
            self.tracer.async_end(SPAN_REQUEST, record.uid, TRACE_CATEGORY,
                                  reason=reason, tokens=record.tokens)
        elif slow and self.tracer is not None:
            # retroactive capture: the phase timestamps were kept, so
            # the slow request still gets attributable Perfetto spans
            # ('X' events at the true historical times)
            spans = [(SPAN_QUEUED, record.submitted_at,
                      record.admitted_at or end)]
            if record.admitted_at is not None:
                spans.append((SPAN_PREFILL, record.admitted_at,
                              record.first_token_at or end))
            if record.first_token_at is not None:
                spans.append((SPAN_DECODE, record.first_token_at, end))
            for name, start, stop in spans:
                self.tracer.complete(name, start, stop - start,
                                     category=TRACE_CATEGORY,
                                     uid=record.uid, slow=True)
        if record.sampled or slow:
            self._journal_event(
                "finished", uid=record.uid, reason=reason,
                tokens=record.tokens, prefill_chunks=record.prefill_chunks,
                prefix_start=record.prefix_start,
                spec_accepted=record.spec_accepted,
                sampled=record.sampled, slow=slow,
                **{k: round(v, 6) for k, v in phases.items()})

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------
    def finalize(self, reason: str = "aborted") -> int:
        """Close every in-flight request span (the finalize
        convention: a crash must not leave dangling spans — the trace
        stays loadable and the journal records how far each request
        got). Returns how many were closed."""
        with self._lock:
            inflight = list(self._inflight.values())
            self._inflight.clear()
        end = time.perf_counter()
        for record in inflight:
            self._close(record, reason, end)
        return len(inflight)

    def close(self) -> None:
        """Finalize in-flight spans and close the journal."""
        self.finalize()
        with self._lock:
            if self._journal is not None:
                self._journal.close()
