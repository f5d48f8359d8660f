"""Serving metrics (port of flashy_tpu/serve/metrics.py).

Time to first token (queue wait + prefill), inter-token latency, queue
depth, slot and pool occupancy, prefix hits, speculative acceptance, and
tokens per second over the serving window. Samples are host-side
appends; `summary()` reports percentiles with the port's own
`percentile`. The samples fan out live to a Tracer's counter tracks and
to an SLOEngine's budgets, and on demand to a ResultLogger (`log_to`),
the telemetry journal (`record`) and the XP folder's `serve.json`
(`write_status`, which `python -m flashy_tpu_torch.info` reads).
"""
import json
import time
import typing as tp
from pathlib import Path

from ..utils import AnyPath, percentile, write_and_rename
from ..xp import SERVE_STATUS_NAME

# Perfetto counter tracks of the serving path.
COUNTER_QUEUE = "serve/queue_depth"
COUNTER_OCCUPANCY = "serve/slot_occupancy"
COUNTER_ACCEPTANCE = "serve/acceptance"
COUNTER_POOL = "serve/pool_occupancy"
COUNTER_PREFIX = "serve/prefix_hit"
COUNTER_KV_BYTES = "serve/kv_bytes_per_token"


class ServeMetrics:
    """Accumulates serving samples; summarizes and fans them out.

    Times are seconds (`time.perf_counter` deltas); `summary()` reports
    latencies in milliseconds. Every hook is a list append plus, with a
    tracer, a counter sample: host-side Python, no device call.

    Args:
        tracer: an `observability.Tracer` for counter tracks and
            journal records.
        percentiles: the percentiles `summary()` reports for every
            sampled distribution.
        slo: an `observability.SLOEngine`; every TTFT, ITL, queue-wait
            and acceptance sample is also fed to its `ttft`, `itl`,
            `queue_wait` and `acceptance` budgets.
    """

    def __init__(self, tracer: tp.Optional[tp.Any] = None,
                 percentiles: tp.Sequence[float] = (50, 95, 99),
                 slo: tp.Optional[tp.Any] = None):
        if not percentiles or not all(0 < p < 100 for p in percentiles):
            raise ValueError(
                f"percentiles must be a non-empty sequence in (0, 100), "
                f"got {percentiles!r}")
        self.tracer = tracer
        self.percentiles = tuple(percentiles)
        self.slo = slo
        # non-numeric facts about the serving setup (cache layout, KV
        # dtype, kernel), filled by the scheduler from its engine
        self.static_info: tp.Dict[str, tp.Any] = {}
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        self.preempted = 0
        self.tokens = 0
        self.finish_reasons: tp.Dict[str, int] = {}
        self.tenants: tp.Dict[str, tp.Dict[str, int]] = {}
        self.ttft: tp.List[float] = []
        self.itl: tp.List[float] = []
        self.latency: tp.List[float] = []
        self.queue_wait: tp.List[float] = []
        self.queue_depth: tp.List[int] = []
        self.occupancy: tp.List[float] = []
        self.pool_occupancy: tp.List[float] = []
        self.kv_bytes_per_token: tp.List[float] = []
        self.prefix_matched_tokens = 0
        self.prefix_prompt_tokens = 0
        self.prefix_admissions = 0
        self.prefix_hits = 0
        # speculative decoding: proposal and acceptance accounting
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.accepted_per_step: tp.List[int] = []
        # the serving window tokens/s is taken over: first submit to
        # last completion
        self.first_submit_at: tp.Optional[float] = None
        self.last_done_at: tp.Optional[float] = None

    def _tenant(self, tenant: tp.Optional[str]) -> tp.Dict[str, int]:
        return self.tenants.setdefault(
            tenant or "default",
            {"requests": 0, "completed": 0, "tokens": 0, "shed": 0,
             "preempted": 0})

    def on_submit(self, tenant: tp.Optional[str] = None) -> None:
        self.submitted += 1
        self._tenant(tenant)["requests"] += 1
        if self.first_submit_at is None:
            self.first_submit_at = time.perf_counter()

    def on_reject(self, tenant: tp.Optional[str] = None) -> None:
        self.rejected += 1
        self._tenant(tenant)["shed"] += 1

    def on_expired(self, tenant: tp.Optional[str] = None) -> None:
        """A queued request shed past its TTL deadline (never ran)."""
        self.expired += 1
        self.finish_reasons["expired"] = \
            self.finish_reasons.get("expired", 0) + 1
        self._tenant(tenant)["shed"] += 1

    def on_preempt(self, tenant: tp.Optional[str] = None) -> None:
        """A running request evicted for a higher-priority admission."""
        self.preempted += 1
        self._tenant(tenant)["preempted"] += 1

    def on_first_token(self, ttft_seconds: float) -> None:
        self.ttft.append(ttft_seconds)
        self.tokens += 1
        if self.slo is not None:
            self.slo.observe("ttft", ttft_seconds)

    def on_token(self, gap_seconds: float) -> None:
        self.itl.append(gap_seconds)
        self.tokens += 1
        if self.slo is not None:
            self.slo.observe("itl", gap_seconds)

    def on_queue_wait(self, wait_seconds: float) -> None:
        """Queue wait of one admitted request (submit -> slot)."""
        self.queue_wait.append(wait_seconds)
        if self.slo is not None:
            self.slo.observe("queue_wait", wait_seconds)

    def on_done(self, latency_seconds: float, reason: str,
                tenant: tp.Optional[str] = None,
                tokens: tp.Optional[int] = None) -> None:
        self.completed += 1
        self.latency.append(latency_seconds)
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1
        entry = self._tenant(tenant)
        entry["completed"] += 1
        if tokens:
            entry["tokens"] += int(tokens)
        self.last_done_at = time.perf_counter()

    def on_spec_step(self, drafted: int, accepted: tp.Sequence[int],
                     emitted: int) -> None:
        """One speculative verify step: `drafted` tokens proposed per live
        slot, `accepted` the kept-draft count of each live slot, `emitted`
        the tokens delivered (accepted + bonus, less any EOS or budget
        truncation)."""
        live = len(accepted)
        self.spec_steps += 1
        self.spec_drafted += drafted * live
        self.spec_accepted += int(sum(accepted))
        self.spec_emitted += emitted
        self.accepted_per_step.extend(int(a) for a in accepted)
        if self.slo is not None and drafted and live:
            self.slo.observe("acceptance",
                             sum(int(a) for a in accepted) / (drafted * live))
        if self.tracer is not None and self.spec_drafted:
            self.tracer.counter(
                COUNTER_ACCEPTANCE,
                rate=self.spec_accepted / self.spec_drafted)

    def on_prefix(self, matched_tokens: int, prompt_tokens: int) -> None:
        """One paged admission: `matched_tokens` of the prompt came from
        the prefix cache; a hit is any admission with matched > 0."""
        self.prefix_admissions += 1
        self.prefix_matched_tokens += matched_tokens
        self.prefix_prompt_tokens += prompt_tokens
        if matched_tokens > 0:
            self.prefix_hits += 1
        if self.tracer is not None and self.prefix_prompt_tokens:
            self.tracer.counter(
                COUNTER_PREFIX,
                hit_rate=self.prefix_matched_tokens
                / self.prefix_prompt_tokens)

    def on_pool(self, occupancy: float, in_use: int, capacity: int,
                cached: int, bytes_per_token: float) -> None:
        """Sample the block pool (once per step, paged layout only)."""
        self.pool_occupancy.append(occupancy)
        if bytes_per_token > 0:
            self.kv_bytes_per_token.append(bytes_per_token)
        if self.tracer is not None:
            self.tracer.counter(COUNTER_POOL, in_use=in_use,
                                cached=cached, occupancy=occupancy)
            if bytes_per_token > 0:
                self.tracer.counter(COUNTER_KV_BYTES, bytes=bytes_per_token)

    def on_gauges(self, queue_depth: int, live: int, capacity: int) -> None:
        """Sample the queue depth + slot occupancy (once per step)."""
        occupancy = live / capacity if capacity else 0.0
        self.queue_depth.append(queue_depth)
        self.occupancy.append(occupancy)
        if self.tracer is not None:
            self.tracer.counter(COUNTER_QUEUE, depth=queue_depth)
            self.tracer.counter(COUNTER_OCCUPANCY, live=live,
                                occupancy=occupancy)

    def summary(self) -> tp.Dict[str, float]:
        """Flat numeric snapshot (ms latencies, configured percentiles)."""
        out: tp.Dict[str, float] = {
            "requests": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "expired": self.expired,
            "preempted": self.preempted,
            "tokens": self.tokens,
        }
        for name, samples, scale in (("ttft_ms", self.ttft, 1e3),
                                     ("itl_ms", self.itl, 1e3),
                                     ("latency_ms", self.latency, 1e3),
                                     ("queue_wait_ms", self.queue_wait, 1e3),
                                     ("queue_depth", self.queue_depth, 1),
                                     ("occupancy", self.occupancy, 1)):
            for p in self.percentiles:
                out[f"{name}_p{p:g}"] = percentile(samples, p) * scale
        if self.first_submit_at is not None and self.last_done_at is not None \
                and self.last_done_at > self.first_submit_at:
            out["tokens_per_sec"] = self.tokens / (self.last_done_at
                                                   - self.first_submit_at)
        if self.pool_occupancy:
            for p in self.percentiles:
                out[f"pool_occupancy_p{p:g}"] = percentile(
                    self.pool_occupancy, p)
        if self.kv_bytes_per_token:
            out["kv_bytes_per_token_p50"] = percentile(
                self.kv_bytes_per_token, 50)
        if self.prefix_admissions:
            out["prefix_hit_rate"] = (
                self.prefix_matched_tokens / self.prefix_prompt_tokens
                if self.prefix_prompt_tokens else 0.0)
            out["prefix_hit_requests"] = self.prefix_hits
        if self.spec_steps:
            out["spec_drafted"] = self.spec_drafted
            out["spec_emitted"] = self.spec_emitted
            out["acceptance_rate"] = (self.spec_accepted / self.spec_drafted
                                      if self.spec_drafted else 0.0)
            for p in self.percentiles:
                out[f"accepted_per_step_p{p:g}"] = percentile(
                    self.accepted_per_step, p)
        for reason, count in sorted(self.finish_reasons.items()):
            out[f"finish_{reason}"] = count
        return out

    def log_to(self, result_logger: tp.Any, step: tp.Optional[int] = None,
               extra: tp.Optional[tp.Dict[str, float]] = None) -> None:
        """Fan the summary out through a ResultLogger ('serve' stage)."""
        from ..logging import serve_formatter
        metrics = self.summary()
        if extra:
            metrics.update(extra)
        result_logger.log_metrics("serve", metrics, step=step,
                                  formatter=serve_formatter())

    def record(self) -> None:
        """Append the summary to telemetry.jsonl through the tracer."""
        if self.tracer is not None:
            self.tracer.record({"type": "serve_summary", **self.summary()})

    def write_status(self, folder: AnyPath,
                     extra: tp.Optional[tp.Dict[str, tp.Any]] = None
                     ) -> Path:
        """Snapshot the summary to `<folder>/serve.json` (atomically) for
        `python -m flashy_tpu_torch.info`; returns the path. The setup
        facts (`static_info`) come first; per-tenant rollups land as the
        `tenants` block and, with an SLOEngine attached, its evaluation
        as the `slo` block (what `info --slo` renders)."""
        from ..resilience import fault_point
        target = Path(folder) / SERVE_STATUS_NAME
        payload: tp.Dict[str, tp.Any] = dict(self.static_info)
        payload.update(self.summary())
        if self.tenants:
            payload["tenants"] = {t: dict(counts) for t, counts
                                  in sorted(self.tenants.items())}
        if self.slo is not None:
            payload["slo"] = self.slo.evaluate()
        if extra:
            payload.update(extra)
        target.parent.mkdir(parents=True, exist_ok=True)
        with write_and_rename(target, "w") as f:
            json.dump(payload, f, indent=2, default=float)
            # the kill window between the temporary write and the rename:
            # a fault here leaves the old serve.json (or none), never a
            # torn one, and the next write heals it
            fault_point("fleet.status", file=SERVE_STATUS_NAME)
        return target
