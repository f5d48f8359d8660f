"""Serving metrics, in memory (port of the sample-keeping half of
flashy_tpu/serve/metrics.py's `ServeMetrics`).

Time to first token (queue wait + prefill), inter-token latency, queue
depth, slot and pool occupancy, prefix hits, and tokens per second over
the serving window. Samples are host-side appends; `summary()` reports
percentiles with the port's own `percentile`. The `serve.json` status
file and the tracer fan-out wait for ROADMAP.md queue A item 3, L4/L5.
"""
import time
import typing as tp

from ..utils import percentile


class ServeMetrics:
    """Accumulates serving samples and summarizes them.

    Times are seconds (`time.perf_counter` deltas); `summary()` reports
    latencies in milliseconds.
    """

    def __init__(self, percentiles: tp.Sequence[float] = (50, 95, 99)):
        if not percentiles or not all(0 < p < 100 for p in percentiles):
            raise ValueError(
                f"percentiles must be a non-empty sequence in (0, 100), "
                f"got {percentiles!r}")
        self.percentiles = tuple(percentiles)
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

    def on_token(self, gap_seconds: float) -> None:
        self.itl.append(gap_seconds)
        self.tokens += 1

    def on_queue_wait(self, wait_seconds: float) -> None:
        """Queue wait of one admitted request (submit -> slot)."""
        self.queue_wait.append(wait_seconds)

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

    def on_prefix(self, matched_tokens: int, prompt_tokens: int) -> None:
        """One paged admission: `matched_tokens` of the prompt came from
        the prefix cache; a hit is any admission with matched > 0."""
        self.prefix_admissions += 1
        self.prefix_matched_tokens += matched_tokens
        self.prefix_prompt_tokens += prompt_tokens
        if matched_tokens > 0:
            self.prefix_hits += 1

    def on_pool(self, occupancy: float, bytes_per_token: float) -> None:
        """Sample the block pool (once per step)."""
        self.pool_occupancy.append(occupancy)
        if bytes_per_token > 0:
            self.kv_bytes_per_token.append(bytes_per_token)

    def on_gauges(self, queue_depth: int, live: int, capacity: int) -> None:
        """Sample the queue depth + slot occupancy (once per step)."""
        self.queue_depth.append(queue_depth)
        self.occupancy.append(live / capacity if capacity else 0.0)

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
        for reason, count in sorted(self.finish_reasons.items()):
            out[f"finish_{reason}"] = count
        return out
