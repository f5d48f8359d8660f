"""SLOEngine: declarative latency/rate budgets + multi-window burn rates
(the port of flashy_tpu/observability/slo.py).

Each budget tolerates a fixed fraction of violating samples (a p95
budget tolerates 5%); the burn rate is the observed violation fraction
divided by that allowance (1.0 = spending exactly on budget), and an
alert needs the burn past the threshold over BOTH a fast window (quick
to fire) and a slow window (sustained, not one pause).
"""
import dataclasses
import time
import typing as tp

from ..utils import percentile

# Perfetto counter track carrying the per-budget slow-window burn rate.
COUNTER_SLO_BURN = "serve/slo_burn"


@dataclasses.dataclass(frozen=True)
class SLOBudget:
    """One declarative service-level objective.

    `kind='latency'`: a sample COMPLIES when `value <= threshold`
    (seconds), and `percentile` states the coverage the budget promises
    (p95 <= threshold tolerates 5% violators). `kind='floor'`: a sample
    complies when `value >= threshold` (acceptance rates, hit rates);
    `percentile` is then the coverage of the floor (p5 >= floor
    tolerates the worst 5%).
    """
    name: str                    # 'ttft' | 'itl' | 'queue_wait' | ...
    threshold: float             # seconds (latency) or rate (floor)
    percentile: float = 95.0     # promised coverage, in percent
    kind: str = "latency"        # 'latency' | 'floor'

    def __post_init__(self):
        if self.kind not in ("latency", "floor"):
            raise ValueError(f"kind must be latency|floor, got {self.kind!r}")
        if not 50.0 <= self.percentile < 100.0:
            raise ValueError(
                f"percentile must be in [50, 100), got {self.percentile}")

    @property
    def allowed_fraction(self) -> float:
        """The violation fraction the budget tolerates (p95 -> 0.05)."""
        return 1.0 - self.percentile / 100.0

    def complies(self, value: float) -> bool:
        if self.kind == "latency":
            return value <= self.threshold
        return value >= self.threshold


# A serving default set sized for the CPU smoke demo's tiny model; real
# deployments pass their own (`SLOEngine(budgets=...)`). Latencies in
# seconds, matching the raw `time.perf_counter` deltas the scheduler
# hands ServeMetrics.
DEFAULT_SLO_BUDGETS: tp.Tuple[SLOBudget, ...] = (
    SLOBudget("ttft", threshold=2.0, percentile=95.0),
    SLOBudget("itl", threshold=0.5, percentile=95.0),
    SLOBudget("queue_wait", threshold=1.5, percentile=95.0),
    SLOBudget("acceptance", threshold=0.05, percentile=90.0, kind="floor"),
)


class SLOEngine:
    """Rolling-window SLO evaluation with fast+slow burn-rate alerting.

    `observe(name, value)` appends one timestamped sample to the named
    budget (unknown names are ignored — the scheduler feeds acceptance
    unconditionally; only engines with a draft declare that budget).
    `evaluate()` returns, per budget, the slow-window percentile value,
    compliance, and the burn rate over both windows; `alerting` is True
    only when BOTH windows burn past `burn_threshold` (the multi-window
    rule). Pass `now=` everywhere for deterministic tests.

    Args:
        budgets: the declarative SLO set (defaults to
            `DEFAULT_SLO_BUDGETS`).
        fast_window / slow_window: rolling horizons in seconds. The
            fast window makes the alert prompt; the slow window makes
            it sustained.
        burn_threshold: burn rate both windows must exceed to alert
            (1.0 = exactly on budget; the default 2.0 pages only when
            the error budget is being spent at twice the sustainable
            rate).
        tracer: optional Tracer; every `evaluate()` samples the
            per-budget slow burn onto the `serve/slo_burn` counter
            track.
        min_samples: below this many slow-window samples a budget
            reports `alerting=False` (a two-sample p95 is noise).
    """

    def __init__(self, budgets: tp.Sequence[SLOBudget] = DEFAULT_SLO_BUDGETS,
                 fast_window: float = 30.0, slow_window: float = 300.0,
                 burn_threshold: float = 2.0,
                 tracer: tp.Optional[tp.Any] = None,
                 min_samples: int = 8):
        if fast_window <= 0 or slow_window < fast_window:
            raise ValueError(
                f"need 0 < fast_window <= slow_window, got "
                f"{fast_window}/{slow_window}")
        names = [b.name for b in budgets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate budget names in {names}")
        self.budgets: tp.Dict[str, SLOBudget] = {b.name: b for b in budgets}
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.burn_threshold = burn_threshold
        self.tracer = tracer
        self.min_samples = min_samples
        self._samples: tp.Dict[str, tp.List[tp.Tuple[float, float]]] = {
            name: [] for name in self.budgets}

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def observe(self, name: str, value: float,
                now: tp.Optional[float] = None) -> None:
        """Record one sample for budget `name` (no-op for unknown names)."""
        samples = self._samples.get(name)
        if samples is None:
            return
        now = time.perf_counter() if now is None else now
        samples.append((now, float(value)))
        # prune eagerly so an endless run stays bounded: everything
        # older than the slow window can never matter again
        horizon = now - self.slow_window
        if samples and samples[0][0] < horizon:
            self._samples[name] = [s for s in samples if s[0] >= horizon]

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _burn(self, budget: SLOBudget,
              values: tp.Sequence[float]) -> tp.Optional[float]:
        """Violation fraction / allowed fraction; None with no samples."""
        if not values:
            return None
        bad = sum(1 for v in values if not budget.complies(v))
        return (bad / len(values)) / budget.allowed_fraction

    def evaluate(self, now: tp.Optional[float] = None) -> tp.Dict[str, tp.Any]:
        """Per-budget compliance + fast/slow burn rates + alert flags.

        Returns ``{"alerting": bool, "budgets": {name: {...}}}`` where
        each budget entry carries `threshold`, `percentile`, `kind`,
        `samples`, the observed slow-window percentile `value`,
        `compliant`, `burn_fast`, `burn_slow` and `alerting`.
        """
        now = time.perf_counter() if now is None else now
        report: tp.Dict[str, tp.Any] = {"alerting": False, "budgets": {},
                                        "burn_threshold": self.burn_threshold,
                                        "fast_window": self.fast_window,
                                        "slow_window": self.slow_window}
        burns: tp.Dict[str, float] = {}
        for name, budget in self.budgets.items():
            slow = [v for t, v in self._samples[name]
                    if t >= now - self.slow_window]
            fast = [v for t, v in self._samples[name]
                    if t >= now - self.fast_window]
            if budget.kind == "latency":
                observed = percentile(slow, budget.percentile) if slow else None
            else:
                observed = (percentile(slow, 100.0 - budget.percentile)
                            if slow else None)
            burn_fast = self._burn(budget, fast)
            burn_slow = self._burn(budget, slow)
            alerting = (len(slow) >= self.min_samples
                        and burn_fast is not None and burn_slow is not None
                        and burn_fast > self.burn_threshold
                        and burn_slow > self.burn_threshold)
            entry = {"kind": budget.kind, "threshold": budget.threshold,
                     "percentile": budget.percentile, "samples": len(slow),
                     "value": observed,
                     "compliant": (budget.complies(observed)
                                   if observed is not None else None),
                     "burn_fast": burn_fast, "burn_slow": burn_slow,
                     "alerting": alerting}
            report["budgets"][name] = entry
            report["alerting"] = report["alerting"] or alerting
            if burn_slow is not None:
                burns[name] = burn_slow
        if self.tracer is not None and burns:
            self.tracer.counter(COUNTER_SLO_BURN, **burns)
        return report

    def alerts(self, now: tp.Optional[float] = None) -> tp.List[str]:
        """Names of budgets currently alerting (both windows burning)."""
        report = self.evaluate(now=now)
        return [name for name, entry in report["budgets"].items()
                if entry["alerting"]]

    def record(self, tracer: tp.Optional[tp.Any] = None,
               now: tp.Optional[float] = None) -> tp.Dict[str, tp.Any]:
        """Evaluate and journal the report (`{"type": "slo"}` record)."""
        report = self.evaluate(now=now)
        tracer = tracer or self.tracer
        if tracer is not None:
            tracer.record({"type": "slo", "alerting": report["alerting"],
                           "budgets": report["budgets"]})
        return report


def engine_budget_sets(
        names: tp.Sequence[str],
        budgets: tp.Sequence[SLOBudget] = DEFAULT_SLO_BUDGETS,
        **engine_kwargs: tp.Any) -> tp.Dict[str, SLOEngine]:
    """One independent `SLOEngine` per fleet engine, all over the same
    declarative budget set.

    A fleet router sheds/redirects per ENGINE — a shared sample pool
    would let a healthy engine's samples mask a burning one, so each
    engine gets its own rolling windows (the frozen `SLOBudget`s
    themselves are safely shared). `engine_kwargs` (fast_window,
    burn_threshold, tracer, ...) pass through to every `SLOEngine`.
    """
    names = list(names)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate engine names in {names}")
    if not names:
        raise ValueError("need at least one engine name")
    return {name: SLOEngine(budgets=budgets, **engine_kwargs)
            for name in names}


def format_slo_report(report: tp.Dict[str, tp.Any]) -> str:
    """Multi-line budget/burn table of an `SLOEngine.evaluate()` report
    (also accepts the `slo` block of a serve.json snapshot)."""
    budgets = report.get("budgets") or {}
    if not budgets:
        return "no SLO budgets evaluated"
    header = (f"{'budget':<12} {'objective':<18} {'observed':>10} "
              f"{'burn fast':>10} {'burn slow':>10}  status")
    lines = [header]
    for name, entry in budgets.items():
        kind = entry.get("kind", "latency")
        threshold = entry.get("threshold", 0.0)
        pct = entry.get("percentile", 95.0)
        if kind == "latency":
            objective = f"p{pct:g} <= {threshold * 1e3:.0f}ms"
            observed = (f"{entry['value'] * 1e3:.1f}ms"
                        if entry.get("value") is not None else "-")
        else:
            objective = f"p{100 - pct:g} >= {threshold:.2f}"
            observed = (f"{entry['value']:.2f}"
                        if entry.get("value") is not None else "-")

        def burn(key: str) -> str:
            value = entry.get(key)
            return f"{value:.2f}x" if value is not None else "-"

        if entry.get("alerting"):
            status = "ALERT"
        elif entry.get("compliant") is None:
            status = "no data"
        else:
            status = "ok" if entry["compliant"] else "burning"
        lines.append(f"{name:<12} {objective:<18} {observed:>10} "
                     f"{burn('burn_fast'):>10} {burn('burn_slow'):>10}  "
                     f"{status}")
    return "\n".join(lines)
