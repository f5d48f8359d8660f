"""Deterministic chaos campaigns: registry-driven fault sweeps and ddmin
(the port of flashy_tpu/resilience/campaign.py).

The drills (`python -m flashy_tpu_torch.resilience`, `python -m
flashy_tpu_torch.datapipe`) each prove one hand-written fault story.
The campaign proves the cross product: that every registered site
(`analysis.registry`), under every fault kind its scenario declares
(transient raise, fatal kill, latency stall, on-disk corruption), still
lands in a recovery story with an oracle at the end. It generates
seeded schedules over (site x kind x occurrence), runs the scenario
adapters under each, and, when an oracle breaks, shrinks the schedule by
delta debugging (ddmin) to a minimal JSON reproducer that `--replay`
re-executes. The same seed calibrates the same occurrence counts, draws
the same schedules and replays the same failure.

Ported scenarios: `train` (the chaos drill's numpy solver; no device)
and `datapipe` (the datapipe drill's solver, on `cuda` unless
`device='cpu'` asks for the host). The others declare their sites
statically, so coverage and `static_coverage()` see the whole registry,
and raise NotImplementedError naming their ROADMAP.md queue A items
when run: `serve` and `fleet` (item 10, the fleet), `pipeline` and
`tensor` (item 8), `elastic` (items 5 and 8). A campaign over every scenario
(`scenarios=None`) therefore raises; an explicit subset of ported
scenarios runs with the narrowed coverage gate.
"""
import contextlib
import dataclasses
import json
import logging
import random
import shutil
import tempfile
import typing as tp
from pathlib import Path

import numpy as np

from . import chaos
from .retry import call_with_retry

logger = logging.getLogger("flashy_tpu_torch.resilience.campaign")

# Fault kinds a schedule can assign to a site. Which kinds apply is a
# per-scenario declaration (`Scenario.sites()`): a `transient` raise is
# only honest at a site whose caller absorbs it, a `fatal` only where a
# kill has a resume story, `corrupt` only where bytes live on disk.
KINDS = ("transient", "fatal", "delay", "corrupt")

# The campaign's own site: ticked (under a deadline-capped retry) once
# per scenario execution, before the workload starts — so the engine
# that injects faults everywhere is itself injectable, and FT003 sees
# it like any other site.
RUN_FAULT_SITE = "campaign.run"

# Injected stall length for `delay` faults: long enough to be a real
# reordering hazard for anything timing-sensitive, short enough that a
# full campaign stays inside a CI budget.
DELAY_SECONDS = 0.02

# Sites deliberately excluded from the sweep, site -> reason. Empty
# today; an exclusion is always a visible decision (the campaign WARNs
# every entry).
NOQA_SITES: tp.Dict[str, str] = {}


class CampaignFailure(Exception):
    """A scenario oracle (or the strict injector) rejected a run."""

    def __init__(self, failures: tp.Sequence[str]):
        self.failures = list(failures)
        super().__init__("; ".join(self.failures))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault to arm: `kind` at the `call`-th occurrence of `site`
    (`times` consecutive occurrences — >1 models persistence that must
    defeat a retry budget)."""
    site: str
    kind: str
    call: int = 1
    times: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {KINDS})")

    def to_dict(self) -> tp.Dict[str, tp.Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, payload: tp.Dict[str, tp.Any]) -> "FaultSpec":
        return cls(site=payload["site"], kind=payload["kind"],
                   call=int(payload.get("call", 1)),
                   times=int(payload.get("times", 1)))

    def __str__(self) -> str:
        return f"{self.kind}@{self.site}#{self.call}" + (
            f"x{self.times}" if self.times != 1 else "")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A seeded fault schedule for one scenario execution."""
    scenario: str
    seed: int
    faults: tp.Tuple[FaultSpec, ...] = ()

    def describe(self) -> str:
        if not self.faults:
            return f"{self.scenario}: clean"
        return f"{self.scenario}: " + ", ".join(str(f) for f in self.faults)

    def to_dict(self) -> tp.Dict[str, tp.Any]:
        return {"scenario": self.scenario, "seed": self.seed,
                "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, payload: tp.Dict[str, tp.Any]) -> "Schedule":
        return cls(scenario=payload["scenario"], seed=int(payload["seed"]),
                   faults=tuple(FaultSpec.from_dict(f)
                                for f in payload["faults"]))


# ---------------------------------------------------------------------------
# scenario adapters
# ---------------------------------------------------------------------------

class Scenario:
    """One deterministic workload the campaign can put under fault.

    The contract: `sites()` is the static declaration (import-light,
    touching no device), `unavailable()`
    is the lazy environment check, `execute()` runs the workload once
    and raises :class:`CampaignFailure` when an oracle breaks. The
    FIRST execution of a campaign is a clean calibration run whose
    per-site occurrence counts bound the schedule generator's `call`
    draws — determinism of the workload is what makes those counts
    (and therefore every schedule) reproducible from the seed alone.
    """

    name = "scenario"

    def sites(self) -> tp.Dict[str, tp.Tuple[str, ...]]:
        """site -> applicable fault kinds; static, import-light."""
        raise NotImplementedError

    def unavailable(self) -> tp.Optional[str]:
        """A reason this scenario cannot run here, or None."""
        return None

    def prepare(self) -> None:
        """Resolve what the scenario runs on before any schedule runs;
        raise when it cannot (the campaign does not turn that into a
        finding)."""

    def fault_times(self, site: str, kind: str) -> int:
        """How many consecutive occurrences a fault of `kind` at
        `site` should hit (override to defeat per-site retry budgets)."""
        return 1

    def arm(self, injector: chaos.FaultInjector, spec: FaultSpec) -> None:
        """Translate one FaultSpec into an injector rule. `corrupt`
        specs never reach here — they are phase-boundary actions the
        scenario applies itself (see `execute(corrupt=...)`)."""
        if spec.kind == "transient":
            injector.fail_at(spec.site, call=spec.call, times=spec.times)
        elif spec.kind == "fatal":
            injector.preempt_at(spec.site, call=spec.call)
        elif spec.kind == "delay":
            injector.delay_at(spec.site, call=spec.call,
                              seconds=DELAY_SECONDS, times=spec.times)
        else:
            raise ValueError(f"cannot arm a {spec.kind!r} fault as an "
                             f"injector rule")

    def execute(self, run_dir: Path, corrupt: tp.Tuple[FaultSpec, ...] = (),
                calibrate: bool = False) -> None:
        raise NotImplementedError

    # -- shared machinery --------------------------------------------------
    def _check(self, failures: tp.List[str], ok: bool, what: str) -> None:
        if not ok:
            failures.append(f"{self.name}: {what}")

    def _run_to_completion(self, make_solver: tp.Callable[[], tp.Any],
                           cfg: tp.Any, root: Path,
                           max_attempts: int = 8):
        """Run a BaseSolver workload to completion through any number
        of injected preemptions: each SIGTERM exits at a commit
        boundary with the requeue code, and the next attempt resumes
        from the same XP folder — the preempt-requeue-resume loop of a
        real cluster, in-process. Returns (final_solver, killed)."""
        from ..xp import create_xp
        from .preemption import EXIT_PREEMPTED, disable_preemption_guard
        killed = []
        for _ in range(max_attempts):
            xp = create_xp(cfg, root=root)
            with xp.enter():
                solver = make_solver()
                solver.enable_preemption_guard(install=False)
                try:
                    solver.run()
                    return solver, killed
                except SystemExit as exc:
                    if exc.code != EXIT_PREEMPTED:
                        raise
                    killed.append(solver)
                finally:
                    disable_preemption_guard()
        raise CampaignFailure(
            [f"{self.name}: workload did not complete within "
             f"{max_attempts} preemption-resume attempts"])


class TrainScenario(Scenario):
    """The checkpointed training loop (numpy DrillSolver): two phases
    (train 2 epochs, then resume to 4) so `ckpt.load` genuinely fires,
    with a metrics-logger probe per phase so `logger.local` does too.
    Oracles: final history and weights identical to the clean run,
    checkpoint restorable. Owns the `campaign.run` site (it is the
    cheapest scenario to re-run)."""

    name = "train"
    PHASES = (2, 4)  # epochs per phase; phase 2 resumes phase 1

    def sites(self):
        return {
            "drill.step": ("fatal", "delay"),
            "ckpt.write": ("transient", "delay", "corrupt"),
            "ckpt.manifest": ("transient", "delay"),
            "ckpt.pointer": ("transient", "delay"),
            "ckpt.load": ("transient", "delay"),
            "history.write": ("transient", "delay"),
            "logger.local": ("transient", "delay"),
            RUN_FAULT_SITE: ("transient", "delay"),
        }

    def execute(self, run_dir, corrupt=(), calibrate=False):
        from ..logging import ResultLogger
        from ..xp import Config, create_xp
        from . import __main__ as drill
        from .integrity import verify_checkpoint

        DrillSolver = drill._drill_solver_class()
        cfg = Config({"campaign": self.name})
        solver = None
        for phase, epochs in enumerate(self.PHASES):
            solver, _ = self._run_to_completion(
                lambda: DrillSolver(epochs), cfg, Path(run_dir))
            with create_xp(cfg, root=Path(run_dir)).enter():
                # deterministic logger.local occurrence, one per phase
                ResultLogger(logger).log_metrics(
                    "campaign", {"probe": 1.0}, step=phase)
            if phase == 0:
                for spec in corrupt:
                    if spec.site == "ckpt.write":
                        slot = chaos.corrupt_active_slot(
                            solver.sharded_checkpoint_path)
                        logger.info("campaign: corrupted active "
                                    "checkpoint slot %r", slot)

        failures: tp.List[str] = []
        stripped = drill._strip_wallclock(solver.history)
        final_w = solver.w.copy()
        report = verify_checkpoint(solver.folder)
        self._check(failures, report["restorable"],
                    "final checkpoint does not verify as restorable")
        if calibrate:
            self._baseline = {"history": stripped, "w": final_w}
        else:
            self._check(failures, stripped == self._baseline["history"],
                        "final history/metrics diverged from the clean run")
            self._check(failures,
                        bool(np.array_equal(final_w, self._baseline["w"])),
                        "final weights diverged from the clean run")
        if failures:
            raise CampaignFailure(failures)


class DatapipeScenario(Scenario):
    """The streaming-input training loop: packed mixture batches with
    the input cursor committed alongside params. Oracle: the
    concatenated consumed-token stream across any number of injected
    kills equals the clean run's, batch for batch."""

    name = "datapipe"
    EPOCHS, STEPS, BATCH, SEQ = 2, 4, 4, 64

    def __init__(self, device: tp.Any = None):
        # on `cuda` unless the caller asks for the host ('cpu'), as the
        # datapipe drill does; resolved by `prepare()`, before anything
        # runs, so a campaign without a card raises instead of sweeping
        # the host
        self.requested = device
        self.device = None

    def sites(self):
        return {"datapipe.batch": ("fatal", "delay")}

    def prepare(self):
        from ..utils import resolve_device
        self.device = resolve_device(self.requested)

    def execute(self, run_dir, corrupt=(), calibrate=False):
        from ..datapipe import __main__ as dp
        from ..xp import Config

        corpus = dp.make_corpus(Path(run_dir) / "corpus")
        DatapipeSolver = dp._solver_class()
        self.prepare()
        device = self.device
        if calibrate:
            logger.info("campaign: scenario %r runs on %s", self.name,
                        device)
        cfg = Config({"campaign": self.name})
        killed: tp.List[tp.Any] = []
        try:
            final, killed = self._run_to_completion(
                lambda: DatapipeSolver(corpus, self.EPOCHS, self.STEPS,
                                       self.BATCH, self.SEQ, device=device),
                cfg, Path(run_dir))
        finally:
            for solver in killed:  # preempted attempts leak the worker
                solver.pipe.close()

        failures: tp.List[str] = []
        consumed = [b for s in killed for b in s.consumed] + final.consumed
        stripped = dp._strip_wallclock(final.history)
        if calibrate:
            self._baseline = {"consumed": consumed, "history": stripped}
        else:
            base = self._baseline["consumed"]
            same = (len(consumed) == len(base)
                    and all(dp.same_batch(a, b)
                            for a, b in zip(consumed, base)))
            self._check(failures, same,
                        f"consumed token stream diverged from the clean "
                        f"run ({len(consumed)} vs {len(base)} batches)")
            self._check(failures, stripped == self._baseline["history"],
                        "final history (losses) diverged from the clean run")
        if failures:
            raise CampaignFailure(failures)


TODO_FLEET = "ROADMAP.md queue A item 10 (the fleet: serve/fleet/)"
TODO_PARALLEL = ("ROADMAP.md queue A item 8 (parallelism beyond data "
                 "parallel: the pipeline schedules and tensor parallelism)")
TODO_ELASTIC = ("ROADMAP.md queue A items 5 and 8 (several processes and "
                "state sharding: the elastic drill)")


class _WaitingScenario(Scenario):
    """A scenario whose workload the port does not run yet: its sites are
    declared (the coverage universe and `static_coverage()` see them),
    and `execute()` raises NotImplementedError naming `todo`, the
    ROADMAP entry that brings the workload."""

    todo = ""

    def execute(self, run_dir, corrupt=(), calibrate=False):
        raise NotImplementedError(
            f"the campaign's {self.name!r} scenario is not ported yet: "
            f"{self.todo}")


class ServeScenario(_WaitingScenario):
    """A single continuous-batching engine behind the fleet door:
    `serve.pool` faults absorbed as backpressure, every output
    token-exact against `generate()`, pool conservation, zero post-warm-up
    compiles. The reference builds it as a one-engine ServingFleet,
    which waits for item 10."""

    name = "serve"
    todo = TODO_FLEET

    def sites(self):
        return {"serve.pool": ("transient", "delay"),
                "serve.step": ("delay",)}


class FleetScenario(_WaitingScenario):
    """The WAL-backed serving fleet and its restart drill (engine deaths
    re-routed, whole-fleet crashes recovered from `requests.wal`,
    at-least-once with exact dedup)."""

    name = "fleet"
    todo = TODO_FLEET

    def sites(self):
        return {
            "fleet.engine_step": ("transient", "fatal", "delay"),
            "serve.step": ("fatal", "delay"),
            "fleet.wal_append": ("transient", "fatal", "delay", "corrupt"),
            "fleet.wal_replay": ("transient", "delay"),
            "fleet.status": ("transient", "delay"),
        }

    def fault_times(self, site, kind):
        if kind != "fatal":
            return 1
        if site == "fleet.engine_step":
            return 2  # kill BOTH engines -> whole-fleet crash
        if site == "fleet.wal_append":
            return 3  # defeat the 3-attempt append retry
        return 1

    def arm(self, injector, spec):
        if spec.kind == "fatal":
            # fleet 'fatal' is a persistent raise (process/engine
            # death), not a SIGTERM: no solver guard exists here.
            injector.fail_at(spec.site, call=spec.call, times=spec.times)
        else:
            super().arm(injector, spec)


class PipelineScenario(_WaitingScenario):
    """The 1F1B pipeline schedules, unpacked and packed, under stalled
    host ticks: loss and grads bit-identical to the clean run."""

    name = "pipeline"
    todo = TODO_PARALLEL

    def sites(self):
        return {"pipeline.tick": ("delay",),
                "pipeline.packed_tick": ("delay",)}


class TensorScenario(_WaitingScenario):
    """Megatron tensor-parallel training under a stalled host tick: the
    loss trajectory bit-identical to the clean run."""

    name = "tensor"
    todo = TODO_PARALLEL

    def sites(self):
        return {"tensor.step": ("delay",)}


class ElasticScenario(_WaitingScenario):
    """Elastic resume across a world-size change, so `ckpt.reshard` and
    `datapipe.resplit` fire on the transition: the canonical-order
    consumed-token stream and the history identical to the clean run's."""

    name = "elastic"
    todo = TODO_ELASTIC

    def sites(self):
        return {"drill.elastic_step": ("fatal", "delay"),
                "ckpt.reshard": ("transient", "delay"),
                "datapipe.resplit": ("transient", "delay")}


def builtin_scenarios(device: tp.Any = None) -> tp.List[Scenario]:
    """All scenario adapters, cheapest first (construction is lazy and
    touches no device). `device` is the datapipe scenario's (default:
    `cuda`; `prepare()` raises when no card is present)."""
    return [TrainScenario(), DatapipeScenario(device), ServeScenario(),
            FleetScenario(), PipelineScenario(), TensorScenario(),
            ElasticScenario()]


def waiting_scenarios(scenarios: tp.Sequence[Scenario]
                      ) -> tp.Dict[str, str]:
    """name -> ROADMAP entry of each scenario in `scenarios` that the
    port cannot run yet."""
    return {s.name: s.todo for s in scenarios
            if isinstance(s, _WaitingScenario)}


def static_coverage() -> tp.Dict[str, tp.Dict[str, tp.Tuple[str, ...]]]:
    """site -> {scenario name -> declared fault kinds}, from the static
    declarations only (no device, no execution): what `info --faults`
    will report against the registry (ROADMAP.md queue A item 12)."""
    coverage: tp.Dict[str, tp.Dict[str, tp.Tuple[str, ...]]] = {}
    for scenario in builtin_scenarios():
        for site, kinds in scenario.sites().items():
            coverage.setdefault(site, {})[scenario.name] = tuple(kinds)
    return coverage


# ---------------------------------------------------------------------------
# seeded defects (for proving the engine catches and shrinks real bugs)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _defect_wal_skip_dedup():
    """Seeded bug: the request WAL's replay 'forgets' completion records,
    so recovery re-admits finished requests and the raw log grows a
    second completion per uid (the failure the fleet scenario's dedup
    oracle exists for). The WAL is the fleet's: applying it raises until
    item 10 ports `serve/fleet/`."""
    raise NotImplementedError(
        f"the seeded defect 'wal_skip_dedup' patches the fleet's request "
        f"WAL, which is not ported yet: {TODO_FLEET}")
    yield  # pragma: no cover - a generator for contextmanager


DEFECTS: tp.Dict[str, tp.Callable[[], tp.ContextManager]] = {
    "wal_skip_dedup": _defect_wal_skip_dedup,
}


@contextlib.contextmanager
def apply_defect(name: tp.Optional[str]):
    """Activate a registered seeded defect for the enclosed campaign."""
    if not name:
        yield
        return
    if name not in DEFECTS:
        raise ValueError(f"unknown seeded defect {name!r} "
                         f"(choose from {sorted(DEFECTS)})")
    with DEFECTS[name]():
        yield


# ---------------------------------------------------------------------------
# one schedule -> one verdict
# ---------------------------------------------------------------------------

def _run_schedule(scenario: Scenario, schedule: Schedule, run_dir: Path,
                  calibrate: bool = False,
                  ) -> tp.Tuple[tp.Optional[tp.List[str]], tp.Dict[str, int]]:
    """Execute `scenario` once under `schedule`. Returns `(failures,
    counts)`: failures is None on a clean pass, else the oracle (or
    escape/unfired-rule) findings; counts is the per-site occurrence
    tally — the calibration data the schedule generator draws from."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    injector = chaos.install(strict=not calibrate)
    corrupts: tp.List[FaultSpec] = []
    failures: tp.Optional[tp.List[str]] = None
    try:
        for spec in schedule.faults:
            if spec.kind == "corrupt":
                corrupts.append(spec)
            else:
                scenario.arm(injector, spec)
        # the campaign's own fault site: retried like any other
        # transient IO, and counted like any other site
        call_with_retry(
            lambda: chaos.fault_point(RUN_FAULT_SITE,
                                      scenario=scenario.name),
            name=RUN_FAULT_SITE, retry_on=(OSError,), attempts=3,
            base_delay=0.01, deadline=10.0)
        scenario.execute(run_dir, corrupt=tuple(corrupts),
                         calibrate=calibrate)
        if not calibrate:
            chaos.uninstall()  # strict: every armed rule must have fired
    except CampaignFailure as exc:
        failures = list(exc.failures)
    except chaos.UnfiredFaultRules as exc:
        failures = [f"{scenario.name}: armed fault rules never fired — "
                    f"{exc}"]
    except Exception as exc:  # noqa: BLE001 — any escape IS the finding
        failures = [f"{scenario.name}: {type(exc).__name__}: {exc}"]
    finally:
        chaos.uninstall(verify=False)
        from .preemption import disable_preemption_guard
        disable_preemption_guard()
    return failures, dict(injector.counts)


# ---------------------------------------------------------------------------
# schedule generation
# ---------------------------------------------------------------------------

def _base_schedules(scenario: Scenario, counts: tp.Dict[str, int],
                    seed: int) -> tp.List[Schedule]:
    """One single-fault schedule per (site, kind) pair the scenario
    declares, with the occurrence index drawn deterministically inside
    the calibrated range (minus a small tail margin, so multi-occurrence
    rules can finish firing before the workload ends)."""
    rng = random.Random(f"{seed}:{scenario.name}")
    schedules = []
    for site in sorted(scenario.sites()):
        for kind in KINDS:
            if kind not in scenario.sites()[site]:
                continue
            if kind == "corrupt":
                spec = FaultSpec(site, kind)
            else:
                times = scenario.fault_times(site, kind)
                hi = max(1, counts.get(site, 1) - times)
                spec = FaultSpec(site, kind, call=1 + rng.randrange(hi),
                                 times=times)
            schedules.append(Schedule(scenario.name, seed, (spec,)))
    return schedules


def _extra_schedule(scenario: Scenario, counts: tp.Dict[str, int],
                    rng: random.Random) -> tp.Optional[Schedule]:
    """A multi-fault schedule over DISTINCT sites, restricted to the
    absorbable kinds (transient/delay): fatal and corrupt faults can
    end a run early and strand another armed rule unfired, which the
    strict oracle would misread as a finding."""
    eligible = [site for site, kinds in scenario.sites().items()
                if any(k in kinds for k in ("transient", "delay"))]
    if len(eligible) < 2:
        return None
    picks = rng.sample(sorted(eligible), min(2 + rng.randrange(2),
                                             len(eligible)))
    specs = []
    for site in picks:
        kinds = [k for k in ("transient", "delay")
                 if k in scenario.sites()[site]]
        kind = kinds[rng.randrange(len(kinds))]
        hi = max(1, counts.get(site, 1) - 1)
        specs.append(FaultSpec(site, kind, call=1 + rng.randrange(hi)))
    return Schedule(scenario.name, rng.randrange(1 << 30), tuple(specs))


# ---------------------------------------------------------------------------
# ddmin shrink
# ---------------------------------------------------------------------------

def ddmin(faults: tp.Sequence[FaultSpec],
          test: tp.Callable[[tp.Tuple[FaultSpec, ...]], bool],
          ) -> tp.List[FaultSpec]:
    """Classic delta debugging: shrink `faults` to a minimal subset for
    which `test(subset)` still returns True (True == still fails).
    Finishes by probing the EMPTY schedule — a defect that breaks even
    the clean path minimizes to `[]`, the strongest reproducer."""
    current = list(faults)
    n = 2
    while len(current) >= 2:
        chunk = max(1, len(current) // n)
        subsets = [tuple(current[i:i + chunk])
                   for i in range(0, len(current), chunk)]
        reduced = False
        for subset in subsets:
            if len(subset) < len(current) and test(subset):
                current, n, reduced = list(subset), 2, True
                break
        if not reduced:
            for i in range(len(subsets)):
                complement = tuple(f for j, s in enumerate(subsets)
                                   for f in s if j != i)
                if 0 < len(complement) < len(current) and test(complement):
                    current, reduced = list(complement), True
                    n = max(n - 1, 2)
                    break
        if not reduced:
            if n >= len(current):
                break
            n = min(n * 2, len(current))
    if current and test(()):
        return []
    return current


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

DEFAULT_ARTIFACT = "campaign_repro.json"


def _write_artifact(path: Path, scenario: Scenario, seed: int,
                    faults: tp.Sequence[FaultSpec],
                    failures: tp.Sequence[str],
                    defect: tp.Optional[str]) -> None:
    payload = {
        "version": 1,
        "scenario": scenario.name,
        "seed": seed,
        "defect": defect,
        "faults": [f.to_dict() for f in faults],
        "failure": list(failures),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def _shrink_and_report(scenario: Scenario, schedule: Schedule,
                       failures: tp.List[str], workdir: Path, seed: int,
                       defect: tp.Optional[str], artifact: Path,
                       log: logging.Logger) -> None:
    """A schedule failed: ddmin it (fresh workdir per probe, so probes
    never share state) and write the minimized JSON reproducer."""
    log.error("campaign: %s FAILED:\n  %s", schedule.describe(),
              "\n  ".join(failures))
    probe_count = [0]

    def still_fails(subset: tp.Tuple[FaultSpec, ...]) -> bool:
        probe_count[0] += 1
        probe_dir = workdir / scenario.name / f"shrink_{probe_count[0]}"
        got, _ = _run_schedule(
            scenario, Schedule(scenario.name, seed, tuple(subset)),
            probe_dir)
        return got is not None

    minimized = ddmin(list(schedule.faults), still_fails)
    _write_artifact(artifact, scenario, seed, minimized, failures, defect)
    log.error("campaign: minimized %d fault(s) -> %d in %d probe runs; "
              "reproducer written to %s (replay with `python -m "
              "flashy_tpu_torch.resilience --campaign --replay %s`)",
              len(schedule.faults), len(minimized), probe_count[0],
              artifact, artifact)


def _coverage_report(executed: tp.Set[str], universe: tp.Set[str],
                     prefixes: tp.Tuple[str, ...],
                     log: logging.Logger) -> tp.List[str]:
    """Sites the campaign owes coverage but did not schedule."""
    uncovered = []
    for site in sorted(universe):
        if site in executed or site in NOQA_SITES:
            continue
        uncovered.append(site)
    for prefix in prefixes:
        if not any(s.startswith(prefix) for s in executed | set(NOQA_SITES)):
            uncovered.append(f"{prefix}*")
    for site, reason in sorted(NOQA_SITES.items()):
        log.warning("campaign: site %s is noqa'd: %s", site, reason)
    return uncovered


def run_campaign(seed: int = 0, budget: tp.Optional[int] = None,
                 scenarios: tp.Optional[tp.Sequence[str]] = None,
                 defect: tp.Optional[str] = None,
                 root: tp.Optional[str] = None, keep: bool = False,
                 artifact: tp.Optional[str] = None,
                 device: tp.Any = None,
                 log: tp.Optional[logging.Logger] = None) -> int:
    """Run the full chaos campaign; returns 0 only when every schedule
    passes AND every registry site was swept.

    Per scenario: one clean calibration run (collects per-site
    occurrence counts and the oracle baselines), then one single-fault
    schedule per declared (site, kind). `budget` caps the total number
    of fault schedules — a budget below the base coverage set drops
    schedules LOUDLY and fails the coverage gate; a budget above it
    spends the surplus on seeded multi-fault (transient/delay)
    schedules. The first failing schedule is ddmin-shrunk to a minimal
    JSON reproducer and the campaign exits 1 (fail fast: the artifact
    is the deliverable).

    Scenarios the port does not run yet raise NotImplementedError
    before anything runs, naming their ROADMAP entries; so does the full
    sweep (`scenarios=None`), which includes them. `device` is the
    datapipe scenario's.
    """
    from ..analysis.registry import FAULT_SITES, FAULT_SITE_PREFIXES

    log = log or logger
    available = {s.name: s for s in builtin_scenarios(device)}
    if scenarios is None:
        selected = list(available.values())
        universe: tp.Set[str] = set(FAULT_SITES)
        prefixes = tuple(FAULT_SITE_PREFIXES)
    else:
        unknown = sorted(set(scenarios) - set(available))
        if unknown:
            raise ValueError(f"unknown scenarios {unknown} "
                             f"(choose from {sorted(available)})")
        selected = [available[name] for name in scenarios]
        # an explicit subset narrows the coverage gate to what the
        # subset CAN cover (still an exact-site gate, just smaller)
        universe = {site for s in selected
                    for site in s.sites() if "." in site}
        universe &= set(FAULT_SITES) | {
            s for s in universe
            if any(s.startswith(p) for p in FAULT_SITE_PREFIXES)}
        prefixes = ()
        log.info("campaign: scenario subset %s narrows the coverage "
                 "gate to %d sites", [s.name for s in selected],
                 len(universe))
    waiting = waiting_scenarios(selected)
    if waiting:
        raise NotImplementedError(
            "the campaign's scenarios " + ", ".join(
                f"{name!r} ({todo})" for name, todo in waiting.items())
            + " are not ported yet; run a subset of "
            + str(sorted(set(available) - set(
                waiting_scenarios(list(available.values()))))))
    for scenario in selected:
        scenario.prepare()

    workdir = Path(root) if root else Path(
        tempfile.mkdtemp(prefix="flashy_campaign_"))
    artifact_path = Path(artifact or DEFAULT_ARTIFACT)
    executed_sites: tp.Set[str] = set()
    calibrated: tp.List[tp.Tuple[Scenario, tp.Dict[str, int]]] = []
    ran = dropped = 0
    failed = False

    try:
        with apply_defect(defect):
            for scenario in selected:
                reason = scenario.unavailable()
                if reason:
                    log.warning("campaign: skipping scenario %r: %s",
                                scenario.name, reason)
                    continue
                log.info("campaign: calibrating scenario %r (clean run)",
                         scenario.name)
                cal_failures, counts = _run_schedule(
                    scenario, Schedule(scenario.name, seed, ()),
                    workdir / scenario.name / "calibrate", calibrate=True)
                if cal_failures is not None:
                    # even the clean path fails: the reproducer is the
                    # empty schedule
                    _shrink_and_report(
                        scenario, Schedule(scenario.name, seed, ()),
                        cal_failures, workdir, seed, defect,
                        artifact_path, log)
                    failed = True
                    break
                dead = sorted(site for site in scenario.sites()
                              if counts.get(site, 0) < 1
                              and site != RUN_FAULT_SITE)
                if dead:
                    log.error("campaign: scenario %r declares sites its "
                              "workload never reaches: %s", scenario.name,
                              dead)
                    failed = True
                    break
                calibrated.append((scenario, counts))

                for schedule in _base_schedules(scenario, counts, seed):
                    if budget is not None and ran >= budget:
                        dropped += 1
                        log.error("campaign: budget %d exhausted — "
                                  "DROPPING %s (coverage gate will "
                                  "fail)", budget, schedule.describe())
                        continue
                    log.info("campaign: run %d — %s", ran + 1,
                             schedule.describe())
                    failures, _ = _run_schedule(
                        scenario, schedule,
                        workdir / scenario.name / f"run_{ran}")
                    ran += 1
                    if failures is not None:
                        _shrink_and_report(scenario, schedule, failures,
                                           workdir, seed, defect,
                                           artifact_path, log)
                        failed = True
                        break
                    executed_sites.update(f.site for f in schedule.faults)
                if failed:
                    break

            # surplus budget -> seeded multi-fault schedules
            if not failed and budget is not None and calibrated:
                rng = random.Random(f"{seed}:extras")
                idx = 0
                while ran < budget:
                    scenario, counts = calibrated[idx % len(calibrated)]
                    idx += 1
                    schedule = _extra_schedule(scenario, counts, rng)
                    if schedule is None:
                        if idx > len(calibrated):
                            break
                        continue
                    log.info("campaign: run %d (extra) — %s", ran + 1,
                             schedule.describe())
                    failures, _ = _run_schedule(
                        scenario, schedule,
                        workdir / scenario.name / f"run_{ran}")
                    ran += 1
                    if failures is not None:
                        _shrink_and_report(scenario, schedule, failures,
                                           workdir, seed, defect,
                                           artifact_path, log)
                        failed = True
                        break
                    executed_sites.update(f.site for f in schedule.faults)
    finally:
        if not keep and root is None:
            shutil.rmtree(workdir, ignore_errors=True)
        elif keep:
            log.info("campaign: artifacts kept under %s", workdir)

    if failed:
        return 1
    uncovered = _coverage_report(executed_sites, universe, prefixes, log)
    if dropped:
        log.error("campaign: %d schedule(s) dropped by the budget", dropped)
    if uncovered:
        log.error("campaign: %d registry site(s) NOT swept: %s — every "
                  "fault_point must live inside a scheduled recovery "
                  "story (add it to a scenario's sites() or NOQA_SITES "
                  "with a reason)", len(uncovered), uncovered)
        return 1
    log.info("campaign passed: %d fault schedules over %d sites, every "
             "oracle green, registry coverage complete.", ran,
             len(executed_sites))
    return 0


def replay_artifact(path: str, root: tp.Optional[str] = None,
                    keep: bool = False, device: tp.Any = None,
                    log: tp.Optional[logging.Logger] = None) -> int:
    """Re-execute a minimized reproducer artifact. Exits 1 when the
    recorded failure REPRODUCES (the run still fails — same convention
    as every drill: nonzero means this run found the problem), 0 when
    the schedule now passes (the defect is fixed or was flaky)."""
    log = log or logger
    payload = json.loads(Path(path).read_text(encoding="utf-8"))
    available = {s.name: s for s in builtin_scenarios(device)}
    scenario = available.get(payload["scenario"])
    if scenario is None:
        raise ValueError(f"artifact names unknown scenario "
                         f"{payload['scenario']!r}")
    for name, todo in waiting_scenarios([scenario]).items():
        raise NotImplementedError(
            f"the campaign's {name!r} scenario is not ported yet: {todo}")
    scenario.prepare()
    reason = scenario.unavailable()
    if reason:
        log.error("replay: scenario %r unavailable: %s", scenario.name,
                  reason)
        return 2
    seed = int(payload["seed"])
    faults = tuple(FaultSpec.from_dict(f) for f in payload["faults"])
    workdir = Path(root) if root else Path(
        tempfile.mkdtemp(prefix="flashy_replay_"))
    try:
        with apply_defect(payload.get("defect")):
            log.info("replay: calibrating %r, then replaying %d fault(s)",
                     scenario.name, len(faults))
            cal_failures, _ = _run_schedule(
                scenario, Schedule(scenario.name, seed, ()),
                workdir / "calibrate", calibrate=True)
            if cal_failures is not None and not faults:
                log.error("replay: REPRODUCED in the clean path:\n  %s",
                          "\n  ".join(cal_failures))
                return 1
            if cal_failures is not None:
                log.error("replay: calibration itself failed:\n  %s",
                          "\n  ".join(cal_failures))
                return 1
            failures, _ = _run_schedule(
                scenario, Schedule(scenario.name, seed, faults),
                workdir / "replay")
    finally:
        if not keep and root is None:
            shutil.rmtree(workdir, ignore_errors=True)
        elif keep:
            log.info("replay: artifacts kept under %s", workdir)
    if failures is not None:
        log.error("replay: REPRODUCED:\n  %s", "\n  ".join(failures))
        return 1
    log.info("replay: the schedule now passes (recorded failure was: %s)",
             payload.get("failure"))
    return 0


__all__ = [
    "KINDS", "RUN_FAULT_SITE", "NOQA_SITES", "DEFECTS", "DEFAULT_ARTIFACT",
    "CampaignFailure", "FaultSpec", "Schedule", "Scenario",
    "TrainScenario", "DatapipeScenario", "ServeScenario", "FleetScenario",
    "PipelineScenario", "TensorScenario", "ElasticScenario",
    "builtin_scenarios", "waiting_scenarios", "static_coverage",
    "apply_defect", "ddmin",
    "run_campaign", "replay_artifact",
]
