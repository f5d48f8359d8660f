"""FaultInjector: site-keyed, deterministic fault injection hooks (the
port of flashy_tpu/resilience/chaos.py).

Recovery code that is never executed is broken code not met yet. The
framework's sites call `fault_point("site")` (one None-check when no
injector is installed); a test or a chaos drill installs an injector
with site-keyed rules (fail the Nth occurrence with an OSError, stall
it, run an action) and afterwards reads `injector.fired` to prove the
fault happened. The port's sites: ``ckpt.write`` / ``ckpt.load`` (every
checkpoint file written or read), ``ckpt.manifest`` / ``ckpt.pointer``
(a slot's manifest and its CURRENT flip), ``history.write``
(`history.json`), ``logger.<backend>`` (each metric backend of the
fan-out), the chaos drill's ``drill.step``, ``serve.step`` (the
scheduler's decode step, inside its inter-token-latency window),
``serve.pool`` (a paged admission's block reservation) and
``fleet.status`` (inside the `serve.json` atomic write, between the
temporary write and the rename).
"""
from pathlib import Path
import dataclasses
import json
import logging
import time
import typing as tp

from ..utils import AnyPath

logger = logging.getLogger(__name__)

# Injected-latency faults sleep through this hook so tests can stub the
# stall without stubbing the global clock.
_sleep: tp.Callable[[float], None] = time.sleep


class InjectedFault(OSError):
    """The default exception an injection rule raises.

    Derives from OSError, the class of the transient IO failure it
    simulates: injecting through the exception class the real failure
    would raise keeps the drill honest.
    """


class UnfiredFaultRules(RuntimeError):
    """Raised by strict `uninstall()` when armed rules never fired.

    A rule that never fires proves nothing — worse, it makes the chaos
    test vacuously green (a typo'd site name or an occurrence index
    past the run's length both look exactly like 'recovery worked').
    """


@dataclasses.dataclass
class _Rule:
    site: str
    first_call: int           # 1-based occurrence that triggers the rule
    times: int                # consecutive occurrences it stays armed for
    action: tp.Callable[[], None]
    kind: str                 # 'fail' | 'preempt' | 'act' | 'delay'
    fired_count: int = 0      # occurrences at which this rule triggered

    def armed_for(self, call: int) -> bool:
        return self.first_call <= call < self.first_call + self.times

    def describe(self, seen: int) -> str:
        return (f"{self.kind}@{self.site!r} (armed for occurrence "
                f"{self.first_call}"
                + (f"..{self.first_call + self.times - 1}"
                   if self.times > 1 else "")
                + f", site seen {seen} time(s))")


class FaultInjector:
    """Site-keyed deterministic fault rules + a record of what fired.

    `counts` tallies every occurrence of every site (whether or not a
    rule fired), `fired` records each triggered fault — the evidence a
    chaos drill checks to assert its faults were actually exercised.

    With `strict=True` (what the chaos drills use), `uninstall()`
    raises :class:`UnfiredFaultRules` if any armed rule never fired;
    non-strict injectors only WARN. Either way a drill cannot silently
    pass with its faults unexercised.
    """

    def __init__(self, strict: bool = False) -> None:
        self.strict = strict
        self.counts: tp.Dict[str, int] = {}
        self.fired: tp.List[tp.Dict[str, tp.Any]] = []
        self._rules: tp.List[_Rule] = []

    # ------------------------------------------------------------------
    # arming rules
    # ------------------------------------------------------------------
    def fail_at(self, site: str, call: int, times: int = 1,
                exc: tp.Optional[tp.Callable[[], BaseException]] = None) -> None:
        """Raise at the `call`-th occurrence of `site` (`times` in a row).

        `exc` builds the exception (default: `InjectedFault`, an
        OSError, the class of a transient IO failure). A larger `times`
        simulates a persistent failure.
        """
        build = exc or (lambda: InjectedFault(f"injected fault at {site}"))

        def action() -> None:
            raise build()

        self._rules.append(_Rule(site, call, times, action, "fail"))

    def preempt_at(self, site: str, call: int) -> None:
        """Deliver a simulated SIGTERM (through the active
        PreemptionGuard) at the `call`-th occurrence of `site`: the
        cloud preemption notice, minus the cloud."""

        def action() -> None:
            from .preemption import get_preemption_guard
            guard = get_preemption_guard()
            if guard is None:
                raise RuntimeError(
                    f"preempt_at({site!r}) fired but no PreemptionGuard is "
                    "enabled; call enable_preemption_guard() first.")
            guard.simulate_signal()

        self._rules.append(_Rule(site, call, 1, action, "preempt"))

    def act_at(self, site: str, call: int, action: tp.Callable[[], None],
               times: int = 1) -> None:
        """Run an arbitrary `action` at the `call`-th occurrence of `site`."""
        self._rules.append(_Rule(site, call, times, action, "act"))

    def delay_at(self, site: str, call: int, seconds: float,
                 times: int = 1) -> None:
        """Stall the `call`-th occurrence of `site` for `seconds`.

        The latency fault: nothing raises, nothing is lost — the site
        just takes `seconds` longer. This is the fault the SLO burn-rate
        engine exists for; a drill that only ever injects crisp
        exceptions never meets it.
        Sleeps through the module-level `_sleep` hook so tests can stub
        the stall to zero wall-clock.
        """
        if seconds < 0:
            raise ValueError(f"delay seconds must be >= 0, got {seconds}")

        def action() -> None:
            _sleep(seconds)

        self._rules.append(_Rule(site, call, times, action, "delay"))

    # ------------------------------------------------------------------
    # the hook
    # ------------------------------------------------------------------
    def tick(self, site: str, **context: tp.Any) -> None:
        """One occurrence of `site`: count it and fire any armed rule."""
        call = self.counts.get(site, 0) + 1
        self.counts[site] = call
        for rule in self._rules:
            if rule.site == site and rule.armed_for(call):
                self.fired.append({"site": site, "call": call,
                                   "kind": rule.kind, **context})
                rule.fired_count += 1
                logger.info("chaos: firing %s fault at %s (occurrence %d)",
                            rule.kind, site, call)
                rule.action()

    def hits(self, site: tp.Optional[str] = None,
             kind: tp.Optional[str] = None) -> int:
        """How many faults fired (optionally filtered by site/kind)."""
        return sum(1 for f in self.fired
                   if (site is None or f["site"] == site)
                   and (kind is None or f["kind"] == kind))

    def unfired_rules(self) -> tp.List[str]:
        """Descriptions of armed rules that never fired — each one a
        fault the test THINKS it injected but did not."""
        return [rule.describe(self.counts.get(rule.site, 0))
                for rule in self._rules if rule.fired_count == 0]

    def verify_fired(self) -> None:
        """Raise :class:`UnfiredFaultRules` if any armed rule never
        fired (whatever `strict` says — for explicit mid-drill gates)."""
        unfired = self.unfired_rules()
        if unfired:
            raise UnfiredFaultRules(
                "fault rules armed but never fired — the faults they "
                "were meant to inject never happened:\n  "
                + "\n  ".join(unfired))


_injector: tp.Optional[FaultInjector] = None


def install(injector: tp.Optional[FaultInjector] = None, *,
            strict: bool = False) -> FaultInjector:
    """Install a process-wide FaultInjector (building one if not given).

    Every framework `fault_point` site starts consulting it. Tests
    should pair this with `uninstall()` (or use it via fixture teardown).
    `strict=True` makes the eventual `uninstall()` raise on rules that
    never fired (see :class:`UnfiredFaultRules`).
    """
    global _injector
    _injector = injector or FaultInjector(strict=strict)
    if strict:
        # honor strict=True for a pre-built injector too — silently
        # keeping it lax would re-open the vacuously-green-drill hole
        _injector.strict = True
    return _injector


def uninstall(verify: tp.Optional[bool] = None) -> None:
    """Remove the process-wide injector; all sites become no-ops again.

    If any armed rule never fired, WARNs — or raises
    :class:`UnfiredFaultRules` when the injector was installed with
    `strict=True` (or `verify=True` forces it). Pass `verify=False` on
    error-cleanup paths where a raise would mask the original failure.
    """
    global _injector
    injector, _injector = _injector, None
    if injector is None or verify is False:
        return
    unfired = injector.unfired_rules()
    if not unfired:
        return
    if verify or injector.strict:
        injector.verify_fired()
    logger.warning("chaos: uninstalling with %d rule(s) that never "
                   "fired:\n  %s", len(unfired), "\n  ".join(unfired))


def get_injector() -> tp.Optional[FaultInjector]:
    return _injector


def fault_point(site: str, **context: tp.Any) -> None:
    """Framework-side hook: a named site where faults can be injected.

    Costs one None-check when no injector is installed, so it is safe
    to leave in production paths; the sites are listed in the module
    docstring.
    """
    if _injector is not None:
        _injector.tick(site, **context)


# ----------------------------------------------------------------------
# direct-action helpers (corruption + stalls are states, not call sites)
# ----------------------------------------------------------------------
def corrupt_file(path: AnyPath, offset: int = 0, nbytes: int = 8) -> None:
    """Flip `nbytes` of `path` in place starting at `offset` — the
    torn/bit-rotted write a checksum manifest exists to catch."""
    path = Path(path)
    data = bytearray(path.read_bytes())
    if not data:
        data = bytearray(b"\0")
    end = min(len(data), offset + max(nbytes, 1))
    for i in range(offset, end):
        data[i] ^= 0xFF
    path.write_bytes(bytes(data))


def corrupt_active_slot(directory: AnyPath,
                        filename: str = "state.pkl") -> str:
    """Corrupt the active slot of an A/B slot checkpoint directory (the
    one the CURRENT pointer names); returns the slot name. The sibling
    is left intact: the state the A/B fallback exists for."""
    from ..checkpoint import read_slot_pointer
    directory = Path(directory)
    slot = read_slot_pointer(directory)
    if slot is None:
        raise FileNotFoundError(f"no committed slot pointer in {directory}")
    corrupt_file(directory / slot / filename, offset=1)
    logger.info("chaos: corrupted %s of active slot %s", filename, slot)
    return slot


def stall_heartbeat(folder: AnyPath, rank: int, age: float) -> Path:
    """Rewrite rank `rank`'s heartbeat file as if it last beat `age`
    seconds ago — the signature of a hung (not crashed) process, which
    the HangWatchdog exists to catch."""
    from ..observability.heartbeat import HEARTBEAT_PREFIX
    path = Path(folder) / f"{HEARTBEAT_PREFIX}{rank}.json"
    payload: tp.Dict[str, tp.Any] = {"rank": rank, "world_size": rank + 1}
    if path.exists():
        try:
            payload = json.loads(path.read_text())
        except json.JSONDecodeError:
            pass
    payload["time"] = time.time() - age
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, default=float))
    return path
