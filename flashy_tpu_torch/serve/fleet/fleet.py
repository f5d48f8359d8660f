"""ServingFleet: router-fronted multi-engine serving (port of
flashy_tpu/serve/fleet/fleet.py).

A fleet composes N engine + scheduler members (each with its own block
pool, compile-cache scope and SLO windows) behind one FleetRouter and one
QuotaManager: submit routes by prefix chain key, quotas shed noisy
tenants at the door, per-engine burn rates redirect traffic away from
burning members, and an engine death (the `fleet.engine_step` fault
site) drains the dead member's in-flight requests and re-routes them to
the survivors, which re-prefill each prompt + generated and so re-derive
the lost K/V exactly (re-served output is token-identical). The host
loop is sequential: one `step()` steps every healthy member once, in
one process, so every single-engine invariant (one captured graph per
step shape, host-exact position mirrors) holds unchanged.

The members' compile caches: each member's keys are scoped by its name,
and a cache entry belongs to the engine that built it (a CUDA graph
binds that engine's buffers), so a cache may be shared by the members of
ONE build but never across two builds. `warmup()` warms every member
before it seals their caches.
"""
import itertools
import json
import logging
import time
import typing as tp
from pathlib import Path

import numpy as np

from ...observability.slo import SLOEngine
from ...resilience import InjectedFault, fault_point
from ...resilience.retry import call_with_retry
from ...utils import AnyPath, write_and_rename
from ...xp import FLEET_STATUS_NAME
from ..metrics import ServeMetrics
from ..scheduler import ContinuousBatchingScheduler, QueueFull, Request
from .quota import QuotaManager
from .router import FleetRouter
from .wal import RequestWAL, WALEntry

logger = logging.getLogger(__name__)

# Consulted once per healthy engine per fleet step (ctx engine=<name>): an
# injected fault there is that engine's death.
ENGINE_FAULT_SITE = "fleet.engine_step"

# Consulted inside the fleet.json atomic write, between the temporary
# file's dump and the rename: a fault there must leave the previous
# snapshot intact, never a torn one, and the next write self-heals.
STATUS_FAULT_SITE = "fleet.status"

# the fleet door's deadline-capped retry of a WAL append
_WAL_RETRY = dict(name="fleet.wal_append", retry_on=(OSError,), attempts=3,
                  base_delay=0.01, deadline=5.0)


class FleetMember:
    """One engine seat in the fleet: name, role, scheduler, SLO."""

    def __init__(self, name: str, scheduler: ContinuousBatchingScheduler,
                 slo: tp.Optional[SLOEngine] = None, role: str = "both"):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, "
                             f"got {role!r}")
        self.name = name
        self.role = role
        self.scheduler = scheduler
        self.slo = slo
        self.healthy = True

    @property
    def engine(self):
        return self.scheduler.engine


class ServingFleet:
    """N engines, one front door.

    `submit()` = quota check -> SLO-aware route -> member queue (-> WAL
    intent record); `step()` = one scheduler step on every healthy member,
    each preceded by the `fleet.engine_step` fault site, where an injected
    fault IS an engine death: the member is marked dead and its in-flight
    requests drain and re-route to survivors. Requests keep their
    fleet-unique uid through any number of re-routes; routing is
    deterministic, so a drill is replayable.

    Args:
        members: the engine seats, in router order.
        router: a FleetRouter over the member names (by default one with
            `policy` over the first member's block size).
        quotas: a QuotaManager (by default every tenant gets the default
            quota).
        policy: the default router's policy.
        tracing: a `RequestTracer` shared by every member scheduler (uids
            are fleet-unique, so one journal serves all); pass it to
            `build()` to wire it through.
        wal: a `RequestWAL` making admissions durable: submit fsyncs an
            intent record before it returns (and rolls the admission back
            when the append exhausts its retries), `step()` journals
            high-water marks, retirement fsyncs completion records, and
            `recover_from_wal()` on a freshly built fleet re-admits what
            a killed process left unfinished.
    """

    def __init__(self, members: tp.Sequence[FleetMember],
                 router: tp.Optional[FleetRouter] = None,
                 quotas: tp.Optional[QuotaManager] = None,
                 policy: str = "sticky",
                 tracing: tp.Optional[tp.Any] = None,
                 wal: tp.Optional[RequestWAL] = None):
        members = list(members)
        if not members:
            raise ValueError("a fleet needs at least one member")
        names = [m.name for m in members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate member names: {names}")
        self.members: tp.Dict[str, FleetMember] = {m.name: m
                                                   for m in members}
        if router is None:
            router = FleetRouter(names, block_size=members[0].engine
                                 .block_size, policy=policy)
        if list(router.engines) != names:
            raise ValueError(
                f"router engines {router.engines} must match the member "
                f"names {names} (order included: it is part of the "
                f"deterministic routing contract)")
        self.router = router
        self.quotas = quotas or QuotaManager()
        self.tracing = tracing
        self.wal = wal
        # uid -> [request, tenant, member name]; reaped as they finish
        self._inflight: tp.Dict[int, tp.List[tp.Any]] = {}
        self._route_seq = 0  # round-robin clock (== submit attempts)
        self.route_reasons: tp.Dict[str, int] = {}
        self.engine_routed: tp.Dict[str, int] = {n: 0 for n in names}
        self.reroutes = 0
        self.deaths: tp.List[str] = []

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, model, *, engines: int = 2, slots: int = 4,
              max_queue: int = 128,
              policy: str = "sticky",
              quotas: tp.Optional[QuotaManager] = None,
              slo_budgets: tp.Optional[tp.Sequence[tp.Any]] = None,
              slo_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
              tracing: tp.Optional[tp.Any] = None,
              names: tp.Optional[tp.Sequence[str]] = None,
              wal: tp.Optional[RequestWAL] = None,
              **engine_kwargs: tp.Any) -> "ServingFleet":
        """A homogeneous fleet: `engines` paged DecodeEngines, each
        `cache_scope`d by its name, one uid counter shared by the member
        schedulers, and one SLOEngine a member. Extra kwargs go to every
        DecodeEngine (device, kernel, block_size, compile_cache, ...)."""
        from ...observability.slo import (DEFAULT_SLO_BUDGETS,
                                          engine_budget_sets)
        from ..engine import DecodeEngine
        if engines < 1:
            raise ValueError(f"need >= 1 engine, got {engines}")
        names = list(names) if names is not None \
            else [f"engine{i}" for i in range(engines)]
        if len(names) != engines:
            raise ValueError(f"{len(names)} names for {engines} engines")
        engine_kwargs.setdefault("cache_layout", "paged")
        slos = engine_budget_sets(names,
                                  budgets=slo_budgets or DEFAULT_SLO_BUDGETS,
                                  **(slo_kwargs or {}))
        uid_source = itertools.count()
        members = []
        for name in names:
            engine = DecodeEngine(model, slots=slots, cache_scope=name,
                                  **engine_kwargs)
            metrics = ServeMetrics(tracer=engine.tracer, slo=slos[name])
            scheduler = ContinuousBatchingScheduler(
                engine, max_queue=max_queue, metrics=metrics,
                tracing=tracing, uid_source=uid_source)
            members.append(FleetMember(name, scheduler, slo=slos[name]))
        return cls(members, quotas=quotas, policy=policy, tracing=tracing,
                   wal=wal)

    def warmup(self, prompt_lengths: tp.Iterable[int] = ()) -> None:
        """Warm every member (each under its own cache scope), then seal
        their compile caches: a cache the members share is sealed after
        the last of them warmed, so no member's warm-up counts as a
        recompile. Every member gets every length: routing, or a death
        re-route, can land any prompt anywhere."""
        lengths = list(prompt_lengths)
        engines = [m.engine for m in self.members.values()]
        for engine in engines:
            engine.warmup(prompt_lengths=lengths, seal=False)
        for cache in {id(e.compile_cache): e.compile_cache
                      for e in engines}.values():
            cache.seal()

    # ------------------------------------------------------------------
    # the front door
    # ------------------------------------------------------------------
    @property
    def healthy(self) -> tp.List[str]:
        return [n for n, m in self.members.items() if m.healthy]

    def alerting(self) -> tp.Set[str]:
        """Members whose SLOEngine has a budget burning over both windows
        right now: the router redirects around them."""
        return {name for name, member in self.members.items()
                if member.slo is not None and member.slo.alerts()}

    def submit(self, prompt: tp.Any, max_new_tokens: int,
               eos_token: tp.Optional[int] = None,
               ttl: tp.Optional[float] = None,
               tenant: str = "default",
               priority: tp.Optional[int] = None) -> Request:
        """Route one request to a member queue; returns its handle.

        Sheds with QueueFull when the tenant is over quota or the routed
        member's queue is full (the quota credit returned): the same
        backpressure either way. `priority` defaults to the tenant's
        quota class.
        """
        if priority is None:
            priority = self.quotas.quota_for(tenant).priority
        if not self.quotas.try_acquire(tenant):
            raise QueueFull(
                f"tenant {tenant!r} is at its in-flight quota "
                f"({self.quotas.quota_for(tenant).max_inflight})")
        decision = self.router.route(self._route_seq, prompt,
                                     healthy=self.healthy,
                                     alerting=self.alerting())
        self._route_seq += 1
        member = self.members[decision.engine]
        try:
            request = member.scheduler.submit(
                prompt, max_new_tokens, eos_token=eos_token, ttl=ttl,
                tenant=tenant, priority=priority)
        except (QueueFull, ValueError):
            self.quotas.release(tenant)
            raise
        if self.wal is not None:
            # accept implies durable: the intent record is fsync'd before
            # submit() returns; when the append exhausts its retries the
            # admission rolls back (queue and quota): an unacknowledged
            # request may be lost, an acknowledged one may not
            try:
                call_with_retry(self.wal.append_admit, request, **_WAL_RETRY)
            except BaseException:
                member.scheduler.cancel_queued(request.uid)
                self.quotas.release(tenant)
                raise
        self.route_reasons[decision.reason] = \
            self.route_reasons.get(decision.reason, 0) + 1
        self.engine_routed[decision.engine] += 1
        self._inflight[request.uid] = [request, tenant, decision.engine]
        return request

    # ------------------------------------------------------------------
    # stepping and death
    # ------------------------------------------------------------------
    def kill(self, name: str) -> int:
        """Declare a member dead and re-route its in-flight requests to
        the survivors; returns how many were re-routed. The dead engine is
        never touched again (no retire or release against it); each
        drained request re-queues elsewhere with its generated tokens
        kept, so re-admission prefills prompt + generated and the
        re-served output is token-exact."""
        member = self.members[name]
        if not member.healthy:
            raise ValueError(f"member {name!r} is already dead")
        member.healthy = False
        self.deaths.append(name)
        survivors = self.healthy
        if not survivors:
            raise RuntimeError(
                f"engine {name!r} died and no healthy members remain")
        drained = member.scheduler.drain_for_reroute()
        for request in drained:
            decision = self.router.route(request.uid, request.prompt,
                                         healthy=survivors)
            self.members[decision.engine].scheduler.enqueue(request)
            if request.uid in self._inflight:
                self._inflight[request.uid][2] = decision.engine
            self.reroutes += 1
            if self.tracing is not None:
                self.tracing.on_handoff(request, src=name,
                                        dst=decision.engine)
        logger.warning("engine %s died; re-routed %d in-flight requests "
                       "to %s", name, len(drained), survivors)
        return len(drained)

    def _reap(self) -> None:
        """Return the quota credits of requests that finished, journaling
        each one's completion record first (retirement is not durable
        until the WAL says so)."""
        for uid in [u for u, (r, _, _) in self._inflight.items()
                    if r.done]:
            request, tenant, _ = self._inflight.pop(uid)
            if self.wal is not None:
                call_with_retry(self.wal.append_complete, request,
                                **_WAL_RETRY)
            self.quotas.release(tenant)

    def step(self) -> int:
        """One scheduler step on every healthy member; returns the tokens
        emitted. An InjectedFault at a member's `fleet.engine_step` site
        kills it (drain and re-route) and the step goes on with the
        survivors."""
        emitted = 0
        for name in list(self.members):
            member = self.members[name]
            if not member.healthy:
                continue
            try:
                fault_point(ENGINE_FAULT_SITE, engine=name,
                            live=member.scheduler.live_count,
                            queue_depth=member.scheduler.queue_depth)
            except InjectedFault as exc:
                logger.warning("engine %s killed by fault injection: %s",
                               name, exc)
                self.kill(name)
                continue
            emitted += member.scheduler.step()
        if self.wal is not None:
            # high-water marks are best effort: a lost one costs re-served
            # tokens after a crash, never correctness
            call_with_retry(self.wal.note_progress,
                            [r for r, _, _ in self._inflight.values()],
                            on_exhausted="warn", **_WAL_RETRY)
        self._reap()
        return emitted

    def run(self, max_steps: int = 1_000_000) -> None:
        """Step until every healthy member drained (the scheduler's
        `run` contract)."""
        for _ in range(max_steps):
            if all(m.scheduler.idle for m in self.members.values()
                   if m.healthy):
                self._reap()
                return
            self.step()
        raise RuntimeError(f"fleet did not drain in {max_steps} steps")

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------
    def recover_from_wal(self) -> tp.Dict[str, tp.Any]:
        """Replay the attached WAL into this freshly built fleet.

        Every logged but incomplete request is rebuilt with its ORIGINAL
        uid and its generated-token high-water mark and re-admitted
        through the ordinary machinery (deterministic route, `enqueue`
        without the depth cap, quota re-acquired), so its admission
        prefills `resume_prompt` and the re-served suffix equals an
        uninterrupted run's. A request whose replayed tokens already end
        it (EOS, or its budget) crashed between its last step and its
        completion append: it is completed from the log, not re-served
        (the exact-dedup half of at-least-once delivery).

        Returns ``{"recovered": {uid: Request}, "completed": {uid:
        WALEntry}}``.
        """
        if self.wal is None:
            raise ValueError("recover_from_wal() needs a fleet built "
                             "with a RequestWAL attached")
        if self._inflight:
            raise RuntimeError("recover_from_wal() must run on a fresh "
                               "fleet, before any submits")
        entries = self.wal.replay()
        recovered: tp.Dict[int, Request] = {}
        completed: tp.Dict[int, WALEntry] = {}
        if not entries:
            return {"recovered": recovered, "completed": completed}
        # the member schedulers share one uid counter
        next(iter(self.members.values())).scheduler.advance_uids(
            max(entries))
        for uid in sorted(entries):
            entry = entries[uid]
            if entry.complete:
                completed[uid] = entry
                continue
            request = Request(
                uid=uid, prompt=np.asarray(entry.prompt, np.int32),
                max_new_tokens=entry.max_new_tokens,
                eos_token=entry.eos_token, tenant=entry.tenant,
                priority=entry.priority, submitted_at=time.perf_counter())
            request.generated = list(entry.generated)
            reason = None
            if (entry.eos_token is not None
                    and entry.eos_token in request.generated):
                reason = "eos"
            elif request.remaining_budget <= 0:
                reason = "length"
            if reason is not None:
                # finished before the kill, never journaled done
                request.state = "done"
                request.finish_reason = reason
                self.wal.append_complete(request)
                entry.generated = list(request.generated)
                entry.complete, entry.finish_reason = True, reason
                entry.complete_records += 1
                completed[uid] = entry
                continue
            if not self.quotas.try_acquire(entry.tenant):
                raise RuntimeError(
                    f"WAL recovery: tenant {entry.tenant!r} no longer fits "
                    f"its quota: the restarted fleet must be built with at "
                    f"least the quotas the WAL was written under")
            decision = self.router.route(self._route_seq, request.prompt,
                                         healthy=self.healthy,
                                         alerting=self.alerting())
            self._route_seq += 1
            self.members[decision.engine].scheduler.enqueue(request)
            self.route_reasons[decision.reason] = \
                self.route_reasons.get(decision.reason, 0) + 1
            self.engine_routed[decision.engine] += 1
            self._inflight[uid] = [request, entry.tenant, decision.engine]
            recovered[uid] = request
        logger.info("WAL recovery: re-admitted %d incomplete request(s), "
                    "%d already complete (served from the log)",
                    len(recovered), len(completed))
        return {"recovered": recovered, "completed": completed}

    # ------------------------------------------------------------------
    # status
    # ------------------------------------------------------------------
    def status(self) -> tp.Dict[str, tp.Any]:
        """Topology and health snapshot (what fleet.json holds)."""
        engines: tp.Dict[str, tp.Any] = {}
        for name, member in self.members.items():
            engine = member.engine
            entry: tp.Dict[str, tp.Any] = {
                "role": member.role,
                "healthy": member.healthy,
                "slots": engine.slots,
                "live": engine.live_count,
                "occupancy": (engine.live_count / engine.slots
                              if engine.slots else 0.0),
                "queue_depth": member.scheduler.queue_depth,
                "routed": self.engine_routed.get(name, 0),
            }
            pool = engine.pool_stats()
            if pool is not None:
                entry["pool_occupancy"] = pool["occupancy"]
                entry["prefix_hit_rate"] = pool["prefix_hit_rate"]
            if member.slo is not None:
                report = member.slo.evaluate()
                entry["slo_alerting"] = sorted(
                    n for n, b in report["budgets"].items()
                    if b["alerting"])
                entry["slo_burn"] = {
                    n: b["burn_slow"]
                    for n, b in report["budgets"].items()
                    if b["burn_slow"] is not None}
            engines[name] = entry
        return {
            "engines": engines,
            "policy": self.router.policy,
            "tenants": self.quotas.summary(),
            "route_reasons": dict(sorted(self.route_reasons.items())),
            "reroutes": self.reroutes,
            "deaths": list(self.deaths),
        }

    def write_status(self, folder: AnyPath) -> Path:
        """Snapshot `status()` to `<folder>/fleet.json` (atomic rename,
        as serve.json) for `python -m flashy_tpu_torch.info`."""
        target = Path(folder) / FLEET_STATUS_NAME
        target.parent.mkdir(parents=True, exist_ok=True)
        with write_and_rename(target, "w") as f:
            json.dump(self.status(), f, indent=2, default=float)
            # the kill window: the temporary file written, the rename not
            # yet done; a fault here leaves the previous snapshot (or no
            # file) in place, and the next write truncates the temporary
            # file and self-heals
            fault_point(STATUS_FAULT_SITE, file=FLEET_STATUS_NAME)
        return target
