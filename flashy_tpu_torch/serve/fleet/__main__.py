"""`python -m flashy_tpu_torch.serve.fleet`: the fleet's acceptance demo
(port of flashy_tpu/serve/fleet/__main__.py). Five legs, each an exit
gate, on a tiny randomly initialized TransformerLM in f32:

  handoff   disaggregated prefill -> decode over one shared pool is
            token-exact against per-request `generate()` on
            mixed-length concurrent requests, nothing captured or built
            after either engine's warm-up, the pool conserved
  sticky    prefix-sticky routing's prefix-cache hit rate is >= the
            round-robin baseline's on a shared-system-prompt workload,
            and a fresh router replays every decision
  preempt   a high-priority tenant preempts low-priority running
            requests; every victim completes token-exactly after
            re-queue, the per-tenant rollups land in serve.json, the pool
            is conserved after every step
  drill     a strict fault injector kills an engine mid-decode at the
            `fleet.engine_step` site; every in-flight request re-routes
            and re-serves token-exactly, and fleet.json records the death
  wal       a WAL-backed fleet WORKER PROCESS is SIGKILLed mid-serve
            (queued and decoding requests together, no clean-up of any
            kind); a fresh fleet here replays requests.wal, and every
            acknowledged request re-serves byte-identically against
            `generate()`, with exactly one completion record per uid in
            the raw log and nothing captured or built after the
            recovering fleet's warm-up

Every leg runs on `--device` (cuda by default; `--device cpu` only when
asked for); the engines' paged reads take `--kernel` (`fused`, the
Hopper kernel, by default; `gather`, its plain version, on the CPU). The
wal leg's worker gets both flags, and on the card loads the kernel
libraries this process built before spawning it. Exits 1 on a failed
gate.
"""
import argparse
import logging
import sys
import typing as tp

logger = logging.getLogger("flashy_tpu_torch.serve.fleet.demo")

LEGS = ("handoff", "sticky", "preempt", "drill", "wal")

# wal leg: tokens a request, and the fleet steps the worker survives
# before it SIGKILLs itself (few enough that requests are still queued
# AND mid-decode when it dies)
WAL_MAX_NEW = 8
WAL_KILL_STEPS = 3

# the kernel libraries the fleet's paged reads load
PAGED_LIBRARIES = ("paged_decode", "paged_general")


def _fleet_mix(n: int, vocab: int, seed: int, shared: int = 16,
               share_every: int = 2):
    """`n` prompts, every `share_every`-th starting with a `shared`-token
    system prefix (one full 16-token block: the routing chain key and
    the prefix-cache hit unit)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, shared).astype(np.int32)
    prompts = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(3, 9)))
        tail = tail.astype(np.int32)
        if i % share_every == 0:
            prompts.append(np.concatenate([system, tail]))
        else:
            prompts.append(tail)
    return prompts


def _post_warm(engine, warm: tp.Dict[str, int]) -> tp.Tuple[int, int]:
    """(builds after the warm-up, recompiles) of one engine."""
    stats = engine.compile_cache.stats()
    return stats["misses"] - warm["misses"], stats["recompiles"]


def run_handoff_demo(requests: int = 8, seed: int = 0,
                     kernel: str = "fused", device: tp.Any = None,
                     log: tp.Optional[logging.Logger] = None) -> int:
    """Gate: disaggregated serving is invisible in the tokens. Also one
    handoff a request, nothing built after either engine's warm-up, and
    the shared pool conserved."""
    import numpy as np
    from ..__main__ import _build_model, _reference
    from .handoff import DisaggregatedPair

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    prompts = _fleet_mix(requests, vocab, seed + 1)
    max_new = 6

    pair = DisaggregatedPair(model, prefill_slots=2, decode_slots=4,
                             block_size=16, kernel=kernel, device=device)
    log.info("handoff leg: warming prefill(2 slots) + decode(4 slots) over "
             "one %d-block shared pool...", pair.pool.stats()["capacity"])
    pair.warmup(prompt_lengths=[len(p) for p in prompts])
    warm = {"prefill": dict(pair.prefill.compile_cache.stats()),
            "decode": dict(pair.decode.compile_cache.stats())}

    outputs = pair.serve(prompts, max_new)

    failures = 0
    mismatches = 0
    for prompt, out in zip(prompts, outputs):
        want = _reference(model, prompt, max_new, device)
        got = np.concatenate([prompt, np.asarray(out, np.int32)])
        if not np.array_equal(got, want):
            mismatches += 1
            log.error("handoff output diverged from generate():\n"
                      "  served   %s\n  generate %s", out, want.tolist())
    if mismatches:
        failures += 1
    else:
        log.info("verified: all %d disaggregated outputs token-exact "
                 "against per-request generate()", len(prompts))
    if len(pair.handoffs) != len(prompts):
        log.error("expected one handoff per request, got %d for %d",
                  len(pair.handoffs), len(prompts))
        failures += 1
    else:
        log.info("handoffs: %d block-list packets crossed the "
                 "prefill->decode boundary (largest %d blocks)",
                 len(pair.handoffs),
                 max(len(p.blocks) for p in pair.handoffs))
    for role, engine in (("prefill", pair.prefill),
                         ("decode", pair.decode)):
        builds, recompiles = _post_warm(engine, warm[role])
        if builds or recompiles:
            log.error("%s engine was not compile-free after its warm-up: "
                      "%d builds, %d recompiles", role, builds, recompiles)
            failures += 1
    try:
        pair.pool.check()
    except AssertionError as exc:
        log.error("pool conservation violated after handoffs: %s", exc)
        failures += 1
    stats = pair.pool.stats()
    log.info("shared pool after run: %d/%d blocks free, %d handoffs "
             "re-keyed", stats["free"], stats["capacity"],
             stats["handoffs"])
    return 1 if failures else 0


def run_sticky_demo(requests: int = 24, engines: int = 3,
                    slots: int = 4, seed: int = 0, kernel: str = "fused",
                    device: tp.Any = None,
                    log: tp.Optional[logging.Logger] = None) -> int:
    """Gate: sticky routing earns its keep AND is replayable. The same
    shared-system-prompt workload through a round-robin and a sticky
    fleet: sticky's aggregate prefix hit rate must be >= round-robin's,
    a fresh router must replay every sticky decision, and both fleets
    must be token-exact and build nothing after the warm-up."""
    import numpy as np
    from ..__main__ import _build_model, _reference
    from .fleet import ServingFleet
    from .quota import QuotaManager, TenantQuota
    from .router import FleetRouter

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    prompts = _fleet_mix(requests, vocab, seed + 1)
    max_new = 5
    failures = 0
    hit_rates = {}
    wants = [_reference(model, p, max_new, device) for p in prompts]

    for policy in ("round_robin", "sticky"):
        fleet = ServingFleet.build(
            model, engines=engines, slots=slots, block_size=16,
            kernel=kernel, policy=policy, device=device,
            quotas=QuotaManager(default=TenantQuota(
                max_inflight=max(requests, 1))))
        fleet.warmup(prompt_lengths=[len(p) for p in prompts])
        warm = {n: dict(m.engine.compile_cache.stats())
                for n, m in fleet.members.items()}
        handles = [fleet.submit(p, max_new) for p in prompts]
        routes = [fleet._inflight[h.uid][2] for h in handles]
        fleet.run()

        for want, handle in zip(wants, handles):
            if not np.array_equal(handle.output, want):
                log.error("[%s] request %d diverged from generate()",
                          policy, handle.uid)
                failures += 1
        for name, member in fleet.members.items():
            builds, recompiles = _post_warm(member.engine, warm[name])
            if builds or recompiles:
                log.error("[%s] %s not compile-free: %d builds, "
                          "%d recompiles", policy, name, builds, recompiles)
                failures += 1
        pools = [m.engine.pool for m in fleet.members.values()]
        hits = sum(p.prefix_matched_tokens for p in pools)
        total = sum(p.prefix_total_tokens for p in pools)
        hit_rates[policy] = hits / max(total, 1)
        log.info("[%s] routed %s; aggregate prefix hit rate %.3f "
                 "(%d/%d prompt tokens from the index)", policy,
                 dict(sorted(fleet.engine_routed.items())),
                 hit_rates[policy], hits, total)

        if policy == "sticky":
            # a FRESH router (fnv1a has no per-process salt) must replay
            # every decision
            replay = FleetRouter(list(fleet.members), block_size=16,
                                 policy="sticky")
            replayed = [replay.route(uid, p).engine
                        for uid, p in enumerate(prompts)]
            if replayed != routes:
                log.error("sticky routing is not replayable: %s vs %s",
                          replayed, routes)
                failures += 1
            else:
                log.info("determinism: a fresh router replayed all %d "
                         "decisions identically", len(routes))

    if hit_rates["sticky"] < hit_rates["round_robin"]:
        log.error("sticky prefix hit rate %.3f lost to round-robin %.3f "
                  "on a shared-prefix workload", hit_rates["sticky"],
                  hit_rates["round_robin"])
        failures += 1
    else:
        log.info("verified: sticky %.3f >= round_robin %.3f prefix hit "
                 "rate", hit_rates["sticky"], hit_rates["round_robin"])
    return 1 if failures else 0


def run_preempt_demo(low: int = 4, slots: int = 2, seed: int = 0,
                     kernel: str = "fused", device: tp.Any = None,
                     log: tp.Optional[logging.Logger] = None) -> int:
    """Gate: preemption's rollback is invisible in the tokens. A batch
    tenant (priority 0) fills a one-engine fleet, an interactive tenant
    (priority 5) then preempts a running batch request; every request,
    victims included, finishes token-exact, the pool is conserved after
    every step and the per-tenant rollups land in serve.json."""
    import json
    import tempfile
    from pathlib import Path

    import numpy as np

    from ...xp import SERVE_STATUS_NAME
    from ..__main__ import _build_model, _reference
    from .fleet import ServingFleet
    from .quota import QuotaManager, TenantQuota

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    rng = np.random.default_rng(seed + 1)
    low_prompts = [rng.integers(0, vocab, 5 + i).astype(np.int32)
                   for i in range(low)]
    hi_prompt = rng.integers(0, vocab, 6).astype(np.int32)

    quotas = QuotaManager({
        "batch": TenantQuota(max_inflight=2 * low, priority=0),
        "interactive": TenantQuota(max_inflight=4, priority=5)})
    fleet = ServingFleet.build(model, engines=1, slots=slots,
                               block_size=16, kernel=kernel, device=device,
                               quotas=quotas)
    lengths = [len(p) for p in low_prompts] + [len(hi_prompt)]
    fleet.warmup(prompt_lengths=lengths)
    member = next(iter(fleet.members.values()))
    warm = dict(member.engine.compile_cache.stats())

    failures = 0
    low_handles = [fleet.submit(p, 12, tenant="batch")
                   for p in low_prompts]
    for _ in range(3):  # let the batch requests get decoding
        fleet.step()
        member.engine.pool.check()
    hi_handle = fleet.submit(hi_prompt, 8, tenant="interactive")
    while not all(h.done for h in low_handles + [hi_handle]):
        fleet.step()
        member.engine.pool.check()
    fleet.run()  # the quota reap

    preemptions = sum(h.preemptions for h in low_handles)
    pool_evictions = member.engine.pool.stats()["preemptions"]
    if preemptions < 1 or pool_evictions < 1:
        log.error("the interactive tenant never preempted anyone (request "
                  "preemptions %d, pool evictions %d): the gate needs the "
                  "rollback path exercised", preemptions, pool_evictions)
        failures += 1
    else:
        log.info("preempted %d batch request(s) (%d slot evictions); "
                 "victims re-queued with generated tokens retained",
                 preemptions, pool_evictions)
    for prompt, handle in zip(low_prompts + [hi_prompt],
                              low_handles + [hi_handle]):
        want = _reference(model, prompt, handle.max_new_tokens, device)
        if not np.array_equal(handle.output, want):
            log.error("request %d (%d preemptions) diverged from "
                      "generate():\n  served   %s\n  generate %s",
                      handle.uid, handle.preemptions,
                      handle.output.tolist(), want.tolist())
            failures += 1
    if not failures:
        log.info("verified: all %d outputs token-exact, preempted victims "
                 "included", low + 1)
    builds, recompiles = _post_warm(member.engine, warm)
    if builds or recompiles:
        log.error("preemption was not compile-free: %d builds, %d "
                  "recompiles (rollback must be a data change, never a "
                  "shape change)", builds, recompiles)
        failures += 1

    with tempfile.TemporaryDirectory() as tmp:
        member.scheduler.metrics.write_status(tmp)
        with open(Path(tmp) / SERVE_STATUS_NAME) as f:
            status = json.load(f)
    tenants = status.get("tenants", {})
    if set(tenants) != {"batch", "interactive"} \
            or tenants.get("batch", {}).get("preempted", 0) < 1:
        log.error("serve.json per-tenant rollups are wrong: %s", tenants)
        failures += 1
    else:
        log.info("serve.json tenants block: %s", tenants)
    return 1 if failures else 0


def run_drill_demo(requests: int = 8, engines: int = 2, slots: int = 4,
                   seed: int = 0, kernel: str = "fused",
                   device: tp.Any = None,
                   log: tp.Optional[logging.Logger] = None) -> int:
    """Gate: an engine death loses no request and no token. A STRICT
    injector kills one engine at the `fleet.engine_step` site while
    requests are mid-decode; every in-flight request re-routes to the
    survivors and every output equals `generate()` (the drill fails if
    the armed fault never fires); fleet.json records the death."""
    import json
    import tempfile
    from pathlib import Path

    import numpy as np

    from ...resilience import chaos
    from ...xp import FLEET_STATUS_NAME
    from ..__main__ import _build_model, _reference
    from .fleet import ENGINE_FAULT_SITE, ServingFleet
    from .quota import QuotaManager, TenantQuota

    log = log or logger
    vocab = 64
    model = _build_model(vocab, seed, device)
    prompts = _fleet_mix(requests, vocab, seed + 1)
    max_new = 6

    fleet = ServingFleet.build(
        model, engines=engines, slots=slots, block_size=16, kernel=kernel,
        device=device, quotas=QuotaManager(default=TenantQuota(
            max_inflight=max(requests, 1))))
    fleet.warmup(prompt_lengths=[len(p) for p in prompts])
    warm = {n: dict(m.engine.compile_cache.stats())
            for n, m in fleet.members.items()}

    failures = 0
    handles = [fleet.submit(p, max_new) for p in prompts]
    for _ in range(2):  # get requests mid-decode before the kill
        fleet.step()
    victim = fleet.healthy[0]
    mid_flight = fleet.members[victim].scheduler.live_count
    log.info("drill: killing %s mid-decode (%d live requests on it) via "
             "strict %s injection...", victim, mid_flight,
             ENGINE_FAULT_SITE)
    if mid_flight < 1:
        log.error("drill is vacuous: no live requests on %s at kill time",
                  victim)
        failures += 1

    injector = chaos.install(strict=True)
    # the victim's fault point is the FIRST occurrence after install
    # (members step in name order, the victim first)
    injector.fail_at(ENGINE_FAULT_SITE, call=1)
    try:
        fleet.run()
    finally:
        chaos.uninstall()  # strict: raises if the kill never happened

    if fleet.deaths != [victim] or injector.hits(ENGINE_FAULT_SITE) != 1:
        log.error("expected exactly one injected death of %s, got "
                  "deaths=%s hits=%d", victim, fleet.deaths,
                  injector.hits(ENGINE_FAULT_SITE))
        failures += 1
    if fleet.reroutes < mid_flight:
        log.error("only %d re-routes for %d in-flight requests on the dead "
                  "engine", fleet.reroutes, mid_flight)
        failures += 1
    mismatches = 0
    for prompt, handle in zip(prompts, handles):
        want = _reference(model, prompt, max_new, device)
        if not handle.done or not np.array_equal(handle.output, want):
            mismatches += 1
            log.error("request %d was not re-served token-exactly "
                      "(done=%s)", handle.uid, handle.done)
    if mismatches:
        failures += 1
    else:
        log.info("verified: every request re-served token-exactly after "
                 "the death (%d re-routed mid-flight)", fleet.reroutes)
    for name, member in fleet.members.items():
        if not member.healthy:
            continue
        builds, recompiles = _post_warm(member.engine, warm[name])
        if builds or recompiles:
            log.error("survivor %s not compile-free after absorbing "
                      "re-routes: %d builds, %d recompiles", name, builds,
                      recompiles)
            failures += 1
        try:
            member.engine.pool.check()
        except AssertionError as exc:
            log.error("survivor %s pool conservation violated: %s", name,
                      exc)
            failures += 1

    with tempfile.TemporaryDirectory() as tmp:
        fleet.write_status(tmp)
        with open(Path(tmp) / FLEET_STATUS_NAME) as f:
            status = json.load(f)
    if status["deaths"] != [victim] \
            or status["engines"][victim]["healthy"] \
            or not all(status["engines"][n]["healthy"]
                       for n in fleet.healthy):
        log.error("fleet.json does not record the death: %s",
                  {n: e["healthy"] for n, e in status["engines"].items()})
        failures += 1
    else:
        log.info("fleet.json: %d engines, deaths=%s, reroutes=%d",
                 len(status["engines"]), status["deaths"],
                 status["reroutes"])
    return 1 if failures else 0


def _build_wal_fleet(model, slots: int, kernel: str, device, wal_path,
                     requests: int):
    """The one fleet configuration the wal leg's worker AND recoverer
    share: recovery re-routes deterministically only because the
    topology (engines, slots, block size) is the same across the kill."""
    from .fleet import ServingFleet
    from .quota import QuotaManager, TenantQuota
    from .wal import RequestWAL
    return ServingFleet.build(
        model, engines=2, slots=slots, block_size=16, kernel=kernel,
        device=device, quotas=QuotaManager(default=TenantQuota(
            max_inflight=max(requests, 1))),
        wal=RequestWAL(wal_path))


def _wal_warm_lengths(prompts) -> tp.List[int]:
    # recovery prefills prompt + generated: every length up to
    # len + max_new must land in a warmed step
    return sorted({n for p in prompts
                   for n in range(len(p), len(p) + WAL_MAX_NEW + 1)})


def run_wal_worker(workdir: str, requests: int = 8, slots: int = 2,
                   seed: int = 0, kernel: str = "fused",
                   device: tp.Any = None) -> int:
    """The condemned half of the wal leg (its subprocess): build the
    WAL-backed fleet, admit the whole workload, step a few times so queued
    and mid-decode requests coexist, then SIGKILL this process: no flush,
    no close, no atexit. On the card it loads the kernel libraries the
    parent built and builds none."""
    import os
    import signal
    from pathlib import Path

    from ...utils import resolve_device
    from ..__main__ import _build_model
    from .wal import WAL_NAME

    device = resolve_device(device)
    if device.type == "cuda":
        from ...ops import _build
        missing = [name for name in PAGED_LIBRARIES
                   if not _build.library_path(name).exists()]
        if missing:
            raise RuntimeError(f"wal worker: the kernel libraries {missing} "
                               f"are not built; the parent builds them "
                               f"before spawning the worker")
    vocab = 64
    model = _build_model(vocab, seed, device)
    prompts = _fleet_mix(requests, vocab, seed + 1)
    fleet = _build_wal_fleet(model, slots, kernel, device,
                             Path(workdir) / WAL_NAME, requests)
    fleet.warmup(prompt_lengths=_wal_warm_lengths(prompts))
    for prompt in prompts:
        fleet.submit(prompt, WAL_MAX_NEW)
    for _ in range(WAL_KILL_STEPS):
        fleet.step()
    os.kill(os.getpid(), signal.SIGKILL)
    return 1  # unreachable


def run_wal_demo(requests: int = 8, slots: int = 2, seed: int = 0,
                 kernel: str = "fused", device: tp.Any = None,
                 log: tp.Optional[logging.Logger] = None) -> int:
    """Gate: a SIGKILLed fleet process loses nothing it acknowledged. A
    worker subprocess admits `requests` requests into a WAL-backed fleet
    and is SIGKILLed after WAL_KILL_STEPS steps; a fresh fleet here
    replays the log and must re-serve every acknowledged uid
    byte-identically to `generate()`, leave exactly one completion record
    per uid in the raw log, conserve its pools and build nothing after
    its own warm-up; fleet.json is written and parsed at the end."""
    import json
    import os
    import signal
    import subprocess
    import tempfile
    from pathlib import Path

    import numpy as np

    from ...utils import resolve_device
    from ...xp import FLEET_STATUS_NAME
    from ..__main__ import _build_model, _reference
    from .wal import WAL_NAME

    log = log or logger
    failures = 0
    vocab = 64
    device = resolve_device(device)
    if device.type == "cuda":
        # the worker loads these and builds nothing
        from ...ops import _build
        for name in PAGED_LIBRARIES:
            _build.build(name)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        cmd = [sys.executable, "-m", "flashy_tpu_torch.serve.fleet",
               "--wal-worker", str(workdir), "-n", str(requests),
               "-s", str(slots), "--seed", str(seed),
               "--kernel", kernel, "--device", str(device)]
        log.info("wal leg: spawning a fleet worker on %s to be SIGKILLed "
                 "after %d steps (%d requests, %d slots/engine)...",
                 device, WAL_KILL_STEPS, requests, slots)
        # the worker imports this very package, wherever the caller runs
        root = str(Path(__file__).resolve().parents[3])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != -signal.SIGKILL:
            log.error("worker should have died by SIGKILL, got rc=%s\n"
                      "--- worker stderr ---\n%s", proc.returncode,
                      proc.stderr[-3000:])
            return 1
        wal_path = workdir / WAL_NAME
        if not wal_path.exists():
            log.error("worker left no WAL at %s", wal_path)
            return 1
        log.info("worker dead (SIGKILL confirmed); WAL holds %d bytes",
                 wal_path.stat().st_size)

        model = _build_model(vocab, seed, device)
        prompts = _fleet_mix(requests, vocab, seed + 1)
        fleet = _build_wal_fleet(model, slots, kernel, device, wal_path,
                                 requests)
        fleet.warmup(prompt_lengths=_wal_warm_lengths(prompts))
        warm = {name: dict(member.engine.compile_cache.stats())
                for name, member in fleet.members.items()}
        rec = fleet.recover_from_wal()
        log.info("replayed: %d re-admitted, %d already complete (served "
                 "from the log)", len(rec["recovered"]),
                 len(rec["completed"]))
        fleet.run()
        fleet.wal.close()

        # the worker acknowledged every submit before stepping: every uid
        # 0..requests-1 is journaled and must re-serve exactly
        mismatches = 0
        for uid, prompt in enumerate(prompts):
            want = _reference(model, prompt, WAL_MAX_NEW, device)
            if uid in rec["completed"]:
                got = np.concatenate([
                    prompt, np.asarray(rec["completed"][uid].generated,
                                       np.int32)])
            elif uid in rec["recovered"]:
                handle = rec["recovered"][uid]
                if not handle.done:
                    log.error("uid %d still unfinished after recovery", uid)
                    mismatches += 1
                    continue
                got = np.asarray(handle.output)
            else:
                log.error("acknowledged uid %d vanished across the SIGKILL "
                          "(at-least-once broken)", uid)
                mismatches += 1
                continue
            if not np.array_equal(got, want):
                mismatches += 1
                log.error("uid %d not byte-identical after restart:\n"
                          "  served   %s\n  generate %s", uid,
                          got.tolist(), want.tolist())
        if mismatches:
            failures += 1
        else:
            log.info("verified: all %d acknowledged requests re-served "
                     "byte-identically across the SIGKILL", requests)

        completes: tp.Dict[int, int] = {}
        with open(wal_path, encoding="utf-8") as f:
            for line in f:
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    break
                if record.get("t") == "complete":
                    uid = record["uid"]
                    completes[uid] = completes.get(uid, 0) + 1
        doubles = {u: c for u, c in completes.items() if c != 1}
        missing = [u for u in range(requests) if u not in completes]
        if doubles or missing:
            log.error("dedup/delivery broken in the raw log: doubled=%s "
                      "missing=%s", doubles, missing)
            failures += 1
        else:
            log.info("raw log: exactly one completion record per uid "
                     "(at-least-once with exact dedup)")

        for name, member in fleet.members.items():
            builds, recompiles = _post_warm(member.engine, warm[name])
            if builds or recompiles:
                log.error("recovering %s not compile-free after its "
                          "warm-up: %d builds, %d recompiles", name,
                          builds, recompiles)
                failures += 1
            try:
                member.engine.pool.check()
            except AssertionError as exc:
                log.error("%s pool conservation violated after recovery: "
                          "%s", name, exc)
                failures += 1

        fleet.write_status(str(workdir))
        with open(workdir / FLEET_STATUS_NAME) as f:
            json.load(f)  # must parse: atomic write, never torn
    return 1 if failures else 0


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.serve.fleet",
        description="Serving-fleet demo of the PyTorch port: disaggregated "
                    "handoff, sticky routing, preemption, death drill, "
                    "request WAL.")
    parser.add_argument("-n", "--requests", type=int, default=8)
    parser.add_argument("-e", "--engines", type=int, default=2)
    parser.add_argument("-s", "--slots", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--legs", default="all",
                        help=f"comma list of legs to run: {','.join(LEGS)} "
                             f"(or 'all')")
    parser.add_argument("--kernel", default="fused",
                        choices=("gather", "fused"),
                        help="the engines' paged pool read: the Hopper "
                             "kernel (CUDA only) or its plain version")
    parser.add_argument("--device", default="cuda",
                        help="where the legs run (cuda by default; cpu only "
                             "when asked for)")
    parser.add_argument("--wal-worker", metavar="DIR", default=None,
                        help=argparse.SUPPRESS)  # the wal leg's subprocess
    args = parser.parse_args(argv)

    if args.kernel == "fused" and not args.device.startswith("cuda"):
        parser.error("--kernel fused is the Hopper kernel and needs the "
                     "card: use --kernel gather with --device cpu")
    from ...utils import resolve_device
    device = resolve_device(args.device)

    if args.wal_worker:
        return run_wal_worker(args.wal_worker, requests=args.requests,
                              slots=args.slots, seed=args.seed,
                              kernel=args.kernel, device=device)

    legs = LEGS if args.legs == "all" else tuple(args.legs.split(","))
    unknown = set(legs) - set(LEGS)
    if unknown:
        parser.error(f"unknown legs: {sorted(unknown)} (choose from {LEGS})")

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="[%(levelname)s] %(message)s")
    rc = 0
    if "handoff" in legs:
        rc |= run_handoff_demo(requests=args.requests, seed=args.seed,
                               kernel=args.kernel, device=device)
    if "sticky" in legs:
        rc |= run_sticky_demo(requests=max(12, 3 * args.requests),
                              engines=max(3, args.engines),
                              slots=args.slots, seed=args.seed,
                              kernel=args.kernel, device=device)
    if "preempt" in legs:
        rc |= run_preempt_demo(low=4, slots=2, seed=args.seed,
                               kernel=args.kernel, device=device)
    if "drill" in legs:
        rc |= run_drill_demo(requests=args.requests, engines=args.engines,
                             slots=args.slots, seed=args.seed,
                             kernel=args.kernel, device=device)
    if "wal" in legs:
        rc |= run_wal_demo(requests=args.requests, slots=2, seed=args.seed,
                           kernel=args.kernel, device=device)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
