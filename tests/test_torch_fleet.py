# The port's serving fleet (flashy_tpu_torch.serve.fleet) held against the
# JAX package's: router and quota decisions equal on seeded sequences, the
# request WAL replayed across the two packages in both directions, the
# pool's and the scheduler's hooks, the handoff, drill, preempt and WAL
# recovery streams token-exact against the JAX `generate` on the same
# converted weights, the status snapshot's keys, a compile cache entry
# bound to the engine that built it, and the demo's entry point.
import itertools
import json
import types

import numpy as np
import pytest

from ._torch_port import jax_generate, tiny_pair

from flashy_tpu_torch.serve.compile_cache import CompileCache
from flashy_tpu_torch.serve.engine import DecodeEngine
from flashy_tpu_torch.serve.fleet import (
    ENGINE_FAULT_SITE, DisaggregatedPair, FleetRouter, QuotaManager,
    RequestWAL, ServingFleet, TenantQuota, fnv1a, hand_off)
from flashy_tpu_torch.serve.paged import BlockPool
from flashy_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

PROMPT_LEN, MAX_NEW, BLOCK = 20, 6, 16


@pytest.fixture(scope="module")
def pair():
    """The tiny JAX LM and its port twin, prompts of one length (one JAX
    compile) of which every other shares a one-block system prefix, and
    the JAX `generate` streams of all of them."""
    jax_model, params, model = tiny_pair(seed=3)
    rng = np.random.default_rng(0)
    system = rng.integers(0, 256, BLOCK)
    prompts = []
    for i in range(8):
        tail = rng.integers(0, 256, PROMPT_LEN - BLOCK)
        head = system if i % 2 == 0 else rng.integers(0, 256, BLOCK)
        prompts.append(np.concatenate([head, tail]).astype(np.int32))
    wants = jax_generate(jax_model, params, np.stack(prompts),
                         max_new_tokens=MAX_NEW)
    return model, prompts, wants


def _quotas(n=16):
    return QuotaManager(default=TenantQuota(max_inflight=n))


def _fleet(model, **kw):
    kw = {"engines": 2, "slots": 2, "block_size": BLOCK, "kernel": "gather",
          "device": "cpu", "quotas": _quotas(), **kw}
    return ServingFleet.build(model, **kw)


def _compile_free(engine, warm):
    stats = engine.compile_cache.stats()
    assert stats["misses"] == warm["misses"] and stats["recompiles"] == 0


# ----------------------------------------------------------------------
# router and quotas against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 1 << 40])
def test_fnv1a_equals_the_reference(seed):
    from flashy_tpu.serve.fleet import fnv1a as ref_fnv1a
    rng = np.random.default_rng(seed % 1000)
    for n in (0, 1, 4, 64, 255):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert fnv1a(data, seed=seed) == ref_fnv1a(data, seed=seed)
    # the constants the reference pins, so any process routes alike
    assert fnv1a(b"abc") == 16654208175385433931
    assert fnv1a(b"") == 14695981039346656037


@pytest.mark.parametrize("policy", ["sticky", "round_robin"])
def test_router_decisions_equal_the_reference(policy):
    from flashy_tpu.serve.fleet import FleetRouter as RefRouter
    names = ["a", "b", "c", "d"]
    ours = FleetRouter(names, block_size=4, policy=policy, seed=5)
    ref = RefRouter(names, block_size=4, policy=policy, seed=5)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 64, 4)
    for uid in range(200):
        n = int(rng.integers(1, 12))
        prompt = rng.integers(0, 64, n).astype(np.int32)
        if uid % 3 == 0 and n >= 4:
            prompt[:4] = shared
        healthy = None if uid % 5 == 0 else \
            [e for e in names if rng.random() < 0.8] or ["c"]
        alerting = {e for e in names if rng.random() < 0.3}
        got = ours.route(uid, prompt, healthy=healthy, alerting=alerting)
        want = ref.route(uid, prompt, healthy=healthy, alerting=alerting)
        assert (got.engine, got.reason, got.key_hash) == \
            (want.engine, want.reason, want.key_hash)
        assert ours.chain_key(prompt) == ref.chain_key(prompt)


def test_router_refuses_what_the_reference_refuses():
    router = FleetRouter(["a", "b", "c"], block_size=4)
    with pytest.raises(RuntimeError, match="no healthy"):
        router.route(0, np.arange(6), healthy=[])
    for bad in (dict(engines=[]), dict(engines=["a", "a"]),
                dict(engines=["a"], block_size=0),
                dict(engines=["a"], policy="nope")):
        kw = {"block_size": 4, **bad}
        with pytest.raises(ValueError):
            FleetRouter(kw.pop("engines"), **kw)


def test_quota_decisions_equal_the_reference():
    from flashy_tpu.serve.fleet import QuotaManager as RefQuotas
    from flashy_tpu.serve.fleet import TenantQuota as RefQuota
    quotas = {"batch": (2, 0), "interactive": (3, 5)}
    ours = QuotaManager({t: TenantQuota(*q) for t, q in quotas.items()},
                        default=TenantQuota(max_inflight=1))
    ref = RefQuotas({t: RefQuota(*q) for t, q in quotas.items()},
                    default=RefQuota(max_inflight=1))
    rng = np.random.default_rng(2)
    tenants = ["batch", "interactive", "anon"]
    for _ in range(300):
        tenant = tenants[int(rng.integers(0, 3))]
        if rng.random() < 0.6:
            assert ours.try_acquire(tenant) == ref.try_acquire(tenant)
        elif ref.inflight(tenant):
            ours.release(tenant)
            ref.release(tenant)
        assert ours.summary() == ref.summary()
    assert ours.quota_for("anon") == TenantQuota(max_inflight=1)
    with pytest.raises(ValueError, match="release without acquire"):
        QuotaManager().release("nobody")
    with pytest.raises(ValueError, match="max_inflight"):
        TenantQuota(max_inflight=0)


# ----------------------------------------------------------------------
# the request WAL, both ways
# ----------------------------------------------------------------------
def _wal_request(uid, prompt=(1, 2, 3), generated=(), reason=None,
                 tenant="default", priority=0, eos=None):
    return types.SimpleNamespace(
        uid=uid, prompt=np.asarray(prompt, np.int32), max_new_tokens=9,
        eos_token=eos, tenant=tenant, priority=priority,
        generated=list(generated), finish_reason=reason)


def _write_wal(wal_class, path):
    """The same journal through either package's RequestWAL."""
    wal = wal_class(path, progress_every=2)
    a = _wal_request(0, prompt=(5, 6), tenant="batch", priority=2, eos=7)
    b = _wal_request(1, prompt=(7,))
    c = _wal_request(2, prompt=(8, 9, 10))
    for request in (a, b, c):
        wal.append_admit(request)
    a.generated = [10, 11]
    wal.note_progress([a, b, c])     # step 1: not on the cadence
    wal.note_progress([a, b, c])     # step 2: a's two tokens
    a.generated, b.generated = [10, 11, 12], [20]
    wal.note_progress([a, b, c])
    wal.note_progress([a, b, c])
    a.finish_reason = "length"
    wal.append_complete(a)
    wal.append_complete(a)           # idempotent
    c.generated, c.finish_reason = [30], "eos"
    wal.append_complete(c)
    wal.close()


def _entries(entries):
    return {uid: vars(entry) for uid, entry in entries.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_across_the_packages(tmp_path, writer):
    from flashy_tpu.serve.fleet.wal import RequestWAL as RefWAL
    ours, theirs = tmp_path / "port.wal", tmp_path / "jax.wal"
    _write_wal(RequestWAL, ours)
    _write_wal(RefWAL, theirs)
    # the records are the same bytes
    assert ours.read_bytes() == theirs.read_bytes()
    path = theirs if writer == "jax" else ours
    got = RequestWAL(path).replay()
    want = RefWAL(path).replay()
    assert _entries(got) == _entries(want)
    assert got[0].generated == [10, 11, 12] and got[0].complete
    assert got[0].complete_records == 1 and got[2].finish_reason == "eos"
    assert got[1].generated == [20] and not got[1].complete


def test_wal_torn_tail_truncates_and_self_heals(tmp_path):
    path = tmp_path / "requests.wal"
    wal = RequestWAL(path)
    req = _wal_request(0, generated=[1, 2])
    wal.append_admit(req)
    wal.note_progress([req])
    wal.close()
    good_size = path.stat().st_size
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"t": "progress", "uid": 0, "n"')  # killed mid-write
    wal2 = RequestWAL(path)
    assert wal2.replay()[0].generated == [1, 2]
    assert path.stat().st_size == good_size
    req.generated, req.finish_reason = [1, 2, 3], "length"
    wal2.append_complete(req)
    wal2.close()
    final = RequestWAL(path).replay()
    assert final[0].complete and final[0].generated == [1, 2, 3]
    assert final[0].complete_records == 1


def test_wal_progress_merges_defensively_and_primes_marks(tmp_path):
    path = tmp_path / "requests.wal"
    records = [
        {"t": "admit", "uid": 0, "prompt": [1], "max_new": 9,
         "eos": None, "tenant": "default", "priority": 0},
        {"t": "progress", "uid": 0, "n": 2, "tokens": [4, 5]},
        {"t": "progress", "uid": 0, "n": 2, "tokens": [4, 5]},  # dup
        {"t": "progress", "uid": 0, "n": 1, "tokens": [4]},     # stale
        {"t": "progress", "uid": 0, "n": 3, "tokens": [6]},     # delta
        {"t": "progress", "uid": 7, "n": 1, "tokens": [9]},     # unknown
    ]
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    wal = RequestWAL(path)
    entries = wal.replay()
    assert list(entries) == [0] and entries[0].generated == [4, 5, 6]
    # a recovered fleet continues from the replayed marks
    req = _wal_request(0, generated=[4, 5, 6])
    assert wal.note_progress([req]) == 0
    req.generated.append(7)
    assert wal.note_progress([req]) == 1
    wal.close()
    assert RequestWAL(path).replay()[0].generated == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="progress_every"):
        RequestWAL(path, progress_every=0)


def test_wal_complete_is_idempotent(tmp_path):
    path = tmp_path / "requests.wal"
    wal = RequestWAL(path)
    req = _wal_request(0, generated=[1], reason="length")
    wal.append_admit(req)
    wal.append_complete(req)
    wal.append_complete(req)
    wal.close()
    raw = [json.loads(line) for line in path.read_text().splitlines()]
    assert sum(r["t"] == "complete" for r in raw) == 1
    assert RequestWAL(path).replay()[0].complete_records == 1


# ----------------------------------------------------------------------
# the pool's and the scheduler's hooks
# ----------------------------------------------------------------------
def test_pool_handoff_verbs_conserve_as_the_reference():
    from flashy_tpu.serve.paged import BlockPool as RefPool
    kw = dict(num_blocks=12, block_size=4, max_seq_len=16)
    pools = (BlockPool(**kw), RefPool(**kw))
    prompt = np.arange(9, dtype=np.int32)
    for pool in pools:
        row, start, cow = pool.commit(pool.plan(prompt, 3), 0)
        pool.on_live(0)
        before = pool.refcount.copy()
        assert pool.transfer_slot(0, 7) == list(row[:3])
        assert np.array_equal(pool.refcount, before)
        assert pool.slot_blocks(7) == list(row[:3]) and not pool.holds(0)
        pool.check()
        with pytest.raises(KeyError):
            pool.transfer_slot(0, 8)
        pool.commit(pool.plan(prompt[:5], 2), 1)
        with pytest.raises(ValueError):
            pool.transfer_slot(1, 7)
        pool.evict_slot(7)
        with pytest.raises(KeyError):
            pool.evict_slot(7)
        pool.release(1)
        pool.check()
    assert pools[0].stats() == pools[1].stats()
    assert pools[0].stats()["handoffs"] == 1


def _scheduler(model, uid_source=None, slots=2):
    engine = DecodeEngine(model, slots=slots, block_size=BLOCK,
                          cache_layout="paged", kernel="gather",
                          device="cpu")
    engine.warmup()
    return ContinuousBatchingScheduler(engine, uid_source=uid_source)


def test_scheduler_shares_uids_and_cancels_queued(pair):
    model, prompts, _ = pair
    uids = itertools.count()
    a, b = _scheduler(model, uids), _scheduler(model, uids)
    handles = [s.submit(p, MAX_NEW) for s, p in zip((a, b, a), prompts)]
    assert [h.uid for h in handles] == [0, 1, 2]
    assert a.cancel_queued(2) is handles[2] and a.queue_depth == 1
    with pytest.raises(ValueError, match="not in the admission queue"):
        a.cancel_queued(2)
    a.advance_uids(10)
    assert b.submit(prompts[3], MAX_NEW).uid == 11
    # a re-injected request keeps its uid and skips the depth cap
    a.max_queue = 1
    a.enqueue(handles[2], front=True)
    assert a.queue_depth == 2 and a._queue[0] is handles[2]


def test_scheduler_drains_for_reroute_without_touching_the_engine(pair):
    model, prompts, _ = pair
    sched = _scheduler(model)
    handles = [sched.submit(p, MAX_NEW) for p in prompts[:4]]
    for _ in range(3):
        sched.step()
    engine = sched.engine
    live = engine.live_count
    assert live >= 1
    drained = sched.drain_for_reroute()
    # in flight first (by uid), then the queue in order
    assert [r.uid for r in drained] == sorted(
        r.uid for r in drained[:live]) + [r.uid for r in drained[live:]]
    assert {r.uid for r in drained} == {h.uid for h in handles}
    assert all(r.state == "queued" and r.slot is None for r in drained)
    assert any(r.generated for r in drained)
    assert sched.idle and engine.live_count == live   # engine untouched


def test_engine_sharing_hooks_validate(pair):
    model = pair[0]
    pool = BlockPool(num_blocks=9, block_size=BLOCK, max_seq_len=64)
    kw = dict(slots=2, cache_layout="paged", kernel="gather", device="cpu")
    for bad, match in (
            (dict(pool=pool, block_size=8), "block_size"),
            (dict(pool=pool, max_seq_len=32), "max_seq_len"),
            (dict(pool=pool, num_blocks=10), "num_blocks"),
            (dict(pool=pool, spec_k=2), "spec_overshoot"),
            (dict(pool_slot_base=-1), "pool_slot_base"),
            (dict(cache_box=DecodeEngine(model, **kw).cache_box),
             "requires a shared pool")):
        with pytest.raises(ValueError, match=match):
            DecodeEngine(model, **{**kw, **bad})
    with pytest.raises(ValueError, match="paged-layout sharing hooks"):
        DecodeEngine(model, slots=2, pool=pool, device="cpu")
    engine = DecodeEngine(model, pool=pool, pool_slot_base=5, **kw)
    assert engine.pool is pool and engine.pool_key(1) == 6
    assert engine.num_blocks == 9


def test_handoff_writes_the_engines_state_in_place(pair):
    model, prompts, _ = pair
    duo = DisaggregatedPair(model, prefill_slots=1, decode_slots=2,
                            block_size=BLOCK, kernel="gather", device="cpu")
    duo.warmup()
    src, dst = duo.prefill, duo.decode
    assert dst.cache_box.value is src.cache_box.value
    ptrs = [t.data_ptr() for e in (src, dst)
            for t in (e._tokens, e._positions, e._active, e._table_dev)]
    slot = src.acquire_slot()
    start = src.admit(slot, prompts[0], MAX_NEW)
    first = None
    while first is None:
        start, first = src.prefill_chunk(slot, prompts[0], start)
    blocks = src.pool.slot_blocks(src.pool_key(slot))
    dslot, packet = hand_off(src, dst, slot)
    assert packet.blocks == tuple(blocks) and packet.last_token == first
    assert packet.position == PROMPT_LEN
    assert (packet.src, packet.dst) == ("prefill", "decode")
    assert src.pool.holds(dst.pool_key(dslot)) and src.live_count == 0
    dst.decode()
    assert ptrs == [t.data_ptr() for e in (src, dst)
                    for t in (e._tokens, e._positions, e._active,
                              e._table_dev)]
    assert int(dst._table_dev[dslot, 0]) == blocks[0]
    with pytest.raises(ValueError, match="share one BlockPool"):
        hand_off(src, DecodeEngine(model, slots=1, cache_layout="paged",
                                   kernel="gather", device="cpu"), 0)
    with pytest.raises(ValueError, match="not live"):
        src.release_for_handoff(0)


# ----------------------------------------------------------------------
# the fleet's paths against the JAX generate
# ----------------------------------------------------------------------
def test_handoff_streams_match_the_jax_generate(pair):
    model, prompts, wants = pair
    duo = DisaggregatedPair(model, prefill_slots=2, decode_slots=3,
                            block_size=BLOCK, kernel="gather", device="cpu")
    duo.warmup()
    warm = [dict(e.compile_cache.stats()) for e in (duo.prefill, duo.decode)]
    outputs = duo.serve(prompts, MAX_NEW)
    for prompt, out, want in zip(prompts, outputs, wants):
        assert np.array_equal(np.concatenate([prompt, out]), want)
    assert len(duo.handoffs) == len(prompts) == duo.pool.stats()["handoffs"]
    assert len(duo.handoff_seconds) == len(prompts)
    for engine, stats in zip((duo.prefill, duo.decode), warm):
        _compile_free(engine, stats)
    duo.pool.check()


def test_drill_streams_match_the_jax_generate(pair, tmp_path):
    from flashy_tpu_torch.resilience import chaos
    from flashy_tpu_torch.serve.tracing import RequestTracer
    model, prompts, wants = pair
    tracer = RequestTracer(journal_path=tmp_path / "requests.jsonl")
    fleet = _fleet(model, tracing=tracer)
    fleet.warmup()
    handles = [fleet.submit(p, MAX_NEW) for p in prompts]
    for _ in range(2):
        fleet.step()
    victim = fleet.healthy[0]
    in_flight = fleet.members[victim].scheduler.live_count
    assert in_flight >= 1
    injector = chaos.install(strict=True)
    injector.fail_at(ENGINE_FAULT_SITE, call=1)
    try:
        fleet.run()
    finally:
        chaos.uninstall()
    assert fleet.deaths == [victim] and fleet.reroutes >= in_flight
    for handle, want in zip(handles, wants):
        assert handle.done and np.array_equal(handle.output, want)
    tracer.close()
    journal = [json.loads(line) for line in
               (tmp_path / "requests.jsonl").read_text().splitlines()]
    hops = [r for r in journal if r.get("event") == "handoff"]
    assert len(hops) == fleet.reroutes
    assert {(r["src"], r["dst"]) for r in hops} == {(victim, "engine1")}
    with pytest.raises(ValueError, match="already dead"):
        fleet.kill(victim)
    with pytest.raises(RuntimeError, match="no healthy members"):
        fleet.kill("engine1")


def test_preempt_streams_match_the_jax_generate(pair):
    model, prompts, wants = pair
    quotas = QuotaManager({"batch": TenantQuota(8, priority=0),
                           "interactive": TenantQuota(4, priority=5)})
    fleet = _fleet(model, engines=1, quotas=quotas)
    fleet.warmup()
    member = fleet.members["engine0"]
    low = [fleet.submit(p, MAX_NEW, tenant="batch") for p in prompts[:4]]
    for _ in range(3):
        fleet.step()
        member.engine.pool.check()
    high = fleet.submit(prompts[4], MAX_NEW, tenant="interactive")
    assert high.priority == 5
    while not all(h.done for h in low + [high]):
        fleet.step()
        member.engine.pool.check()
    fleet.run()
    assert sum(h.preemptions for h in low) >= 1
    assert member.engine.pool.stats()["preemptions"] >= 1
    for handle, want in zip(low + [high], wants[:5]):
        assert np.array_equal(handle.output, want)
    assert fleet.quotas.summary()["batch"]["inflight"] == 0
    # the door sheds over quota, the credit coming back at the reap
    tight = _fleet(model, engines=1, quotas=QuotaManager(
        default=TenantQuota(max_inflight=1)))
    tight.submit(prompts[0], MAX_NEW)
    from flashy_tpu_torch.serve.scheduler import QueueFull
    with pytest.raises(QueueFull, match="quota"):
        tight.submit(prompts[1], MAX_NEW)
    assert tight.quotas.summary()["default"]["shed"] == 1


def test_wal_recovery_streams_match_the_jax_generate(pair, tmp_path):
    model, prompts, wants = pair
    path = tmp_path / "requests.wal"
    lengths = range(PROMPT_LEN, PROMPT_LEN + MAX_NEW + 1)
    first = _fleet(model, wal=RequestWAL(path))
    first.warmup(lengths)
    handles = [first.submit(p, MAX_NEW) for p in prompts]
    for _ in range(6):
        first.step()
    done_before = {h.uid for h in handles if h.done}
    assert done_before and len(done_before) < len(handles)
    first.wal._f.close()       # the process dies: nothing more is written
    fleet = _fleet(model, wal=RequestWAL(path))
    fleet.warmup(lengths)
    warm = [dict(m.engine.compile_cache.stats())
            for m in fleet.members.values()]
    rec = fleet.recover_from_wal()
    assert set(rec["completed"]) == done_before
    assert set(rec["recovered"]) | done_before == set(range(len(prompts)))
    fleet.run()
    fleet.wal.close()
    for uid, (prompt, want) in enumerate(zip(prompts, wants)):
        if uid in rec["completed"]:
            got = np.concatenate([prompt, rec["completed"][uid].generated])
        else:
            got = rec["recovered"][uid].output
        assert np.array_equal(got, want), uid
    raw = [json.loads(line) for line in path.read_text().splitlines()]
    completes = [r["uid"] for r in raw if r["t"] == "complete"]
    assert sorted(completes) == list(range(len(prompts)))
    # the next uid is past every journaled one
    probe = fleet.submit(prompts[0], MAX_NEW)
    assert probe.uid > max(rec["recovered"])
    for member, stats in zip(fleet.members.values(), warm):
        _compile_free(member.engine, stats)
        member.engine.pool.check()
    with pytest.raises(RuntimeError, match="fresh fleet"):
        fleet.recover_from_wal()


# ----------------------------------------------------------------------
# status
# ----------------------------------------------------------------------
def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if tree is None else "leaf"


def test_status_has_the_references_keys(pair):
    from flashy_tpu.serve.fleet import QuotaManager as RefQuotas
    from flashy_tpu.serve.fleet import ServingFleet as RefFleet
    from flashy_tpu.serve.fleet import TenantQuota as RefQuota
    jax_model, params, _ = tiny_pair(seed=3)
    model, prompts, _ = pair
    ours = _fleet(model)
    ref = RefFleet.build(jax_model, params, engines=2, slots=2,
                         block_size=BLOCK, kernel="gather",
                         quotas=RefQuotas(default=RefQuota(16)))
    for fleet in (ours, ref):
        fleet.submit(prompts[0], MAX_NEW, tenant="t")
    assert _keys(ours.status()) == _keys(ref.status())


def test_fleet_json_is_never_torn_under_a_status_fault(pair, tmp_path):
    from flashy_tpu_torch import info
    from flashy_tpu_torch.resilience import InjectedFault, chaos
    from flashy_tpu_torch.serve.fleet import STATUS_FAULT_SITE
    from flashy_tpu_torch.xp import FLEET_STATUS_NAME
    fleet = _fleet(pair[0])
    target = fleet.write_status(tmp_path)
    assert target == tmp_path / FLEET_STATUS_NAME
    before = target.read_text()
    fleet.submit(pair[1][0], MAX_NEW)
    injector = chaos.install(strict=True)
    injector.fail_at(STATUS_FAULT_SITE, call=1)
    try:
        with pytest.raises(InjectedFault):
            fleet.write_status(tmp_path)
    finally:
        chaos.uninstall()
    assert target.read_text() == before
    fleet.write_status(tmp_path)       # self-heals
    status = json.loads(target.read_text())
    assert status["engines"]["engine0"]["routed"] + \
        status["engines"]["engine1"]["routed"] == 1
    assert info.format_fleet_status(status).startswith("policy=sticky")


# ----------------------------------------------------------------------
# compile caches: an entry binds the engine that built it
# ----------------------------------------------------------------------
def test_a_second_engine_on_a_filled_cache_raises(pair):
    model = pair[0]
    cache = CompileCache(device="cpu")
    kw = dict(slots=2, cache_layout="paged", kernel="gather",
              device="cpu", compile_cache=cache, cache_scope="m")
    first = DecodeEngine(model, **kw)
    first.warmup()
    second = DecodeEngine(model, **kw)
    with pytest.raises(ValueError, match="built for another engine"):
        second.warmup()
    with pytest.raises(ValueError, match="built for another engine"):
        second.decode()
    first.decode()   # the owner still gets its entries
    # a fleet build over a cache another build filled raises alike
    fleet = _fleet(model, compile_cache=CompileCache(device="cpu"))
    fleet.warmup()
    shared = next(iter(fleet.members.values())).engine.compile_cache
    with pytest.raises(ValueError, match="built for another engine"):
        _fleet(model, compile_cache=shared).warmup()


def test_a_shared_cache_leaves_the_warmups_without_recompiles(pair):
    model, prompts, wants = pair
    cache = CompileCache(device="cpu")
    fleet = _fleet(model, engines=3, compile_cache=cache)
    fleet.warmup()
    assert cache.sealed and cache.recompiles() == 0
    assert len(cache) == 3 * 4
    warm = dict(cache.stats())
    handles = [fleet.submit(p, MAX_NEW) for p in prompts]
    fleet.run()
    for handle, want in zip(handles, wants):
        assert np.array_equal(handle.output, want)
    _compile_free(next(iter(fleet.members.values())).engine, warm)
    duo_cache = CompileCache(device="cpu")
    duo = DisaggregatedPair(model, prefill_slots=1, decode_slots=2,
                            block_size=BLOCK, kernel="gather", device="cpu",
                            compile_cache=duo_cache)
    duo.warmup()
    assert duo_cache.recompiles() == 0 and len(duo_cache) == 8


# ----------------------------------------------------------------------
# the demo
# ----------------------------------------------------------------------
def test_demo_entry_point_passes_on_the_cpu():
    from flashy_tpu_torch.serve.fleet.__main__ import main
    assert main(["--device", "cpu", "--kernel", "gather", "-n", "4",
                 "--legs", "handoff,sticky,preempt,drill,wal"]) == 0
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--legs", "handoff"])   # fused on the CPU
