# The chaos fault points of the PyTorch port (flashy_tpu_torch/resilience/
# chaos.py; the sites `serve.pool`, `serve.step` and `fleet.status`) on
# the CPU: the FaultInjector records the same counts and firings as the
# JAX package's for the same rules and site sequence; a strict uninstall
# raises on a rule that never fired; an injected pool failure sheds one
# admission and every stream stays token-exact against the JAX
# `generate`; an injected status-write failure leaves the old serve.json
# (or none), never a torn one, and the next write heals it.
import json

import numpy as np
import pytest

from ._torch_port import TINY, jax_generate, tiny_pair


@pytest.fixture(autouse=True)
def _no_global_state():
    yield
    from flashy_tpu.resilience import chaos as jax_chaos
    from flashy_tpu_torch.resilience import chaos
    for module in (chaos, jax_chaos):
        module.uninstall(verify=False)


def _arm(injector, acted):
    injector.fail_at("ckpt.write", 2)
    injector.fail_at("serve.pool", 1, times=2)
    injector.act_at("serve.step", 3, lambda: acted.append(3), times=2)
    injector.delay_at("serve.step", 2, seconds=0.5)
    injector.delay_at("fleet.status", 9, seconds=1.0)   # never reached


SITES = ["serve.step", "serve.pool", "ckpt.write", "serve.pool",
         "serve.step", "ckpt.write", "serve.step", "serve.pool",
         "serve.step", "fleet.status"]


def _run_sites(module, monkeypatch):
    slept = []
    monkeypatch.setattr(module, "_sleep", slept.append)
    acted = []
    injector = module.install(strict=False)
    _arm(injector, acted)
    raised = []
    for i, site in enumerate(SITES):
        try:
            module.fault_point(site, index=i)
        except OSError as exc:
            raised.append((i, type(exc).__name__, str(exc)))
    return injector, slept, acted, raised


def test_fault_injector_records_match_jax(monkeypatch):
    from flashy_tpu.resilience import chaos as jax_chaos
    from flashy_tpu_torch.resilience import chaos
    port = _run_sites(chaos, monkeypatch)
    ref = _run_sites(jax_chaos, monkeypatch)
    (injector, slept, acted, raised), (jax_injector, *jax_rest) = port, ref
    assert injector.counts == jax_injector.counts
    assert injector.fired == jax_injector.fired
    assert (slept, acted, raised) == tuple(jax_rest)
    assert injector.unfired_rules() == jax_injector.unfired_rules()
    assert injector.hits() == jax_injector.hits() == 6
    assert injector.hits("serve.pool", "fail") == 2
    assert slept == [0.5] and acted == [3, 3]
    assert [r[0] for r in raised] == [1, 3, 5]
    assert chaos.get_injector() is injector
    chaos.uninstall()   # not strict: WARNs about the unfired rule
    assert chaos.get_injector() is None
    chaos.fault_point("serve.step")   # no injector: a no-op


def test_strict_uninstall_raises_on_a_dead_rule():
    from flashy_tpu_torch.resilience import (FaultInjector,
                                             UnfiredFaultRules, chaos)
    injector = chaos.install(strict=True)
    injector.fail_at("serve.pool", 5)
    chaos.fault_point("serve.pool")
    with pytest.raises(UnfiredFaultRules, match="serve.pool"):
        chaos.uninstall()
    # strict=True holds for a pre-built lax injector too
    lax = FaultInjector()
    lax.delay_at("serve.stpe", 1, seconds=0.0)   # a typo never fires
    assert chaos.install(lax, strict=True).strict
    with pytest.raises(UnfiredFaultRules):
        chaos.uninstall()
    with pytest.raises(ValueError, match=">= 0"):
        lax.delay_at("serve.step", 1, seconds=-1.0)
    # the two helpers the resilience half brought (driven in
    # tests/test_torch_resilience.py): a preemption that fires with no
    # guard enabled raises as the JAX package's does, and a directory
    # without a slot pointer has no active slot to corrupt
    chaos.install(lax)
    lax.preempt_at("serve.step", 1)
    with pytest.raises(RuntimeError, match="no PreemptionGuard"):
        chaos.fault_point("serve.step")
    chaos.uninstall(verify=False)
    with pytest.raises(FileNotFoundError, match="no committed slot"):
        chaos.corrupt_active_slot("somewhere")


def test_injected_pool_failure_sheds_one_admission_token_exact():
    from flashy_tpu_torch.resilience import chaos
    from flashy_tpu_torch.serve import (POOL_FAULT_SITE,
                                        ContinuousBatchingScheduler,
                                        DecodeEngine)
    jax_model, params, model = tiny_pair(seed=13)
    rng = np.random.default_rng(14)
    prompts = rng.integers(1, TINY["vocab_size"], (4, 10)).astype(np.int32)
    max_new = 6
    engine = DecodeEngine(model, slots=2, max_seq_len=64, block_size=8,
                          cache_layout="paged", device="cpu")
    engine.warmup()
    scheduler = ContinuousBatchingScheduler(engine)
    injector = chaos.install(strict=True)
    injector.fail_at(POOL_FAULT_SITE, 2)       # the second admission
    handles = [scheduler.submit(p, max_new) for p in prompts]
    scheduler.step()
    # the first request admitted, the second shed back to the queue head
    assert engine.live_count == 1 and scheduler.queue_depth == 3
    assert scheduler.admitted_order == [handles[0].uid]
    scheduler.run()
    chaos.uninstall()                             # the rule fired
    assert injector.hits(POOL_FAULT_SITE, "fail") == 1
    assert injector.counts[POOL_FAULT_SITE] == 5  # four admissions + retry
    assert scheduler.admitted_order == [h.uid for h in handles]
    want = jax_generate(jax_model, params, prompts, max_new_tokens=max_new)
    for handle, row in zip(handles, want):
        assert handle.done
        np.testing.assert_array_equal(handle.output, row)
    engine.pool.check()


def test_status_write_failure_never_tears_serve_json(tmp_path):
    from flashy_tpu_torch.observability import SLOEngine
    from flashy_tpu_torch.resilience import InjectedFault, chaos
    from flashy_tpu_torch.serve import ServeMetrics
    metrics = ServeMetrics(slo=SLOEngine())
    metrics.on_submit()
    target = tmp_path / "serve.json"
    # a failure on the very first write leaves none
    injector = chaos.install(strict=True)
    injector.fail_at("fleet.status", 1)
    with pytest.raises(InjectedFault):
        metrics.write_status(tmp_path)
    assert not target.exists()
    chaos.uninstall()
    first = metrics.write_status(tmp_path)
    assert first == target
    old = json.loads(target.read_text())
    assert old["requests"] == 1 and "slo" in old
    # a failure between the temporary write and the rename keeps the old
    # file whole; the next write heals it
    metrics.on_submit(tenant="b")
    injector = chaos.install(strict=True)
    injector.fail_at("fleet.status", 1)
    with pytest.raises(InjectedFault):
        metrics.write_status(tmp_path)
    assert json.loads(target.read_text()) == old
    metrics.write_status(tmp_path, extra={"note": "healed"})
    chaos.uninstall()
    new = json.loads(target.read_text())
    assert new["requests"] == 2 and new["note"] == "healed"
    assert new["tenants"]["b"]["requests"] == 1
    assert injector.counts["fleet.status"] == 2
