# Request tracing, the SLO engine, the serve.json status file and the
# roofline profiler of the PyTorch port (flashy_tpu_torch/serve/tracing.py,
# serve/metrics.py, observability/slo.py, observability/roofline.py) on the
# CPU: the JAX scheduler and the port's on the same tiny f32 weights give
# the same sampled uids and the same requests.jsonl records (times
# stripped) on the paged and the dense layout; SLOEngine reports,
# format_slo_report text and the serve.json counts equal the JAX
# package's; a latency budget alerts under an injected delay and stays
# silent without one, on every run; a crash mid-step closes every span;
# the roofline counts a matmul's 2*M*N*K FLOPs.
import json
import time

import numpy as np
import pytest
import torch

from ._torch_port import TINY, tiny_pair

ENGINE = dict(slots=2, max_seq_len=64)
PAGED = dict(cache_layout="paged", block_size=8, chunk=8, tail_bucket=4)


@pytest.fixture(autouse=True)
def _no_global_state():
    """Keep the chaos hooks of both packages from leaking."""
    yield
    from flashy_tpu.resilience import chaos as jax_chaos
    from flashy_tpu_torch.resilience import chaos
    for module in (chaos, jax_chaos):
        module.uninstall(verify=False)


def _workload():
    """Five requests over several prompt buckets (two share a prefix)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, TINY["vocab_size"], 9)
    prompts = [rng.integers(1, TINY["vocab_size"], 5),
               np.concatenate([prefix, rng.integers(1, 256, 4)]),
               rng.integers(1, TINY["vocab_size"], 11),
               np.concatenate([prefix, rng.integers(1, 256, 2)]),
               rng.integers(1, TINY["vocab_size"], 3)]
    return [(p.astype(np.int32), n) for p, n in zip(prompts, (4, 6, 3, 5, 2))]


def _drive(scheduler, workload):
    """Submit two at a time, one with a lapsed TTL, one past the queue
    cap (rejected), and run to the end; returns the handles."""
    handles = []
    pending = list(workload)
    expired = scheduler.submit(pending[0][0], 2, ttl=1e-9)
    time.sleep(0.002)
    handles.append(expired)
    while pending or not scheduler.idle:
        for _ in range(min(2, len(pending))):
            prompt, max_new = pending.pop(0)
            handles.append(scheduler.submit(prompt, max_new))
        if len(handles) == 3:
            with pytest.raises(Exception, match="capacity"):
                scheduler.submit(workload[0][0], 2)
        scheduler.step()
    return handles


def _records(path):
    """requests.jsonl lines with every time stripped."""
    out = []
    for line in path.read_text().splitlines():
        event = json.loads(line)
        out.append({k: v for k, v in event.items()
                    if k != "time" and not k.endswith("_s")})
    return out


def _serve_both(tmp_path, layout_kw):
    from flashy_tpu.observability import SLOEngine as JaxSLO
    from flashy_tpu.observability import Tracer as JaxTracer
    from flashy_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
    from flashy_tpu.serve import DecodeEngine as JaxEngine
    from flashy_tpu.serve.metrics import ServeMetrics as JaxMetrics
    from flashy_tpu.serve.tracing import RequestTracer as JaxRequestTracer
    from flashy_tpu_torch.observability import SLOEngine, Tracer
    from flashy_tpu_torch.serve import (ContinuousBatchingScheduler,
                                        DecodeEngine, RequestTracer,
                                        ServeMetrics)
    jax_model, params, model = tiny_pair(seed=11)
    workload = _workload()
    lengths = [len(p) for p, _ in workload]
    out = {}
    for side, engine_cls, sched_cls, tracer_cls, tracing_cls, metrics_cls, \
            slo_cls in (
            ("jax", JaxEngine, JaxScheduler, JaxTracer, JaxRequestTracer,
             JaxMetrics, JaxSLO),
            ("port", DecodeEngine, ContinuousBatchingScheduler, Tracer,
             RequestTracer, ServeMetrics, SLOEngine)):
        folder = tmp_path / side
        tracer = tracer_cls(trace_path=folder / "trace.json")
        if side == "jax":
            engine = engine_cls(jax_model, params, kernel="gather",
                                tracer=tracer, **ENGINE, **layout_kw)
        else:
            engine = engine_cls(model, device="cpu", tracer=tracer,
                                **ENGINE, **layout_kw)
        engine.warmup(prompt_lengths=lengths)
        tracing = tracing_cls(tracer=tracer,
                              journal_path=folder / "requests.jsonl",
                              sample_rate=0.5, seed=2)
        metrics = metrics_cls(tracer=tracer, slo=slo_cls(tracer=tracer))
        scheduler = sched_cls(engine, max_queue=3, metrics=metrics,
                              tracing=tracing)
        handles = _drive(scheduler, workload)
        metrics.write_status(folder)
        tracing.close()
        tracer.close()
        out[side] = (handles, tracing, metrics, folder)
    return out


@pytest.mark.parametrize("layout_kw", [PAGED, {}], ids=["paged", "dense"])
def test_request_journal_matches_jax(tmp_path, layout_kw):
    runs = _serve_both(tmp_path, layout_kw)
    (jax_handles, jax_tracing, jax_metrics, jax_dir) = runs["jax"]
    (handles, tracing, metrics, folder) = runs["port"]
    # the same streams, fates and sampled uid set
    assert [h.output.tolist() for h in handles] == [
        h.output.tolist() for h in jax_handles]
    assert [h.finish_reason for h in handles] == [
        h.finish_reason for h in jax_handles]
    assert "expired" in [h.finish_reason for h in handles]
    sampled = {h.uid for h in handles if tracing.sampled(h.uid)}
    assert sampled == {h.uid for h in jax_handles
                       if jax_tracing.sampled(h.uid)}
    assert 0 < len(sampled) < len(handles)
    assert (tracing.sampled_count, tracing.finished_count,
            tracing.rejected_count) == (jax_tracing.sampled_count,
                                        jax_tracing.finished_count,
                                        jax_tracing.rejected_count)
    # the journal: the same records in the same order once times go
    records = _records(folder / "requests.jsonl")
    assert records == _records(jax_dir / "requests.jsonl")
    finished = [r for r in records if r["event"] == "finished"]
    assert {r["uid"] for r in finished} == sampled
    assert any(r["event"] == "rejected" for r in records)
    for record in finished:
        handle = next(h for h in handles if h.uid == record["uid"])
        assert record["tokens"] == len(handle.generated)
    # every sampled request's phases sit in the trace as balanced async
    # spans, the outer one opened and closed once
    events = json.loads((folder / "trace.json").read_text())["traceEvents"]
    pairs = {}
    for event in events:
        if event.get("ph") in ("b", "e"):
            key = (event["name"], event["id"], event["ph"])
            pairs[key] = pairs.get(key, 0) + 1
    for uid in sampled:
        assert pairs[("serve/request", f"0x{uid:x}", "b")] == 1
        assert pairs[("serve/request", f"0x{uid:x}", "e")] == 1
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert "serve/decode" in names
    assert ("serve/prefill_chunk" if layout_kw else "serve/prefill") in names


def test_serve_status_matches_jax(tmp_path):
    runs = _serve_both(tmp_path, {})
    port = json.loads((runs["port"][3] / "serve.json").read_text())
    ref = json.loads((runs["jax"][3] / "serve.json").read_text())
    # the port adds the engine's kernel to the setup facts and the window's
    # tokens/s to the summary; every other key is the reference's
    assert set(port) == set(ref) | {"kernel", "tokens_per_sec"}
    for key in ("requests", "completed", "rejected", "expired", "preempted",
                "tokens", "cache_layout", "kv_dtype",
                "state_bytes_per_slot", "tenants"):
        assert port[key] == ref[key], key
    assert {k: v for k, v in port.items() if k.startswith("finish_")} == {
        k: v for k, v in ref.items() if k.startswith("finish_")}
    assert set(port["slo"]) == set(ref["slo"])
    assert set(port["slo"]["budgets"]) == set(ref["slo"]["budgets"])
    for name, budget in port["slo"]["budgets"].items():
        assert budget["samples"] == ref["slo"]["budgets"][name]["samples"]
    assert not port["slo"]["alerting"]


def _feed(engine, samples):
    for name, value, now in samples:
        engine.observe(name, value, now=now)


def test_slo_engine_and_report_match_jax():
    from flashy_tpu.observability import SLOBudget as JaxBudget
    from flashy_tpu.observability import SLOEngine as JaxSLO
    from flashy_tpu.observability import format_slo_report as jax_format
    from flashy_tpu_torch.observability import (SLOBudget, SLOEngine,
                                                format_slo_report)
    rng = np.random.default_rng(0)
    samples = []
    for i in range(200):
        now = i * 0.7
        samples.append(("ttft", float(rng.exponential(0.8)), now))
        samples.append(("itl", 0.02 if i < 150 else 0.4, now))
        samples.append(("acceptance", float(rng.uniform(0, 0.3)), now))
        samples.append(("unknown", 1.0, now))
    specs = [("ttft", 1.0, 90.0, "latency"), ("itl", 0.1, 95.0, "latency"),
             ("acceptance", 0.05, 90.0, "floor")]
    port = SLOEngine([SLOBudget(*spec) for spec in specs], fast_window=20.0,
                     slow_window=100.0, min_samples=8)
    ref = JaxSLO([JaxBudget(*spec) for spec in specs], fast_window=20.0,
                 slow_window=100.0, min_samples=8)
    _feed(port, samples)
    _feed(ref, samples)
    for now in (50.0, 120.0, 139.3, 500.0):
        got, want = port.evaluate(now=now), ref.evaluate(now=now)
        assert got == want
        assert format_slo_report(got) == jax_format(want)
        assert port.alerts(now=now) == ref.alerts(now=now)
    # the itl burst of the last 50 samples alerts in both windows; ttft
    # (exponential, mean 0.8 s, against p90 <= 1 s) burns too
    assert port.alerts(now=139.3) == ["ttft", "itl"]
    assert port.alerts(now=500.0) == []   # every sample out of the windows
    # the defaults and the empty report agree too
    assert format_slo_report(SLOEngine().evaluate(now=0.0)) == jax_format(
        JaxSLO().evaluate(now=0.0))
    assert format_slo_report({}) == jax_format({})


def _serve_with_slo(delay):
    """4 requests x 10 new through a 2-slot engine under one ITL budget
    of 0.25 s; with `delay`, steps 3..10 stall 0.3 s each at the
    scheduler's `serve.step` fault point (a real sleep: it must land in
    the measured gap)."""
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.observability import SLOBudget, SLOEngine
    from flashy_tpu_torch.resilience import chaos
    from flashy_tpu_torch.serve import (ContinuousBatchingScheduler,
                                        DecodeEngine, ServeMetrics)
    cfg = TransformerConfig(vocab_size=32, dim=16, num_layers=2, num_heads=2,
                            max_seq_len=32, dtype=torch.float32,
                            attention="dense")
    engine = DecodeEngine(TransformerLM(cfg, device="cpu"), slots=2,
                          device="cpu")
    engine.warmup(prompt_lengths=[4])
    slo = SLOEngine(budgets=(SLOBudget("itl", threshold=0.25),),
                    min_samples=8)
    metrics = ServeMetrics(slo=slo)
    scheduler = ContinuousBatchingScheduler(engine, metrics=metrics)
    injector = None
    if delay:
        injector = chaos.install(strict=True)
        injector.delay_at("serve.step", 3, seconds=0.3, times=8)
    for _ in range(4):
        scheduler.submit(np.arange(4, dtype=np.int32), max_new_tokens=10)
    scheduler.run()
    if injector is not None:
        chaos.uninstall()
        assert injector.hits("serve.step", "delay") == 8
    return slo, metrics


@pytest.fixture
def one_thread():
    """One intra-op thread: on a loaded host a pool of them waits on every
    op of the tiny model, which stretches its steps by an order of
    magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_slo_alert_fires_under_injected_latency_and_not_clean(one_thread):
    slo, _ = _serve_with_slo(delay=True)
    report = slo.evaluate()
    entry = report["budgets"]["itl"]
    assert slo.alerts() == ["itl"] and report["alerting"]
    assert entry["burn_fast"] > slo.burn_threshold
    assert entry["burn_slow"] > slo.burn_threshold
    assert not entry["compliant"]
    # the same budget without the delay stays silent: 0.25 s is far above
    # any tiny-model step on a loaded CPU
    slo, metrics = _serve_with_slo(delay=False)
    report = slo.evaluate()
    assert slo.alerts() == [] and not report["alerting"]
    assert report["budgets"]["itl"]["samples"] >= slo.min_samples
    assert set(metrics.slo.evaluate()["budgets"]) == {"itl"}


def test_crash_mid_step_closes_every_inflight_span(tmp_path):
    from flashy_tpu_torch.observability import Tracer
    from flashy_tpu_torch.resilience import chaos
    from flashy_tpu_torch.serve import (ContinuousBatchingScheduler,
                                        DecodeEngine, RequestTracer)
    _, _, model = tiny_pair(seed=3)
    engine = DecodeEngine(model, device="cpu", **ENGINE)
    engine.warmup(prompt_lengths=[4])
    tracer = Tracer(trace_path=tmp_path / "trace.json")
    tracing = RequestTracer(tracer=tracer,
                            journal_path=tmp_path / "requests.jsonl")
    scheduler = ContinuousBatchingScheduler(engine, tracing=tracing)
    prompt = np.arange(1, 5, dtype=np.int32)
    handles = [scheduler.submit(prompt, max_new_tokens=8) for _ in range(3)]
    scheduler.step()   # two admitted and decoding, one queued

    def crash():
        raise RuntimeError("injected mid-step crash")

    injector = chaos.install(strict=True)
    injector.act_at("serve.step", call=1, action=crash)
    with pytest.raises(RuntimeError, match="injected"):
        scheduler.step()
    chaos.uninstall()
    tracer.close()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    begins = sum(1 for e in events if e.get("ph") == "b")
    ends = sum(1 for e in events if e.get("ph") == "e")
    assert begins == ends and begins > 0
    finished = {e["uid"]: e for e in map(json.loads, (
        tmp_path / "requests.jsonl").read_text().splitlines())
        if e["event"] == "finished"}
    for handle in handles:
        assert finished[handle.uid]["reason"] == "crashed"
    assert "decode_s" in finished[handles[0].uid]
    assert "prefill_s" not in finished[handles[2].uid]   # still queued


def test_slow_unsampled_request_is_captured_after_the_fact(tmp_path):
    from flashy_tpu_torch.observability import Tracer
    from flashy_tpu_torch.serve.tracing import RequestTracer

    class Req:
        def __init__(self, uid):
            self.uid, self.prompt, self.max_new_tokens = uid, np.ones(3), 2
            self.submitted_at = time.perf_counter() - 1.0
            self.generated = [1, 2]

    tracer = Tracer()
    tracing = RequestTracer(tracer=tracer, sample_rate=0.0, slow_latency=0.5,
                            journal_path=tmp_path / "requests.jsonl")
    req = Req(7)
    tracing.on_submit(req)
    tracing.on_admit(req, slot=0)
    tracing.on_first_token(req)
    tracing.on_finish(req, "length")
    assert tracing.slow_count == 1 and tracing.sampled_count == 0
    spans = [e["name"] for e in tracer.events if e["ph"] == "X"]
    assert spans == ["serve/request/queued", "serve/request/prefill",
                     "serve/request/decode"]
    line = json.loads((tmp_path / "requests.jsonl").read_text())
    assert line["slow"] and not line["sampled"] and line["tokens"] == 2


def test_roofline_matmul_flops_mfu_costs_and_disabled():
    from flashy_tpu_torch.observability import RooflineProfiler
    m, n, k = 32, 48, 64
    a, b = torch.randn(m, k), torch.randn(k, n)
    profiler = RooflineProfiler(peak_flops=1e12, peak_bytes_per_sec=1e11)
    out = profiler.register_fn("mm", torch.matmul, (a, b))
    torch.testing.assert_close(out, a @ b)
    assert profiler.profiles["mm"].flops == 2 * m * n * k
    # counted once: a second registration is the plain call
    profiler.register_fn("mm", torch.matmul, (b.T, a.T))
    assert profiler.profiles["mm"].flops == 2 * m * n * k
    profiler.observe("mm", 0.002)
    profiler.observe("mm", 0.004)
    entry = profiler.summarize("mm")
    assert entry["calls"] == 2 and entry["wall_ms_per_call"] == \
        pytest.approx(3.0)
    assert entry["mfu"] == pytest.approx(2 * m * n * k / 0.003 / 1e12)
    assert entry["verdict"] == "unknown"   # no bytes: no intensity
    profiler.register_costs("mm", bytes_accessed=4 * (m * k + k * n + m * n))
    entry = profiler.summarize("mm")
    assert entry["intensity"] == pytest.approx(
        2 * m * n * k / (4 * (m * k + k * n + m * n)))
    assert entry["verdict"] == "bandwidth-bound"   # below 10 flops/byte
    mark = profiler.mark()
    profiler.note_call("mm")
    stage = profiler.stage_summary(0.001, since=mark)
    assert stage["roofline_mfu"] == pytest.approx(2 * m * n * k / 1e-3
                                                  / 1e12)
    timed = profiler.timed("mm2", torch.matmul)
    timed(a, b)
    assert profiler.profiles["mm2"].calls == 1
    with pytest.raises(NotImplementedError, match="register_fn"):
        profiler.register_compiled("x", object())
    with pytest.raises(TypeError, match="tuple"):
        profiler.register_fn("bad", torch.matmul, a)
    # a disabled profiler runs the call and records nothing
    off = RooflineProfiler(enabled=False)
    torch.testing.assert_close(off.register_fn("mm", torch.matmul, (a, b)),
                               a @ b)
    off.observe("mm", 1.0)
    off.register_costs("mm", flops=1.0)
    off.note_call("mm")
    assert off.profiles == {} and off.stage_summary(1.0) == {}
    assert off.timed("mm", torch.matmul) is torch.matmul
    # the H100 is the only machine the port knows; no CUDA, no peaks
    from flashy_tpu_torch.observability import device_peaks
    assert device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert device_peaks("TPU v5 lite") == (None, None)
    if not torch.cuda.is_available():
        assert device_peaks() == (None, None)


def _metrics_script(metrics):
    metrics.static_info.update(cache_layout="paged", kv_dtype="model")
    metrics.on_submit(tenant="a")
    metrics.on_submit()
    metrics.on_reject(tenant="b")
    metrics.on_queue_wait(0.01)
    metrics.on_prefix(8, 12)
    metrics.on_gauges(queue_depth=1, live=1, capacity=2)
    metrics.on_pool(occupancy=0.25, in_use=2, capacity=8, cached=1,
                    bytes_per_token=64.0)
    metrics.on_first_token(0.02)
    for gap in (0.003, 0.004, 0.0):
        metrics.on_token(gap)
    metrics.on_spec_step(drafted=4, accepted=[2, 4], emitted=7)
    metrics.on_preempt(tenant="a")
    metrics.on_expired()
    metrics.on_done(0.05, "length", tenant="a", tokens=4)


def test_serve_metrics_fanout_matches_jax(tmp_path):
    # the counter tracks, the telemetry record and the log_to fan-out of
    # ServeMetrics on the same hook calls, against the JAX package's
    from flashy_tpu.observability import SLOEngine as JaxSLO
    from flashy_tpu.observability import Tracer as JaxTracer
    from flashy_tpu.serve.metrics import ServeMetrics as JaxMetrics
    from flashy_tpu_torch.observability import SLOEngine, Tracer
    from flashy_tpu_torch.serve import ServeMetrics

    class Logged:
        def log_metrics(self, stage, metrics, step=None, formatter=None):
            self.call = (stage, step, metrics, formatter(metrics))

    out = {}
    for side, tracer_cls, metrics_cls, slo_cls in (
            ("jax", JaxTracer, JaxMetrics, JaxSLO),
            ("port", Tracer, ServeMetrics, SLOEngine)):
        tracer = tracer_cls(jsonl_path=tmp_path / side / "telemetry.jsonl")
        slo = slo_cls()
        metrics = metrics_cls(tracer=tracer, slo=slo)
        _metrics_script(metrics)
        metrics.record()
        logged = Logged()
        metrics.log_to(logged, step=3, extra={"note": 1.0})
        counters = [(e["name"], e["args"]) for e in tracer.events
                    if e["ph"] == "C"]
        (record,) = [json.loads(line) for line in (
            tmp_path / side / "telemetry.jsonl").read_text().splitlines()]
        out[side] = (counters, record, logged.call, slo.evaluate(now=1e9))
    (counters, record, call, slo), (jax_counters, jax_record, jax_call,
                                     jax_slo) = out["port"], out["jax"]
    assert counters == jax_counters and len(counters) == 6

    def strip(d):   # the port's summary adds the window's tokens/s
        return {k: v for k, v in d.items()
                if k not in ("time", "tokens_per_sec")}

    assert strip(record) == strip(jax_record)
    assert record["type"] == "serve_summary" and "tokens_per_sec" in record
    assert call[:2] == jax_call[:2] == ("serve", 3)
    assert strip(call[2]) == strip(jax_call[2])
    assert {k: v for k, v in call[3].items() if k != "tokens_per_sec"} \
        == jax_call[3]
    assert slo == jax_slo
