# The observability package of the PyTorch port (flashy_tpu_torch/
# observability/) on the CPU: the Tracer and JsonlJournal produce the
# JAX package's Chrome events and journal lines for the same calls (ts,
# pid, tid and wall times normalised); the event cap counts drops; the
# journal rotates; the StepTimer splits a slow loader's steps through the
# port's LogProgressBar; the RecompileWatchdog warns past warm-up and
# counts the CompileCache's builds after seal() as the cache does;
# heartbeats and the straggler report render the reference's text; the
# port's solver runs end to end under enable_telemetry and
# enable_profiling.
import json
import logging
import time

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _no_global_state():
    yield
    from flashy_tpu_torch import observability
    observability.disable_telemetry()


def _tracer_script(tracer):
    """The same calls on either package's Tracer: spans (context and
    decorator), a complete span at injected times, instants, counters,
    async spans and journal records."""
    with tracer.span("outer", category="host", k=1):
        with tracer.span("inner"):
            pass

    @tracer.wrap(name="wrapped")
    def f(x):
        return x + 1

    assert f(1) == 2
    start = tracer._t0 + 0.25
    tracer.complete("step/host", start, 0.125, category="step", stage="a")
    tracer.instant("test/mark", category="serve", slot=3)
    tracer.counter("serve/queue_depth", depth=4)
    tracer.async_begin("serve/request", 10, prompt_tokens=5)
    tracer.async_instant("serve/request", 10, tokens=1)
    tracer.async_end("serve/request", 10, reason="eos")
    tracer.record({"type": "step", "value": 1.5})
    tracer.record({"type": "serve_summary", "tokens": np.float32(2.0)})


def _normalised(events):
    out = []
    for event in events:
        event = {k: v for k, v in event.items()
                 if k not in ("ts", "pid", "tid")}
        if event.get("name") in ("outer", "inner", "wrapped"):
            event.pop("dur")   # measured, not injected
        out.append(event)
    return out


def _journal(path):
    return [{k: v for k, v in json.loads(line).items() if k != "time"}
            for line in path.read_text().splitlines()]


def test_tracer_and_journal_match_jax(tmp_path):
    from flashy_tpu.observability import Tracer as JaxTracer
    from flashy_tpu_torch.observability import Tracer
    traces = {}
    for side, cls in (("jax", JaxTracer), ("port", Tracer)):
        tracer = cls(trace_path=tmp_path / side / "trace.json",
                     jsonl_path=tmp_path / side / "telemetry.jsonl", rank=2)
        _tracer_script(tracer)
        tracer.close()
        traces[side] = json.loads((tmp_path / side / "trace.json").read_text())
    port, ref = traces["port"], traces["jax"]
    assert _normalised(port["traceEvents"]) == _normalised(ref["traceEvents"])
    assert port["displayTimeUnit"] == ref["displayTimeUnit"]
    # the injected span keeps its duration and its offset from the start
    step = next(e for e in port["traceEvents"] if e["name"] == "step/host")
    assert step["dur"] == 0.125e6 and step["ts"] == pytest.approx(0.25e6)
    assert all(e["pid"] == 2 for e in port["traceEvents"])
    assert _journal(tmp_path / "port" / "telemetry.jsonl") == _journal(
        tmp_path / "jax" / "telemetry.jsonl")


def test_event_cap_counts_drops(tmp_path):
    from flashy_tpu_torch.observability import Tracer
    tracer = Tracer(trace_path=tmp_path / "trace.json", max_events=5)
    for i in range(10):
        tracer.instant(f"test/e{i}")
    assert len(tracer.events) == 5 and tracer.dropped == 6   # + the meta
    tracer.close()
    payload = json.loads((tmp_path / "trace.json").read_text())
    assert payload["metadata"] == {"dropped_events": 6}
    with pytest.raises(ValueError, match="trace path"):
        Tracer().export_chrome_trace()


def test_journal_rotation_matches_jax(tmp_path):
    from flashy_tpu.observability import JsonlJournal as JaxJournal
    from flashy_tpu_torch.observability import JsonlJournal
    lines = [json.dumps({"i": i, "pad": "x" * 100}) for i in range(40)]
    rotations = {}
    for side, cls in (("jax", JaxJournal), ("port", JsonlJournal)):
        journal = cls(tmp_path / side / "j.jsonl", max_bytes=1024, keep=2)
        for line in lines:
            journal.write_line(line)
        journal.close()
        rotations[side] = journal.rotations
    assert rotations["port"] == rotations["jax"] == 5
    for name in ("j.jsonl", "j.jsonl.1", "j.jsonl.2"):
        assert _journal(tmp_path / "port" / name) == _journal(
            tmp_path / "jax" / name)
    assert not (tmp_path / "port" / "j.jsonl.3").exists()
    first = json.loads((tmp_path / "port" / "j.jsonl").read_text()
                       .splitlines()[0])
    assert first["type"] == "journal_rotated" and first["rotation"] == 5
    with pytest.raises(ValueError, match="max_bytes"):
        JsonlJournal(tmp_path / "x", max_bytes=1023)
    with pytest.raises(ValueError, match="keep"):
        JsonlJournal(tmp_path / "x", keep=0)


def test_step_timer_through_log_progress_bar_on_a_slow_loader(tmp_path,
                                                               monkeypatch):
    from flashy_tpu_torch.logging import LogProgressBar
    from flashy_tpu_torch.observability import StepTimer, Tracer
    tracer = Tracer(jsonl_path=tmp_path / "telemetry.jsonl")
    steps = []
    timer = StepTimer(stage="train", tracer=tracer, on_step=steps.append)

    def loader():
        for i in range(4):
            time.sleep(0.03)      # the batch is late: data wait
            yield torch.full((2,), float(i))

    def synchronize(device=None):
        raise AssertionError("CPU tensors have nothing to wait for")

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    bar = LogProgressBar(logging.getLogger("test"), loader(), total=4,
                         updates=0, step_timer=timer)
    begin = time.perf_counter()
    for batch in bar:
        time.sleep(0.01)          # host work
        bar.observe(batch * 2)    # CPU tensors: nothing to wait for
    wall = time.perf_counter() - begin
    assert len(timer.records) == 4 and steps == timer.records
    for record in timer.records:
        assert record["data_wait"] >= 0.025
        assert record["host"] >= 0.009
        assert record["total"] == pytest.approx(
            record["data_wait"] + record["host"] + record["device"])
    # the steps tile the loop's wall clock (the exhausted next() adds a
    # sliver, and the timer's own IO is carried, not lost)
    assert wall - 0.05 < sum(r["total"] for r in timer.records) <= wall
    summary = timer.summary()
    assert summary["steps"] == 4 and summary["data_wait_frac"] > 0.5
    assert summary["data_wait_frac"] + summary["host_frac"] \
        + summary["device_frac"] == pytest.approx(1.0)
    assert set(summary) >= {"step_p50", "step_p95", "step_p99", "step_max"}
    journal = [json.loads(line) for line in
               (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    assert [r["step"] for r in journal] == [0, 1, 2, 3]
    assert {e["name"] for e in tracer.events if e["ph"] == "X"} == {
        "step/data_wait", "step/host", "step/device"}
    assert StepTimer().summary() == {}
    with pytest.raises(ValueError, match="percentiles"):
        StepTimer(percentiles=())


def test_recompile_watchdog_and_the_compile_cache_count_the_same(tmp_path):
    from flashy_tpu_torch.observability import RecompileWatchdog, Tracer
    from flashy_tpu_torch.serve.compile_cache import CompileCache
    records = []
    log = logging.getLogger("test.watchdog")
    log.propagate = False
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    tracer = Tracer(jsonl_path=tmp_path / "telemetry.jsonl")
    watchdog = RecompileWatchdog(warmup=1, tracer=tracer, log=log)
    assert watchdog.note_compile("step", "float32[4]") == 0
    assert watchdog.note_compile("step", "float32[8]") == 1
    assert watchdog.note_compile("other", "x", warmup=2) == 0
    watchdog.note_call("step")
    assert watchdog.summary() == {"step": 1}
    assert watchdog.counts["step"] == {"calls": 1, "compiles": 2,
                                       "recompiles": 1}
    assert len(records) == 1 and "float32[8]" in records[0].getMessage()
    assert any(e["name"] == "recompile/step" for e in tracer.events)
    with pytest.raises(TypeError, match="note_compile"):
        watchdog.watch(lambda x: x)

    class Cached:                 # a callable with a compile cache
        size = 0

        def _cache_size(self):
            return self.size

        def __call__(self, x):
            self.size = max(self.size, x)
            return x

    watched = watchdog.watch(Cached(), name="cached")
    for x in (1, 1, 2):
        watched(x)
    assert watchdog.counts["cached"] == {"calls": 3, "compiles": 2,
                                         "recompiles": 1}
    # the serving cache reports every build; after seal() the budget is 0
    cache = CompileCache(watchdog=RecompileWatchdog(), device="cpu")
    build = lambda: (lambda x: x + 1)  # noqa: E731
    for key in (("decode", 2), ("prefill", 4)):
        cache.warm(key, build, torch.ones(2))
    cache.seal()
    cache.get(("decode", 2), build)          # a hit builds nothing
    assert cache.recompiles() == 0 == sum(cache.watchdog.summary().values())
    cache.get(("prefill", 8), build)
    cache.get(("verify", 2, 4), build)
    assert cache.recompiles() == 2 == sum(cache.watchdog.summary().values())
    assert cache.stats()["recompiles"] == 2
    # a private watchdog when none is given
    assert CompileCache(device="cpu").watchdog is not None


def _fabricated_beats(folder, now):
    folder.mkdir(parents=True)
    beats = [
        {"rank": 0, "world_size": 4, "time": now - 2.0, "step": 120,
         "devices": [{"id": 0, "bytes_in_use": 10, "bytes_limit": 100}]},
        {"rank": 1, "world_size": 4, "time": now - 30.5, "step": 100,
         "devices": [{"id": 0, "bytes_in_use": 95, "bytes_limit": 100}]},
        {"rank": 3, "world_size": 4, "time": now - 1.0, "step": 118},
    ]
    for beat in beats:
        (folder / f"rank{beat['rank']}.json").write_text(json.dumps(beat))
    (folder / "rank9.json").write_text("{torn")


def test_heartbeats_and_straggler_report_match_jax(tmp_path):
    from flashy_tpu.observability import format_straggler_report as jax_fmt
    from flashy_tpu.observability import straggler_report as jax_report
    from flashy_tpu_torch.observability import (Heartbeat,
                                                device_memory_stats,
                                                format_straggler_report,
                                                read_heartbeats,
                                                straggler_report)
    now = 1_000_000.0
    _fabricated_beats(tmp_path / "beats", now)
    report = straggler_report(tmp_path / "beats", now=now)
    assert report == jax_report(tmp_path / "beats", now=now)
    text = format_straggler_report(report)
    assert text == jax_fmt(report)
    assert "missing 2" in text and "HBM-pressured stragglers 1" in text
    assert format_straggler_report({"ranks": 0}) == jax_fmt({"ranks": 0})
    assert straggler_report(tmp_path / "none") == {"ranks": 0}
    # a live heartbeat: throttled, forced at stage edges, atomic
    beat = Heartbeat(tmp_path / "live", rank=1, world_size=2, interval=60.0)
    assert beat.beat(step=1, stage="train")
    assert not beat.beat(step=2)                 # throttled
    assert beat.beat(step=3, force=True, epoch=1)
    (payload,) = read_heartbeats(tmp_path / "live")
    assert payload["step"] == 3 and payload["rank"] == 1
    # no card: no device entries, and the call does not raise
    if not torch.cuda.is_available():
        assert device_memory_stats() == []
        assert payload["devices"] == []


def _solver_config():
    import yaml
    from pathlib import Path
    from flashy_tpu_torch.xp import Config
    root = Path(__file__).resolve().parent.parent
    cfg = Config(yaml.safe_load((root / "flashy_tpu_torch" / "examples"
                                 / "lm" / "config" / "config.yaml")
                                .read_text()))
    cfg.model.update(vocab_size=128, dim=32, num_layers=2, num_heads=2)
    cfg.update(seq_len=32, batch_size=2, steps_per_epoch=4, epochs=2,
               valid_steps=2)
    return cfg


def test_solver_under_telemetry_and_profiling_on_cpu(capsys):
    from flashy_tpu_torch import info, observability
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.xp import temporary_xp
    cfg = _solver_config()
    with temporary_xp(cfg) as xp:
        solver = LMSolver(cfg, device="cpu")
        telemetry = solver.enable_telemetry(roofline=True)
        telemetry.roofline.peak_flops = 1e12   # the CPU has no known peak
        solver.enable_profiling(stages=["train"])
        solver.run()
        observability.disable_telemetry()
        folder = xp.folder
        records = [json.loads(line) for line in
                   (folder / "telemetry.jsonl").read_text().splitlines()]
        steps = [r for r in records if r["type"] == "step"]
        assert [r["step"] for r in steps if r["stage"] == "train"] == [
            0, 1, 2, 3] * 2
        assert [r["step"] for r in steps if r["stage"] == "valid"] == [
            0, 1] * 2
        for record in steps:
            assert record["total"] == pytest.approx(
                record["data_wait"] + record["host"] + record["device"])
        assert [r["stage"] for r in records if r["type"] == "stage"] == [
            "train", "valid"] * 2
        roofline = next(r for r in records if r["type"] == "roofline")
        step_cost = roofline["executables"]["lm/train_step"]
        assert step_cost["source"] == "flop_counter"
        assert step_cost["flops_per_call"] > 0 and step_cost["calls"] == 8
        train_steps = [r for r in steps if r["stage"] == "train"]
        for index, epoch in enumerate(solver.history):
            train = epoch["train"]
            assert train["steps"] == 4 and "recompiles" not in train
            # the stage's FLOPs over its steps' wall clock
            wall = sum(r["total"] for r in train_steps[4 * index:
                                                       4 * index + 4])
            assert train["roofline_tflops_per_sec"] * 1e12 == pytest.approx(
                step_cost["flops_per_call"] * 4 / wall, rel=1e-6)
            assert train["roofline_mfu"] == pytest.approx(
                train["roofline_tflops_per_sec"] * 1e12 / 1e12)
            assert {"step_p50", "data_wait_frac", "host_frac",
                    "device_frac"} <= set(train)
            assert epoch["valid"]["steps"] == 2
        assert telemetry.watchdog.summary() == {}
        trace = json.loads((folder / "trace.json").read_text())
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"stage/train", "stage/valid", "step/host"} <= names
        assert sorted(p.name for p in (folder / "profiles").iterdir()) == [
            "train-epoch1.json", "train-epoch2.json"]
        profile = json.loads((folder / "profiles"
                              / "train-epoch1.json").read_text())
        assert profile["traceEvents"]
        beats = json.loads((folder / "heartbeats" / "rank0.json").read_text())
        assert beats["stage"] == "valid" and beats["epoch"] == 2
        # info renders the heartbeats beside the history
        capsys.readouterr()
        assert info.main([str(folder.parent.parent)]) == 0
        assert "heartbeats: 1/1 ranks | step skew 0" in \
            capsys.readouterr().out


def test_solver_refuses_the_resilience_half():
    # The resilience half is ported now (tests/test_torch_resilience.py
    # drives it): the solver's two switches return a working guard and a
    # running watchdog; declared state sharding is ported too (ROADMAP
    # queue A item 8a): an unregistered name is a KeyError, a single
    # sharding covers every leaf of the attribute.
    from flashy_tpu_torch import resilience
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.xp import temporary_xp
    cfg = _solver_config()
    with temporary_xp(cfg):
        solver = LMSolver(cfg, device="cpu")
        watchdog = None
        try:
            guard = solver.enable_preemption_guard(install=False)
            assert guard is resilience.get_preemption_guard()
            assert not solver.check_preemption()
            watchdog = solver.enable_hang_watchdog(warn_after=60.0,
                                                   interval=0.05)
            assert watchdog.check()["action"] is None
        finally:
            if watchdog is not None:
                watchdog.stop()
            resilience.disable_preemption_guard()
        from flashy_tpu_torch.parallel import NamedSharding, P
        with pytest.raises(KeyError, match="not a registered"):
            solver.set_state_sharding("weights", None)
        solver.set_state_sharding("state", NamedSharding(solver.mesh, P()))
        assert solver._state_shardings["state"] == {
            "step": NamedSharding(solver.mesh, P())}
        assert solver._flat_layout() == {}  # replicated: nothing sharded


def test_info_heartbeats_and_slo_views_match_jax(tmp_path, capsys,
                                                 monkeypatch):
    # an XP with heartbeats and a serve.json carrying an slo block: the
    # port's `info` and `info --slo` print what the JAX package's print
    import types
    from flashy_tpu import info as jax_info
    from flashy_tpu.observability import heartbeat as jax_heartbeat
    from flashy_tpu_torch import info
    from flashy_tpu_torch.observability import SLOEngine, heartbeat
    from flashy_tpu_torch.serve import ServeMetrics
    now = 1_000_000.0
    clock = types.SimpleNamespace(time=lambda: now)
    for module in (heartbeat, jax_heartbeat):
        monkeypatch.setattr(module, "time", clock)
    folder = tmp_path / "xps" / "abc123"
    _fabricated_beats(folder / "heartbeats", now)
    slo = SLOEngine()
    metrics = ServeMetrics(slo=slo)
    for i in range(20):
        metrics.on_submit()
        metrics.on_token(0.9 if i % 2 else 0.01)   # itl burns
        slo.observe("ttft", 0.1, now=0.0)
    metrics.write_status(folder)
    status = json.loads((folder / "serve.json").read_text())
    status["slo"] = slo.evaluate(now=0.0)       # fixed windows
    (folder / "serve.json").write_text(json.dumps(status))
    outputs = {}
    for side, main in (("port", info.main), ("jax", jax_info.main)):
        for argv in ([str(tmp_path)], [str(tmp_path), "--slo"]):
            assert main(argv) == 0
            outputs[side, len(argv)] = capsys.readouterr().out
    assert outputs["port", 1] == outputs["jax", 1]
    assert outputs["port", 2] == outputs["jax", 2]
    assert "heartbeats: 3/4 ranks | missing 2" in outputs["port", 1]
    assert "SLO-ALERT[itl]" in outputs["port", 1]
    assert "itl          p95 <= 500ms" in outputs["port", 2]
