# The port's fault tolerance (flashy_tpu_torch.resilience and its sites in
# the harness) held against the JAX package: backoff delays equal on the
# same seeded jitter, the retry rules (allow-list, deadline, warn on
# exhaustion, attempts journaled); manifests and sidecars giving the same
# entries (less `created`) and the same problems on the same files; the
# fault sites (`ckpt.write`, `history.write`, `logger.<name>`) absorbing a
# transient fault and a broken backend degrading to a warning; the
# preemption guard (simulated and real signals, both modes); the hang
# watchdog's verdicts equal to the JAX watchdog's on the same heartbeat
# files; `info --verify-checkpoint` printing what the JAX report prints;
# and the chaos drill of both packages passing with identical histories.
# A/B slots, asynchronous saves and resume exactness of the LM trainer
# are in tests/test_torch_checkpoint_slots.py.
import json
import logging
import random
import signal
import sys

import numpy as np
import pytest
import torch

from flashy_tpu_torch import checkpoint as ckpt
from flashy_tpu_torch import resilience
from flashy_tpu_torch.resilience import chaos
from flashy_tpu_torch.resilience.retry import backoff_delay, call_with_retry
from flashy_tpu_torch.solver import BaseSolver
from flashy_tpu_torch.xp import temporary_xp


@pytest.fixture()
def injector():
    inj = chaos.install()
    yield inj
    chaos.uninstall()


@pytest.fixture()
def fast_retry(monkeypatch):
    """Stub the backoff sleep out (through sys.modules: the package
    attribute `resilience.retry` is the decorator)."""
    monkeypatch.setattr(sys.modules["flashy_tpu_torch.resilience.retry"],
                        "_sleep", lambda _: None)


@pytest.fixture(autouse=True)
def _no_leaked_guard():
    yield
    resilience.disable_preemption_guard()
    chaos.uninstall(verify=False)


# ----------------------------------------------------------------------
# retry / backoff
# ----------------------------------------------------------------------
@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_backoff_delays_equal_the_jax_packages(jitter):
    from flashy_tpu.resilience.retry import backoff_delay as jax_delay
    port_rng, jax_rng = random.Random(7), random.Random(7)
    for attempt in range(1, 10):
        assert backoff_delay(attempt, 0.1, 5.0, jitter, port_rng) == \
            jax_delay(attempt, 0.1, 5.0, jitter, jax_rng)
    # exponential growth, then the cap
    assert [backoff_delay(a, 0.1, 1.0, 0.0) for a in (1, 2, 3, 4, 5)] == \
        [0.1, 0.2, 0.4, 0.8, 1.0]


def test_retry_succeeds_after_transient_failures_and_only_allowlisted():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    sleeps = []
    assert call_with_retry(flaky, sleep=sleeps.append, jitter=0.0) == "ok"
    assert calls["n"] == 3 and sleeps == [0.1, 0.2]

    def bug():
        calls["n"] += 1
        raise ValueError("not transient")

    calls["n"] = 0
    with pytest.raises(ValueError):
        call_with_retry(bug, sleep=lambda _: None)
    assert calls["n"] == 1   # never retried

    def always():
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        call_with_retry(always, attempts=3, sleep=lambda _: None)
    with pytest.raises(ValueError, match="attempts"):
        call_with_retry(always, attempts=0)
    with pytest.raises(ValueError, match="deadline"):
        call_with_retry(always, deadline=0)
    with pytest.raises(ValueError, match="on_exhausted"):
        call_with_retry(always, on_exhausted="ignore")


def test_retry_deadline_and_warn_on_exhaustion(caplog):
    now = {"t": 0.0}

    def clock():
        return now["t"]

    def stall(seconds):
        now["t"] += seconds

    def always():
        now["t"] += 1.0   # each attempt takes a second
        raise OSError("slow failure")

    from flashy_tpu.resilience.retry import call_with_retry as jax_retry
    ends = []
    for retry in (call_with_retry, jax_retry):
        now["t"] = 0.0
        with pytest.raises(OSError):
            retry(always, attempts=100, base_delay=1.0, jitter=0.0,
                  deadline=5.0, sleep=stall, clock=clock)
        ends.append(now["t"])
    # no wait starts that would end past the deadline: attempts end at
    # 1, 3 and 6 s (the waits 1 and 2 s), the next wait (4 s) is refused
    assert ends == [6.0, 6.0]
    now["t"] = 0.0
    with caplog.at_level(logging.WARNING, "flashy_tpu_torch.resilience"):
        assert call_with_retry(always, attempts=100, base_delay=1.0,
                               jitter=0.0, deadline=5.0, sleep=stall,
                               clock=clock, on_exhausted="warn",
                               name="t.site") is None
        assert call_with_retry(always, attempts=2, sleep=stall,
                               on_exhausted="warn", name="t.other") is None
    assert any("t.site deadline" in r.message and "degrading" in r.message
               for r in caplog.records)
    assert any("t.other failed 2/2" in r.message for r in caplog.records)


def test_retry_attempts_journaled_through_tracer(tmp_path):
    from flashy_tpu_torch import observability
    telemetry = observability.enable_telemetry(folder=tmp_path,
                                               with_device_stats=False)
    try:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 2:
                raise OSError("transient")

        call_with_retry(flaky, name="test.site", sleep=lambda _: None)
        telemetry.close()
        records = [json.loads(line)
                   for line in (tmp_path / "telemetry.jsonl").open()]
        retries = [r for r in records if r.get("type") == "retry"]
        assert len(retries) == 1
        assert retries[0]["site"] == "test.site"
        assert retries[0]["outcome"] == "retrying"
        assert retries[0]["error"] == "OSError: transient"
    finally:
        observability.disable_telemetry()


# ----------------------------------------------------------------------
# manifests and sidecars
# ----------------------------------------------------------------------
def _slot(tmp_path):
    slot = tmp_path / "slot0"
    (slot / "arrays").mkdir(parents=True)
    (slot / "state.pkl").write_bytes(b"skeleton" * 9)
    (slot / "arrays" / "shard0").write_bytes(b"\x01\x02\x03")
    (slot / "arrays.pt").write_bytes(bytes(range(200)))
    (slot / "state.pkl.tmp").write_bytes(b"a dropping")
    return slot


def _entries(path):
    manifest = json.loads(path.read_text())
    assert set(manifest) == {"version", "created", "files"}
    return manifest["version"], manifest["files"]


def test_manifest_and_problems_equal_the_jax_packages(tmp_path):
    from flashy_tpu.resilience import integrity as jax_integrity
    slot = _slot(tmp_path)
    port_manifest = resilience.write_manifest(slot)
    port = _entries(port_manifest)
    jax_integrity.write_manifest(slot)
    assert _entries(port_manifest) == port
    assert sorted(port[1]) == ["arrays.pt", "arrays/shard0", "state.pkl"]
    assert resilience.verify_slot(slot) == [] \
        == jax_integrity.verify_slot(slot)
    chaos.corrupt_file(slot / "arrays" / "shard0")
    (slot / "arrays.pt").write_bytes(b"short")
    (slot / "state.pkl").unlink()
    problems = resilience.verify_slot(slot)
    assert problems == jax_integrity.verify_slot(slot)
    assert len(problems) == 3
    assert any("sha256 mismatch" in p for p in problems)
    assert any("size 5 != manifest 200" in p for p in problems)
    assert any("listed in manifest but missing" in p for p in problems)
    # a manifest that does not parse
    (slot / resilience.MANIFEST_NAME).write_text("{not json")
    assert resilience.verify_slot(slot)[0].endswith(
        jax_integrity.verify_slot(slot)[0].split(": ", 1)[1])


def test_missing_manifest_is_legacy_ok_unless_strict(tmp_path):
    from flashy_tpu.resilience import integrity as jax_integrity
    slot = tmp_path / "slot0"
    slot.mkdir()
    (slot / "state.pkl").write_bytes(b"x")
    assert resilience.verify_slot(slot) == []
    assert resilience.verify_slot(slot, strict=True) == \
        jax_integrity.verify_slot(slot, strict=True) != []
    single = tmp_path / "checkpoint.th"
    single.write_bytes(b"y" * 10)
    assert resilience.verify_file(single) == []
    assert resilience.verify_file(single, strict=True) == \
        jax_integrity.verify_file(single, strict=True) != []
    assert resilience.verify_file(tmp_path / "gone") == \
        jax_integrity.verify_file(tmp_path / "gone")


def test_sidecar_verifies_then_detects_corruption(tmp_path):
    from flashy_tpu.resilience import integrity as jax_integrity
    path = tmp_path / "checkpoint.th"
    ckpt.save_state({"w": torch.arange(3.0)}, path)
    side = resilience.integrity.sidecar_path(path)
    assert side.name == "checkpoint.th.manifest.json"
    meta = json.loads(side.read_text())
    assert (meta["sha256"], meta["size"]) == resilience.file_digest(path)
    assert resilience.verify_file(path, strict=True) == [] \
        == jax_integrity.verify_file(path, strict=True)
    chaos.corrupt_file(path, offset=2)
    assert resilience.verify_file(path) == jax_integrity.verify_file(path)
    with pytest.raises(resilience.CheckpointCorrupted, match="sha256"):
        ckpt.load_state(path)


def test_load_state_names_the_path_of_a_bad_file(tmp_path):
    bad = tmp_path / "checkpoint.th"
    bad.write_bytes(b"this is not a checkpoint")
    with pytest.raises(resilience.CheckpointError, match=str(bad)):
        ckpt.load_state(bad)
    with pytest.raises(FileNotFoundError):
        ckpt.load_state(tmp_path / "absent.th")


# ----------------------------------------------------------------------
# fault sites in the harness
# ----------------------------------------------------------------------
class _Toy(BaseSolver):
    """Deterministic solver: metrics are pure functions of the state."""

    def __init__(self, epochs=4, steps=3):
        super().__init__()
        self.epochs = epochs
        self.steps = steps
        self.w = torch.zeros(2)
        self.register_stateful("w")

    def train_stage(self):
        for step in range(self.steps):
            chaos.fault_point("toy.step", step=step)
            self.check_preemption()
            self.w = self.w + self.epoch
        return {"loss": float(self.w.sum())}

    def run(self):
        self.restore()
        for _ in range(self.epoch, self.epochs + 1):
            self.run_stage("train", self.train_stage)
            self.commit()


def test_transient_ckpt_write_and_history_write_faults_are_retried(
        tmp_path, injector, fast_retry):
    injector.fail_at("ckpt.write", call=1)
    ckpt.save_state({"w": 7}, tmp_path / "c.th")
    assert ckpt.load_state(tmp_path / "c.th") == {"w": 7}
    assert injector.hits("ckpt.write") == 1
    injector.fail_at("ckpt.load", call=2)   # the load above was the 1st
    assert ckpt.load_state(tmp_path / "c.th") == {"w": 7}
    assert injector.hits("ckpt.load") == 1
    with temporary_xp():
        solver = _Toy()
        injector.fail_at("history.write", call=1)
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        assert (solver.folder / "history.json").exists()
        assert injector.hits("history.write") == 1


def test_commit_rolls_back_history_on_a_failed_single_save(injector,
                                                           fast_retry):
    with temporary_xp():
        solver = _Toy()
        solver.run_stage("train", solver.train_stage)
        pending = dict(solver._pending_metrics)
        # exactly the retry budget: every attempt of the first commit fails
        injector.fail_at("ckpt.write", call=1, times=4)
        with pytest.raises(OSError):
            solver.commit()
        assert solver.epoch == 1 and solver.history == []
        assert solver._pending_metrics == pending
        assert not (solver.folder / "history.json").exists()
        solver.commit()
        assert solver.epoch == 2 and solver.checkpoint_path.exists()


class _BrokenBackend:
    """A backend whose every method raises (a wandb outage)."""

    def __getattr__(self, name):
        def method(*args, **kwargs):
            raise ConnectionError("backend is down")

        return method


def test_backend_failure_degrades_to_warning(caplog, fast_retry):
    with temporary_xp():
        solver = _Toy()
        solver.result_logger._experiment_loggers["wandb"] = _BrokenBackend()
        with caplog.at_level(logging.WARNING,
                             "flashy_tpu_torch.resilience.retry"):
            solver.run_stage("train", solver.train_stage)
            solver.commit()  # training survives the dead backend
        assert len(solver.history) == 1
        assert any("logger.wandb" in r.message and "degrading" in r.message
                   for r in caplog.records)


def test_backend_transient_fault_retried_then_succeeds(injector, fast_retry):
    class Recording:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return lambda *args, **kwargs: self.calls.append(name)

    with temporary_xp():
        solver = _Toy()
        backend = Recording()
        solver.result_logger._experiment_loggers["rec"] = backend
        injector.fail_at("logger.rec", call=1,
                         exc=lambda: ConnectionError("hiccup"))
        solver.run_stage("train", solver.train_stage)
        assert injector.hits("logger.rec") == 1
        # the retried call reached the backend, once
        assert backend.calls == ["log_metrics"]


# ----------------------------------------------------------------------
# the preemption guard
# ----------------------------------------------------------------------
def test_preemption_simulated_signal_stops_at_boundary(injector):
    with temporary_xp():
        solver = _Toy(epochs=4)
        guard = solver.enable_preemption_guard(install=False)
        assert guard is resilience.get_preemption_guard()
        injector.preempt_at("toy.step", call=4)   # mid-train of epoch 2
        with pytest.raises(SystemExit) as exit_info:
            solver.run()
        assert exit_info.value.code == resilience.EXIT_PREEMPTED == 75
        # finish_stage: epoch 2's stage finished, its commit landed and
        # the commit boundary took the exit
        assert len(solver.history) == 2
        marker = json.loads((solver.folder / "preempted.json").read_text())
        assert marker["committed_epochs"] == 2
        assert marker["exit_code"] == 75 and marker["signal"] == "SIMULATED"
        assert marker["where"] == "commit boundary (epoch 2 committed)"


def test_preemption_abandon_stage_mode(injector):
    with temporary_xp():
        solver = _Toy(epochs=4)
        solver.enable_preemption_guard(mode="abandon_stage", install=False)
        injector.preempt_at("toy.step", call=4)   # step 1 of epoch 2
        with pytest.raises(SystemExit) as exit_info:
            solver.run()
        assert exit_info.value.code == resilience.EXIT_PREEMPTED
        assert len(solver.history) == 1   # the abandoned epoch never landed
        assert solver._pending_metrics == {}
        marker = json.loads((solver.folder / "preempted.json").read_text())
        assert marker["where"].startswith("mid-stage 'train' abandoned")


def test_preemption_guard_real_signal_sets_flag():
    guard = resilience.enable_preemption_guard()
    try:
        assert not guard.requested and not guard.check()
        signal.raise_signal(signal.SIGTERM)
        assert guard.requested and guard.signal_name == "SIGTERM"
        assert guard.should_stop() and guard.check(every=5)
    finally:
        resilience.disable_preemption_guard()
    # the previous handler is back
    assert signal.getsignal(signal.SIGTERM) is not guard._handle


def test_check_is_throttled_by_call_count():
    guard = resilience.PreemptionGuard()
    guard.simulate_signal()
    assert [guard.check(every=3) for _ in range(3)] == [False, False, True]
    assert guard.check(every=3)   # sticky


def test_solver_rejects_unknown_preemption_mode():
    with temporary_xp():
        solver = _Toy()
        with pytest.raises(ValueError, match="mode"):
            solver.enable_preemption_guard(mode="nope", install=False)
        assert resilience.get_preemption_guard() is None


# ----------------------------------------------------------------------
# the hang watchdog
# ----------------------------------------------------------------------
def _beats(folder, now, ages):
    from flashy_tpu_torch.observability import Heartbeat
    for rank, age in enumerate(ages):
        Heartbeat(folder, rank=rank, world_size=len(ages),
                  with_device_stats=False).beat(step=10 - rank, force=True)
        payload = json.loads((folder / f"rank{rank}.json").read_text())
        payload["time"] = now - age
        (folder / f"rank{rank}.json").write_text(json.dumps(payload))


@pytest.mark.parametrize("ages,abort_after,action,stalled", [
    ((0.5, 1.0), None, None, []),
    ((0.5, 300.0), None, "warn", [1]),
    ((400.0, 300.0), 350.0, "abort", [0, 1]),
    ((200.0, 2.0), 350.0, "warn", [0]),
])
def test_hang_watchdog_verdicts_equal_the_jax_watchdogs(tmp_path, ages,
                                                         abort_after,
                                                         action, stalled):
    from flashy_tpu.resilience.hang import HangWatchdog as JaxWatchdog
    now = 1_000_000.0
    _beats(tmp_path, now, ages)
    seen = {"port": [], "jax": []}

    def watchdog(cls, key):
        return cls(tmp_path, warn_after=120.0, abort_after=abort_after,
                   on_warn=lambda m: seen[key].append(("warn", m)),
                   on_abort=lambda code, r: seen[key].append(("abort", code)))

    port = watchdog(resilience.HangWatchdog, "port").check(now=now)
    want = watchdog(JaxWatchdog, "jax").check(now=now)
    assert (port["stalled"], port["action"]) == \
        (want["stalled"], want["action"]) == (stalled, action)
    assert seen["port"] == seen["jax"]
    if action == "abort":
        assert ("abort", resilience.EXIT_HUNG) in seen["port"]
        assert resilience.EXIT_HUNG == 70


def test_hang_watchdog_warns_once_and_rearms(tmp_path):
    now = 1_000_000.0
    _beats(tmp_path, now, (500.0,))
    warnings = []
    dog = resilience.HangWatchdog(tmp_path, warn_after=60.0,
                                  on_warn=warnings.append)
    assert dog.check(now=now)["action"] == "warn"
    assert dog.check(now=now + 1)["action"] is None   # once per stall
    assert "stalled past 60s" in warnings[0]
    _beats(tmp_path, now, (1.0,))
    assert dog.check(now=now)["action"] is None       # fresh: re-armed
    _beats(tmp_path, now, (500.0,))
    assert dog.check(now=now)["action"] == "warn"
    assert len(warnings) == 2
    with pytest.raises(ValueError, match="abort_after"):
        resilience.HangWatchdog(tmp_path, warn_after=10.0, abort_after=5.0)
    # an empty folder: quiet
    assert resilience.HangWatchdog(tmp_path / "none").check()["action"] \
        is None


def test_hang_watchdog_thread_aborts_a_stalled_run(tmp_path):
    import threading
    chaos.stall_heartbeat(tmp_path, 0, 30.0)
    aborted = threading.Event()
    dog = resilience.HangWatchdog(tmp_path, warn_after=1.0, abort_after=2.0,
                                  interval=0.01, on_warn=lambda m: None,
                                  on_abort=lambda code, r: aborted.set())
    dog.start()
    try:
        assert aborted.wait(5.0)
    finally:
        dog.stop()


# ----------------------------------------------------------------------
# info --verify-checkpoint and the drill
# ----------------------------------------------------------------------
def test_info_verify_checkpoint_prints_the_jax_report(tmp_path, capsys):
    from flashy_tpu import info as jax_info
    from flashy_tpu.resilience import integrity as jax_integrity
    from flashy_tpu_torch import info
    from flashy_tpu_torch.xp import create_xp
    layouts = {}
    # a single file with its sidecar and meta, as a 'single' commit
    # leaves them
    with create_xp({"a": 1}, root=tmp_path).enter():
        solver = _Toy(epochs=1)
        solver.run()
        layouts["single"] = solver.folder
    # slots: both committed, the active one corrupted
    with create_xp({"a": 2}, root=tmp_path).enter():
        solver = _Toy(epochs=2)
        solver.checkpoint_mode = "sharded"
        solver.run()
        chaos.corrupt_active_slot(solver.sharded_checkpoint_path)
        layouts["slots"] = solver.folder
    # both slots bad: not restorable
    with create_xp({"a": 3}, root=tmp_path).enter():
        solver = _Toy(epochs=2)
        solver.checkpoint_mode = "sharded"
        solver.run()
        for slot in ckpt.SLOTS:
            chaos.corrupt_file(solver.sharded_checkpoint_path / slot
                               / "arrays.pt", offset=3)
        layouts["bad"] = solver.folder
    create_xp({"a": 4}, root=tmp_path)   # no checkpoint
    capsys.readouterr()
    assert info.main([str(tmp_path), "--verify-checkpoint"]) == 1
    out = capsys.readouterr().out.splitlines()
    want = []
    for folder in sorted((tmp_path / "xps").iterdir()):
        report = jax_integrity.verify_checkpoint(
            folder, checkpoint_name="checkpoint.th")
        meta = folder / "checkpoint_meta.json"
        topology = (json.loads(meta.read_text())["topology"]
                    if meta.exists() else None)
        want += jax_info.format_verify_report(
            folder.name, report, topology=topology).splitlines()
    assert out == want
    assert f"{layouts['slots'].name}  slot0=OK slot1=CORRUPT*  -> " \
        "restorable" in out
    assert f"{layouts['bad'].name}  slot0=CORRUPT slot1=CORRUPT*  -> " \
        "NOT RESTORABLE" in out
    assert "  topology: saved on 1 device(s) state=replicated" in out


def test_verify_checkpoint_loads_what_the_digest_passes(tmp_path):
    # the port's one deliberate difference: a digest that matches is not
    # enough, the file must also load with weights_only=True
    import pickle
    path = tmp_path / "checkpoint.th"
    with open(path, "wb") as f:
        pickle.dump({"fn": print}, f)
    resilience.write_sidecar(path)
    assert resilience.verify_file(path) == []
    report = resilience.verify_checkpoint(tmp_path)
    assert not report["restorable"] and report["single"]


def test_chaos_drill_passes_with_the_jax_drills_history(tmp_path):
    from flashy_tpu.resilience.__main__ import run_drill as jax_drill
    from flashy_tpu_torch.resilience.__main__ import main, run_drill
    assert run_drill(root=str(tmp_path / "port")) == 0
    assert jax_drill(root=str(tmp_path / "jax")) == 0

    def histories(root):
        return sorted(json.dumps([{stage: {k: v for k, v in m.items()
                                           if k != "duration"}
                                   for stage, m in epoch.items()}
                                  for epoch in json.loads(p.read_text())])
                      for p in (root / "xps").glob("*/history.json"))

    port = histories(tmp_path / "port")
    assert len(port) == 2 and port == histories(tmp_path / "jax")
    assert port[0] == port[1]   # the chaos run resumed to the baseline
    # the elastic drill still waits; the campaign's full sweep names the
    # item its waiting scenario needs, 8e's (the serve, fleet, pipeline
    # and tensor scenarios run; a subset of ported ones runs:
    # tests/test_torch_campaign.py)
    for flag, match in (("--elastic", "item 9's elastic drill"),
                        ("--campaign", "item 8e")):
        with pytest.raises(NotImplementedError, match=match) as exc:
            main([flag])
        assert "item 10" not in str(exc.value)
        assert "item 8c" not in str(exc.value)
    with pytest.raises(ValueError, match="preempt_epoch"):
        run_drill(preempt_epoch=2)
    assert np.isfinite(float(json.loads(port[0])[-1]["train"]["loss"]))
