# The port's A/B slot checkpoints on one process (flashy_tpu_torch/
# checkpoint.py) and the solver's commit modes, held to the JAX package's
# behavior: a corrupt active slot falls back to its sibling and CURRENT
# is repointed, both slots bad raise, a missing active payload falls back;
# the asynchronous save commits only at finalize, snapshots the state
# before later in-place updates, and a failed background write rolls back
# the epochs it covered; a failed single or slot save rolls the commit
# back; 'auto' picks slots by size; and the LM trainer preempted mid-stage
# and resumed (single file and slots) gives the uninterrupted run's
# history and state bit for bit, and the JAX LMSolver's preempted and
# resumed the same way within the optimizer tolerance of
# tests/test_torch_train.py (loss, grad_norm 1e-5 relative, parameters
# 1e-5 relative in norm per leaf).
import functools
import json
import logging
import sys

import numpy as np
import pytest
import torch

from flashy_tpu_torch import checkpoint as ckpt
from flashy_tpu_torch import resilience
from flashy_tpu_torch.resilience import chaos
from flashy_tpu_torch.solver import BaseSolver
from flashy_tpu_torch.xp import temporary_xp

from .test_torch_solver import root_logging  # noqa: F401


@pytest.fixture()
def fast_retry(monkeypatch):
    monkeypatch.setattr(sys.modules["flashy_tpu_torch.resilience.retry"],
                        "_sleep", lambda _: None)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    resilience.disable_preemption_guard()
    chaos.uninstall(verify=False)


def _state(value):
    return {"w": torch.full((4,), float(value)), "step": value,
            "opt": {"state": {0: {"exp_avg": torch.ones(3) * value}}}}


def test_fallback_to_sibling_repoints_current(tmp_path, caplog):
    directory = tmp_path / "checkpoint.th.sharded"
    ckpt.save_state_sharded(_state(1), directory)   # slot0
    ckpt.save_state_sharded(_state(2), directory)   # slot1 active
    assert sorted(p.name for p in (directory / "slot1").iterdir()) == [
        "arrays.pt", "manifest.json", "state.pkl"]
    assert chaos.corrupt_active_slot(directory) == "slot1"
    with caplog.at_level(logging.WARNING, "flashy_tpu_torch.checkpoint"):
        state = ckpt.load_state_sharded(directory)
    assert state["step"] == 1 and torch.equal(state["w"], torch.ones(4))
    assert any("FALLBACK" in r.message for r in caplog.records)
    # CURRENT names the slot that restored: the next save overwrites the
    # corrupt slot, not the only good copy
    assert ckpt.read_slot_pointer(directory) == "slot0"
    ckpt.save_state_sharded(_state(3), directory)
    assert ckpt.read_slot_pointer(directory) == "slot1"
    assert ckpt.load_state_sharded(directory)["step"] == 3
    assert ckpt._load_slot(directory, "slot0")["step"] == 1


@pytest.mark.parametrize("damage", ["both_corrupt", "arrays_missing"])
def test_both_slots_bad_raises(tmp_path, damage):
    directory = tmp_path / "ckpt.sharded"
    ckpt.save_state_sharded(_state(1), directory)
    ckpt.save_state_sharded(_state(2), directory)
    for slot in ckpt.SLOTS:
        if damage == "both_corrupt":
            chaos.corrupt_file(directory / slot / "state.pkl", offset=1)
        else:
            (directory / slot / "arrays.pt").unlink()
    with pytest.raises(resilience.CheckpointCorrupted, match="both A/B"):
        ckpt.load_state_sharded(directory)
    assert not resilience.verify_checkpoint(
        tmp_path, checkpoint_name="ckpt")["restorable"]


def test_fallback_when_active_payload_missing(tmp_path):
    directory = tmp_path / "ckpt.sharded"
    assert not ckpt.sharded_checkpoint_exists(directory)
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_sharded(directory)
    ckpt.save_state_sharded(_state(1), directory)
    ckpt.save_state_sharded(_state(2), directory)
    (directory / "slot1" / "state.pkl").unlink()
    assert ckpt.sharded_checkpoint_exists(directory)
    assert ckpt.load_state_sharded(directory)["step"] == 1


def test_slot_state_loads_weights_only_with_markers(tmp_path):
    directory = tmp_path / "ckpt.sharded"
    state = {"model": {"a.b": torch.arange(6.0).reshape(2, 3)},
             "history": [{"train": {"loss": 1.5}}], "w": np.arange(3.0),
             "xp.cfg": {"lr": 0.1}}
    ckpt.save_state_sharded(state, directory)
    slot = ckpt.read_slot_pointer(directory)
    skeleton = torch.load(directory / slot / "state.pkl",
                          weights_only=True)
    assert skeleton["model"]["a.b"] == ckpt.ArraySlot("['model']['a.b']")
    tensors = torch.load(directory / slot / "arrays.pt", weights_only=True)
    assert list(tensors) == ["['model']['a.b']"]
    back = ckpt.load_state_sharded(directory)
    assert torch.equal(back["model"]["a.b"], state["model"]["a.b"])
    assert np.array_equal(back["w"], state["w"])
    assert back["history"] == state["history"]
    assert ckpt.tensor_bytes(state) == 24


def test_async_save_commits_at_finalize_from_its_snapshot(tmp_path):
    directory = tmp_path / "ckpt.sharded"
    saver = ckpt.AsyncShardedCheckpointer()
    live = {"w": torch.zeros(4), "step": 1}
    saver.save(live, directory)
    # in place, as an optimizer step updates its parameters
    live["w"].add_(5.0)
    saver.finalize_pending()
    assert ckpt.read_slot_pointer(directory) == "slot0"
    assert torch.equal(ckpt.load_state_sharded(directory)["w"],
                       torch.zeros(4))
    assert saver.last_background_seconds >= 0.0
    saver.save({"w": torch.ones(2), "step": 2}, directory)
    # deferred: the pointer still names the previous slot
    assert ckpt.read_slot_pointer(directory) == "slot0"
    assert not (directory / "slot1" / "state.pkl").exists()
    saver.close()
    assert ckpt.read_slot_pointer(directory) == "slot1"
    assert resilience.verify_slot(directory / "slot1", strict=True) == []


class _Toy(BaseSolver):
    def __init__(self):
        super().__init__()
        self.w = torch.zeros(2)
        self.register_stateful("w")

    def train_stage(self):
        self.w.add_(self.epoch)   # in place
        return {"loss": float(self.w.sum())}


def test_commit_modes_and_the_form_they_drop():
    with temporary_xp():
        solver = _Toy()
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        assert solver.checkpoint_path.exists()
        solver.checkpoint_mode = "sharded"
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        # the single file goes once the slot save is durable, and back
        assert not solver.checkpoint_path.exists()
        assert not (solver.folder / "checkpoint.th.manifest.json").exists()
        meta = json.loads((solver.folder
                           / "checkpoint_meta.json").read_text())
        assert meta["mode"] == "sharded"
        assert meta["topology"]["device_count"] == 1
        solver.checkpoint_mode = "auto"
        solver.sharded_checkpoint_min_bytes = 9   # the state has 8 bytes
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        assert solver.checkpoint_path.exists()
        assert not solver.sharded_checkpoint_path.exists()
        solver.sharded_checkpoint_min_bytes = 8
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        assert solver.sharded_checkpoint_path.exists()
        restored = _Toy()
        assert restored.restore() and torch.equal(restored.w, solver.w)
        assert len(restored.history) == 4
        solver.checkpoint_mode = "nope"
        solver.run_stage("train", solver.train_stage)
        with pytest.raises(ValueError, match="checkpoint_mode"):
            solver.commit()
        assert len(solver.history) == 4


@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.manifest",
                                  "ckpt.pointer"])
def test_failed_slot_save_rolls_commit_back(fast_retry, site):
    with temporary_xp():
        solver = _Toy()
        solver.checkpoint_mode = "sharded"
        solver.run_stage("train", solver.train_stage)
        solver.commit()
        solver.run_stage("train", solver.train_stage)
        injector = chaos.install()
        injector.fail_at(site, call=1, times=4)   # the retry budget
        with pytest.raises(OSError):
            solver.commit()
        assert len(solver.history) == 1 and solver._pending_metrics
        restored = _Toy()
        assert restored.restore()   # the previous slot is still active
        assert len(restored.history) == 1
        assert torch.equal(restored.w, torch.ones(2))
        solver.commit()
        assert len(solver.history) == 2


def test_async_commit_failure_rolls_back_covered_epochs(fast_retry):
    # a background write failure surfaces one commit late (at the next
    # finalize): the rollback drops the epochs that save covered
    with temporary_xp():
        solver = _Toy()
        solver.checkpoint_mode = "sharded"
        solver.checkpoint_async = True
        injector = chaos.install()
        injector.fail_at("ckpt.write", call=1, times=4)   # the retry budget
        solver.run_stage("train", solver.train_stage)
        solver.commit()   # epoch 1: the background write fails
        assert len(solver.history) == 1
        solver.run_stage("train", solver.train_stage)
        with pytest.raises(OSError):
            solver.commit()   # the finalize of epoch 1's save raises
        assert solver.history == [] and solver.epoch == 1
        assert json.loads(
            (solver.folder / "history.json").read_text()) == []
        # the epoch-2 metrics stay pending; a clean retry commits them
        solver.commit()
        solver.finalize_checkpoints()
        assert len(solver.history) == 1
        assert ckpt.sharded_checkpoint_exists(solver.sharded_checkpoint_path)
        assert injector.hits("ckpt.write") == 4
        restored = _Toy()
        assert restored.restore() and torch.equal(restored.w, solver.w)


# ----------------------------------------------------------------------
# the LM trainer preempted mid-stage and resumed
# ----------------------------------------------------------------------
def _lm_cfg(mesh):
    return {
        "model": {"vocab_size": 64, "dim": 32, "num_layers": 2,
                  "num_heads": 2, "mlp_ratio": 2, "attention": "dense"},
        "mesh": mesh, "seq_len": 16, "batch_size": 8, "accumulate": 1,
        "steps_per_epoch": 2, "epochs": 2, "valid_steps": 1,
        "generate_every": 0, "lr": 1e-2, "warmup_steps": 1,
        "weight_decay": 0.1, "ema_decay": 0.0, "device": "cpu"}


def _signal_at(solver, guard, epoch, index):
    """Deliver the guard a (simulated) signal when the train loop asks
    for the batch of `index` in `epoch`."""
    batch_at = solver.batch_at
    steps = solver.cfg.steps_per_epoch

    def patched(step, eval_set=False):
        if not eval_set and step == (epoch - 1) * steps + index:
            guard.simulate_signal("SIGTERM")
        return batch_at(step, eval_set=eval_set)

    solver.batch_at = patched


def _strip(history):
    return [{stage: {k: v for k, v in metrics.items()
                     if k not in ("duration", "tokens_per_sec")}
             for stage, metrics in epoch.items()} for epoch in history]


def _port_run(port_lm, cfg, params, preempt, mode="single"):
    """The port's LMSolver from `params`: whole, or preempted at train
    step 2 of epoch 2 and resumed in the same XP."""
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.xp import Config

    def solver():
        built = port_lm.LMSolver(Config(cfg), device="cpu")
        built.model.load_state_dict(params_from_jax(params,
                                                    built.model.config))
        built.checkpoint_mode = mode
        return built

    with temporary_xp(cfg):
        first = solver()
        if not preempt:
            first.run()
            return first
        guard = first.enable_preemption_guard(install=False)
        _signal_at(first, guard, epoch=2, index=1)
        with pytest.raises(SystemExit) as exit_info:
            first.run()
        assert exit_info.value.code == 75 and len(first.history) == 1
        assert json.loads((first.folder / "preempted.json").read_text())[
            "where"] == "boundary before stage 'valid' (epoch 2)"
        resilience.disable_preemption_guard()
        resumed = solver()
        resumed.run()
        assert resumed.restored and len(resumed.history) == 2
        return resumed


def test_lm_resume_after_preemption_is_exact_and_matches_jax(
        monkeypatch, root_logging):  # noqa: F811
    import jax
    import jax.numpy as jnp

    import examples.lm.solver as jax_lm
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.examples.lm import solver as port_lm
    from flashy_tpu_torch.models.convert import params_from_jax
    # both solvers compute in f32 here (their default is bf16)
    monkeypatch.setattr(jax_lm, "TransformerConfig", functools.partial(
        jax_lm.TransformerConfig, dtype=jnp.float32))
    monkeypatch.setattr(port_lm, "TransformerConfig", functools.partial(
        port_lm.TransformerConfig, dtype=torch.float32))
    from flashy_tpu import resilience as jax_resilience
    with jax_xp(_lm_cfg({"data": 8})) as xp:
        first = jax_lm.LMSolver(JaxConfig(_lm_cfg({"data": 8})))
        params = jax.tree.map(np.asarray, first.state["params"])
        guard = first.enable_preemption_guard(install=False)
        _signal_at(first, guard, epoch=2, index=1)
        with pytest.raises(SystemExit) as exit_info:
            first.run()
        assert exit_info.value.code == 75 and len(first.history) == 1
        jax_resilience.disable_preemption_guard()
        xp.link.load()
        resumed = jax_lm.LMSolver(JaxConfig(_lm_cfg({"data": 8})))
        resumed.run()
        want_history = _strip(resumed.history)
        want = jax.tree.map(np.asarray, resumed.state["params"])
    cfg = _lm_cfg({"data": -1})
    whole = _port_run(port_lm, cfg, params, preempt=False)
    for mode in ("single", "sharded"):
        got = _port_run(port_lm, cfg, params, preempt=True, mode=mode)
        # bit for bit against the uninterrupted run
        assert _strip(got.history) == _strip(whole.history)
        for name, value in whole.model.state_dict().items():
            assert torch.equal(got.model.state_dict()[name], value), name
        ours, theirs = (o.state_dict()["state"]
                        for o in (got.optimizer, whole.optimizer))
        for index, moments in theirs.items():
            for key, value in moments.items():
                assert torch.equal(ours[index][key], value), (index, key)
    # against the JAX solver preempted and resumed the same way
    for ours, theirs in zip(_strip(got.history), want_history):
        for stage in theirs:
            for key in ("loss", "grad_norm"):
                if key in theirs[stage]:
                    np.testing.assert_allclose(
                        ours[stage][key], theirs[stage][key], rtol=1e-5)
    want = params_from_jax(want, got.model.config)
    for name, value in got.model.state_dict().items():
        err = float((value - want[name]).norm() / want[name].norm())
        assert err <= 1e-5, (name, err)
