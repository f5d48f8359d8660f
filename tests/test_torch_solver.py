# The port's harness (flashy_tpu_torch: xp, formatter, utils, solver,
# checkpoint, distrib and the LM solver) against the JAX package's:
# identical XP signatures, override parsing, metric formatting and
# averaging on the same inputs; and the LM solver run on the CPU at a
# tiny width with attention='flash', interrupted after its first commit
# and resumed, giving a history.json bit-equal to an uninterrupted run's
# (leaving out the wall-clock keys).
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
TINY_ARGS = ["device=cpu", "model.vocab_size=256", "model.dim=32",
             "model.num_layers=2", "model.num_heads=4", "seq_len=32",
             "batch_size=4", "steps_per_epoch=3", "valid_steps=1",
             "warmup_steps=2", "lr=1e-2"]


@pytest.fixture()
def root_logging():
    """Restore the root logger after a run that calls setup_logging."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for handler in root.handlers[:]:
        if handler not in handlers:
            root.removeHandler(handler)
            handler.close()
    for handler in handlers:
        if handler not in root.handlers:
            root.addHandler(handler)
    root.setLevel(level)


def _lm_config():
    with open(ROOT / "examples/lm/config/config.yaml") as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("cfg,exclude", [
    ({"lr": 0.1, "model": {"dim": 8, "layers": [2, 2]}}, ()),
    ({"lr": 0.1, "epochs": 3, "dora": {"dir": "x"}}, ("epochs",)),
    ({"optim": {"lr": 1e-3, "name": "adam"}, "seed": None}, ("optim.*",)),
    (_lm_config(), _lm_config()["dora"]["exclude"]),
])
def test_signature_is_the_jax_packages(cfg, exclude):
    from flashy_tpu.xp import compute_sig as jax_sig
    from flashy_tpu_torch.xp import compute_sig
    assert compute_sig(cfg, exclude) == jax_sig(cfg, exclude)


def test_port_config_matches_the_jax_solvers_where_both_have_keys():
    # the port's LM config differs only in what it adds (device) and in
    # its XP root; shared keys keep the JAX package's values
    from flashy_tpu_torch.xp import flatten_config
    port_yaml = ROOT / "flashy_tpu_torch/examples/lm/config/config.yaml"
    port = flatten_config(yaml.safe_load(port_yaml.read_text()))
    jax_cfg = flatten_config(_lm_config())
    shared = (set(port) & set(jax_cfg)) - {"dora.dir", "dora.exclude"}
    assert {key: port[key] for key in shared} == \
        {key: jax_cfg[key] for key in shared}
    assert port["dora.dir"] != jax_cfg["dora.dir"]


def test_overrides_parse_as_in_the_jax_package():
    from flashy_tpu.xp import parse_overrides as jax_parse
    from flashy_tpu_torch.xp import parse_overrides
    argv = ["lr=1e-3", "epochs=4", "name=resnet", "layers=[2,2]",
            "+new.key=true", "empty=", "model.dim=512"]
    assert parse_overrides(argv) == jax_parse(argv)
    with pytest.raises(ValueError, match="key=value"):
        parse_overrides(["oops"])


@pytest.mark.parametrize("kwargs", [
    {"formats": {"loss": ".4f", "acc*": ".1%"}},
    {"formats": {"loss": ".2e"}, "exclude_keys": ["dur*"]},
    {"include_keys": ["acc*"], "include_formatted": False},
    {"exclude_keys": ["*"], "include_keys": ["loss"]},
])
def test_formatter_agrees_with_the_jax_package(kwargs):
    from flashy_tpu.formatter import Formatter as JaxFormatter
    from flashy_tpu_torch.formatter import Formatter
    metrics = {"loss": 1.23456, "acc_top1": 0.5, "acc_top5": 0.875,
               "duration": 12.5, "ppl": 3.4}
    assert Formatter(**kwargs)(metrics) == JaxFormatter(**kwargs)(metrics)


@pytest.mark.parametrize("beta", [1.0, 0.9])
def test_averager_agrees_with_the_jax_package(beta):
    from flashy_tpu.utils import averager as jax_averager
    from flashy_tpu_torch.utils import averager
    ours, theirs = averager(beta), jax_averager(beta)
    rng = np.random.default_rng(0)
    for step in range(6):
        metrics = {"loss": float(rng.random()), "grad_norm": rng.random()}
        loss = torch.tensor(metrics["loss"], dtype=torch.float64)
        got = ours({"loss": loss, "grad_norm": metrics["grad_norm"]},
                   weight=step + 1)
        assert got == theirs(metrics, weight=step + 1)


@pytest.mark.parametrize("seed,subset,step", [(0, 0, 0), (0, 1, 7),
                                              (3, 0, 12)])
def test_synthetic_token_stream_gives_the_jax_solvers_tokens(seed, subset,
                                                             step):
    from examples.lm.solver import synthetic_token_stream as jax_stream
    from flashy_tpu_torch.examples.lm.solver import synthetic_token_stream
    got = synthetic_token_stream(512, seed)(4, 33, step, subset=subset)
    want = jax_stream(512, seed)(4, 33, step, subset=subset)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _history(folder):
    entries = json.loads((folder / "history.json").read_text())
    return [{stage: {key: value for key, value in metrics.items()
                     if key != "duration" and not key.endswith("_per_sec")}
             for stage, metrics in entry.items()} for entry in entries]


class _Killed(Exception):
    pass


def test_lm_solver_resumes_bit_exactly(tmp_path, monkeypatch, root_logging):
    from flashy_tpu_torch.examples.lm import solver as lm
    from flashy_tpu_torch.ops.attention import launch_counts
    before = dict(launch_counts)
    whole = lm.main(TINY_ARGS + ["epochs=2", f"dora.dir={tmp_path / 'a'}"])
    assert whole.model.config.attention == "flash"
    assert launch_counts == before  # the CPU runs the plain versions
    assert not whole.restored and len(whole.history) == 2
    losses = [entry["train"]["loss"] for entry in whole.history]
    assert np.isfinite(losses).all()

    commit = lm.LMSolver.commit

    def commit_then_die(self, *args, **kwargs):
        commit(self, *args, **kwargs)
        raise _Killed()

    args = TINY_ARGS + ["epochs=2", f"dora.dir={tmp_path / 'b'}"]
    monkeypatch.setattr(lm.LMSolver, "commit", commit_then_die)
    with pytest.raises(_Killed):
        lm.main(args)
    monkeypatch.setattr(lm.LMSolver, "commit", commit)
    resumed = lm.main(args)
    assert resumed.restored and resumed.state["step"] == 6
    assert resumed.folder.name == whole.folder.name  # same signature
    assert _history(resumed.folder) == _history(whole.folder)
    for name, value in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name


def test_clear_starts_afresh_and_workers_raise(tmp_path, root_logging,
                                              monkeypatch):
    import subprocess
    import sys
    from flashy_tpu_torch.examples.lm.solver import main
    args = TINY_ARGS + ["epochs=1", "valid_steps=0",
                        f"dora.dir={tmp_path}"]
    first = main(args)
    assert (first.folder / "checkpoint.th").exists()
    cleared = main(args + ["--clear"])
    assert not cleared.restored and len(cleared.history) == 1
    # --workers re-executes this process's script once a worker, with the
    # launcher environment, minus --workers and --clear; a failed worker
    # raises in the launcher, naming it (the real multi-process runs are
    # tests/test_torch_distrib_multiproc.py's)
    script = tmp_path / "worker.py"
    # worker 1 fails once worker 0 has written its record (the launcher
    # stops the others when one fails)
    script.write_text(
        "import json, os, sys, time\n"
        "env = {k: v for k, v in os.environ.items() if k.startswith("
        "('FLASHY_TPU_', 'LOCAL_'))}\n"
        "rank = env['FLASHY_TPU_PROCESS_ID']\n"
        "with open(sys.argv[0] + '.tmp' + rank, 'w') as f:\n"
        "    json.dump({'env': env, 'argv': sys.argv[1:]}, f)\n"
        "os.rename(sys.argv[0] + '.tmp' + rank, sys.argv[0] + '.' + rank)\n"
        "deadline = time.time() + 30\n"
        "while rank == '1' and not os.path.exists(sys.argv[0] + '.0') "
        "and time.time() < deadline:\n"
        "    time.sleep(0.01)\n"
        "sys.exit(3 if rank == '1' else 0)\n")
    monkeypatch.setattr(sys.modules["__main__"], "__spec__", None)
    monkeypatch.setattr(sys, "argv", [str(script)])
    monkeypatch.delenv("FLASHY_TPU_COORDINATOR", raising=False)
    with pytest.raises(subprocess.CalledProcessError, match="worker 1"):
        main(args + ["--workers=2", "--clear"])
    seen = [json.loads((tmp_path / f"worker.py.{rank}").read_text())
            for rank in range(2)]
    for rank, record in enumerate(seen):
        assert record["argv"] == args
        env = record["env"]
        assert env["FLASHY_TPU_PROCESS_ID"] == env["LOCAL_RANK"] == str(rank)
        assert env["FLASHY_TPU_NUM_PROCESSES"] == "2"
        assert env["LOCAL_WORLD_SIZE"] == "2"
        assert env["FLASHY_TPU_COORDINATOR"].startswith("localhost:")
    assert seen[0]["env"]["FLASHY_TPU_COORDINATOR"] == \
        seen[1]["env"]["FLASHY_TPU_COORDINATOR"]


def test_failed_save_rolls_history_back(monkeypatch):
    from flashy_tpu_torch import checkpoint
    from flashy_tpu_torch.solver import BaseSolver
    from flashy_tpu_torch.xp import temporary_xp

    class Solver(BaseSolver):
        def __init__(self):
            super().__init__()
            self.weights = torch.nn.Linear(2, 2)
            self.register_stateful("weights")

    def broken(state, path):
        raise OSError("disk full")

    with temporary_xp({"lr": 1}):
        solver = Solver()
        solver.run_stage("train", lambda: {"loss": 1.0})
        monkeypatch.setattr(checkpoint, "save_state", broken)
        with pytest.raises(OSError):
            solver.commit()
        assert solver.epoch == 1 and solver.history == []
        assert not (solver.folder / "history.json").exists()
        monkeypatch.undo()
        solver.commit()  # the pending metrics are still there
        assert solver.epoch == 2 and solver.history[0]["train"]["loss"] == 1.0
        restored = Solver()
        assert restored.restore()
        assert torch.equal(restored.weights.weight, solver.weights.weight)
        assert restored.history == solver.history


@pytest.mark.parametrize("override,match", [
    # tensor ranks are processes too (item 8b)
    ({"mesh": {"tensor": 2}}, "queue A item 5"),
    ({"mesh": {"data": 2}}, "queue A item 5"),
    # fsdp ranks are processes too (item 8a): one process cannot hold two
    ({"mesh": {"fsdp": 2}}, "queue A item 5"),
    # expert ranks are processes too (item 8d)
    ({"mesh": {"expert": 2}, "model": {"moe_experts": 4,
                                       "moe_dispatch": "dropless_ep"}},
     "queue A item 5"),
])
def test_lm_solver_refuses_what_one_card_lacks(override, match):
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.xp import Config, temporary_xp
    cfg = Config(_lm_config())
    for key, value in override.items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    with temporary_xp(cfg):
        with pytest.raises(NotImplementedError, match=match):
            LMSolver(cfg, device="cpu")


def test_multi_process_distrib_raises(monkeypatch):
    # a multi-process launch whose entry point never called init(): the
    # collectives refuse (the multi-process runs themselves are
    # tests/test_torch_distrib_multiproc.py's)
    from flashy_tpu_torch import distrib
    assert distrib.world_size() == 1 and distrib.is_rank_zero()
    assert distrib.average_metrics({"loss": 2.0}) == {"loss": 2.0}
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert distrib.rank() == 1 and not distrib.is_rank_zero()
    assert distrib._init_method() == "tcp://localhost:29500"
    with pytest.raises(RuntimeError, match="distrib.init"):
        distrib.average_metrics({"loss": 2.0})
