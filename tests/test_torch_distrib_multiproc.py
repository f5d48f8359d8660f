# The port's data parallelism across processes on the CPU: two gloo ranks
# that rendezvous through a file:// path in tmp_path (no ports, so the
# file is safe under xdist), one 60 s timeout per spawn, four spawns:
#
#  1. the collectives (all_reduce with every op, weighted average_metrics,
#     average_tensors by both methods, broadcasts, barrier, a mismatched
#     tree raising RuntimeError on both ranks); then the tiny LM (2 layers,
#     dim 64, f32) through the port's LMSolver under DDP for two clipped
#     AdamW steps, each rank on its rows of the global batch, held to the
#     JAX package's LMSolver on the whole batch (weights carried across by
#     params_from_jax) and to one port process; the same with
#     accumulate=2, with dropout on (train_step on a wrapped model,
#     against one port process) and with mesh data=2, seq=2 (a ring of two
#     ranks inside each process);
#  2-4. `python -m flashy_tpu_torch.examples.lm.solver --workers=2` for two
#     epochs, and the same run stopped after one epoch and resumed: the
#     histories (without wall-clock keys) and the final checkpoints equal.
import functools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60
CFG = {
    "model": {"vocab_size": 64, "dim": 64, "num_layers": 2, "num_heads": 2,
              "mlp_ratio": 2, "attention": "dense"},
    "mesh": {"data": -1}, "seq_len": 16, "batch_size": 8, "accumulate": 1,
    "steps_per_epoch": 2, "epochs": 1, "valid_steps": 0,
    "generate_every": 0, "lr": 1e-2, "warmup_steps": 1,
    "weight_decay": 0.1, "device": "cpu"}
# (name, config changes) of the LMSolver cases; "dropout" is train_step's
CASES = {"plain": {}, "accumulate": {"accumulate": 2},
         "seq": {"mesh": {"data": -1, "seq": 2},
                 "model": {**CFG["model"], "attention": "ring"}}}
DROPOUT_SEED = 7

WORKER = r'''
import functools, json, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.xp import Config, temporary_xp

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank, world = distrib.rank(), distrib.world_size()
out = {"rank": rank, "world": world}

# ---- collectives
x = torch.arange(4, dtype=torch.float32) + 10 * rank
out["all_reduce"] = {op: distrib.all_reduce(x, op).tolist()
                     for op in ("sum", "mean", "max", "min")}
out["all_reduce_host"] = distrib.all_reduce(np.array([1.5, rank]), "sum"
                                            ).tolist()
out["all_reduce_int_mean"] = float(distrib.all_reduce(np.int64(rank + 1),
                                                      "mean"))
out["all_reduce_max"] = distrib.all_reduce_max(5 * rank)
out["metrics"] = distrib.average_metrics({"loss": 1.0 + rank, "acc": 0.5},
                                         count=1 + 3 * rank)
trees = [{"w": torch.from_numpy(np.random.default_rng(r).normal(
              size=(300, 1000)).astype(np.float32)),
          "b": np.random.default_rng(10 + r).normal(size=5),
          "step": torch.tensor(rank)} for r in range(world)]
for method in ("reduce", "allgather"):
    got = distrib.average_tensors(trees[rank], method=method)
    want_w = sum(t["w"] for t in trees) / world
    want_b = sum(t["b"] for t in trees) / world
    out[f"average_{method}"] = [
        bool(torch.equal(got["w"], want_w)),
        bool(np.array_equal(got["b"], want_b)),
        int(got["step"]) == rank, type(got["b"]).__name__]
model = torch.nn.Linear(3, 2)
torch.nn.init.constant_(model.weight, float(rank))
distrib.broadcast_model(model)
out["broadcast_model"] = model.weight.flatten().tolist()
tree = distrib.broadcast_tensors({"v": torch.full((3,), float(rank)),
                                  "n": torch.tensor([rank])}, src=1)
out["broadcast_tensors"] = [tree["v"].tolist(), tree["n"].tolist()]
out["broadcast_object"] = distrib.broadcast_object(
    {"from": rank} if rank == 1 else None, src=1)
distrib.barrier()
try:
    distrib.average_tensors({"w": torch.ones(2 + rank)})
    out["mismatch"] = "no error"
except RuntimeError as exc:
    out["mismatch"] = str(exc)
distrib.barrier()

# ---- the tiny LM under DDP
lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
cfg = json.loads((folder / "cfg.json").read_text())
cases = json.loads((folder / "cases.json").read_text())
init = torch.load(folder / "init.pt")
results = {}
for name, change in cases.items():
    with temporary_xp():
        solver = lm.LMSolver(Config({**cfg, **change}), device="cpu")
        solver.model.load_state_dict(init)
        metrics = solver.run_stage("train", solver.train)
        results[name] = {"params": {k: v.detach().clone() for k, v in
                                    solver.model.state_dict().items()},
                         "metrics": metrics,
                         "ddp": type(solver.train_model).__name__}
model = lm.TransformerLM(lm.TransformerConfig(
    vocab_size=cfg["model"]["vocab_size"], dim=cfg["model"]["dim"],
    num_layers=cfg["model"]["num_layers"], num_heads=cfg["model"]["num_heads"],
    mlp_ratio=cfg["model"]["mlp_ratio"], attention="dense", dropout=0.1),
    device="cpu", seed=0)
model.load_state_dict(init)
ddp = lm.wrap(model)
optimizer, schedule = lm.build_optimizer(model, cfg)
tokens = torch.load(folder / "tokens.pt")
rows = tokens.shape[1] // world
for step in range(tokens.shape[0]):
    local = tokens[step, rank * rows:(rank + 1) * rows]
    lm.train_step(ddp, optimizer, schedule, step, local,
                  lambda m, t, dropout_seed: lm.lm_next_token_loss(
                      m, t, train=True, dropout_seed=dropout_seed),
                  dropout_seed=%d)
results["dropout"] = {"params": {k: v.detach().clone() for k, v in
                                 model.state_dict().items()},
                      "calls": ddp.compile_stats()}
out["cases"] = results
torch.save(out, folder / f"rank{rank}.pt")
''' % DROPOUT_SEED


def _env(rendezvous, folder):
    env = dict(os.environ)
    env.update({"FLASHY_TPU_COORDINATOR": f"file://{rendezvous}",
                "PYTHONPATH": os.pathsep.join(
                    [str(ROOT)] + [p for p in env.get("PYTHONPATH", "")
                                   .split(os.pathsep) if p]),
                "OMP_NUM_THREADS": "1"})
    return env


def _spawn(commands, folder, env):
    """Run every command in a session of its own, under one TIMEOUT for
    all; on timeout kill every process group. Returns the exit codes and
    each command's stderr."""
    procs, logs = [], []
    for index, (command, extra) in enumerate(commands):
        log = open(folder / f"spawn{index}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(command, env={**env, **extra},
                                      cwd=folder, stdout=log,
                                      stderr=subprocess.STDOUT,
                                      start_new_session=True))
    try:
        for proc in procs:
            proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for proc in procs:
            proc.wait()
        pytest.fail("spawn timed out: " + " | ".join(
            log.seek(0) or log.read()[-2000:] for log in logs))
    out = []
    for proc, log in zip(procs, logs):
        log.seek(0)
        out.append((proc.returncode, log.read()))
        log.close()
    return out


def _jax_reference(cfg):
    """The JAX package's LMSolver in f32 on the whole global batch for
    cfg's steps: its initial and final parameters in the port's layout,
    and the tokens of each step."""
    import jax
    import jax.numpy as jnp
    import examples.lm.solver as jax_lm
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.models.convert import params_from_jax
    original = jax_lm.TransformerConfig
    jax_lm.TransformerConfig = functools.partial(original, dtype=jnp.float32)
    try:
        with jax_xp():
            solver = jax_lm.LMSolver(JaxConfig({**cfg, "mesh": {"data": 8}}))
            config = solver.model.config
            init = params_from_jax(
                jax.tree.map(np.asarray, solver.state["params"]), config)
            state = solver.state
            tokens = []
            for step in range(cfg["steps_per_epoch"]):
                batch = solver.batch_at(step)
                tokens.append(np.asarray(batch))
                state, _ = solver._train_step(state, batch)
            final = params_from_jax(jax.tree.map(np.asarray,
                                                 state["params"]), config)
    finally:
        jax_lm.TransformerConfig = original
    return init, final, np.stack(tokens)


def _one_process(cfg, init, change, tokens):
    """The port's LMSolver case (or the dropout train_step) in this
    process on the whole batch."""
    from flashy_tpu_torch.examples.lm import solver as lm
    from flashy_tpu_torch.xp import Config, temporary_xp
    original = lm.TransformerConfig
    lm.TransformerConfig = functools.partial(original, dtype=torch.float32)
    try:
        if change is None:  # dropout: train_step on the plain model
            model = lm.TransformerLM(lm.TransformerConfig(
                vocab_size=cfg["model"]["vocab_size"],
                dim=cfg["model"]["dim"],
                num_layers=cfg["model"]["num_layers"],
                num_heads=cfg["model"]["num_heads"],
                mlp_ratio=cfg["model"]["mlp_ratio"], attention="dense",
                dropout=0.1), device="cpu", seed=0)
            model.load_state_dict(init)
            optimizer, schedule = lm.build_optimizer(model, cfg)
            for step in range(tokens.shape[0]):
                lm.train_step(model, optimizer, schedule, step, tokens[step],
                              lambda m, t, dropout_seed: lm.lm_next_token_loss(
                                  m, t, train=True, dropout_seed=dropout_seed),
                              dropout_seed=DROPOUT_SEED)
            return model.state_dict()
        with temporary_xp():
            solver = lm.LMSolver(Config({**cfg, **change}), device="cpu")
            solver.model.load_state_dict(init)
            solver.run_stage("train", solver.train)
            return solver.model.state_dict()
    finally:
        lm.TransformerConfig = original


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_collectives_and_ddp_steps_on_two_gloo_ranks(tmp_path):
    init, jax_final, tokens = _jax_reference(CFG)
    tokens = torch.from_numpy(tokens).long()
    torch.save(init, tmp_path / "init.pt")
    torch.save(tokens, tmp_path / "tokens.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    (tmp_path / "cases.json").write_text(json.dumps(CASES))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = _env(tmp_path / "rendezvous", tmp_path)
    runs = _spawn([([sys.executable, str(script), str(tmp_path)],
                    {"FLASHY_TPU_NUM_PROCESSES": "2",
                     "FLASHY_TPU_PROCESS_ID": str(rank)})
                   for rank in range(2)], tmp_path, env)
    for code, log in runs:
        assert code == 0, log[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    # collectives: identical answers on both ranks, the one-process values
    for out in ranks:
        assert out["world"] == 2
        assert out["all_reduce"] == {"sum": [10.0, 12.0, 14.0, 16.0],
                                     "mean": [5.0, 6.0, 7.0, 8.0],
                                     "max": [10.0, 11.0, 12.0, 13.0],
                                     "min": [0.0, 1.0, 2.0, 3.0]}
        assert out["all_reduce_host"] == [3.0, 1.0]
        assert out["all_reduce_int_mean"] == 1.5
        assert out["all_reduce_max"] == 5
        # weighted: (1 * 1 + 2 * 4) / 5 and 0.5
        assert out["metrics"] == pytest.approx({"loss": 1.8, "acc": 0.5},
                                               rel=1e-12)
        for method in ("reduce", "allgather"):
            assert out[f"average_{method}"] == [True, True, True, "ndarray"]
        assert out["broadcast_model"] == [0.0] * 6
        assert out["broadcast_tensors"][0] == [1.0] * 3
        assert out["broadcast_tensors"][1] == [out["rank"]]  # ints stay
        assert out["broadcast_object"] == {"from": 1}
        assert "Mismatch in synced tree" in out["mismatch"]

    # the tiny LM: both ranks bit-identical, one process and JAX at 1e-5
    for name in list(CASES) + ["dropout"]:
        got = ranks[0]["cases"][name]["params"]
        for key, value in ranks[1]["cases"][name]["params"].items():
            assert torch.equal(got[key], value), (name, key)
        change = CASES.get(name)
        want = _one_process(CFG, init, change, tokens)
        for key, value in want.items():
            assert _rel(got[key], value) <= 1e-5, (name, key)
        if name != "dropout":
            assert ranks[0]["cases"][name]["ddp"] == "DistributedDataParallel"
    assert ranks[0]["cases"]["dropout"]["calls"]["calls"] == 2
    plain = ranks[0]["cases"]["plain"]["params"]
    for key, value in jax_final.items():
        assert _rel(plain[key], value) <= 1e-5, key
    moved = sum(_rel(ranks[0]["cases"]["plain"]["params"][k], init[k])
                for k in init)
    assert moved > 1e-3  # the steps changed the weights


# one warmup step: the schedule is sized by epochs x steps, and with one
# warmup step the 1-epoch run's schedule is the 2-epoch run's first epoch
ARGS = ["device=cpu", "model.vocab_size=64", "model.dim=64",
        "model.num_layers=2", "model.num_heads=2", "model.mlp_ratio=2",
        "seq_len=16", "batch_size=4", "steps_per_epoch=2", "valid_steps=1",
        "warmup_steps=1", "lr=1e-2"]
WALL_CLOCK = ("duration", "tokens_per_sec")


def _main(folder, rendezvous, epochs):
    folder.mkdir(exist_ok=True)
    env = _env(rendezvous, folder)
    command = [sys.executable, "-m", "flashy_tpu_torch.examples.lm.solver",
               *ARGS, f"epochs={epochs}", f"dora.dir={folder}",
               "--workers=2"]
    ((code, log),) = _spawn([(command, {})], folder, env)
    assert code == 0, log[-3000:]
    (xp,) = (folder / "xps").iterdir()
    return xp, log


def _history(xp):
    history = json.loads((xp / "history.json").read_text())
    return [{stage: {k: v for k, v in metrics.items() if k not in WALL_CLOCK}
             for stage, metrics in epoch.items()} for epoch in history]


def test_workers_run_commit_and_resume_as_the_uninterrupted_run(tmp_path):
    from flashy_tpu_torch.checkpoint import load_state
    stop_after = 1
    whole, log = _main(tmp_path / "a", tmp_path / "rdv_a", epochs=2)
    assert "Restored: False" in log
    first, _ = _main(tmp_path / "b", tmp_path / "rdv_b", epochs=stop_after)
    resumed, log = _main(tmp_path / "b", tmp_path / "rdv_c", epochs=2)
    assert resumed == first
    # both ranks restored rank 0's file
    assert log.count(f"Restored: True; starting at epoch {stop_after + 1}") \
        == 2
    for rank in range(2):
        assert (resumed / f"solver.log.{rank}").exists()
    assert len(_history(whole)) == 2
    assert _history(resumed) == _history(whole)
    got = load_state(resumed / "checkpoint.th")
    want = load_state(whole / "checkpoint.th")
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    assert got["state"]["step"] == want["state"]["step"] == 4
    meta = json.loads((resumed / "checkpoint_meta.json").read_text())
    assert meta["topology"]["world_size"] == 2


# The tiny ResNet (f32, stage_sizes (1, 1), 8 filters) under DDP, each of
# two gloo ranks on its half of a batch of 8: every BatchNorm normalizes
# with the global batch's statistics (the JAX step is one program over
# the global batch), so the updated batch_stats and the gradients equal
# one process on the whole batch.
RESNET_WORKER = r'''
import sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.models.resnet import BasicBlock, ResNet
from flashy_tpu_torch.parallel.data_parallel import wrap

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank, world = distrib.rank(), distrib.world_size()
images, labels = torch.load(folder / "batch.pt")
rows = images.shape[0] // world
model = ResNet((1, 1), BasicBlock, num_filters=8, dtype=torch.float32,
               device="cpu")
ddp = wrap(model, broadcast_buffers=False)
local = slice(rank * rows, (rank + 1) * rows)
loss = torch.nn.functional.cross_entropy(ddp(images[local], train=True),
                                         labels[local])
loss.backward()
torch.save({"grads": {n: p.grad for n, p in model.named_parameters()},
            "buffers": dict(model.named_buffers()),
            "ddp": type(ddp).__name__}, folder / f"resnet{rank}.pt")
'''


def test_resnet_batchnorm_on_two_gloo_ranks_is_the_global_batchs(tmp_path):
    from flashy_tpu_torch.models.resnet import BasicBlock, ResNet
    generator = torch.Generator().manual_seed(0)
    images = torch.randn(8, 16, 16, 3, generator=generator)
    labels = torch.randint(0, 10, (8,), generator=generator)
    torch.save((images, labels), tmp_path / "batch.pt")
    script = tmp_path / "resnet_worker.py"
    script.write_text(RESNET_WORKER)
    env = _env(tmp_path / "rendezvous", tmp_path)
    runs = _spawn([([sys.executable, str(script), str(tmp_path)],
                    {"FLASHY_TPU_NUM_PROCESSES": "2",
                     "FLASHY_TPU_PROCESS_ID": str(rank)})
                   for rank in range(2)], tmp_path, env)
    for code, log in runs:
        assert code == 0, log[-3000:]
    ranks = [torch.load(tmp_path / f"resnet{r}.pt") for r in range(2)]
    model = ResNet((1, 1), BasicBlock, num_filters=8, dtype=torch.float32,
                   device="cpu")
    torch.nn.functional.cross_entropy(model(images, train=True),
                                      labels).backward()
    want = {"grads": {n: p.grad for n, p in model.named_parameters()},
            "buffers": dict(model.named_buffers())}
    for out in ranks:
        assert out["ddp"] == "DistributedDataParallel"
        for kind in ("grads", "buffers"):
            assert set(out[kind]) == set(want[kind])
            for name, value in want[kind].items():
                scale = float(value.abs().max())
                err = float((out[kind][name] - value).abs().max())
                assert err <= 1e-5 * max(scale, 1e-30), (kind, name, err)
    # the statistics moved: each rank saw the global batch, not its half
    assert any(float(b.abs().max()) > 0 for n, b in
               ranks[0]["buffers"].items() if n.endswith(".mean"))
