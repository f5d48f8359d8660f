# ZeRO-1 and FSDP across processes on the CPU (queue A item 8a): a spawn
# of two gloo ranks rendezvousing through a file:// path in tmp_path
# (test_torch_distrib_multiproc.py's `_spawn`), under its 60 s timeout,
# and a spawn of four for HSDP (the last test). Each of the two runs:
#
#  1. a least-squares weight [64, 32] under DDP, under `wrap(model,
#     state_sharding=zero_sharding(...))` and under the explicit
#     `zero_update`, both with `with_grad_accumulation` (2
#     microbatches), two AdamW steps each, on its rows of a global batch
#     of 16: held here to each other and to the JAX package's
#     `wrap(step, state_sharding=...)` on a {"data": 2} mesh at 1e-5;
#  2. the tiny LM (2 layers, dim 64, f32, remat on, tied head) through
#     the port's LMSolver under mesh.fsdp=2 and under DDP, two clipped
#     steps from the JAX LMSolver's weights (params_from_jax), held to
#     the JAX LMSolver with mesh.fsdp=2 on the whole batch and to each
#     other, then a single-file commit (gathered, written by rank 0)
#     holding the full parameters;
#  3. the accounting of one step of each layout;
#  4. the reference's ZeRO checkpoint round trip: a solver declaring its
#     optimizer state zero1-sharded commits slots on both ranks, restores
#     onto the declared shards, writes checkpoint_meta.json
#     zero1(data=2), saves asynchronously; then here, in one process,
#     `info` prints the layout, `info --verify-checkpoint` passes over
#     every rank's file, and a restore on one rank raises naming 8e.
import functools
import json
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distrib_multiproc import _env, _rel, _spawn

CFG = {
    "model": {"vocab_size": 64, "dim": 64, "num_layers": 2, "num_heads": 2,
              "mlp_ratio": 2, "attention": "dense", "remat": True},
    "mesh": {"data": -1, "fsdp": 2}, "seq_len": 16, "batch_size": 8,
    "accumulate": 1, "steps_per_epoch": 2, "epochs": 1, "valid_steps": 0,
    "generate_every": 0, "lr": 1e-2, "warmup_steps": 1,
    "weight_decay": 0.1, "device": "cpu"}
ROWS, N, M, LR = 16, 64, 32, 1e-2

# the solver of the reference's test_solver_zero_checkpoint_roundtrip,
# its optimizer state declared zero1 over the data axis: each rank holds
# the rows of the moments it updates, and gathers the fresh weight
ZSOLVER = r'''
import torch
from flashy_tpu_torch import distrib
from flashy_tpu_torch.parallel import make_mesh, zero_sharding
from flashy_tpu_torch.parallel.sharding import place
from flashy_tpu_torch.solver import BaseSolver


class ZSolver(BaseSolver):
    checkpoint_mode = "auto"

    def __init__(self):
        super().__init__()
        self.mesh = make_mesh({"data": -1})
        self.params = {"w": torch.arange(256.0).reshape(32, 8)}
        full = [{"w": torch.zeros(32, 8)}, {"w": torch.zeros(32, 8)},
                torch.zeros(())]
        self.spec = zero_sharding(full, self.mesh, min_size=1)
        self.opt_state = place(full, self.spec)
        self.register_stateful("params", "opt_state")
        self.set_state_sharding("opt_state", self.spec)

    def train_stage(self):
        mu, nu, count = self.opt_state
        sharding = self.spec[0]["w"]
        grad = sharding.shard(torch.ones(32, 8))
        mu = {"w": 0.9 * mu["w"] + 0.1 * grad}
        nu = {"w": 0.999 * nu["w"] + 0.001 * grad * grad}
        local = sharding.shard(self.params["w"]) \
            - 1e-2 * mu["w"] / (nu["w"].sqrt() + 1e-8)
        gathered = distrib.all_gather(local.reshape(-1),
                                      self.mesh.group("data"))
        self.params["w"] = gathered.view(32, 8)
        self.opt_state[:] = [mu, nu, count + 1]
        return {"loss": 1.0}

    def run(self):
        pass
'''

WORKER = r'''
import functools, json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.parallel import (collective_stats, count_collectives,
                                       make_mesh, model_state, wrap,
                                       zero_sharding, zero_update)
from flashy_tpu_torch.parallel.data_parallel import with_grad_accumulation
from flashy_tpu_torch.xp import Config, create_xp, temporary_xp

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank, world = distrib.rank(), distrib.world_size()
out = {"rank": rank}
N, M, LR = %d, %d, %g
batch = torch.load(folder / "lsq.pt")
rows = batch["x"].shape[0] // world
x, y = (batch[k][rank * rows:(rank + 1) * rows] for k in ("x", "y"))


class Weight(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(batch["w"].clone())

    def forward(self, x):
        return x @ self.w


def loss_and_grad(model, rows_x, rows_y):
    loss = ((model(rows_x) - rows_y) ** 2).mean()
    loss.backward()
    return loss.detach()


def grad_fn(model, xy):
    return loss_and_grad(model, xy[:, :N], xy[:, N:])


adamw = functools.partial(torch.optim.AdamW, lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4)
xy = torch.cat([x, y], dim=1)
mesh = make_mesh({"data": -1})
lsq, stats = {}, {}
for mode in ("ddp", "zero1", "zero_update"):
    model = Weight()
    if mode == "zero_update":
        step = zero_update(with_grad_accumulation(grad_fn, 2), adamw,
                           mesh=mesh, min_size=1)
    else:
        wrapped = wrap(model) if mode == "ddp" else wrap(
            model, state_sharding=zero_sharding(model_state(model), mesh,
                                                min_size=1))
        optimizer = adamw(wrapped.parameters())
        accumulated = with_grad_accumulation(grad_fn, 2)

        def step(model, xy):
            optimizer.zero_grad(set_to_none=True)
            loss = accumulated(wrapped, xy)
            optimizer.step()
            return {"loss": loss}
    for index in range(2):
        with count_collectives() as record:
            step(model, xy)
    stats[mode] = collective_stats(record)
    lsq[mode] = model.w.detach().clone()
    if mode == "zero1":
        lsq["zero1_update_shape"] = list(optimizer.state_dict()["state"][0]
                                         ["exp_avg"].shape)
out["lsq"], out["lsq_stats"] = lsq, stats

# ---- the tiny LM under mesh.fsdp=2 and under DDP
lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
cfg = json.loads((folder / "cfg.json").read_text())
init = torch.load(folder / "init.pt")
runs = {}
for name, mesh_cfg in (("fsdp", {"data": -1, "fsdp": 2}),
                       ("ddp", {"data": -1})):
    with temporary_xp():
        solver = lm.LMSolver(Config({**cfg, "mesh": mesh_cfg}), device="cpu")
        sharded = getattr(solver.model, "_sharded", None)
        solver.model.load_state_dict(
            init if sharded is None else {
                key: sharded.shardings[key].shard(value).clone()
                for key, value in init.items()})
        metrics = solver.run_stage("train", solver.train)
        with count_collectives() as record:
            lm.train_step(solver.train_model, solver.optimizer,
                          solver.schedule, 2, solver.batch_at(2),
                          lambda m, t: solver.loss(t, model=m))
        summon = getattr(solver.model, "summon_full_params", None)
        with summon() if summon else torch.no_grad():
            params = {k: v.detach().clone()
                      for k, v in solver.model.state_dict().items()}
        # a single file: gathered on both ranks, written by rank 0, whole
        solver.commit()
        if rank == 0:
            from flashy_tpu_torch.checkpoint import load_state
            saved = load_state(solver.checkpoint_path)["model"]
            out.setdefault("single_file", {})[name] = all(
                torch.equal(saved[k], v) for k, v in params.items())
        runs[name] = {"params": params, "metrics": metrics,
                      "stats": collective_stats(record),
                      "wrapped": type(solver.train_model).__name__,
                      "local_bytes": sum(p.numel() * p.element_size()
                                         for p in solver.model.parameters()),
                      "sharded_bytes": sum(
                          p.numel() * p.element_size() for p in
                          solver.model.parameters()
                          if getattr(p, "sharding", None) is not None
                          and not p.sharding.is_replicated)}
        if sharded is not None:
            runs[name]["mode"] = sharded.mode
            runs[name]["shapes"] = {k: list(p.shape) for k, p in
                                    solver.model.named_parameters()}
            runs[name]["moments"] = list(solver.optimizer.state_dict()[
                "state"][0]["exp_avg"].shape)
out["lm"] = runs

# ---- the ZeRO checkpoint round trip across the ranks
exec((folder / "zsolver.py").read_text())
xp = create_xp(Config({"name": "zero"}), root=folder / "zxp")
with xp.enter():
    solver = ZSolver()
    solver.run_stage("train", solver.train_stage)
    solver.commit()
    ck = {"mode": solver._resolve_checkpoint_mode(solver.state_dict()),
          "slots": solver.sharded_checkpoint_path.exists(),
          "mu": solver.opt_state[0]["w"].clone(),
          "w": solver.params["w"].clone()}
    xp.link.load()
    solver2 = ZSolver()
    ck["restored"] = solver2.restore()
    ck["mu2"] = solver2.opt_state[0]["w"].clone()
    ck["w2"] = solver2.params["w"].clone()
    ck["epoch2"] = solver2.epoch
    # an asynchronous save on both ranks, committed at finalize
    solver2.checkpoint_async = True
    solver2.run_stage("train", solver2.train_stage)
    solver2.commit()
    solver2.finalize_checkpoints()
    solver3 = ZSolver()
    ck["restored3"] = solver3.restore()
    ck["epoch3"] = solver3.epoch
    ck["mu3"], ck["mu_async"] = (solver3.opt_state[0]["w"].clone(),
                                 solver2.opt_state[0]["w"].clone())
    ck["folder"] = str(solver.folder)
out["ckpt"] = ck
torch.save(out, folder / f"rank{rank}.pt")
''' % (N, M, LR)


def _jax_zero_reference(batch):
    """The JAX package's wrap(step, state_sharding=zero_sharding(...)) on
    a {"data": 2} mesh, the whole batch, two optax.adamw steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from flashy_tpu.parallel import make_mesh, shard_batch, wrap
    from flashy_tpu.parallel import zero_sharding
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    optim = optax.adamw(LR)
    params = {"w": jnp.asarray(batch["w"].numpy())}
    state = {"params": params, "opt_state": optim.init(params)}

    def step(state, data):
        def loss_fn(params):
            return jnp.mean((data["x"] @ params["w"] - data["y"]) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = optim.update(grads, state["opt_state"],
                                          state["params"])
        return ({"params": optax.apply_updates(state["params"], updates),
                 "opt_state": opt_state}, {"loss": loss})

    spec = zero_sharding(state, mesh, min_size=1)
    wrapped = wrap(step, mesh=mesh, batch_axes=("data",),
                   state_sharding=spec, donate_state=False)
    data = shard_batch({k: batch[k].numpy() for k in ("x", "y")}, mesh,
                       batch_axes=("data",))
    state = jax.device_put(state, spec)
    for _ in range(2):
        state, _ = wrapped(state, data)
    return torch.from_numpy(np.asarray(state["params"]["w"]))


def _jax_lm_reference(cfg):
    """The JAX LMSolver in f32 with mesh.fsdp=2 (data 4 x fsdp 2 over the
    8 virtual devices) on the whole batch for cfg's steps: its initial
    and final parameters in the port's layout."""
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
            solver = jax_lm.LMSolver(JaxConfig(
                {**cfg, "mesh": {"data": 4, "fsdp": 2}}))
            config = solver.model.config
            init = params_from_jax(
                jax.tree.map(np.asarray, solver.state["params"]), config)
            state = solver.state
            for step in range(cfg["steps_per_epoch"]):
                state, _ = solver._train_step(state, solver.batch_at(step))
            final = params_from_jax(jax.tree.map(np.asarray,
                                                 state["params"]), config)
    finally:
        jax_lm.TransformerConfig = original
    return init, final


def test_zero1_and_fsdp_on_two_gloo_ranks_match_ddp_and_jax(tmp_path,
                                                            capsys):
    generator = torch.Generator().manual_seed(0)
    batch = {"w": torch.randn(N, M, generator=generator),
             "x": torch.randn(ROWS, N, generator=generator),
             "y": torch.randn(ROWS, M, generator=generator)}
    torch.save(batch, tmp_path / "lsq.pt")
    init, jax_final = _jax_lm_reference(CFG)
    torch.save(init, tmp_path / "init.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    (tmp_path / "zsolver.py").write_text(ZSOLVER)
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

    # 1. ZeRO-1 (declared and explicit) against DDP and the JAX wrap
    jax_w = _jax_zero_reference(batch)
    for out in ranks:
        lsq = out["lsq"]
        for mode in ("zero1", "zero_update"):
            assert _rel(lsq[mode], lsq["ddp"]) <= 1e-5, mode
            assert _rel(lsq[mode], jax_w) <= 1e-5, mode
        assert _rel(lsq["ddp"], jax_w) <= 1e-5
        # the moments are the rank's half of the rows
        assert lsq["zero1_update_shape"] == [N // 2, M]
        assert torch.equal(lsq["zero1"], ranks[0]["lsq"]["zero1"])
    moved = _rel(ranks[0]["lsq"]["ddp"], batch["w"])
    assert moved > 1e-3

    # 2. the tiny LM under FSDP: both ranks equal, JAX and DDP at 1e-5
    fsdp, ddp = ranks[0]["lm"]["fsdp"], ranks[0]["lm"]["ddp"]
    assert fsdp["mode"] == "fsdp" and ddp["wrapped"] == \
        "DistributedDataParallel"
    for key, value in ranks[1]["lm"]["fsdp"]["params"].items():
        assert torch.equal(fsdp["params"][key], value), key
    for key, value in jax_final.items():
        assert _rel(fsdp["params"][key], value) <= 1e-5, key
        assert _rel(fsdp["params"][key], ddp["params"][key]) <= 1e-5, key
    assert fsdp["metrics"]["grad_norm"] == pytest.approx(
        ddp["metrics"]["grad_norm"], rel=1e-5)
    # each parameter held as the rank's shard under transformer_shardings
    assert fsdp["shapes"]["embed"] == [64, 32]
    assert fsdp["shapes"]["block_0.attn.qkv.kernel"] == [32, 3, 2, 32]
    assert fsdp["shapes"]["block_0.norm1.scale"] == [64]
    assert fsdp["moments"] == fsdp["shapes"]["embed"]
    # the single file holds the full parameters, as one process loads them
    assert ranks[0]["single_file"] == {"fsdp": True, "ddp": True}

    # 3. the accounting of one step
    params_bytes = 64 * 32 * 4
    lsq_stats = ranks[0]["lsq_stats"]
    assert lsq_stats["ddp"]["all-reduce"]["bytes"] == params_bytes
    assert lsq_stats["ddp"]["all-gather"]["count"] == 0
    assert lsq_stats["zero1"]["reduce-scatter"] == {
        "count": 1, "bytes": params_bytes // 2}
    assert 0 < lsq_stats["zero1"]["all-gather"]["bytes"] \
        <= 1.5 * params_bytes
    assert lsq_stats["zero_update"]["reduce-scatter"]["count"] == 1
    assert lsq_stats["zero_update"]["all-gather"]["bytes"] == params_bytes
    sharded_full = 2 * fsdp["sharded_bytes"]
    stats = fsdp["stats"]
    # forward: every sharded parameter gathered once; the backward
    # gathers again (remat's recompute, the tied embedding's saved use)
    assert stats["all-gather"]["bytes"] == 2 * sharded_full
    assert stats["reduce-scatter"]["bytes"] == sharded_full // 2
    assert stats["reduce-scatter"]["count"] == 3  # embed and two blocks
    assert ddp["stats"]["all-reduce"]["bytes"] >= ddp["local_bytes"]
    assert ddp["stats"]["reduce-scatter"]["count"] == 0
    assert fsdp["local_bytes"] < ddp["local_bytes"]

    # 4. the ZeRO checkpoint round trip across the ranks
    for out in ranks:
        ck = out["ckpt"]
        assert ck["mode"] == "sharded" and ck["slots"]
        assert ck["restored"] and ck["epoch2"] == 2
        assert ck["mu2"].shape == (16, 8)
        assert torch.equal(ck["mu2"], ck["mu"])
        assert torch.equal(ck["w2"], ck["w"])
        assert ck["restored3"] and ck["epoch3"] == 3
        assert torch.equal(ck["mu3"], ck["mu_async"])
    from pathlib import Path
    from flashy_tpu_torch import info
    from flashy_tpu_torch.checkpoint import read_slot_pointer, slot_manifest
    folder = Path(ranks[0]["ckpt"]["folder"])
    slots = folder / "checkpoint.th.sharded"
    manifest = slot_manifest(slots / read_slot_pointer(slots))
    assert set(manifest["files"]) == {"state.pkl", "arrays.pt",
                                      "arrays-0.pt", "arrays-1.pt"}
    assert manifest["world"] == 2
    assert manifest["layout"]["['opt_state'][0]['w']"] == {
        "spec": ["data", None], "mesh": {"data": 2, "fsdp": 1, "expert": 1,
                                         "pipe": 1, "tensor": 1, "seq": 1}}
    meta = json.loads((folder / "checkpoint_meta.json").read_text())
    assert meta["mode"] == "sharded"
    assert meta["state_sharding"]["summary"] == "zero1(data=2)"
    root = folder.parent.parent
    capsys.readouterr()
    assert info.main([str(root)]) == 0
    assert "state-sharding=zero1(data=2)" in capsys.readouterr().out
    assert info.verify_checkpoints(root) == 0
    # a restore on another world size raises, naming item 8e
    from flashy_tpu_torch.xp import Config, create_xp
    namespace = {}
    exec(ZSOLVER, namespace)
    xp = create_xp(Config({"name": "zero"}), root=tmp_path / "zxp")
    with xp.enter():
        with pytest.raises(NotImplementedError, match="queue A item 8e"):
            namespace["ZSolver"]().restore()


# HSDP: four gloo ranks on a data 2 x fsdp 2 mesh. FSDP shards over the
# fsdp groups ({0, 1}, {2, 3}) and all-reduces over the data groups
# ({0, 2}, {1, 3}); ZeRO-1 over data keeps compute replicated on all four.
HSDP_WORKER = r'''
import sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                 TransformerLM,
                                                 transformer_shardings)
from flashy_tpu_torch.parallel import make_mesh, model_state, wrap
from flashy_tpu_torch.parallel import zero_sharding
from flashy_tpu_torch.parallel.data_parallel import grad_norm

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank = distrib.rank()
tokens = torch.load(folder / "tokens.pt")
local = tokens[rank * 2:(rank + 1) * 2]
cfg = TransformerConfig(vocab_size=64, dim=64, num_layers=2, num_heads=2,
                        mlp_ratio=2, attention="dense", dtype=torch.float32)
out = {}
for mode in ("ddp", "hsdp", "zero1"):
    model = TransformerLM(cfg, device="cpu", seed=0)
    mesh = make_mesh({"data": 2, "fsdp": 2})
    if mode == "ddp":
        wrapped = wrap(model)
    elif mode == "hsdp":
        wrapped = wrap(model, mesh=mesh, fsdp=True,
                       state_sharding=transformer_shardings(
                           dict(model.named_parameters())))
    else:
        wrapped = wrap(model, mesh=mesh, state_sharding=zero_sharding(
            model_state(model), mesh, min_size=1))
    optimizer = torch.optim.AdamW(wrapped.parameters(), lr=1e-2)
    for _ in range(2):
        optimizer.zero_grad(set_to_none=True)
        logits = wrapped(local)
        torch.nn.functional.cross_entropy(
            logits[:, :-1].flatten(0, 1), local[:, 1:].flatten()).backward()
        norm = float(grad_norm(wrapped.parameters()))
        optimizer.step()
    summon = getattr(model, "summon_full_params", None)
    with summon() if summon else torch.no_grad():
        out[mode] = ({k: v.detach().clone()
                      for k, v in model.state_dict().items()}, norm)
torch.save(out, folder / f"hsdp{rank}.pt")
'''


def test_hsdp_and_zero1_on_four_gloo_ranks_match_ddp(tmp_path):
    tokens = torch.randint(0, 64, (8, 16),
                           generator=torch.Generator().manual_seed(1))
    torch.save(tokens, tmp_path / "tokens.pt")
    script = tmp_path / "hsdp_worker.py"
    script.write_text(HSDP_WORKER)
    env = _env(tmp_path / "rendezvous", tmp_path)
    runs = _spawn([([sys.executable, str(script), str(tmp_path)],
                    {"FLASHY_TPU_NUM_PROCESSES": "4",
                     "FLASHY_TPU_PROCESS_ID": str(rank)})
                   for rank in range(4)], tmp_path, env)
    for code, log in runs:
        assert code == 0, log[-3000:]
    ranks = [torch.load(tmp_path / f"hsdp{r}.pt") for r in range(4)]
    for out in ranks:
        want, want_norm = out["ddp"]
        for mode in ("hsdp", "zero1"):
            got, norm = out[mode]
            assert norm == pytest.approx(want_norm, rel=1e-6), mode
            for key, value in want.items():
                assert _rel(got[key], value) <= 1e-5, (mode, key)
            for key, value in ranks[0][mode][0].items():
                assert torch.equal(got[key], value), (mode, key)
