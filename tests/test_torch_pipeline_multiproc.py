# Pipeline parallelism across processes on the CPU (queue A item 8c): a
# spawn of two gloo ranks (pipe 2) and one of four (pipe 2 x data 2 and
# pipe 2 x tensor 2), rendezvousing through a file:// path in tmp_path
# (test_torch_distrib_multiproc.py's `_spawn`). The two ranks run:
#
#  1. `pipeline` (GPipe) forward and gradient against the JAX `pipeline`
#     on test_parallel.py's stage function (forward atol 1e-6, gradient
#     rtol 1e-4 / atol 1e-5);
#  2. `pipeline_1f1b` at v 1 and 2 against the port's GPipe and the JAX
#     GPipe gradient; packed against unpacked BITWISE, with and without
#     `overlap`;
#  3. `pipelined_apply` (gpipe, and 1f1b at v 2) against the JAX one;
#  4. `pipelined_value_and_grad` (gpipe, 1f1b at v 2, packed) against the
#     JAX gpipe one, and MoE (1f1b) against the JAX sequential oracle;
#  5. the LM solver at mesh.pipe=2 (1f1b, v 2) from the JAX LMSolver's
#     weights: its first-step loss against the JAX LMSolver at pipe 2
#     (1e-3), its losses and parameters against the port's pipe=1 solver
#     step by step (1e-5);
#  6. checkpoint and resume across the pipe ranks, bit-identical;
#  7. the `pipeline.tick` and `pipeline.packed_tick` faults raised on
#     every rank before any send, and the ranks carry on (no hang);
#  8. the refusals (fsdp or ZeRO-1 with pipe, loss=chunked with pipe)
#     and the bench through `main` (its gates but packed's timing).
# The four ranks run the LM solver at pipe 2 x data 2 (each stage's data
# ranks averaging their gradients) against the two-rank run, and the
# bench's `tensor_compose` (pipe 2 x tensor 2 against pipe 2 x data 2).
import functools
import json
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distrib_multiproc import _env, _rel, _spawn

CFG = {
    "model": {"vocab_size": 64, "dim": 32, "num_layers": 4, "num_heads": 2,
              "mlp_ratio": 2, "attention": "dense", "scan_layers": True},
    "mesh": {"data": -1, "pipe": 2}, "seq_len": 16, "batch_size": 8,
    "accumulate": 1, "steps_per_epoch": 2, "epochs": 1, "valid_steps": 1,
    "generate_every": 0, "lr": 1e-3, "warmup_steps": 1,
    "weight_decay": 0.0, "device": "cpu", "pipeline_schedule": "1f1b",
    "pipeline_interleave": 2, "pipeline_microbatches": 4}
LM = dict(vocab_size=64, dim=32, num_layers=4, num_heads=4,
          attention="dense", scan_layers=True)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=8.0)

WORKER = r'''
import functools, json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.models import (pipelined_apply,
                                     pipelined_value_and_grad)
from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                 TransformerLM)
from flashy_tpu_torch.parallel import (make_mesh, pipeline, pipeline_1f1b,
                                       wrap)
import importlib
pipeline_mod = importlib.import_module("flashy_tpu_torch.parallel.pipeline")
from flashy_tpu_torch.resilience import chaos
from flashy_tpu_torch.xp import Config, create_xp, temporary_xp

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank = distrib.rank()
mesh = make_mesh({"pipe": 2})
group = mesh.group("pipe")
data = torch.load(folder / "data.pt")
out = {"rank": rank}


def tanh(p, h):
    return torch.tanh(h @ p["w"])


def chain(p, h):
    for w in p["w"]:
        h = torch.tanh(h @ w)
    return h


def mean_sq(lp, h):
    return (h ** 2).mean()


# ---- 1. GPipe against the JAX pipeline
w = data["w"].clone().requires_grad_(True)
y = pipeline(tanh, {"w": w}, data["x"], mesh=mesh, num_microbatches=4)
(y ** 2).sum().backward()
out["gpipe"] = (y.detach(), distrib.all_reduce(w.grad, "sum", group))

# ---- 2. 1F1B at v 1 and 2: GPipe oracles, packed bitwise
for v in (1, 2):
    wc = data[f"wc{v}"]
    runs = {}
    for packed, overlap in ((False, False), (True, False), (True, True)):
        if overlap and v > 1:
            continue
        loss, grads = pipeline_1f1b(
            tanh, {"w": wc}, data["x"], loss_fn=mean_sq, mesh=mesh,
            num_microbatches=4, interleave=v, packed=packed,
            overlap=overlap)
        runs[(packed, overlap)] = (loss, grads["stage_params"]["w"],
                                   grads["x"])
    wg = wc.reshape(2, v, 16, 16).clone().requires_grad_(True)
    yg = pipeline(chain, {"w": wg}, data["x"], mesh=mesh, num_microbatches=4)
    (yg ** 2).mean().backward()
    out[f"1f1b{v}"] = {"runs": runs, "gpipe": distrib.all_reduce(
        wg.grad, "sum", group).reshape(2 * v, 16, 16)}
    out[f"1f1b{v}_forward"] = pipeline_1f1b(
        tanh, {"w": wc}, data["x"], mesh=mesh, num_microbatches=4,
        interleave=v)

# ---- 3-4. the LM: pipelined_apply and pipelined_value_and_grad
tokens = data["tokens"]
for moe in (False, True):
    cfg = TransformerConfig(**data["lm"], **(data["moe"] if moe else {}),
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(data["moe_params" if moe else "params"])
    weight = 0.01 if moe else 0.0
    got = {}
    if not moe:
        with torch.no_grad():
            got["apply_gpipe"] = pipelined_apply(model, tokens, mesh=mesh,
                                                 num_microbatches=4)
            got["apply_1f1b"] = pipelined_apply(
                model, tokens, mesh=mesh, num_microbatches=4,
                schedule="1f1b", interleave=2)
    for schedule, v in (("gpipe", 1), ("1f1b", 2), ("packed_1f1b", 1),
                        ("1f1b", 1)):
        if moe and schedule != "1f1b":
            continue
        got[f"{schedule}{v}"] = pipelined_value_and_grad(
            model, mesh=mesh, num_microbatches=4, interleave=v,
            schedule=schedule, aux_weight=weight)(None, tokens)
    out["moe" if moe else "dense"] = got

# ---- 5. the LM solver at pipe 2 from the JAX solver's weights
lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
cfg = json.loads((folder / "cfg.json").read_text())


def load_sliced(model, full):
    sh = model._sharded.shardings
    model.load_state_dict({k: sh[k].shard(v).clone() if k in sh else v
                           for k, v in full.items()})


def full_state(solver):
    with solver.model.summon_full_params():
        return {k: v.detach().clone()
                for k, v in solver.model.state_dict().items()}


with temporary_xp():
    solver = lm.LMSolver(Config(cfg), device="cpu")
    load_sliced(solver.model, data["jax_init"])
    metrics = solver.run_stage("train", solver.train)
    valid = solver.run_stage("valid", solver.valid)
    out["solver"] = {"losses": solver.step_losses, "params": full_state(
        solver), "metrics": metrics, "valid": valid,
        "shapes": {k: list(p.shape) for k, p in
                   solver.model.named_parameters()},
        "wrapped": type(solver.train_model).__name__}

# ---- 6. checkpoint and resume across the pipe ranks
def run(xp_cfg, epochs):
    solver = lm.LMSolver(Config({**xp_cfg, "epochs": epochs}), device="cpu")
    load_sliced(solver.model, data["jax_init"])
    solver.run()
    return solver


ck = {}
xp = create_xp(Config({**cfg, "epochs": 2}), root=folder / "pxp-a")
with xp.enter():
    whole = run(cfg, 2)
    ck["whole"] = full_state(whole)
    ck["whole_local"] = {k: v.clone() for k, v in
                         whole.optimizer.state_dict()["state"][0].items()}
for mode in ("sharded", "single"):
    lm.LMSolver.checkpoint_mode = mode
    xp = create_xp(Config({**cfg, "epochs": 2}), root=folder / f"pxp-{mode}")
    with xp.enter():
        first = run(cfg, 1)
        resumed = run(cfg, 2)
        ck[mode] = {"restored": resumed.restored,
                    "resumed": full_state(resumed),
                    "local": {k: v.clone() for k, v in resumed.optimizer
                              .state_dict()["state"][0].items()},
                    "folder": str(resumed.folder)}
out["ckpt"] = ck

# ---- 7. the tick faults: raised on every rank before any send
faults = {}
for site, packed in (("pipeline.tick", False), ("pipeline.packed_tick",
                                                True)):
    injector = chaos.install()
    injector.fail_at(site, call=1)
    try:
        pipeline_1f1b(tanh, {"w": data["wc1"]}, data["x"], loss_fn=mean_sq,
                      mesh=mesh, num_microbatches=4, packed=packed)
        faults[site] = None
    except OSError as exc:
        faults[site] = type(exc).__name__
    finally:
        chaos.uninstall(verify=False)
    # the ranks carry on together: a collective and a clean run
    faults[site + ".after"] = float(distrib.all_reduce(
        torch.ones(()), "sum", group))
    loss, _ = pipeline_1f1b(tanh, {"w": data["wc1"]}, data["x"],
                            loss_fn=mean_sq, mesh=mesh, num_microbatches=4,
                            packed=packed)
    faults[site + ".loss"] = float(loss)
out["faults"] = faults

# ---- 8. refusals and the bench
refusals = {}
model = TransformerLM(TransformerConfig(**data["lm"], dtype=torch.float32),
                      device="cpu")
for name, kwargs in (("fsdp", {"fsdp": True}),
                     ("zero1", {"state_sharding": {"opt_state": {}}})):
    try:
        wrap(model, mesh=mesh, **kwargs)
        refusals[name] = None
    except NotImplementedError as exc:
        refusals[name] = str(exc)
with temporary_xp():
    try:
        lm.LMSolver(Config({**cfg, "loss": "chunked"}), device="cpu")
        refusals["chunked"] = None
    except ValueError as exc:
        refusals["chunked"] = str(exc)
out["refusals"] = refusals
out["bench_rc"] = pipeline_mod.main(
    ["--device", "cpu", "--steps", "1", "--micro", "4", "--seq", "8",
     "--no-moe", "--json", str(folder / "bench.json")])
torch.save(out, folder / f"rank{rank}.pt")
'''


def _jax_references(tokens, x, w, wcs):
    """The JAX package's values on the 8 virtual devices, pipe 2 x data 4:
    the GPipe forward and gradient of test_parallel.py's stage function,
    the GPipe gradient of each chained-chunk stack, and the tiny LM's
    pipelined_apply and value-and-grad (dense gpipe; MoE sequential),
    their weights in the port's layout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu.models.pipelined import (pipelined_apply,
                                             pipelined_value_and_grad,
                                             sequential_value_and_grad)
    from flashy_tpu.parallel import make_mesh, pipeline
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import TransformerConfig
    mesh = make_mesh({"pipe": 2, "data": 4})
    out = {}

    def stage(p, h):
        return jnp.tanh(h @ p["w"])

    jx = jnp.asarray(x.numpy())
    sharded = jax.device_put({"w": jnp.asarray(w.numpy())},
                             NamedSharding(mesh, P("pipe")))
    out["y"] = np.asarray(jax.jit(lambda p, x: pipeline(
        stage, p, x, mesh=mesh, num_microbatches=4))(sharded, jx))
    out["w_grad"] = np.asarray(jax.jit(jax.grad(lambda p, x: (pipeline(
        stage, p, x, mesh=mesh, num_microbatches=4) ** 2).sum()))(
            sharded, jx)["w"])

    def chain(p, h):
        for c in range(p["w"].shape[0]):
            h = jnp.tanh(h @ p["w"][c])
        return h

    for v, wc in wcs.items():
        stacked = jax.device_put(
            {"w": jnp.asarray(wc.numpy()).reshape(2, v, 16, 16)},
            NamedSharding(mesh, P("pipe")))
        grad = jax.jit(jax.grad(lambda p, x: (pipeline(
            chain, p, x, mesh=mesh, num_microbatches=4) ** 2).mean()))(
                stacked, jx)["w"]
        out[f"wc{v}_grad"] = np.asarray(grad).reshape(2 * v, 16, 16)
    jt = jnp.asarray(tokens.numpy(), jnp.int32)
    for moe in (False, True):
        kwargs = {**LM, **(MOE if moe else {})}
        model = JaxLM(JaxConfig(**kwargs, dtype=jnp.float32))
        variables = {"params": jax.jit(model.init)(
            jax.random.PRNGKey(5), jt)["params"]}
        cfg = TransformerConfig(**kwargs)
        tag = "moe" if moe else "dense"
        out[f"{tag}_params"] = params_from_jax(
            jax.tree.map(np.asarray, variables), cfg)
        if moe:
            loss, grads = jax.jit(sequential_value_and_grad(
                model, num_microbatches=4, aux_weight=0.01))(variables, jt)
        else:
            out["apply_gpipe"] = np.asarray(jax.jit(lambda v, t: (
                pipelined_apply(model, v, t, mesh=mesh,
                                num_microbatches=4)))(variables, jt))
            out["apply_1f1b"] = np.asarray(jax.jit(lambda v, t: (
                pipelined_apply(model, v, t, mesh=mesh, num_microbatches=4,
                                schedule="1f1b", interleave=2)))(
                                    variables, jt))
            loss, grads = jax.jit(pipelined_value_and_grad(
                model, mesh=mesh, num_microbatches=4, schedule="gpipe"))(
                    variables, jt)
        out[f"{tag}_loss"] = float(loss)
        out[f"{tag}_grads"] = params_from_jax(jax.tree.map(np.asarray,
                                                           grads), cfg)
    return out


def _jax_solver(cfg):
    """The JAX LMSolver in f32 at pipe 2 x data 4 (its gpipe schedule):
    its initial parameters in the port's layout and its first step's
    loss."""
    import jax
    import jax.numpy as jnp
    import examples.lm.solver as jax_lm
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.models.convert import params_from_jax
    keys = ("model", "seq_len", "batch_size", "accumulate",
            "steps_per_epoch", "epochs", "generate_every", "lr",
            "warmup_steps", "weight_decay")
    original = jax_lm.TransformerConfig
    jax_lm.TransformerConfig = functools.partial(original, dtype=jnp.float32)
    try:
        with jax_xp():
            solver = jax_lm.LMSolver(JaxConfig(
                {**{k: cfg[k] for k in keys},
                 "mesh": {"data": 4, "pipe": 2},
                 "pipeline_microbatches": 4}))
            init = params_from_jax(
                jax.tree.map(np.asarray, solver.state["params"]),
                solver.model.config)
            _, metrics = solver._train_step(solver.state, solver.batch_at(0))
            loss = float(jax.device_get(metrics["loss"]))
    finally:
        jax_lm.TransformerConfig = original
    return init, loss


def _one_process_solver(cfg, init):
    """The port's LM solver at pipe=1 (the stacked layout) from `init`:
    its step losses and final parameters."""
    from flashy_tpu_torch.examples.lm import solver as lm
    from flashy_tpu_torch.xp import Config, temporary_xp
    original = lm.TransformerConfig
    lm.TransformerConfig = functools.partial(original, dtype=torch.float32)
    try:
        with temporary_xp():
            solver = lm.LMSolver(Config({**cfg, "mesh": {"data": -1}}),
                                 device="cpu")
            solver.model.load_state_dict(init)
            solver.run_stage("train", solver.train)
            valid = solver.run_stage("valid", solver.valid)
            return solver.step_losses, {
                k: v.detach().clone()
                for k, v in solver.model.state_dict().items()}, valid
    finally:
        lm.TransformerConfig = original


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5, err_msg=what)


def _spawn_ranks(tmp_path, script, ranks, tag):
    env = _env(tmp_path / f"rendezvous-{tag}", tmp_path)
    runs = _spawn([([sys.executable, str(script), str(tmp_path)],
                    {"FLASHY_TPU_NUM_PROCESSES": str(ranks),
                     "FLASHY_TPU_PROCESS_ID": str(rank)})
                   for rank in range(ranks)], tmp_path, env)
    for code, log in runs:
        assert code == 0, log[-3000:]


def test_pipeline_on_two_gloo_ranks_matches_jax(tmp_path):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 16, generator=gen)
    w = torch.randn(2, 16, 16, generator=gen) * 0.3
    wcs = {v: torch.randn(2 * v, 16, 16, generator=gen) * 0.3
           for v in (1, 2)}
    tokens = torch.randint(0, 64, (8, 12), generator=gen)
    ref = _jax_references(tokens, x, w, wcs)
    jax_init, jax_loss = _jax_solver(CFG)
    data = {"x": x, "w": w, "wc1": wcs[1], "wc2": wcs[2], "tokens": tokens,
            "lm": LM, "moe": MOE, "params": ref["dense_params"],
            "moe_params": ref["moe_params"], "jax_init": jax_init}
    torch.save(data, tmp_path / "data.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    _spawn_ranks(tmp_path, script, 2, "two")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    for out in ranks:
        # 1. GPipe against the JAX pipeline
        y, w_grad = out["gpipe"]
        np.testing.assert_allclose(y.numpy(), ref["y"], atol=1e-6)
        _close(w_grad, ref["w_grad"], "gpipe grad")
        # 2. 1F1B against both GPipes; packed bitwise
        for v in (1, 2):
            runs = out[f"1f1b{v}"]["runs"]
            loss, grad, _ = runs[(False, False)]
            _close(grad, ref[f"wc{v}_grad"], f"1f1b v{v} vs jax gpipe")
            _close(grad, out[f"1f1b{v}"]["gpipe"], f"1f1b v{v} vs gpipe")
            for key, (other_loss, other, dx) in runs.items():
                assert torch.equal(other_loss, loss), (v, key)
                assert torch.equal(other, grad), (v, key)
                assert torch.equal(dx, runs[(False, False)][2]), (v, key)
            assert len(runs) == (3 if v == 1 else 2)
            chained = x
            for wc in wcs[v]:
                chained = torch.tanh(chained @ wc)
            np.testing.assert_allclose(out[f"1f1b{v}_forward"].numpy(),
                                       chained.numpy(), atol=1e-6)
        # 3. pipelined_apply
        _close(out["dense"]["apply_gpipe"], ref["apply_gpipe"], "apply")
        _close(out["dense"]["apply_1f1b"], ref["apply_1f1b"], "apply 1f1b")
        # 4. pipelined_value_and_grad: dense against the JAX gpipe one,
        # MoE against the JAX sequential oracle; packed bitwise
        for tag, names in (("dense", ("gpipe1", "1f1b2", "packed_1f1b1",
                                      "1f1b1")),
                           ("moe", ("1f1b2", "1f1b1"))):
            for name in names:
                loss, grads = out[tag][name]
                _close(loss, ref[f"{tag}_loss"], f"{tag} {name} loss")
                assert set(grads) == set(ref[f"{tag}_grads"])
                for key, value in ref[f"{tag}_grads"].items():
                    _close(grads[key], value, f"{tag} {name} {key}")
        packed, plain = out["dense"]["packed_1f1b1"], out["dense"]["1f1b1"]
        assert torch.equal(packed[0], plain[0])
        assert all(torch.equal(packed[1][k], plain[1][k]) for k in plain[1])

    # 5. the LM solver: the JAX LMSolver's first step, then one port process
    solver = ranks[0]["solver"]
    assert abs(solver["losses"][0] - jax_loss) <= 1e-3
    one_losses, one_params, one_valid = _one_process_solver(CFG, jax_init)
    np.testing.assert_allclose(solver["losses"], one_losses, rtol=1e-5)
    assert abs(solver["valid"]["loss"] - one_valid["loss"]) <= 1e-5
    for key, value in one_params.items():
        assert _rel(solver["params"][key], value) <= 1e-5, key
        assert torch.equal(solver["params"][key],
                           ranks[1]["solver"]["params"][key]), key
    # each rank holds its 2 of 4 layers (chunks d and d + 2)
    assert solver["shapes"]["blocks.block.attn.qkv.kernel"][0] == 2
    assert solver["shapes"]["embed"] == [64, 32]
    assert solver["wrapped"] == "TransformerLM"
    assert solver["metrics"]["bubble_frac"] == pytest.approx(1 / 9, abs=1e-6)
    assert solver["metrics"]["peak_stash_bytes"] > 0

    # 6. resume across the pipe ranks, from slots (a file a rank) and
    # from a single gathered file: bit-identical
    for out in ranks:
        ck = out["ckpt"]
        for mode in ("sharded", "single"):
            assert ck[mode]["restored"], mode
            for key, value in ck["whole"].items():
                assert torch.equal(ck[mode]["resumed"][key], value), key
            for key, value in ck["whole_local"].items():
                assert torch.equal(ck[mode]["local"][key], value), key
    from pathlib import Path
    from flashy_tpu_torch.checkpoint import read_slot_pointer, slot_manifest
    slots = Path(ranks[0]["ckpt"]["sharded"]["folder"]) \
        / "checkpoint.th.sharded"
    manifest = slot_manifest(slots / read_slot_pointer(slots))
    assert {"arrays-0.pt", "arrays-1.pt"} <= set(manifest["files"])
    record = manifest["layout"]["['model']['blocks.block.mlp.up.kernel']"]
    assert record["interleave"] == 2 and record["mesh"]["pipe"] == 2
    single = Path(ranks[0]["ckpt"]["single"]["folder"])
    assert (single / "checkpoint.th").exists()
    meta = json.loads((single / "checkpoint_meta.json").read_text())
    assert meta["mode"] == "single"
    assert meta["state_sharding"]["axis_sizes"] == {"pipe": 2}

    # 7. the tick faults: raised on both ranks, then a clean run
    for out in ranks:
        faults = out["faults"]
        for site in ("pipeline.tick", "pipeline.packed_tick"):
            assert faults[site] == "InjectedFault", site
            assert faults[site + ".after"] == 2.0
        assert faults["pipeline.tick.loss"] == \
            faults["pipeline.packed_tick.loss"]

    # 8. the refusals name their ROADMAP entry; the bench's gates
    for out in ranks:
        for name in ("fsdp", "zero1"):
            assert "queue A item 8f" in out["refusals"][name], name
        assert "pipeline" in out["refusals"]["chunked"]
    from flashy_tpu_torch.parallel.pipeline import bench_problems
    bench = json.loads((tmp_path / "bench.json").read_text())
    assert bench_problems(bench, timing=False) == []
    assert bench["pipe"] == 2 and bench["recompiles"] == 0
    assert bench["bubble_track_recorded"]
    rc = {out["bench_rc"] for out in ranks}
    timing = bench_problems(bench)
    assert rc == ({1} if timing else {0}), timing
    torch.save({"params": solver["params"], "init": jax_init},
               tmp_path.parent / "pipe_two_ranks.pt")


FOUR = r'''
import functools, json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.parallel.pipeline import tensor_compose
from flashy_tpu_torch.xp import Config, temporary_xp

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank = distrib.rank()
data = torch.load(folder / "four.pt")
lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
cfg = json.loads((folder / "cfg.json").read_text())
out = {"compose": tensor_compose("cpu")}
with temporary_xp():
    solver = lm.LMSolver(Config({**cfg, "mesh": {"data": 2, "pipe": 2}}),
                         device="cpu")
    sh = solver.model._sharded.shardings
    solver.model.load_state_dict({
        k: sh[k].shard(v).clone() if k in sh else v
        for k, v in data["init"].items()})
    solver.run_stage("train", solver.train)
    with solver.model.summon_full_params():
        out["params"] = {k: v.detach().clone()
                         for k, v in solver.model.state_dict().items()}
    out["losses"] = solver.step_losses
torch.save(out, folder / f"four{rank}.pt")
'''


def test_pipe_with_data_and_tensor_on_four_gloo_ranks(tmp_path):
    # the two-rank run's init and result, recomputed when run alone
    two = tmp_path.parent / "pipe_two_ranks.pt"
    if two.exists():
        saved = torch.load(two, weights_only=False)
        init, want = saved["init"], saved["params"]
    else:
        init, _ = _jax_solver(CFG)
        _, want, _ = _one_process_solver(CFG, init)
    torch.save({"init": init}, tmp_path / "four.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    script = tmp_path / "four_worker.py"
    script.write_text(FOUR)
    _spawn_ranks(tmp_path, script, 4, "four")
    ranks = [torch.load(tmp_path / f"four{r}.pt", weights_only=False)
             for r in range(4)]
    for out in ranks:
        compose = out["compose"]
        assert compose["ok"], compose
        for key, value in want.items():
            assert _rel(out["params"][key], value) <= 1e-5, key
            assert torch.equal(out["params"][key], ranks[0]["params"][key])
