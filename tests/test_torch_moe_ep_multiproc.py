# Expert parallelism across processes on the CPU (queue A item 8d, the
# expert half): a spawn of two gloo ranks and one of four rendezvousing
# through a file:// path in tmp_path (test_torch_distrib_multiproc.py's
# `_spawn`), the tiny MoE LM (2 layers, dim 32, 4 heads, 4 experts of
# width 64, top-2, f32, dense attention) through the port's LMSolver: two
# clipped AdamW steps from the JAX LMSolver's weights (params_from_jax),
# each rank's rows of the same global batch.
#
# The two ranks run:
#  1. `+mesh.expert=2` with moe_dispatch=dropless_ep at capacity factor
#     2.0 (= e: nothing drops) and with einsum at 8.0, each rank holding
#     2 of every block's 4 experts; then `mesh.tensor=2` (MoE blocks
#     under tensor: the experts' hidden width split) with dropless and
#     einsum; all held to the JAX LMSolver at the same mesh (einsum at
#     8.0: where nothing drops every dispatch computes the same function)
#     and to one port process at 1e-5; the parameters the expert ranks
#     hold whole bit-identical across them;
#  2. the accounting: a forward's exchanges cross 'expert' as all-to-alls
#     (three a block: the tokens, their expert ids, the results);
#  3. `grad_norm` against the norm of the gathered gradients (each
#     expert's squares summed over 'expert', a whole leaf counted once);
#     a leaf held whole gets its gradients averaged over the expert ranks
#     (1 added to rank 1's embedding gradient comes out as 0.5 on both);
#  4. a single-file commit (gathered over 'expert', written by rank 0)
#     holding the full parameters, checkpoint_meta.json recording the
#     layout; the sharded slots round trip on both ranks, `info
#     --verify-checkpoint` passes here, and a restore onto expert=1
#     raises, naming item 8e.
#
# The four ranks run data 2 x expert 2 (the aux loss's densities averaged
# over all four) and expert 2 x tensor 2 with dropless_ep, held to the
# JAX LMSolver at {"data": 2, "expert": 2} and {"expert": 2, "tensor": 2}
# and to one port process at 1e-5.
import functools
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tests.test_torch_distrib_multiproc import _env, _rel, _spawn

MODEL = {"vocab_size": 64, "dim": 32, "num_layers": 2, "num_heads": 4,
         "mlp_ratio": 2, "attention": "dense", "moe_experts": 4,
         "moe_top_k": 2}
CFG = {"model": MODEL, "mesh": {"data": -1}, "seq_len": 16,
       "batch_size": 8, "accumulate": 1, "steps_per_epoch": 2, "epochs": 1,
       "valid_steps": 0, "generate_every": 0, "lr": 1e-3,
       "warmup_steps": 1, "weight_decay": 0.1, "device": "cpu"}
EP = {"moe_dispatch": "dropless_ep", "moe_capacity_factor": 2.0}
EINSUM = {"moe_dispatch": "einsum", "moe_capacity_factor": 8.0}
DROPLESS = {"moe_dispatch": "dropless", "moe_capacity_factor": 2.0}
# the two-rank runs: (tag, dispatch, mesh)
TWO = (("ep", EP, {"data": 1, "expert": 2}),
       ("einsum", EINSUM, {"data": 1, "expert": 2}),
       ("tp_dropless", DROPLESS, {"data": 1, "tensor": 2}),
       ("tp_einsum", EINSUM, {"data": 1, "tensor": 2}))
FOUR = (("data_expert", EP, {"data": 2, "expert": 2}),
        ("expert_tensor", EP, {"data": 1, "expert": 2, "tensor": 2}))

WORKER = r'''
import functools, json, math, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.parallel import collective_stats, count_collectives
from flashy_tpu_torch.parallel.data_parallel import grad_norm
from flashy_tpu_torch.xp import Config, create_xp, temporary_xp

folder = Path(sys.argv[1])
runs_spec = json.loads((folder / sys.argv[2]).read_text())
distrib.init(backend="gloo")
rank = distrib.rank()
data = torch.load(folder / "data.pt")
lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
out = {"rank": rank}


def config(over, mesh):
    cfg = json.loads((folder / "cfg.json").read_text())
    return Config({**cfg, "model": {**cfg["model"], **over}, "mesh": mesh})


def load_sliced(model, full):
    sh = model._sharded.shardings
    model.load_state_dict({k: sh[k].shard(v).clone() if k in sh else v
                           for k, v in full.items()})


def full_state(solver):
    with solver.model.summon_full_params():
        return {k: v.detach().clone()
                for k, v in solver.model.state_dict().items()}


for tag, over, mesh in runs_spec:
    with temporary_xp():
        solver = lm.LMSolver(config(over, mesh), device="cpu")
        load_sliced(solver.model, data["init"])
        metrics = solver.run_stage("train", solver.train)
        run = {"params": full_state(solver), "metrics": metrics,
               "own": {k: v.detach().clone()
                       for k, v in solver.model.state_dict().items()},
               "shapes": {k: list(p.shape) for k, p in
                          solver.model.named_parameters()},
               "wrapped": type(solver.train_model).__name__,
               "mode": solver.model._sharded.mode}
        if tag == "ep":
            tokens = solver.batch_at(0)
            with torch.no_grad(), count_collectives() as record:
                solver.model(tokens)
            run["forward_stats"] = collective_stats(record)
            solver.model.zero_grad(set_to_none=True)
            solver.loss(tokens).backward()
            run["grad_norm"] = float(grad_norm(solver.model.parameters()))
            squares = 0.0
            for p in solver.model.parameters():
                sharding = getattr(p, "sharding", None)
                grad = p.grad if sharding is None else \
                    sharding.gather(p.grad)
                squares += float(grad.double().pow(2).sum())
            run["full_norm"] = math.sqrt(squares)
            # the leaves held whole are averaged over the expert ranks: a
            # difference put into one rank's gradient comes out halved on
            # both
            embed = []
            for offset in (0.0, float(rank)):
                solver.model.zero_grad(set_to_none=True)
                hook = solver.model.embed.register_hook(
                    lambda grad, offset=offset: grad + offset)
                solver.loss(tokens, model=solver.train_model).backward()
                hook.remove()
                embed.append(solver.model.embed.grad.clone())
            run["embed_shift"] = embed[1] - embed[0]
            solver.model.zero_grad(set_to_none=True)
            last = full_state(solver)
            solver.commit()
            if rank == 0:
                from flashy_tpu_torch.checkpoint import load_state
                saved = load_state(solver.checkpoint_path)["model"]
                run["single_file"] = all(torch.equal(saved[k], v)
                                         for k, v in last.items())
                run["meta"] = json.loads(
                    (solver.folder / "checkpoint_meta.json").read_text())
        out[tag] = run

if "ep" in out:
    # the solvers' mesh checks
    refused = []
    for call in (lambda: lm.check_mesh({"data": 1, "expert": 2}, "dense",
                                       expert=lm.TODO_EXPERT_SOLVERS),
                 lambda: lm.check_mesh({"data": 1, "expert": 2}, "dense",
                                       model={"moe_experts": 3})):
        try:
            call()
            refused.append(None)
        except (NotImplementedError, ValueError) as exc:
            refused.append(f"{type(exc).__name__}: {exc}")
    out["refused"] = refused
    # the sharded slots round trip; a restore onto expert=1 raises
    over, mesh = runs_spec[0][1], runs_spec[0][2]
    xp = create_xp(Config({"name": "expert"}), root=folder / "exp")
    ck = {}
    with xp.enter():
        solver = lm.LMSolver(config(over, mesh), device="cpu")
        solver.checkpoint_mode = "sharded"
        solver.run_stage("train", solver.train)
        solver.commit()
        ck["local"] = {k: v.detach().clone()
                       for k, v in solver.model.state_dict().items()}
        ck["folder"] = str(solver.folder)
        again = lm.LMSolver(config(over, mesh), device="cpu")
        again.checkpoint_mode = "sharded"
        ck["restored"] = again.restore()
        ck["epoch"] = again.epoch
        ck["same"] = all(torch.equal(v, ck["local"][k])
                         for k, v in again.model.state_dict().items())
        other = lm.LMSolver(config(over, {"data": -1}), device="cpu")
        other.checkpoint_mode = "sharded"
        try:
            other.restore()
            ck["other_width"] = None
        except NotImplementedError as exc:
            ck["other_width"] = str(exc)
    out["ckpt"] = ck
torch.save(out, folder / f"{sys.argv[2]}-rank{rank}.pt")
'''


def _jax_lm_reference(mesh, on_init=None):
    """The JAX LMSolver in f32, einsum at capacity factor 8.0, over
    `mesh` (on the first devices of the 8 virtual ones) on the whole
    batch for CFG's steps: its initial and final parameters in the
    port's layout (the initial ones handed to `on_init` first)."""
    import jax
    import jax.numpy as jnp
    import examples.lm.solver as jax_lm
    from flashy_tpu.parallel import make_mesh
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.models.convert import params_from_jax
    original = jax_lm.TransformerConfig, jax_lm.make_mesh
    count = math.prod(mesh.values())
    jax_lm.TransformerConfig = functools.partial(original[0],
                                                 dtype=jnp.float32)
    jax_lm.make_mesh = lambda shape: make_mesh(
        shape, devices=jax.devices()[:count])
    try:
        with jax_xp():
            solver = jax_lm.LMSolver(JaxConfig(
                {**CFG, "model": {**MODEL, **EINSUM}, "mesh": mesh}))
            config = solver.model.config
            init = params_from_jax(
                jax.tree.map(np.asarray, solver.state["params"]), config)
            if on_init is not None:
                on_init(init)
            state = solver.state
            for step in range(CFG["steps_per_epoch"]):
                state, _ = solver._train_step(state, solver.batch_at(step))
            final = params_from_jax(jax.tree.map(np.asarray,
                                                 state["params"]), config)
    finally:
        jax_lm.TransformerConfig, jax_lm.make_mesh = original
    return init, final


def _one_process(init, over):
    """One port process: the LM solver's two clipped steps from `init`."""
    from flashy_tpu_torch.examples.lm import solver as lm
    from flashy_tpu_torch.xp import Config, temporary_xp
    original = lm.TransformerConfig
    lm.TransformerConfig = functools.partial(original, dtype=torch.float32)
    try:
        with temporary_xp():
            solver = lm.LMSolver(Config({**CFG, "model": {**MODEL, **over}}),
                                 device="cpu")
            solver.model.load_state_dict(init)
            solver.run_stage("train", solver.train)
            return {k: v.detach().clone()
                    for k, v in solver.model.state_dict().items()}
    finally:
        lm.TransformerConfig = original


def _run_ranks(tmp_path, runs, world):
    name = f"runs{world}.json"
    (tmp_path / name).write_text(json.dumps(runs))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = _env(tmp_path / f"rendezvous{world}", tmp_path)
    codes = _spawn([([sys.executable, str(script), str(tmp_path), name],
                     {"FLASHY_TPU_NUM_PROCESSES": str(world),
                      "FLASHY_TPU_PROCESS_ID": str(rank)})
                    for rank in range(world)], tmp_path, env)
    for code, log in codes:
        assert code == 0, log[-3000:]
    return [torch.load(tmp_path / f"{name}-rank{r}.pt", weights_only=False)
            for r in range(world)]


def _setup(tmp_path, meshes, runs, world):
    """The JAX references at `meshes`, and the ranks' `runs` started in a
    thread as soon as the first reference has its initial weights (saved
    for them), so that they run while the references train. Returns the
    initial weights, the references' final ones by mesh, and the future
    of the ranks' results."""
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    pool = ThreadPoolExecutor(1)
    ranks = []

    def start(init):
        torch.save({"init": init}, tmp_path / "data.pt")
        ranks.append(pool.submit(_run_ranks, tmp_path, runs, world))

    refs = {json.dumps(mesh, sort_keys=True): _jax_lm_reference(
        mesh, None if ranks else start) for mesh in meshes}
    pool.shutdown(wait=False)
    init = next(iter(refs.values()))[0]
    for other, _ in refs.values():
        assert all(torch.equal(other[k], v) for k, v in init.items())
    return init, {key: final for key, (_, final) in refs.items()}, ranks[0]


def _check_run(ranks, tag, mesh, want_jax, want_one):
    """Rank 0's gathered parameters against the JAX package's and one
    process's; every rank's gathered parameters equal; what a rank holds
    whole (all but the experts) bit-identical on the ranks of its tensor
    index."""
    run = ranks[0][tag]
    for key, value in want_jax.items():
        assert _rel(run["params"][key], value) <= 1e-5, (tag, key)
        assert _rel(run["params"][key], want_one[key]) <= 1e-5, (tag, key)
    tensor = mesh.get("tensor", 1)
    for out in ranks:
        peer = ranks[out["rank"] % tensor][tag]
        for key, value in run["params"].items():
            assert torch.equal(out[tag]["params"][key], value), (tag, key)
        for key, value in peer["own"].items():
            if ".moe.w_" not in key:
                assert torch.equal(out[tag]["own"][key], value), (tag, key)


def test_expert_parallel_on_two_gloo_ranks_matches_jax(tmp_path, capsys):
    init, refs, running = _setup(tmp_path, [{"expert": 2}, {"tensor": 2}],
                                 TWO, 2)
    ones = {"ep": _one_process(init, EP), "einsum": _one_process(init, EINSUM),
            "tp_dropless": _one_process(init, DROPLESS)}
    ones["tp_einsum"] = ones["einsum"]
    ranks = running.result()
    assert _rel(ones["ep"]["block_0.moe.w_up"], init["block_0.moe.w_up"]) \
        > 1e-4
    for tag, _, mesh in TWO:
        want = refs[json.dumps({k: v for k, v in mesh.items() if k != "data"},
                               sort_keys=True)]
        _check_run(ranks, tag, mesh, want, ones[tag])
    ep = ranks[0]["ep"]
    # each rank its 2 of the 4 experts, the rest whole; DDP over the
    # expert ranks averages the gradients of what they hold whole
    assert ep["mode"] == "expert" \
        and ep["wrapped"] == "DistributedDataParallel"
    assert ep["shapes"]["block_0.moe.w_up"] == [2, 32, 64]
    assert ep["shapes"]["block_0.moe.w_down"] == [2, 64, 32]
    assert ep["shapes"]["block_0.moe.router.kernel"] == [32, 4]
    assert ep["shapes"]["embed"] == [64, 32]
    tp = ranks[0]["tp_dropless"]
    assert tp["mode"] == "tensor"
    assert tp["shapes"]["block_0.moe.w_up"] == [4, 32, 32]
    assert tp["shapes"]["block_0.moe.w_down"] == [4, 32, 32]
    assert ranks[0]["ep"]["own"]["block_0.moe.w_up"].shape[0] == 2
    assert not torch.equal(ranks[0]["ep"]["own"]["block_0.moe.w_up"],
                           ranks[1]["ep"]["own"]["block_0.moe.w_up"])

    # 2. three all-to-alls a block in a forward, over 'expert'
    for out in ranks:
        stats = out["ep"]["forward_stats"]
        assert stats["all-to-all"]["count"] == 3 * MODEL["num_layers"], stats
        assert stats["all-to-all"]["bytes"] > 0

    # 3. the clip's norm: the experts' squares summed over 'expert'
    for out in ranks:
        assert abs(out["ep"]["grad_norm"] - out["ep"]["full_norm"]) \
            <= 1e-5 * out["ep"]["full_norm"]
    assert ranks[0]["ep"]["grad_norm"] == ranks[1]["ep"]["grad_norm"]
    for out in ranks:
        shift = out["ep"]["embed_shift"]
        assert torch.allclose(shift, torch.full_like(shift, 0.5), atol=1e-6)

    # the MLM and translate solvers refuse expert ranks (item 8f); the LM
    # solver wants experts the expert axis divides
    for out in ranks:
        mlm, indivisible = out["refused"]
        assert mlm.startswith("NotImplementedError") and "8f" in mlm
        assert indivisible.startswith("ValueError") and "divisible" in \
            indivisible

    # 4. checkpoints across the expert ranks
    assert ep["single_file"]
    assert ep["meta"]["state_sharding"]["summary"] == "fsdp(expert=2)"
    for out in ranks:
        ck = out["ckpt"]
        assert ck["restored"] and ck["epoch"] == 2 and ck["same"]
        assert "queue A item 8e" in ck["other_width"]
    from flashy_tpu_torch import info
    from flashy_tpu_torch.checkpoint import read_slot_pointer, slot_manifest
    folder = Path(ranks[0]["ckpt"]["folder"])
    slots = folder / "checkpoint.th.sharded"
    manifest = slot_manifest(slots / read_slot_pointer(slots))
    assert {"arrays-0.pt", "arrays-1.pt"} <= set(manifest["files"])
    assert manifest["layout"]["['model']['block_0.moe.w_up']"]["spec"][0] \
        == "expert"
    capsys.readouterr()
    root = folder.parent.parent
    assert info.main([str(root)]) == 0
    assert "state-sharding=fsdp(expert=2)" in capsys.readouterr().out
    assert info.verify_checkpoints(root) == 0


def test_expert_parallel_with_data_and_tensor_on_four_gloo_ranks(tmp_path):
    init, refs, running = _setup(tmp_path, [{"data": 2, "expert": 2},
                                            {"expert": 2, "tensor": 2}],
                                 FOUR, 4)
    one = _one_process(init, EP)
    ranks = running.result()
    for tag, _, mesh in FOUR:
        want = refs[json.dumps({k: v for k, v in mesh.items()
                                if k != "data" or v > 1}, sort_keys=True)]
        _check_run(ranks, tag, mesh, want, one)
    data_expert = ranks[0]["data_expert"]
    assert data_expert["wrapped"] == "DistributedDataParallel"
    assert data_expert["mode"] == "expert"
    expert_tensor = ranks[0]["expert_tensor"]
    assert expert_tensor["mode"] == "expert+tensor"
    assert expert_tensor["shapes"]["block_0.moe.w_up"] == [2, 32, 32]
