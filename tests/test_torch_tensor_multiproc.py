# Megatron tensor parallelism across processes on the CPU (queue A item
# 8b): a spawn of two gloo ranks and one of four rendezvousing through a
# file:// path in tmp_path (test_torch_distrib_multiproc.py's `_spawn`).
# The two ranks (data 1 x tensor 2) run:
#
#  1. the tiny LM (2 layers, dim 64, 4 heads, f32, remat on, tied head)
#     through the port's LMSolver, two clipped steps from the JAX
#     LMSolver's weights (params_from_jax), dense and chunked loss, held
#     to the JAX LMSolver at mesh {"data": 4, "tensor": 2} on the whole
#     batch and to one port process at 1e-5; then a single-file commit
#     (gathered over 'tensor', written by rank 0) holding the full
#     parameters and checkpoint_meta.json reading tensor(tensor=2);
#  2. the same LM with dropout on, two steps at a dropout seed, against
#     one port process at the same seed (the tensor ranks draw the same
#     masks);
#  3. a hybrid SSD stack's and the tiny translate model's gradients,
#     gathered to full shapes, against the JAX package's;
#  4. `run_tp_bench` at widths 1 and 2 through `main`, exit 0 (grads,
#     optimizer bytes, flash backward parity, recompiles);
#  5. the vocab-parallel cross entropy (dense and chunked) against
#     `F.cross_entropy` on the gathered logits, values and gradients;
#  6. the accounting: two forward all-reduces a block;
#  7. the checkpoint round trip in sharded slots: restored on both
#     ranks, `info` and `info --verify-checkpoint` here, a restore onto
#     another tensor width raising, naming item 8e.
#
# The four ranks run data 2 x tensor 2 through tensor_state_sharding
# (tensor+zero1) and fsdp 2 x tensor 2 through the LM solver (3 heads a
# tensor rank), held to DDP over the four ranks and to the JAX package
# at 1e-5.
import functools
import json
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distrib_multiproc import _env, _rel, _spawn

CFG = {
    "model": {"vocab_size": 64, "dim": 64, "num_layers": 2, "num_heads": 4,
              "mlp_ratio": 2, "attention": "dense", "remat": True},
    "mesh": {"data": -1, "tensor": 2}, "seq_len": 16, "batch_size": 8,
    "accumulate": 1, "steps_per_epoch": 2, "epochs": 1, "valid_steps": 0,
    "generate_every": 0, "lr": 1e-2, "warmup_steps": 1,
    "weight_decay": 0.1, "device": "cpu", "loss_chunk": 5}
HYBRID = dict(vocab_size=64, dim=64, num_layers=2, num_heads=4, mlp_ratio=2,
              attention="dense", mixer="ssd,attention", ssd_state_dim=8,
              ssd_chunk=8)
TRANSLATE = dict(vocab_size=64, dim=64, enc_layers=1, dec_layers=1,
                 num_heads=4, max_seq_len=32)
# the four-rank LM at fsdp 2 x tensor 2: 6 heads of 8, so a tensor rank
# holds 3 heads, which 'fsdp' does not divide (it cuts the slices' dim
# 0, the model width, not their heads)
FOUR_LM = {**CFG, "model": {**CFG["model"], "dim": 48, "num_heads": 6}}
DROPOUT_SEED = 5
# AdamW's learning rate in the four-rank ZeRO run: an Adam step divides
# each gradient component by its own magnitude, so the f32
# reduction-order noise of a near-zero component becomes a step of lr
# in either direction. At lr 1e-2 from the random init (the embedding's
# std is 0.02) that noise alone puts DDP 1.6e-5 from the JAX package on
# an `mlp/up` kernel after two steps (tensor+zero1 5e-6 from DDP); at
# 1e-3 the steps are the size the 1e-5 comparison resolves
ADAM_LR = 1e-3

WORKER = r'''
import functools, json, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.models import Seq2SeqConfig, Seq2SeqTransformer
from flashy_tpu_torch.models.convert import params_from_jax, seq2seq_from_jax
from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                 TransformerLM)
from flashy_tpu_torch.ops.losses import (chunked_softmax_cross_entropy,
                                         lm_next_token_loss)
from flashy_tpu_torch.parallel import (collective_stats, count_collectives,
                                       make_mesh, wrap)
from flashy_tpu_torch.parallel import tensor as tensor_mod
from flashy_tpu_torch.parallel.sharding import NamedSharding, P
from flashy_tpu_torch.xp import Config, create_xp, temporary_xp

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank = distrib.rank()
mesh = make_mesh({"data": 1, "tensor": 2})
data = torch.load(folder / "data.pt")
out = {"rank": rank}


def load_sliced(model, full):
    sh = model._sharded.shardings
    model.load_state_dict({k: sh[k].shard(v).clone() if k in sh else v
                           for k, v in full.items()})


def full_grads(model):
    out = {}
    for name, p in model.named_parameters():
        sharding = getattr(p, "sharding", None)
        grad = p.grad if sharding is None or sharding.is_replicated \
            else sharding.gather(p.grad)
        out[name] = grad.detach().clone()
    return out


# ---- 1. the LM solver at tensor=2, dense and chunked loss
lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
cfg = json.loads((folder / "cfg.json").read_text())
runs = {}
for loss in ("dense", "chunked"):
    with temporary_xp():
        solver = lm.LMSolver(Config({**cfg, "loss": loss}), device="cpu")
        load_sliced(solver.model, data["init"])
        metrics = solver.run_stage("train", solver.train)
        with solver.model.summon_full_params():
            params = {k: v.detach().clone()
                      for k, v in solver.model.state_dict().items()}
        run = {"params": params, "metrics": metrics,
               "shapes": {k: list(p.shape) for k, p in
                          solver.model.named_parameters()},
               "wrapped": type(solver.train_model).__name__}
        if loss == "dense":
            with count_collectives() as record:
                lm.train_step(solver.train_model, solver.optimizer,
                              solver.schedule, 2, solver.batch_at(2),
                              lambda m, t: solver.loss(t, model=m),
                              mesh=solver.mesh)
            run["stats"] = collective_stats(record)
            with solver.model.summon_full_params():
                last = {k: v.detach().clone()
                        for k, v in solver.model.state_dict().items()}
            solver.commit()
            if rank == 0:
                from flashy_tpu_torch.checkpoint import load_state
                saved = load_state(solver.checkpoint_path)["model"]
                run["single_file"] = all(torch.equal(saved[k], v)
                                         for k, v in last.items())
                run["meta"] = json.loads(
                    (solver.folder / "checkpoint_meta.json").read_text())
        runs[loss] = run
out["lm"] = runs

# ---- 2. dropout: the tensor ranks draw the same masks
dcfg = TransformerConfig(**{**cfg["model"], "dropout": 0.2},
                         dtype=torch.float32)
model = TransformerLM(dcfg, device="cpu", seed=0, mesh=mesh)
model.load_state_dict(data["init"])
wrapped = wrap(model, mesh=mesh)
optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2)
for step in range(2):
    lm.train_step(wrapped, optimizer, lambda count: 1e-2, step,
                  data["tokens"],
                  lambda m, t, **kw: lm_next_token_loss(
                      m, t, vocab_mesh=mesh, train=True, **kw),
                  dropout_seed=DROPOUT_SEED + step, mesh=mesh)
with model.summon_full_params():
    out["dropout"] = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}

# ---- 3. a hybrid SSD stack's and the translate model's gradients
model = TransformerLM(TransformerConfig(**data["hybrid_cfg"],
                                        dtype=torch.float32),
                      device="cpu", mesh=mesh)
model.load_state_dict(data["hybrid"])
wrapped = wrap(model, mesh=mesh)
lm_next_token_loss(wrapped, data["tokens"], vocab_mesh=mesh).backward()
out["hybrid"] = full_grads(model)

s2s = Seq2SeqTransformer(Seq2SeqConfig(**data["translate_cfg"],
                                       dtype=torch.float32),
                         device="cpu", mesh=mesh)
s2s.load_state_dict(data["translate"])
wrapped = wrap(s2s, mesh=mesh)
from flashy_tpu_torch.examples.translate.solver import teacher_loss
teacher_loss(wrapped, data["packed"], mesh).backward()
out["translate"] = full_grads(s2s)

# ---- 4. the bench through main, both widths
out["bench_rc"] = tensor_mod.main(
    ["--device", "cpu", "--widths", "1,2", "--steps", "2", "--dim", "64",
     "--vocab", "128", "--seq", "32", "--json", str(folder / "bench.json")])

# ---- 5. the vocab-parallel cross entropy against the gathered logits
cols = NamedSharding(mesh, P(None, "tensor"))
logits = cols.shard(data["logits"]).clone().requires_grad_(True)
ce = tensor_mod.vocab_parallel_cross_entropy(logits, data["labels"], mesh)
(ce * data["weights"]).sum().backward()
out["ce"] = (ce.detach(), cols.gather(logits.grad))
rows = NamedSharding(mesh, P("tensor", None))
head = rows.shard(data["head"]).clone().requires_grad_(True)
hidden = data["hidden"].clone().requires_grad_(True)
chunked = chunked_softmax_cross_entropy(
    tensor_mod.copy_to_tensor(hidden, mesh), head, data["hidden_labels"], 5,
    mesh)
chunked.sum().backward()
out["chunked"] = (chunked.detach(), hidden.grad.clone(),
                  rows.gather(head.grad))

# ---- 6. the accounting: two forward all-reduces a block
model = TransformerLM(TransformerConfig(**cfg["model"], dtype=torch.float32),
                      device="cpu", mesh=mesh)
wrap(model, mesh=mesh)
with torch.no_grad(), count_collectives() as record:
    model(data["tokens"])
out["forward_stats"] = collective_stats(record)

# ---- 7. the checkpoint round trip in sharded slots
xp = create_xp(Config({"name": "tensor"}), root=folder / "txp")
ck = {}
with xp.enter():
    solver = lm.LMSolver(Config(cfg), device="cpu")
    solver.checkpoint_mode = "sharded"
    solver.run_stage("train", solver.train)
    solver.commit()
    ck["local"] = {k: v.detach().clone()
                   for k, v in solver.model.state_dict().items()}
    ck["folder"] = str(solver.folder)
    again = lm.LMSolver(Config(cfg), device="cpu")
    again.checkpoint_mode = "sharded"
    ck["restored"] = again.restore()
    ck["epoch"] = again.epoch
    ck["same"] = all(torch.equal(v, ck["local"][k])
                     for k, v in again.model.state_dict().items())
    ck["moments"] = list(again.optimizer.state_dict()["state"][0]
                         ["exp_avg"].shape)
    other = lm.LMSolver(Config({**cfg, "mesh": {"data": -1}}), device="cpu")
    other.checkpoint_mode = "sharded"
    try:
        other.restore()
        ck["other_width"] = None
    except NotImplementedError as exc:
        ck["other_width"] = str(exc)
out["ckpt"] = ck
torch.save(out, folder / f"rank{rank}.pt")
'''


def _jax_lm_reference(cfg, mesh):
    """The JAX LMSolver in f32 over `mesh` (on the 8 virtual devices) on
    the whole batch for cfg's steps: its initial and final parameters in
    the port's layout."""
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
            solver = jax_lm.LMSolver(JaxConfig({**cfg, "mesh": mesh}))
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


def _jax_lm_grads(tokens):
    """The hybrid SSD stack's JAX params and its next-token CE gradients
    on `tokens`, in the port's layout."""
    import jax
    import jax.numpy as jnp
    import optax
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import TransformerConfig
    model = JaxLM(JaxConfig(**HYBRID, dtype=jnp.float32))
    tokens = jnp.asarray(tokens.numpy(), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), tokens)

    def loss(p):
        logits = model.apply(p, tokens)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tokens[:, 1:]).mean()

    grads = jax.jit(jax.grad(loss))(params)
    cfg = TransformerConfig(**HYBRID)
    return (params_from_jax(jax.tree.map(np.asarray, params), cfg),
            params_from_jax(jax.tree.map(np.asarray, grads), cfg))


def _jax_translate_grads(packed):
    """The tiny translate model's JAX params and its teacher-forced CE
    gradients on `packed` ([B, 3, S]: src, tgt, decoder input)."""
    import jax
    import jax.numpy as jnp
    import optax
    from flashy_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
    from flashy_tpu.models.seq2seq import Seq2SeqTransformer as JaxModel
    from flashy_tpu_torch.models import Seq2SeqConfig, Seq2SeqTransformer
    from flashy_tpu_torch.models.convert import seq2seq_from_jax
    model = JaxModel(JaxConfig(**TRANSLATE, dtype=jnp.float32))
    src, tgt, dec_in = (jnp.asarray(t.numpy(), jnp.int32)
                        for t in packed.unbind(1))
    params = jax.jit(model.init)(jax.random.PRNGKey(4), src, dec_in)

    def loss(p):
        logits = model.apply(p, src, dec_in)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()

    grads = jax.jit(jax.grad(loss))(params)
    port = Seq2SeqTransformer(Seq2SeqConfig(**TRANSLATE,
                                            dtype=torch.float32),
                              device="cpu")
    return (seq2seq_from_jax(jax.tree.map(np.asarray, params), port),
            seq2seq_from_jax(jax.tree.map(np.asarray, grads), port))


def _one_process_lm(init, tokens, loss, dropout):
    """One port process: the LM solver's two clipped steps (or two
    dropout steps at DROPOUT_SEED) from `init`."""
    from flashy_tpu_torch.examples.lm import solver as lm
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.ops.losses import lm_next_token_loss
    from flashy_tpu_torch.xp import Config, temporary_xp
    if dropout:
        model = TransformerLM(TransformerConfig(
            **{**CFG["model"], "dropout": 0.2}, dtype=torch.float32),
            device="cpu")
        model.load_state_dict(init)
        optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2)
        for step in range(2):
            lm.train_step(model, optimizer, lambda count: 1e-2, step,
                          tokens, lambda m, t, **kw: lm_next_token_loss(
                              m, t, train=True, **kw),
                          dropout_seed=DROPOUT_SEED + step)
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    original = lm.TransformerConfig
    lm.TransformerConfig = functools.partial(original, dtype=torch.float32)
    try:
        with temporary_xp():
            solver = lm.LMSolver(Config({**CFG, "loss": loss,
                                         "mesh": {"data": -1}}),
                                 device="cpu")
            solver.model.load_state_dict(init)
            solver.run_stage("train", solver.train)
            return {k: v.detach().clone()
                    for k, v in solver.model.state_dict().items()}
    finally:
        lm.TransformerConfig = original


def test_tensor_parallel_on_two_gloo_ranks_matches_jax(tmp_path, capsys):
    gen = torch.Generator().manual_seed(0)
    init, jax_final = _jax_lm_reference(CFG, {"data": 4, "tensor": 2})
    tokens = torch.randint(0, 64, (4, 16), generator=gen)
    hybrid, hybrid_grads = _jax_lm_grads(tokens)
    src = torch.randint(2, 64, (4, 12), generator=gen)
    tgt = src.flip(1)
    packed = torch.stack([src, tgt, torch.cat(
        [torch.ones(4, 1, dtype=torch.long), tgt[:, :-1]], 1)], 1)
    translate, translate_grads = _jax_translate_grads(packed)
    data = {"init": init, "tokens": tokens, "hybrid": hybrid,
            "hybrid_cfg": HYBRID, "translate": translate,
            "translate_cfg": TRANSLATE, "packed": packed,
            "logits": torch.randn(24, 64, generator=gen) * 3,
            "labels": torch.randint(0, 64, (24,), generator=gen),
            "weights": torch.rand(24, generator=gen),
            "hidden": torch.randn(2, 12, 16, generator=gen),
            "head": torch.randn(64, 16, generator=gen),
            "hidden_labels": torch.randint(0, 64, (2, 12), generator=gen)}
    torch.save(data, tmp_path / "data.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("DROPOUT_SEED", str(DROPOUT_SEED)))
    env = _env(tmp_path / "rendezvous", tmp_path)
    runs = _spawn([([sys.executable, str(script), str(tmp_path)],
                    {"FLASHY_TPU_NUM_PROCESSES": "2",
                     "FLASHY_TPU_PROCESS_ID": str(rank)})
                   for rank in range(2)], tmp_path, env)
    for code, log in runs:
        assert code == 0, log[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    # 1. the LM solver: JAX at data 4 x tensor 2 and one process, 1e-5
    for loss in ("dense", "chunked"):
        one = _one_process_lm(init, None, loss, dropout=False)
        run = ranks[0]["lm"][loss]
        for key, value in jax_final.items():
            assert _rel(run["params"][key], value) <= 1e-5, (loss, key)
            assert _rel(run["params"][key], one[key]) <= 1e-5, (loss, key)
            assert torch.equal(run["params"][key],
                               ranks[1]["lm"][loss]["params"][key]), key
    dense = ranks[0]["lm"]["dense"]
    # the model itself (data 1: no DDP), each rank its heads and rows
    assert dense["wrapped"] == "TransformerLM"
    assert dense["shapes"]["embed"] == [32, 64]
    assert dense["shapes"]["block_0.attn.qkv.kernel"] == [64, 3, 2, 16]
    assert dense["shapes"]["block_0.mlp.up.kernel"] == [64, 128]
    assert dense["shapes"]["block_0.norm1.scale"] == [64]
    assert dense["single_file"]
    assert dense["meta"]["state_sharding"]["summary"] == "tensor(tensor=2)"
    assert dense["metrics"]["grad_norm"] > 1.0  # the clip acted

    # 2. dropout under tensor parallelism: one process's masks
    one = _one_process_lm(init, tokens, "dense", dropout=True)
    for key, value in one.items():
        assert _rel(ranks[0]["dropout"][key], value) <= 1e-5, key
    assert _rel(one["embed"], init["embed"]) > 1e-4

    # 3. the hybrid SSD stack and the translate model against JAX
    for out in ranks:
        for key, value in hybrid_grads.items():
            assert _rel(out["hybrid"][key], value) <= 1e-5, key
        for key, value in translate_grads.items():
            assert _rel(out["translate"][key], value) <= 1e-5, key

    # 4. the bench's gates
    assert ranks[0]["bench_rc"] == 0 and ranks[1]["bench_rc"] == 0
    bench = json.loads((tmp_path / "bench.json").read_text())
    assert bench["widths"] == [1, 2] and bench["flash_bwd_parity"] == 0.0
    assert bench["grads_max_delta_overall"] <= 1e-4
    assert bench["recompiles"] == 0
    assert bench["sharding"] == {"1": "zero1(data=2)",
                                 "2": "tensor(tensor=2)"}

    # 5. the vocab-parallel losses against F.cross_entropy
    logits = data["logits"].clone().requires_grad_(True)
    want = torch.nn.functional.cross_entropy(logits, data["labels"],
                                             reduction="none")
    (want * data["weights"]).sum().backward()
    hidden = data["hidden"].clone().requires_grad_(True)
    head = data["head"].clone().requires_grad_(True)
    chunk_want = torch.nn.functional.cross_entropy(
        (hidden @ head.t()).flatten(0, 1), data["hidden_labels"].flatten(),
        reduction="none").view(2, 12)
    chunk_want.sum().backward()
    for out in ranks:
        ce, grad = out["ce"]
        assert _rel(ce, want.detach()) <= 1e-6
        assert _rel(grad, logits.grad) <= 1e-6
        chunked, dhidden, dhead = out["chunked"]
        assert _rel(chunked, chunk_want.detach()) <= 1e-6
        assert _rel(dhidden, hidden.grad) <= 1e-5
        assert _rel(dhead, head.grad) <= 1e-5

    # 6. two forward all-reduces a block (and the embedding's one); a
    # step adds the loss's two, the backward's one a block's column
    # split and the head's, the clip's norm and the remat recompute's
    layers = CFG["model"]["num_layers"]
    assert ranks[0]["forward_stats"]["all-reduce"]["count"] == 1 + 2 * layers
    assert ranks[0]["forward_stats"]["all-gather"]["count"] == 0
    step = dense["stats"]["all-reduce"]["count"]
    least = (1 + 2 * layers) + 2 + (2 * layers + 1) + 1
    assert least <= step <= least + 2 * layers
    assert dense["stats"]["reduce-scatter"]["count"] == 0

    # 7. the checkpoint round trip across the ranks
    for out in ranks:
        ck = out["ckpt"]
        assert ck["restored"] and ck["epoch"] == 2 and ck["same"]
        assert ck["moments"] == [32, 64]
        assert "queue A item 8e" in ck["other_width"]
    from pathlib import Path
    from flashy_tpu_torch import info
    from flashy_tpu_torch.checkpoint import read_slot_pointer, slot_manifest
    folder = Path(ranks[0]["ckpt"]["folder"])
    slots = folder / "checkpoint.th.sharded"
    manifest = slot_manifest(slots / read_slot_pointer(slots))
    assert {"arrays-0.pt", "arrays-1.pt"} <= set(manifest["files"])
    assert manifest["layout"]["['model']['block_0.mlp.up.kernel']"][
        "pairs"] == 2
    capsys.readouterr()
    root = folder.parent.parent
    assert info.main([str(root)]) == 0
    assert "state-sharding=tensor(tensor=2)" in capsys.readouterr().out
    assert info.verify_checkpoints(root) == 0


FOUR = r'''
import functools, json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from flashy_tpu_torch import distrib
from flashy_tpu_torch.examples.lm import solver as lm
from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                 TransformerLM)
from flashy_tpu_torch.parallel import (make_mesh, model_state,
                                       tensor_state_sharding, wrap)
from flashy_tpu_torch.parallel.data_parallel import grad_norm
from flashy_tpu_torch.parallel.tensor import vocab_parallel_cross_entropy
from flashy_tpu_torch.xp import Config, temporary_xp

folder = Path(sys.argv[1])
distrib.init(backend="gloo")
rank = distrib.rank()
data = torch.load(folder / "four.pt")
LR = data["lr"]
cfg = TransformerConfig(**data["model"], dtype=torch.float32)
out = {}
for mode in ("ddp", "tensor+zero1"):
    if mode == "ddp":
        mesh = make_mesh({"data": 4})
        model = TransformerLM(cfg, device="cpu")
        model.load_state_dict(data["init"])
        wrapped = wrap(model)
        vocab = None
    else:
        mesh = make_mesh({"data": 2, "tensor": 2})
        model = TransformerLM(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(data["init"])
        wrapped = wrap(model, mesh=mesh, state_sharding=tensor_state_sharding(
            model_state(model), mesh, min_size=1))
        vocab = mesh
    rows = 8 // mesh.data_parallel_size
    index = mesh.data_parallel_index()
    local = data["tokens"][index * rows:(index + 1) * rows]
    optimizer = torch.optim.AdamW(wrapped.parameters(), lr=LR,
                                  weight_decay=1e-4)
    for _ in range(2):
        optimizer.zero_grad(set_to_none=True)
        logits = wrapped(local)
        vocab_parallel_cross_entropy(logits[:, :-1], local[:, 1:],
                                     vocab).mean().backward()
        norm = float(grad_norm(wrapped.parameters()))
        optimizer.step()
    summon = getattr(model, "summon_full_params", None)
    with summon() if summon else torch.no_grad():
        out[mode] = ({k: v.detach().clone()
                      for k, v in model.state_dict().items()}, norm)

lm.TransformerConfig = functools.partial(lm.TransformerConfig,
                                         dtype=torch.float32)
lcfg = json.loads((folder / "cfg.json").read_text())
for name, mesh in (("fsdp+tensor", {"data": 1, "fsdp": 2, "tensor": 2}),
                   ("lm_ddp", {"data": -1})):
    with temporary_xp():
        solver = lm.LMSolver(Config({**lcfg, "mesh": mesh}), device="cpu")
        sh = getattr(solver.model, "_sharded", None)
        solver.model.load_state_dict(
            data["lm_init"] if sh is None else {
                k: sh.shardings[k].shard(v).clone() if k in sh.shardings
                else v for k, v in data["lm_init"].items()})
        metrics = solver.run_stage("train", solver.train)
        summon = getattr(solver.model, "summon_full_params", None)
        with summon() if summon else torch.no_grad():
            out[name] = ({k: v.detach().clone()
                          for k, v in solver.model.state_dict().items()},
                         metrics["grad_norm"])
        if sh is not None:
            from flashy_tpu_torch.parallel import describe_state_sharding
            out["fsdp_summary"] = describe_state_sharding(
                {"params": dict(solver.model.named_parameters())})["summary"]
torch.save(out, folder / f"four{rank}.pt")
'''


def _jax_zero_tensor_reference(tokens):
    """The JAX package's wrap(step, state_sharding=tensor_state_sharding)
    on {"data": 4, "tensor": 2}, two optax.adamw steps on the whole
    batch: the final parameters in the port's layout."""
    import jax
    import jax.numpy as jnp
    import optax
    from flashy_tpu.models import TransformerConfig as JaxConfig
    from flashy_tpu.models import TransformerLM as JaxLM
    from flashy_tpu.parallel import (make_mesh, shard_batch,
                                     tensor_state_sharding, wrap)
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.models.transformer import TransformerConfig
    kwargs = dict(CFG["model"], remat=False)
    mesh = make_mesh({"data": 4, "tensor": 2})
    model = JaxLM(JaxConfig(**kwargs, dtype=jnp.float32), mesh=mesh)
    variables = jax.jit(model.init)(jax.random.PRNGKey(2),
                                    jnp.zeros((1, 8), jnp.int32))
    variables = {"params": variables["params"]}
    optim = optax.adamw(ADAM_LR, weight_decay=1e-4)
    state = {"params": variables, "opt_state": optim.init(variables)}

    def step(state, batch):
        def loss_fn(params):
            logits = model.apply(params, batch)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], batch[:, 1:]).mean()
        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = optim.update(grads, state["opt_state"],
                                          state["params"])
        return ({"params": optax.apply_updates(state["params"], updates),
                 "opt_state": opt_state}, {"loss": loss})

    spec = tensor_state_sharding(state, mesh, min_size=1)
    wrapped = wrap(step, mesh=mesh, batch_axes=("data",),
                   state_sharding=spec, donate_state=False)
    batch = shard_batch(jnp.asarray(tokens.numpy(), jnp.int32), mesh,
                        batch_axes=("data",))
    initial = params_from_jax(jax.tree.map(np.asarray, variables),
                              TransformerConfig(**kwargs))
    state = jax.device_put(state, spec)
    for _ in range(2):
        state, _ = wrapped(state, batch)
    return initial, params_from_jax(
        jax.tree.map(np.asarray, state["params"]), TransformerConfig(**kwargs))


def test_zero1_and_fsdp_with_tensor_on_four_gloo_ranks(tmp_path):
    tokens = torch.randint(0, 64, (8, 16),
                           generator=torch.Generator().manual_seed(1))
    init, jax_zero = _jax_zero_tensor_reference(tokens)
    lm_init, jax_lm = _jax_lm_reference(
        FOUR_LM, {"data": 2, "fsdp": 2, "tensor": 2})
    torch.save({"tokens": tokens, "init": init, "lm_init": lm_init,
                "lr": ADAM_LR,
                "model": dict(CFG["model"], remat=False)},
               tmp_path / "four.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(FOUR_LM))
    script = tmp_path / "four_worker.py"
    script.write_text(FOUR)
    env = _env(tmp_path / "rendezvous", tmp_path)
    runs = _spawn([([sys.executable, str(script), str(tmp_path)],
                    {"FLASHY_TPU_NUM_PROCESSES": "4",
                     "FLASHY_TPU_PROCESS_ID": str(rank)})
                   for rank in range(4)], tmp_path, env)
    for code, log in runs:
        assert code == 0, log[-3000:]
    ranks = [torch.load(tmp_path / f"four{r}.pt") for r in range(4)]
    for out in ranks:
        want, want_norm = out["ddp"]
        got, norm = out["tensor+zero1"]
        assert norm == pytest.approx(want_norm, rel=1e-5)
        for key, value in want.items():
            assert _rel(got[key], value) <= 1e-5, key
            assert _rel(got[key], jax_zero[key]) <= 1e-5, key
            assert torch.equal(got[key], ranks[0]["tensor+zero1"][0][key])
        want, want_norm = out["lm_ddp"]
        got, norm = out["fsdp+tensor"]
        assert norm == pytest.approx(want_norm, rel=1e-5)
        for key, value in jax_lm.items():
            assert _rel(got[key], value) <= 1e-5, key
            assert _rel(got[key], want[key]) <= 1e-5, key
        assert out["fsdp_summary"] == "tensor+fsdp(fsdp=2,tensor=2)"
