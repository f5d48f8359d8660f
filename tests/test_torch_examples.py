# The port's basic, cifar, mlm and translate examples against the JAX
# package's, in f32 on the CPU at tiny widths:
#  * basic: a run stopped after its epoch-2 checkpoint and resumed gives
#    a history and weights bit-equal to the uninterrupted run's; its
#    first 3 Adam steps within 1e-5 of the JAX solver's on the same
#    initial weights (optax's f32 bias corrections against torch's f64);
#  * cifar: 3 SGD steps of a tiny ResNet at flax's init against optax's
#    chain (add_decayed_weights, then nesterov sgd under the cosine
#    schedule): each step's loss within 1e-6 relative, every parameter and
#    statistic after them within rtol 1e-5, atol 1e-5 (a block whose last
#    BatchNorm starts at scale 0 puts its output within rounding of
#    relu's kink, so an element's last bit picks its side: one bias moved
#    by 1.9e-6 of its 3e-3 here); the padded, masked eval equal to an
#    unpadded one, in one shard and in two;
#  * the data: `_synthetic`, `synthetic_pairs` and the MLM `batch_at`
#    bit-equal to the JAX ones;
#  * an MLM and a translate loss against the JAX solvers' `loss_fn` on
#    converted tiny weights within 1e-5.
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

WALL_CLOCK = ("duration", "images_per_sec")


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


def _history(folder):
    history = json.loads((folder / "history.json").read_text())
    return [{stage: {k: v for k, v in metrics.items() if k not in WALL_CLOCK}
             for stage, metrics in epoch.items()} for epoch in history]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


class _Killed(Exception):
    pass


@pytest.fixture()
def no_tensorboard(monkeypatch):
    """The basic solvers attach TensorBoard, whose writer imports
    TensorFlow where it is installed (seconds); these tests read the XP
    folder instead."""
    import flashy_tpu
    import flashy_tpu_torch
    for solver in (flashy_tpu.BaseSolver, flashy_tpu_torch.BaseSolver):
        monkeypatch.setattr(solver, "init_tensorboard", lambda self: None)


def test_basic_resumes_bit_exactly(tmp_path, monkeypatch, root_logging,
                                   no_tensorboard):
    from flashy_tpu_torch.examples.basic import train as basic
    args = ["device=cpu", "epochs=4", "batch_size=8"]
    whole = basic.main(args + [f"dora.dir={tmp_path / 'a'}"])
    assert len(whole.history) == 4
    assert whole.history[-1]["train"]["loss"] < \
        whole.history[0]["train"]["loss"]
    # only even epochs write a checkpoint: die after epoch 2's
    commit = basic.Solver.commit

    def commit_then_die(self, save_checkpoint=True):
        commit(self, save_checkpoint=save_checkpoint)
        if len(self.history) == 2:
            raise _Killed()

    monkeypatch.setattr(basic.Solver, "commit", commit_then_die)
    with pytest.raises(_Killed):
        basic.main(args + [f"dora.dir={tmp_path / 'b'}"])
    monkeypatch.setattr(basic.Solver, "commit", commit)
    resumed = basic.main(args + [f"dora.dir={tmp_path / 'b'}"])
    assert resumed.folder.name == whole.folder.name
    assert _history(resumed.folder) == _history(whole.folder)
    for name, value in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    assert resumed.best_state["loss"] == whole.best_state["loss"]
    assert all(v.device.type == "cpu"
               for v in resumed.best_state["params"].values())


def test_basic_steps_match_jax(no_tensorboard):
    import examples.basic.train as jax_basic
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.examples.basic import train as basic
    from flashy_tpu_torch.models.convert import mlp_from_jax
    from flashy_tpu_torch.xp import Config, temporary_xp
    cfg = {"epochs": 1, "lr": 0.01, "batch_size": 8}
    with jax_xp():
        jax_solver = jax_basic.Solver(JaxConfig(cfg))
        params, opt_state = jax_solver.params, jax_solver.opt_state
        with temporary_xp():
            solver = basic.Solver(Config(cfg), device="cpu")
            solver.model.load_state_dict(mlp_from_jax(
                jax.tree.map(np.asarray, params), solver.model))
            rng = np.random.default_rng(0)
            for _ in range(3):
                x = rng.normal(size=(8, 32)).astype(np.float32)
                y = x.sum(axis=1, keepdims=True) * 0.1
                params, opt_state, want = jax_solver._step(
                    params, opt_state, jnp.asarray(x), jnp.asarray(y))
                got = solver.step(torch.from_numpy(x), torch.from_numpy(y))
                assert abs(float(got) - float(want)) <= 1e-5 * float(want)
            state = mlp_from_jax(jax.tree.map(np.asarray, params),
                                 solver.model)
            for name, value in solver.model.state_dict().items():
                assert _rel(value, state[name]) <= 1e-5, name


@pytest.mark.parametrize("example", ["basic", "cifar", "mlm", "translate"])
def test_configs_keep_the_jax_values_and_signatures(example):
    # the port's configs add `device` and root their XPs apart; every key
    # both have keeps the JAX package's value, and the signature excludes
    # what the JAX package's excludes (and `device`)
    from pathlib import Path
    import yaml
    from flashy_tpu_torch.xp import flatten_config
    root = Path(__file__).resolve().parent.parent
    jax_cfg = yaml.safe_load((root / "examples" / example / "config"
                              / "config.yaml").read_text())
    port_cfg = yaml.safe_load((root / "flashy_tpu_torch" / "examples"
                               / example / "config" / "config.yaml")
                              .read_text())
    port, theirs = flatten_config(port_cfg), flatten_config(jax_cfg)
    shared = (set(port) & set(theirs)) - {"dora.dir", "dora.exclude"}
    assert {k: port[k] for k in shared} == {k: theirs[k] for k in shared}
    assert set(port) - set(theirs) <= {"device", "dora.exclude"}
    assert set(theirs) - set(port) == set()
    assert port["dora.dir"] == "./outputs_torch"
    assert set(port["dora.exclude"]) == \
        set(jax_cfg["dora"].get("exclude", [])) | {"device"}


# ----------------------------------------------------------------------
# cifar
# ----------------------------------------------------------------------
CIFAR_CFG = {"model": "tiny", "epochs": 1, "batch_size": 16, "lr": 0.1,
             "momentum": 0.9, "weight_decay": 5e-4, "max_batches": 3,
             "data_parallel": -1, "target_acc": 0.94}


@functools.lru_cache(maxsize=None)
def _cifar_data():
    from flashy_tpu_torch.examples.cifar.data import _synthetic
    return _synthetic(512, 100)


def _tiny_resnet(num_classes, device, seed):
    from flashy_tpu_torch.models.resnet import BasicBlock, ResNet
    return ResNet((1, 1), BasicBlock, num_classes=num_classes, num_filters=8,
                  dtype=torch.float32, device=device, seed=seed)


def _cifar_solver(monkeypatch, cfg=CIFAR_CFG):
    from flashy_tpu_torch import distrib
    from flashy_tpu_torch.examples.cifar import solver as cifar
    from flashy_tpu_torch.examples.cifar.data import CifarDataset
    from flashy_tpu_torch.xp import Config
    monkeypatch.setitem(cifar.MODELS, "tiny", _tiny_resnet)
    x_train, y_train, x_test, y_test = _cifar_data()
    loaders = {
        "train": distrib.loader(CifarDataset(x_train, y_train, augment=True),
                                batch_size=cfg["batch_size"], shuffle=True),
        "valid": distrib.loader(CifarDataset(x_test, y_test),
                                batch_size=cfg["batch_size"],
                                pad_to_even=True)}
    return cifar.Solver(Config(cfg), loaders, device="cpu")


def test_cifar_sgd_steps_match_optax(monkeypatch):
    from flashy_tpu.models.resnet import BasicBlock as JaxBasic
    from flashy_tpu.models.resnet import ResNet as JaxResNet
    from flashy_tpu_torch.models.convert import resnet_from_jax
    from flashy_tpu_torch.xp import temporary_xp
    jax_model = JaxResNet((1, 1), JaxBasic, num_filters=8,
                          dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    cfg = CIFAR_CFG
    optim = optax.chain(
        optax.add_decayed_weights(cfg["weight_decay"]),
        optax.sgd(optax.cosine_decay_schedule(cfg["lr"], 3),
                  momentum=cfg["momentum"], nesterov=True))

    @jax.jit
    def step(params, stats, opt_state, images, labels):
        def loss_fn(params):
            logits, mutated = jax_model.apply(
                {"params": params, "batch_stats": stats}, images, train=True,
                mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean(), mutated["batch_stats"]
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = optim.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    with temporary_xp():
        solver = _cifar_solver(monkeypatch)
        solver.model.load_state_dict(resnet_from_jax(variables,
                                                     solver.model))
        params, stats = variables["params"], variables["batch_stats"]
        opt_state = optim.init(params)
        for index, batch in enumerate(solver.loaders["train"]):
            if index == 3:
                break
            params, stats, opt_state, want = step(
                params, stats, opt_state, batch["image"], batch["label"])
            got = solver.train_step({k: torch.from_numpy(v)
                                     for k, v in batch.items()})["loss"]
            assert abs(float(got) - float(want)) <= 1e-6 * float(want)
        assert solver.state["step"] == 3
        want = resnet_from_jax({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray,
                                                            stats)},
                               solver.model)
        for name, value in solver.model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def test_cifar_padded_eval_equals_unpadded(monkeypatch):
    from flashy_tpu_torch.data import DataLoader
    from flashy_tpu_torch.examples.cifar.data import MEAN, STD, CifarDataset
    from flashy_tpu_torch.xp import temporary_xp
    _, _, x_test, y_test = _cifar_data()
    with temporary_xp():
        solver = _cifar_solver(monkeypatch, {**CIFAR_CFG,
                                             "max_batches": None})
        with torch.no_grad():
            logits = solver.model(torch.from_numpy((x_test - MEAN) / STD),
                                  train=False)
            labels = torch.from_numpy(y_test).long()
            want_loss = float(torch.nn.functional.cross_entropy(logits,
                                                                labels))
            want_acc = float((logits.argmax(-1) == labels).float().mean())
        for shards in (1, 2):
            totals = np.zeros(3)
            for shard in range(shards):
                loader = DataLoader(CifarDataset(x_test, y_test),
                                    batch_size=16, num_shards=shards,
                                    shard_index=shard, pad_to_even=True)
                for batch, mask in loader:
                    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
                    batch["valid"] = torch.from_numpy(mask.astype(np.float32))
                    sums = solver.eval_step(batch)
                    totals += [float(sums[k]) for k in ("loss_sum",
                                                        "acc_sum", "n")]
            assert totals[2] == len(y_test)
            assert totals[0] / totals[2] == pytest.approx(want_loss,
                                                          rel=1e-6)
            assert totals[1] / totals[2] == pytest.approx(want_acc, rel=1e-6)
        # the solver's own valid stage over the padded loader
        metrics = solver.run_stage("valid", solver._run_epoch, train=False)
        assert metrics["loss"] == pytest.approx(want_loss, rel=1e-6)
        assert metrics["acc"] == pytest.approx(want_acc, rel=1e-6)


def test_cifar_data_is_the_jax_packages():
    import examples.cifar.data as jax_data
    from flashy_tpu_torch.examples.cifar import data
    for got, want in zip(data._synthetic(64, 16, seed=3),
                         jax_data._synthetic(64, 16, seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    images, labels = data._synthetic(32, 8)[:2]
    for augment in (False, True):
        ours = data.CifarDataset(images, labels, augment=augment, seed=1)
        theirs = jax_data.CifarDataset(images, labels, augment=augment,
                                       seed=1)
        for index in range(4):
            a, b = ours[index], theirs[index]
            np.testing.assert_array_equal(a["image"], b["image"])
            assert a["label"] == b["label"]


# ----------------------------------------------------------------------
# mlm and translate
# ----------------------------------------------------------------------
MLM_CFG = {"model": {"vocab_size": 64, "dim": 32, "num_layers": 2,
                     "num_heads": 2, "mlp_ratio": 2, "attention": "dense",
                     "remat": False},
           "mesh": {"data": -1, "fsdp": 1, "tensor": 1},
           "seq_len": 16, "batch_size": 8, "mask_prob": 0.15,
           "mask_token": 5, "epochs": 1, "steps_per_epoch": 2,
           "valid_steps": 1, "lr": 1e-2, "warmup_steps": 1,
           "weight_decay": 0.01}
TRANSLATE_CFG = {"model": {"vocab_size": 64, "dim": 32, "enc_layers": 1,
                           "dec_layers": 2, "num_heads": 2, "mlp_ratio": 2,
                           "attention": "dense"},
                 "mesh": {"data": -1, "fsdp": 1, "tensor": 1},
                 "src_len": 12, "batch_size": 8, "task": "reverse",
                 "bos_token": 1, "epochs": 1, "steps_per_epoch": 2,
                 "valid_steps": 1, "translate_every": 1, "lr": 1e-2,
                 "warmup_steps": 1, "weight_decay": 0.01}


def _f32(monkeypatch, module, name, dtype):
    """Make module.<name> (a config class) build f32 configs."""
    monkeypatch.setattr(module, name, functools.partial(
        getattr(module, name), dtype=dtype))


@pytest.mark.parametrize("seed,task", [(0, "reverse"), (3, "copy")])
def test_synthetic_pairs_are_the_jax_packages(seed, task):
    import examples.translate.solver as jax_translate
    from flashy_tpu_torch.examples.translate.solver import synthetic_pairs
    ours = synthetic_pairs(100, task, seed)
    theirs = jax_translate.synthetic_pairs(100, task, seed)
    for step, subset in ((0, 0), (7, 1)):
        for got, want in zip(ours(4, 9, step, subset),
                             theirs(4, 9, step, subset)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="reverse"):
        synthetic_pairs(100, "sort")


def test_mlm_batches_and_loss_match_jax(monkeypatch):
    import examples.mlm.solver as jax_mlm
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.examples.mlm import solver as mlm
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.xp import Config, temporary_xp
    _f32(monkeypatch, jax_mlm, "TransformerConfig", jnp.float32)
    _f32(monkeypatch, mlm, "TransformerConfig", torch.float32)
    with jax_xp():
        jax_solver = jax_mlm.MLMSolver(JaxConfig(MLM_CFG))
        with temporary_xp():
            solver = mlm.MLMSolver(Config(MLM_CFG), device="cpu")
            solver.model.load_state_dict(params_from_jax(
                jax.tree.map(np.asarray, jax_solver.state["params"]),
                solver.model.config))
            for step, eval_set in ((0, False), (5, False), (1, True)):
                want = jax_solver.batch_at(step, eval_set=eval_set)
                got = solver.batch_at(step, eval_set=eval_set)
                assert set(got) == set(want)
                for key, value in got.items():
                    np.testing.assert_array_equal(value,
                                                  np.asarray(want[key]))
                assert not (got["labels"] == MLM_CFG["mask_token"]).any()
                jax_loss = float(jax_solver._eval_step(
                    jax_solver.state["params"], want))
                packed, count = solver._local(got)
                with torch.no_grad():
                    loss = float(mlm.masked_loss(solver.model, packed,
                                                 count))
                assert loss == pytest.approx(jax_loss, rel=1e-5)


def test_translate_loss_matches_jax(monkeypatch):
    import examples.translate.solver as jax_translate
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.examples.translate import solver as translate
    from flashy_tpu_torch.models.convert import seq2seq_from_jax
    from flashy_tpu_torch.xp import Config, temporary_xp
    _f32(monkeypatch, jax_translate, "Seq2SeqConfig", jnp.float32)
    _f32(monkeypatch, translate, "Seq2SeqConfig", torch.float32)
    with jax_xp():
        jax_solver = jax_translate.TranslateSolver(JaxConfig(TRANSLATE_CFG))
        with temporary_xp():
            solver = translate.TranslateSolver(Config(TRANSLATE_CFG),
                                               device="cpu")
            assert solver.model.config.max_seq_len == 128
            solver.model.load_state_dict(seq2seq_from_jax(
                jax.tree.map(np.asarray, jax_solver.state["params"]),
                solver.model))
            for step, eval_set in ((0, False), (2, True)):
                want = jax_solver.batch_at(step, eval_set=eval_set)
                got = solver.batch_at(step, eval_set=eval_set)
                for key, value in got.items():
                    np.testing.assert_array_equal(value,
                                                  np.asarray(want[key]))
                jax_loss = float(jax_solver._eval_step(
                    jax_solver.state["params"], want))
                with torch.no_grad():
                    loss = float(translate.teacher_loss(
                        solver.model, solver._local(got)))
                assert loss == pytest.approx(jax_loss, rel=1e-5)
            metrics = solver.run_stage("valid", solver.valid)
            assert 0.0 <= metrics["seq_acc"] <= metrics["tok_acc"] <= 1.0
