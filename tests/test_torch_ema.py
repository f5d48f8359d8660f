# The port's parameter EMA (flashy_tpu_torch/ema.py and the LM solver's
# ema_decay) held against the JAX package: `ema_update` on the same numpy
# inputs within one f32 ulp per fold (XLA may contract s * d + p * (1 - d)
# into an FMA, the port's foreach add may too); EMA's restore warnings
# and refusals; the tiny LM solver's shadow after three steps against the
# JAX solver's on converted weights, both in f32, within the AdamW drift
# of ROADMAP queue C (optax's bias corrections in f32, torch's in f64:
# 1e-5 relative in norm per leaf); the shadow's checkpoint round trip and
# both `_reconcile_ema` branches.
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_solver import root_logging  # noqa: F401


def _trees(seed=0, shapes=((4, 3), (5,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    shadow = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return shadow, params


@pytest.mark.parametrize("decay", [0.9, 0.999])
@pytest.mark.parametrize("with_step", [False, True],
                         ids=["no_step", "step"])
def test_ema_update_matches_jax_within_one_ulp_a_fold(decay, with_step):
    from flashy_tpu.ema import ema_update as jax_update
    from flashy_tpu_torch.ema import ema_update
    shadow, params = _trees()
    jax_shadow = [jnp.asarray(s) for s in shadow]
    port_shadow = [torch.from_numpy(s.copy()) for s in shadow]
    fold = jax.jit(jax_update, static_argnames=("decay",))
    folds = 6
    for step in range(folds):
        _, params = _trees(seed=10 + step)
        jax_shadow = fold(jax_shadow, [jnp.asarray(p) for p in params],
                          decay=decay,
                          step=jnp.asarray(step) if with_step else None)
        out = ema_update(port_shadow, [torch.from_numpy(p) for p in params],
                         decay, step=step if with_step else None)
        assert out is port_shadow
    for got, want in zip(port_shadow, jax_shadow):
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=folds)


def test_effective_decay_is_the_jax_warm_up_in_f32():
    from flashy_tpu_torch.ema import effective_decay
    for step in range(0, 2000, 7):
        want = jnp.minimum(jnp.float32(0.999),
                           (1.0 + jnp.float32(step)) / (10.0 + jnp.float32(step)))
        got = effective_decay(0.999, step)
        assert got.dtype == np.float32 and got == np.float32(want), step
    assert effective_decay(0.5) == np.float32(0.5)


def test_ema_update_keeps_the_shadow_f32_for_bf16_params():
    from flashy_tpu_torch.ema import EMA
    params = {"w": torch.randn(8, dtype=torch.bfloat16)}
    ema = EMA(params, decay=0.5)
    assert ema.shadow["w"].dtype == torch.float32
    start = ema.shadow["w"].clone()
    new = {"w": torch.randn(8, dtype=torch.bfloat16)}
    ema.update(new)
    torch.testing.assert_close(ema.shadow["w"],
                               start * 0.5 + new["w"].float() * 0.5)


def test_ema_restore_warns_and_refuses_as_the_jax_package(caplog):
    from flashy_tpu_torch.ema import EMA
    params = {"a": torch.randn(3, 2), "b": torch.randn(4)}
    ema = EMA(params, decay=0.99)
    saved = {"decay": 0.9, "shadow": {k: v + 1 for k, v in
                                       ema.shadow.items()}}
    live = ema.shadow["a"]
    with caplog.at_level(logging.WARNING, logger="flashy_tpu_torch.ema"):
        ema.load_state_dict(saved)
    assert "EMA decay mismatch on restore" in caplog.text
    assert ema.decay == 0.99
    # restored in place, bit for bit
    assert ema.shadow["a"] is live
    assert torch.equal(ema.shadow["a"], saved["shadow"]["a"])
    # a checkpoint's numpy leaves load too
    ema.load_state_dict({"decay": 0.99, "shadow": [
        np.zeros((3, 2), np.float32), np.ones(4, np.float32)]})
    assert torch.equal(ema.shadow["b"], torch.ones(4))
    with pytest.raises(ValueError, match="leaves"):
        ema.load_state_dict({"decay": 0.99, "shadow": [torch.zeros(3, 2)]})
    with pytest.raises(ValueError, match="shapes differ"):
        ema.load_state_dict({"decay": 0.99, "shadow": {
            "a": torch.zeros(2, 3), "b": torch.zeros(4)}})


def _solver_cfg(decay, mesh):
    return {
        "model": {"vocab_size": 64, "dim": 32, "num_layers": 1,
                  "num_heads": 2, "mlp_ratio": 2, "attention": "dense"},
        "mesh": mesh, "seq_len": 16, "batch_size": 8, "accumulate": 1,
        "steps_per_epoch": 3, "epochs": 1, "valid_steps": 1,
        "generate_every": 0, "lr": 1e-2, "warmup_steps": 1,
        "weight_decay": 0.1, "ema_decay": decay, "device": "cpu"}


def test_lm_solver_shadow_matches_the_jax_solvers(monkeypatch):
    import examples.lm.solver as jax_lm
    from flashy_tpu.xp import Config as JaxConfig
    from flashy_tpu.xp import temporary_xp as jax_xp
    from flashy_tpu_torch.examples.lm import solver as port_lm
    from flashy_tpu_torch.models.convert import params_from_jax
    from flashy_tpu_torch.xp import Config, temporary_xp
    # both solvers compute in f32 here (their default is bf16)
    monkeypatch.setattr(jax_lm, "TransformerConfig", functools.partial(
        jax_lm.TransformerConfig, dtype=jnp.float32))
    monkeypatch.setattr(port_lm, "TransformerConfig", functools.partial(
        port_lm.TransformerConfig, dtype=torch.float32))
    with jax_xp():
        jax_solver = jax_lm.LMSolver(JaxConfig(_solver_cfg(0.9,
                                                           {"data": 8})))
        params = jax.tree.map(np.asarray, jax_solver.state["params"])
        state = jax_solver.state
        for step in range(3):
            state, _ = jax_solver._train_step(state, jax_solver.batch_at(step))
        want = params_from_jax(jax.tree.map(np.asarray, state["ema"]),
                               jax_solver.model.config)
        want_params = params_from_jax(jax.tree.map(np.asarray,
                                                   state["params"]),
                                      jax_solver.model.config)
    with temporary_xp():
        solver = port_lm.LMSolver(Config(_solver_cfg(0.9, {"data": -1})),
                                  device="cpu")
        solver.model.load_state_dict(params_from_jax(params,
                                                     solver.model.config))
        solver.reset_ema()
        solver.run_stage("train", solver.train)
        assert solver.state["step"] == 3
        got = solver.state["ema"]
        live = dict(solver.model.named_parameters())
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == torch.float32
        err = float((got[name] - value).norm() / value.norm())
        assert err <= 1e-5, (name, err)
        # the shadow trails the live params: it is not a copy of them
        assert not torch.equal(got[name], live[name].detach()) \
            or torch.equal(want_params[name], value), name


TINY_ARGS = ["device=cpu", "model.vocab_size=64", "model.dim=32",
             "model.num_layers=1", "model.num_heads=2", "model.mlp_ratio=2",
             "seq_len=16", "batch_size=4", "steps_per_epoch=2",
             "valid_steps=1", "warmup_steps=1", "lr=1e-2"]


def test_lm_solver_ema_checkpoint_and_reconcile(tmp_path, capsys,
                                                root_logging):  # noqa: F811
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    # ema_decay out of the signature, so that a run without EMA resumes
    # the same XP
    args = TINY_ARGS + [f"dora.dir={tmp_path}", "model.remat=true",
                        "model.remat_policy=dots", "dora.exclude=[epochs,"
                        "ema_decay,device]"]
    first = lm_main(args + ["ema_decay=0.99", "epochs=1"])
    saved = {name: t.clone() for name, t in first.state["ema"].items()}
    live = dict(first.model.named_parameters())
    assert all(not torch.equal(saved[n], live[n].detach()) for n in saved)
    # valid ran on the shadow
    with torch.no_grad():
        want = first.loss(first.batch_at(0, eval_set=True),
                          params=first.state["ema"])
        live_loss = first.loss(first.batch_at(0, eval_set=True))
    assert first.history[0]["valid"]["loss"] == pytest.approx(float(want))
    assert float(want) != float(live_loss)
    # epochs=1 again: restore and reconcile, no more training; the
    # shadow comes back bit for bit
    resumed = lm_main(args + ["ema_decay=0.99", "epochs=1"])
    assert resumed.restored and resumed.state["step"] == 2
    assert list(resumed.state["ema"]) == list(saved)
    for name, value in saved.items():
        assert torch.equal(resumed.state["ema"][name], value), name
    # without EMA the shadow is dropped, loudly (the solver's log goes to
    # stderr), and training goes on
    capsys.readouterr()
    dropped = lm_main(args + ["ema_decay=0", "epochs=2"])
    assert dropped.restored and "ema" not in dropped.state
    assert dropped.state["step"] == 4
    assert "ema_decay=0 but the checkpoint carries an EMA shadow" in \
        capsys.readouterr().err


def test_lm_solver_reinitializes_a_missing_shadow(tmp_path, caplog,
                                                  root_logging):  # noqa: F811
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.xp import Config, temporary_xp
    with temporary_xp():
        solver = LMSolver(Config(_solver_cfg(0.9, {"data": -1})),
                          device="cpu")
        del solver.state["ema"]   # a checkpoint written without EMA
        with caplog.at_level(logging.WARNING):
            solver._reconcile_ema()
        assert "re-initializing the shadow" in caplog.text
        for name, p in solver.model.named_parameters():
            assert torch.equal(solver.state["ema"][name], p.detach())
            assert solver.state["ema"][name].data_ptr() != p.data_ptr()
