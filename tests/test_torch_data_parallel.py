# The port's data-parallel layer (flashy_tpu_torch/parallel/data_parallel.py)
# in one process, against the JAX package's flashy_tpu.parallel on the cases
# of tests/test_parallel.py: with_grad_accumulation equal to the full batch
# and to the JAX accumulation, bf16 gradients summed in f32 (bit-equal to
# the JAX result), the identity for one microbatch, the dropout seed folded
# per microbatch; wrap, shard_batch and replicate at world size 1; and the
# dropout RowShard: two ranks' rows of a global draw equal the one-process
# draw over the whole batch.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashy_tpu.parallel import with_grad_accumulation as jax_accumulation
from flashy_tpu_torch.parallel import (shard_batch, with_grad_accumulation,
                                       wrap)


def _linear_case(seed=11):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = rng.normal(size=(16, 3)).astype(np.float32)
    return w, x, y


class Linear(torch.nn.Module):
    def __init__(self, w, dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w).to(dtype))


@pytest.mark.parametrize("num_micro", [2, 4, 8])
def test_grad_accumulation_matches_full_batch_and_jax(num_micro):
    w, x, y = _linear_case()

    def jax_loss(w, batch):
        return jnp.mean((batch[:, :6] @ w - batch[:, 6:]) ** 2)

    batch = np.concatenate([x, y], axis=1)
    want_loss, want_grad = jax.jit(jax_accumulation(
        jax.value_and_grad(jax_loss), num_micro))(jnp.asarray(w),
                                                  jnp.asarray(batch))

    def value_and_grad(model, batch):
        loss = torch.mean((batch[:, :6] @ model.w - batch[:, 6:]) ** 2)
        loss.backward()
        return loss.detach()

    model = Linear(w)
    loss = with_grad_accumulation(value_and_grad, num_micro)(
        model, torch.from_numpy(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(model.w.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6)
    full = Linear(w)
    full_loss = value_and_grad(full, torch.from_numpy(batch))
    np.testing.assert_allclose(float(loss), float(full_loss), rtol=1e-6)
    np.testing.assert_allclose(model.w.grad.numpy(), full.w.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        with_grad_accumulation(value_and_grad, 3)(model,
                                                  torch.from_numpy(batch))


def test_grad_accumulation_bf16_accumulates_in_f32_as_jax():
    # one big addend, then a tail of small ones: a bf16 running sum at
    # ~100 has a spacing of 0.5, so every later 0.25 rounds away
    num_micro = 16
    rows = np.full((num_micro, 8), 0.25, np.float32)
    rows[0] = 100.0

    def jax_value_and_grad(w, batch):
        grads = jnp.mean(batch, axis=0).astype(jnp.bfloat16)
        return jnp.mean(batch).astype(jnp.bfloat16), grads

    want_loss, want = jax.jit(jax_accumulation(jax_value_and_grad, num_micro))(
        jnp.ones((8,), jnp.bfloat16), jnp.asarray(rows))

    def value_and_grad(model, batch):
        # a loss whose gradient is the microbatch's mean row, in the
        # parameter's bf16
        loss = (model.w * batch.mean(dim=0).to(torch.bfloat16)).sum()
        loss.backward()
        return batch.mean().to(torch.bfloat16)

    model = Linear(np.ones(8, np.float32), dtype=torch.bfloat16)
    loss = with_grad_accumulation(value_and_grad, num_micro)(
        model, torch.from_numpy(rows))
    assert model.w.grad.dtype == torch.bfloat16
    assert loss.dtype == torch.bfloat16
    got = model.w.grad.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert float(loss) == float(want_loss)
    ref = rows.mean(axis=0)
    assert np.max(np.abs(got - ref)) <= 0.016  # only the final bf16 rounding


def test_grad_accumulation_identity_for_one_and_checks_fold_rng():
    def fn(model, batch):
        return batch.sum()

    assert with_grad_accumulation(fn, 1) is fn
    assert jax_accumulation(fn, 1) is fn
    with pytest.raises(ValueError, match="fold_rng"):
        with_grad_accumulation(fn, 2, fold_rng="maybe")
    with pytest.raises(ValueError, match="fold_rng"):
        jax_accumulation(fn, 2, fold_rng="maybe")


def test_grad_accumulation_folds_the_dropout_seed_per_microbatch():
    from flashy_tpu_torch.models.transformer import RowShard, fold_seed
    seeds = []

    def value_and_grad(model, batch, dropout_seed=None):
        seeds.append(dropout_seed)
        loss = (model.w * batch.mean()).sum()
        loss.backward()
        return loss.detach()

    model = Linear(np.ones(2, np.float32))
    batch = torch.ones(8, 2)
    for fold in (True, "typed"):
        seeds.clear()
        with_grad_accumulation(value_and_grad, 4, fold_rng=fold)(
            model, batch, dropout_seed=5)
        assert seeds == [fold_seed(5, i) for i in range(4)]
    seeds.clear()
    with_grad_accumulation(value_and_grad, 4, fold_rng=False)(
        model, batch, dropout_seed=5)
    assert seeds == [5] * 4
    # a data-parallel rank's seed keeps its rows
    seeds.clear()
    with_grad_accumulation(value_and_grad, 2)(
        model, batch, dropout_seed=RowShard(5, 1, 2))
    assert seeds == [RowShard(fold_seed(5, i), 1, 2) for i in range(2)]
    seeds.clear()
    with_grad_accumulation(value_and_grad, 2)(model, batch)
    assert seeds == [None, None]


def test_row_shard_dropout_draws_the_global_batch_rows():
    from flashy_tpu_torch.models.transformer import (RowShard,
                                                     TransformerConfig,
                                                     TransformerLM, dropout)
    x = torch.ones(6, 5, 4)
    whole = dropout(x, 0.5, 17)
    parts = [dropout(x[2 * r:2 * r + 2], 0.5, RowShard(17, r, 3))
             for r in range(3)]
    assert torch.equal(torch.cat(parts), whole)
    cfg = TransformerConfig(vocab_size=32, dim=16, num_layers=2, num_heads=2,
                            max_seq_len=8, dtype=torch.float32,
                            attention="dense", dropout=0.2)
    model = TransformerLM(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 32, (4, 8)))
    want = model(tokens, train=True, dropout_seed=3)
    got = torch.cat([model(tokens[2 * r:2 * r + 2], train=True,
                           dropout_seed=RowShard(3, r, 2)) for r in range(2)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not torch.equal(got, model(tokens, train=True, dropout_seed=4))


def test_wrap_at_one_rank_is_the_model_and_counts_calls():
    from flashy_tpu_torch import distrib, parallel
    model = torch.nn.Linear(3, 2)
    wrapped = wrap(model)
    assert wrapped is model and distrib.wrap(model) is model
    for _ in range(3):
        wrapped(torch.ones(1, 3))
    assert wrapped.compile_stats() == {"calls": 3, "compiles": 0,
                                       "recompiles": 0}
    decorated = wrap()(torch.nn.Linear(2, 2))
    assert decorated.compile_stats()["calls"] == 0
    # the sharded forms (queue A item 8a) at one rank: FSDP leaves the
    # model whole, a ZeRO layout over data=1 shards no update
    from flashy_tpu_torch.parallel import P, zero
    mesh = parallel.make_mesh({"data": -1})
    assert wrap(model, fsdp=True) is model
    assert not hasattr(model, "_sharded")
    zeroed = wrap(model, state_sharding=zero.zero_sharding(
        zero.model_state(model), mesh, min_size=1))
    assert [id(p) for p in zeroed.parameters()] == \
        [id(p) for p in model.parameters()]
    x = torch.ones(1, 3)
    assert torch.equal(zeroed(x), model(x))
    with pytest.raises(TypeError, match="nn.Module"):
        wrap(lambda state, batch: state)
    w = torch.ones(2)
    assert parallel.fsdp_sharding({"w": w})["w"].spec == P()
    assert parallel.shard_params({"w": w})["w"] is w
    from flashy_tpu_torch.parallel import data_parallel
    assert data_parallel.batch_spec() == P(("data", "fsdp"))
    assert data_parallel.axis_leaf_sharding(mesh, "data", 1)(w).spec == P()


def test_shard_batch_and_replicate_place_the_local_batch(monkeypatch):
    from flashy_tpu_torch.parallel import make_mesh, replicate
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "pair": (np.ones(2, np.float32), torch.zeros(2)), "name": "b"}
    for placed in (shard_batch(batch, device="cpu"),
                   shard_batch(batch, make_mesh({"seq": 2}, ["cpu"] * 2)),
                   replicate(batch, device="cpu")):
        assert placed["name"] == "b"
        assert placed["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(placed["tokens"].numpy(),
                                      batch["tokens"])
        assert isinstance(placed["pair"], tuple)
        assert placed["pair"][0].device.type == "cpu"
    with pytest.raises(ValueError, match="batch axes"):
        shard_batch(batch, batch_axes=("seq",), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_batch(batch)
