# The port's distrib (flashy_tpu_torch/distrib.py) in one process, against
# the JAX package's flashy_tpu.distrib: every helper is the identity (or a
# no-op) at world size 1, the same launcher environment gives the same rank
# and world size, the loader delegates to the sharded DataLoader, the
# host-sync warning fires once on the third large tree, and a launch whose
# entry point never called init() refuses every collective. The
# multi-process collectives are tests/test_torch_distrib_multiproc.py's.
import logging

import numpy as np
import pytest
import torch

from flashy_tpu import distrib as jax_distrib
from flashy_tpu_torch import distrib

LAUNCHER_ENV = ("FLASHY_TPU_COORDINATOR", "FLASHY_TPU_NUM_PROCESSES",
                "FLASHY_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(autouse=True)
def clean_launcher_env(monkeypatch):
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)


def test_single_process_identities():
    assert distrib.rank() == jax_distrib.rank() == 0
    assert distrib.world_size() == jax_distrib.world_size() == 1
    assert distrib.is_rank_zero()
    assert not distrib.is_distributed()


def test_rank_zero_only_runs():
    calls = []

    @distrib.rank_zero_only
    def fn(x):
        calls.append(x)
        return x

    assert fn(5) == 5
    assert calls == [5]
    assert fn.__name__ == "fn"


def test_average_metrics_identity():
    metrics = {"loss": 1.0, "acc": 0.5}
    assert distrib.average_metrics(metrics, count=3) is metrics
    assert distrib.average_metrics(metrics, count=3) == \
        jax_distrib.average_metrics(metrics, count=3)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_tree_helpers_identity(kind):
    if kind == "numpy":
        tree = {"w": np.ones(3), "n": np.array([2], dtype=np.int64)}
    else:
        tree = {"w": torch.ones(3), "n": torch.tensor([2])}
    for method in ("auto", "reduce", "allgather"):
        assert distrib.average_tensors(tree, method=method) is tree
    assert distrib.broadcast_tensors(tree) is tree
    assert distrib.sync_gradients(tree) is tree
    assert distrib.eager_sync_gradients(tree) is tree
    assert distrib.broadcast_model(tree) is tree
    model = torch.nn.Linear(2, 2)
    model(torch.ones(1, 2)).sum().backward()
    grad = model.weight.grad.clone()
    assert distrib.sync_gradients(model) is model
    assert distrib.broadcast_model(model) is model
    assert torch.equal(model.weight.grad, grad)


def test_sync_model_identity():
    params = {"w": np.ones(2)}
    stats = {"mean": np.zeros(2)}
    assert distrib.sync_model(params) is params
    new_params, new_stats = distrib.sync_model(params, stats)
    assert new_params is params and new_stats is stats
    assert distrib.eager_sync_model(params) is params
    norm = torch.nn.BatchNorm1d(3)
    weight = norm.weight.detach().clone()
    assert distrib.sync_model(norm, average_buffers=False) is norm
    assert torch.equal(norm.weight, weight)


def test_broadcast_object_identity():
    obj = {"a": [1, 2, 3]}
    assert distrib.broadcast_object(obj) is obj
    assert jax_distrib.broadcast_object(obj) is obj


def test_barrier_noop():
    distrib.barrier()  # must not hang or raise
    distrib.barrier("named")


def test_all_reduce_identity():
    x = np.array([1.0, 2.0])
    assert distrib.all_reduce(x) is x is jax_distrib.all_reduce(x)
    t = torch.tensor([1.0, 2.0])
    for op in ("sum", "mean", "max", "min"):
        assert distrib.all_reduce(t, op) is t
    assert distrib.all_reduce_max(7) == 7
    with pytest.raises(ValueError, match="Unsupported reduce op"):
        distrib.all_reduce(t, "prod")


def test_init_single_process_noop():
    distrib.init()
    assert distrib.world_size() == 1
    assert not torch.distributed.is_initialized()


def test_loader_delegates():
    data = [np.full((2,), i, dtype=np.float32) for i in range(10)]
    loader = distrib.loader(data, batch_size=2, shuffle=False)
    batches = list(loader)
    assert len(batches) == 5
    assert batches[0].shape == (2, 2)
    want = list(jax_distrib.loader(data, batch_size=2, shuffle=False))
    for got, ref in zip(batches, want):
        np.testing.assert_array_equal(got, ref)


def test_host_sync_warning_after_repeated_big_trees(monkeypatch, caplog):
    # simulate distribution so average_tensors takes the sync path while
    # stubbing the collectives (one process here)
    monkeypatch.setattr(distrib, "is_distributed", lambda: True)
    monkeypatch.setattr(distrib, "_require_backend", lambda: None)
    monkeypatch.setattr(distrib, "_check_tree_sizes", lambda tree: None)
    monkeypatch.setattr(distrib, "_reduce_mean", lambda floats: floats)
    monkeypatch.setattr(distrib, "_gather_mean", lambda floats: floats)
    monkeypatch.setattr(distrib, "_host_sync_big_calls", 0)
    big = {"w": np.zeros(400_000, np.float32)}  # > REDUCE_MIN_BYTES

    with caplog.at_level(logging.WARNING, logger="flashy_tpu_torch.distrib"):
        for _ in range(2):
            distrib.average_tensors(big)
        assert not any("average_tensors" in r.message for r in caplog.records)
        distrib.average_tensors(big)  # third large call -> one warning
        distrib.average_tensors(big)  # no repeat
    hits = [r for r in caplog.records if "distrib.wrap" in r.message]
    assert len(hits) == 1

    # small metric-sized trees never warn
    monkeypatch.setattr(distrib, "_host_sync_big_calls", 0)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="flashy_tpu_torch.distrib"):
        for _ in range(5):
            distrib.average_tensors({"loss": np.zeros(3, np.float32)},
                                    method="reduce")
    assert not caplog.records


def test_collectives_require_init(monkeypatch):
    """The launcher says distributed but init() was never called: every
    collective raises the clear RuntimeError, as the JAX package's do."""
    monkeypatch.setenv("FLASHY_TPU_COORDINATOR", "localhost:1")
    monkeypatch.setenv("FLASHY_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("FLASHY_TPU_PROCESS_ID", "1")
    assert distrib.is_distributed() and jax_distrib.is_distributed()
    for call in (lambda: distrib.broadcast_object({"kind": 1}),
                 lambda: distrib.barrier(),
                 lambda: distrib.all_reduce(np.ones(2)),
                 lambda: distrib.all_reduce_max(1),
                 lambda: distrib.average_metrics({"loss": 1.0}),
                 lambda: distrib.average_tensors({"w": np.ones(2)}),
                 lambda: distrib.broadcast_tensors({"w": np.ones(2)}),
                 lambda: distrib._check_tree_sizes({"w": np.ones(2)}),
                 lambda: distrib.wrap(torch.nn.Linear(2, 2))):
        with pytest.raises(RuntimeError, match="distrib.init"):
            call()


@pytest.mark.parametrize("env,rank,world", [
    ({}, 0, 1),
    ({"RANK": "3"}, 0, 1),  # a stray RANK alone does not count
    ({"MASTER_ADDR": "h", "WORLD_SIZE": "4", "RANK": "2"}, 2, 4),
    ({"FLASHY_TPU_COORDINATOR": "h:5", "FLASHY_TPU_NUM_PROCESSES": "3",
      "FLASHY_TPU_PROCESS_ID": "1", "RANK": "2", "MASTER_ADDR": "x",
      "WORLD_SIZE": "9"}, 1, 3),
])
def test_launcher_env_gives_the_jax_packages_rank_and_world(monkeypatch, env,
                                                            rank, world):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert distrib.rank() == jax_distrib.rank() == rank
    assert distrib.world_size() == jax_distrib.world_size() == world
    assert distrib.is_rank_zero() == jax_distrib.is_rank_zero()


def test_rendezvous_and_backend_choice(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert distrib._init_method() == "tcp://node0:29500"
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert distrib._init_method() == "tcp://node0:1234"
    monkeypatch.setenv("FLASHY_TPU_COORDINATOR", "localhost:7")
    monkeypatch.setenv("FLASHY_TPU_NUM_PROCESSES", "2")
    assert distrib._init_method() == "tcp://localhost:7"
    monkeypatch.setenv("FLASHY_TPU_COORDINATOR", "file:///tmp/rendezvous")
    assert distrib._init_method() == "file:///tmp/rendezvous"
    assert distrib.local_rank_world() == (0, 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distrib.local_rank_world() == (1, 2)
    # NCCL only where each local rank has a card of its own
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distrib.default_backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distrib.default_backend() == "gloo"  # two ranks share a card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distrib.default_backend() == "nccl"
