# The port's data loading (flashy_tpu_torch/data) against the JAX
# package's flashy_tpu.data on the same datasets: sampler indices for
# several (length, shards, seed, epoch) including a dataset smaller than
# the shard count, strided shards, the padded eval's coverage and masks,
# nested collation, masked_mean, threaded workers equal to inline; and
# prefetch_to_device on the CPU delivering the same batches, closing its
# source on an early stop and rewinding a datapipe stage past the batches
# it still held.
import numpy as np
import pytest
import torch

from flashy_tpu import data as jax_data
from flashy_tpu.data.loader import default_collate as jax_collate
from flashy_tpu_torch import data
from flashy_tpu_torch.data.loader import default_collate


class SquareDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, dtype=np.float32), "y": np.int64(i)}


def _same(got, want, dtypes=True):
    """Trees of arrays equal leaf for leaf, dtypes included unless
    `dtypes` is False."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key], dtypes)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b, dtypes)
    else:
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(want))
        assert not dtypes or np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("length,shards,seed,epoch", [
    (10, 4, 1, 0), (10, 4, 1, 3), (20, 1, 0, 1), (97, 8, 5, 2),
    (3, 8, 0, 0), (1, 2, 7, 4), (64, 3, 11, 9)])
def test_sampler_indices_are_the_jax_packages(length, shards, seed, epoch):
    lengths = set()
    for rank in range(shards):
        for shuffle in (True, False):
            got = data.ShardedSampler(length, rank, shards, shuffle=shuffle,
                                      seed=seed)
            want = jax_data.ShardedSampler(length, rank, shards,
                                           shuffle=shuffle, seed=seed)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)
            assert len(got) == len(want)
            lengths.add(len(list(got)))
    # equal, non-empty shards: a rank with fewer steps would wait for ever
    assert len(lengths) == 1 and lengths.pop() >= 1


def test_strided_shards_and_sharded_eval_are_the_jax_packages():
    dataset = SquareDataset(10)
    for rank in range(3):
        got = data.StridedShard(dataset, rank, 3)
        want = jax_data.StridedShard(dataset, rank, 3)
        assert got.indices == want.indices
        assert [int(got[i]["y"]) for i in range(len(got))] == got.indices
    loaders = [data.DataLoader(dataset, batch_size=2, shuffle=False,
                               num_shards=2, shard_index=r) for r in range(2)]
    seen = sorted(int(y) for loader in loaders for b in loader
                  for y in b["y"])
    assert seen == list(range(10))


@pytest.mark.parametrize("kwargs", [
    {"batch_size": 4, "shuffle": True, "seed": 0},
    {"batch_size": 4, "shuffle": True, "seed": 3, "num_shards": 3,
     "shard_index": 2},
    {"batch_size": 4, "shuffle": False},
    {"batch_size": 3, "shuffle": False, "num_shards": 2, "shard_index": 1},
    {"batch_size": 4, "shuffle": True, "seed": 1, "drop_last": False},
])
def test_loader_batches_are_the_jax_packages(kwargs):
    got = data.DataLoader(SquareDataset(10), **kwargs)
    want = jax_data.DataLoader(SquareDataset(10), **kwargs)
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        got_batches, want_batches = list(got), list(want)
        assert len(got) == len(want) == len(got_batches) == len(want_batches)
        for a, b in zip(got_batches, want_batches):
            _same(a, b)


def test_padded_eval_coverage_and_masks_are_the_jax_packages():
    for n, shards, batch in ((13, 4, 2), (2, 4, 2), (11, 3, 4)):
        valid = []
        for rank in range(shards):
            got = data.DataLoader(SquareDataset(n), batch, num_shards=shards,
                                  shard_index=rank, pad_to_even=True)
            want = jax_data.DataLoader(SquareDataset(n), batch,
                                       num_shards=shards, shard_index=rank,
                                       pad_to_even=True)
            assert len(got) == len(want)
            for (batch_got, mask_got), (batch_want, mask_want) in zip(
                    got, want):
                _same(batch_got, batch_want)
                _same(mask_got, mask_want)
                assert batch_got["x"].shape == (batch, 3)
                valid.extend(int(y) for y, m in zip(batch_got["y"], mask_got)
                             if m)
        assert sorted(valid) == list(range(n))  # each sample exactly once
    with pytest.raises(ValueError, match="pad_to_even"):
        data.DataLoader(SquareDataset(4), 2, shuffle=True, pad_to_even=True)


def test_nested_collate_and_masked_mean_are_the_jax_packages():
    samples = [{"x": np.ones(2) * i, "pair": (np.zeros(1), np.full(1, i)),
                "scalar": np.float32(i), "list": [np.arange(2)]}
               for i in range(3)]
    _same(default_collate(samples), jax_collate(samples))
    fortran = [np.asfortranarray(np.arange(6.0).reshape(2, 3))] * 2
    _same(default_collate(fortran), jax_collate(fortran))
    per_sample = {"y": np.array([5.0, 7.0, 1.5]),
                  "z": torch.tensor([1.0, 2.0, 4.0])}
    for mask in ([True, False, True], [False, False, False],
                 [True, True, True]):
        mask = np.array(mask)
        got = data.masked_mean(per_sample, mask)
        want = jax_data.masked_mean(
            {"y": per_sample["y"], "z": per_sample["z"].numpy()}, mask)
        assert got == want


def test_threaded_workers_equal_inline_and_release_on_early_stop():
    inline = list(data.DataLoader(SquareDataset(8), batch_size=2,
                                  num_workers=0))
    threaded = list(data.DataLoader(SquareDataset(8), batch_size=2,
                                    num_workers=4))
    for a, b in zip(inline, threaded):
        _same(a, b)
    loader = data.DataLoader(SquareDataset(64), batch_size=4, shuffle=True,
                             num_workers=2, seed=0)
    it = iter(loader)
    next(it)
    it.close()  # the generator's finally shuts the pool down
    assert len(list(loader)) == len(loader)


def test_empty_dataset_rejected_at_construction():
    with pytest.raises(ValueError, match="empty dataset"):
        data.DataLoader(SquareDataset(0), batch_size=2)
    with pytest.raises(ValueError, match="non-empty"):
        data.ShardedSampler(0, 0, 2)


def test_prefetch_to_device_delivers_the_jax_packages_batches():
    from flashy_tpu.parallel import make_mesh as jax_make_mesh
    # batch 8: the JAX mesh shards it over the test harness's 8 devices
    loader = data.DataLoader(SquareDataset(32), batch_size=8, shuffle=True,
                             seed=2)
    jax_loader = jax_data.DataLoader(SquareDataset(32), batch_size=8,
                                     shuffle=True, seed=2)
    got = list(data.prefetch_to_device(loader, size=2, device="cpu",
                                       batch_axes=("data",)))
    want = list(jax_data.prefetch_to_device(
        jax_loader, size=2, mesh=jax_make_mesh({"data": -1}),
        batch_axes=("data",)))
    assert len(got) == len(want) == 4
    for a, b, host in zip(got, want, loader):
        assert isinstance(a["x"], torch.Tensor) and a["x"].device.type == "cpu"
        # the values of the JAX package's; the dtypes of the host batch
        # (JAX without x64 narrows int64 to int32)
        _same(a, {key: np.asarray(value) for key, value in b.items()},
              dtypes=False)
        _same(a, host)
    with pytest.raises(ValueError, match="batch axes"):
        next(data.prefetch_to_device(loader, device="cpu",
                                     batch_axes=("seq",)))


def test_prefetch_to_device_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(data.prefetch_to_device(iter([np.zeros(2)])))


def test_prefetch_to_device_closes_source_on_early_stop():
    closed = []

    def source():
        try:
            for i in range(100):
                yield {"x": np.full((8, 3), i, dtype=np.float32)}
        finally:
            closed.append(True)

    it = data.prefetch_to_device(source(), size=2, device="cpu")
    assert float(next(it)["x"][0, 0]) == 0.0
    it.close()
    assert closed == [True]


class Docs:
    """A checkpointable document source: document i is 8 tokens of i."""

    def __init__(self):
        self.i = 0
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        doc = np.full(8, self.i, dtype=np.int32)
        self.i += 1
        return doc

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, state):
        self.i = state["i"]

    def close(self):
        self.closed = True


def _first_docs(prefetch, packer, make_pipe_to_device):
    """The reference's rewind scenario on either package: two batches
    delivered out of a `size=2` device buffer, an early stop, then three
    batches read straight from the pipe."""
    docs = Docs()
    pipe = prefetch(packer(docs, batch_size=8, max_len=8), size=2)
    it = make_pipe_to_device(pipe)
    seen = [int(np.asarray(next(it)["tokens"])[0, 0]) for _ in range(2)]
    it.close()  # the device buffer still holds 2 undelivered batches
    joined = pipe._thread is None
    seen += [int(np.asarray(next(pipe)["tokens"])[0, 0]) for _ in range(3)]
    pipe.close()
    return seen, joined


def test_prefetch_to_device_rewinds_a_datapipe_stage_as_the_jax_package():
    from flashy_tpu.datapipe import SequencePacker as JaxPacker
    from flashy_tpu.datapipe import prefetch as jax_prefetch
    from flashy_tpu.parallel import make_mesh as jax_make_mesh
    from flashy_tpu_torch.datapipe import SequencePacker, prefetch
    got, joined = _first_docs(prefetch, SequencePacker, lambda pipe: (
        data.prefetch_to_device(pipe, size=2, device="cpu")))
    want, _ = _first_docs(jax_prefetch, JaxPacker, lambda pipe: (
        jax_data.prefetch_to_device(pipe, size=2,
                                    mesh=jax_make_mesh({"data": -1}),
                                    batch_axes=("data",))))
    # doc ids are consumed 8 per batch: no gap where the buffer was dropped
    assert got == want == [0, 8, 16, 24, 32]
    assert joined  # the datapipe's prefetch thread was stopped by close()


def test_prefetch_to_device_closes_a_datapipe_stage_on_early_stop():
    from flashy_tpu_torch.datapipe import SequencePacker, prefetch
    docs = Docs()
    pipe = prefetch(SequencePacker(docs, batch_size=8, max_len=8), size=2)
    it = data.prefetch_to_device(pipe, size=1, device="cpu")
    next(it)
    it.close()
    assert pipe._thread is None  # the prefetch worker joined
    assert docs.closed
