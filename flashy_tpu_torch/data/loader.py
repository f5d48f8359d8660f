"""Distributed data loading (the port of flashy_tpu/data/loader.py).

Training uses an epoch-seeded shuffling sampler that equalizes the
per-process shard sizes (the DistributedSampler role); evaluation uses a
strided shard with no sample repeated. Batches stay numpy on the host
(collated with `np.stack`, the JAX package's fallback collation),
fetched inline or by threads; `prefetch_to_device` keeps batches in
flight to the card so the step never waits on an upload.
"""
import collections
import collections.abc
import typing as tp
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch


def _data_tracer():
    """The active telemetry tracer, or None: batch fetches and uploads
    then show up as `data/...` spans beside the solver's step split."""
    from ..observability import get_telemetry
    telemetry = get_telemetry()
    return None if telemetry is None else telemetry.tracer


def _span(tracer, name: str):
    """A `data`-category span on `tracer`, or a no-op context when
    telemetry is off."""
    return (tracer.span(name, category="data") if tracer is not None
            else nullcontext())


class StridedShard:
    """View of `dataset` keeping indices rank, rank+ws, rank+2*ws, ...

    Used for evaluation: shards may differ in size by one but no sample
    is ever repeated.
    """

    def __init__(self, dataset, shard_index: int, num_shards: int):
        self.dataset = dataset
        self.indices = list(range(shard_index, len(dataset), num_shards))

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


class ShardedSampler:
    """Epoch-seeded shuffling sampler with equal-size per-process shards.

    Pads the permutation (by tiling it) so every process sees the same
    number of samples: unequal batch counts would leave one rank waiting
    in a collective the others never reach. Call `set_epoch` to reshuffle
    between epochs (the DistributedSampler role). The permutation is the
    JAX package's: `np.random.default_rng(seed + epoch)`.
    """

    def __init__(self, length: int, shard_index: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0):
        if length <= 0:
            raise ValueError(f"ShardedSampler needs a non-empty dataset, "
                             f"got length={length}")
        self.length = length
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return (self.length + self.num_shards - 1) // self.num_shards

    def __iter__(self) -> tp.Iterator[int]:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(
                self.length)
        else:
            order = np.arange(self.length)
        total = len(self) * self.num_shards
        # tile, not slice: a dataset smaller than the shard count still
        # gives every process a non-empty, equal-size shard
        reps = -(-total // max(self.length, 1))
        padded = np.tile(order, reps)[:total]
        return iter(padded[self.shard_index::self.num_shards].tolist())


def _stack_samples(samples: tp.Sequence[tp.Any]) -> np.ndarray:
    def as_contiguous(sample):
        array = np.asarray(sample)
        # not ascontiguousarray: that promotes 0-d scalars to 1-d
        return array if array.flags.c_contiguous \
            else np.ascontiguousarray(array)

    return np.stack([as_contiguous(sample) for sample in samples])


def default_collate(samples: tp.Sequence[tp.Any]) -> tp.Any:
    """Stack a list of samples into a batch, recursively over dicts,
    tuples and lists."""
    first = samples[0]
    if isinstance(first, collections.abc.Mapping):
        return {key: default_collate([s[key] for s in samples])
                for key in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(group))
                           for group in zip(*samples))
    return _stack_samples(samples)


class DataLoader:
    """Batched iteration over a dataset, sharded per process.

    Args:
        dataset: anything with `__len__` and `__getitem__`.
        batch_size: per-process batch size.
        shuffle: True for training (epoch-seeded equal shards), False for
            eval (strided shard, no sample repeated).
        num_shards / shard_index: distribution; `distrib.loader` passes
            the world size and the rank.
        drop_last: drop the trailing partial batch (default: True when
            shuffling, so training shapes stay static; eval keeps all).
        collate_fn: list-of-samples -> batch tree.
        num_workers: threads fetching a batch's samples (0 = inline).
        seed: shuffling seed.
        pad_to_even: padded, masked eval. Strided eval shards differ in
            size by one, so the ranks' step counts differ and an eval step
            with a collective waits for ever. With `pad_to_even=True`
            every process yields the same number of full batches (from
            the global dataset length) as `(batch, valid_mask)` pairs:
            `valid_mask` is a bool [batch_size] marking real samples;
            padding rows repeat a shard sample and must be masked out of
            metrics (`masked_mean`, then `distrib.average_metrics` with
            the valid count). Incompatible with `shuffle=True`;
            `drop_last` is ignored (every batch is full).
    """

    def __init__(self, dataset, batch_size: int = 1, *, shuffle: bool = False,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_last: tp.Optional[bool] = None,
                 collate_fn: tp.Callable = default_collate,
                 num_workers: int = 0, seed: int = 0,
                 pad_to_even: bool = False):
        if pad_to_even and shuffle:
            raise ValueError("pad_to_even is an eval mode; the training "
                             "path (shuffle=True) already pads via its "
                             "sampler")
        if len(dataset) == 0:
            # an empty shard skips its collectives and leaves the other
            # ranks waiting: refuse here, where it is debuggable
            raise ValueError("DataLoader got an empty dataset")
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.drop_last = shuffle if drop_last is None else drop_last
        self.pad_to_even = pad_to_even
        self.sampler: tp.Optional[ShardedSampler] = None
        if shuffle:
            self.dataset = dataset
            self.sampler = ShardedSampler(len(dataset), shard_index,
                                          num_shards, shuffle=True, seed=seed)
        elif pad_to_even:
            # the raw dataset: padding may need a sample even when this
            # process's strided shard is empty
            self.dataset = dataset
            self._num_shards = num_shards
            self._shard_index = shard_index
        elif num_shards > 1:
            self.dataset = StridedShard(dataset, shard_index, num_shards)
        else:
            self.dataset = dataset

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling for a new epoch (no-op for eval loaders)."""
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self) -> tp.Iterator[int]:
        if self.sampler is not None:
            return iter(self.sampler)
        return iter(range(len(self.dataset)))

    def __len__(self) -> int:
        if self.pad_to_even:
            per_shard = -(-len(self.dataset) // self._num_shards)
            return -(-per_shard // self.batch_size)
        n = len(self.sampler) if self.sampler is not None \
            else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _run(self, starts: tp.Iterable[tp.Any],
             fetch: tp.Callable) -> tp.Iterator[tp.Any]:
        """`fetch(start, sample_map)` for each start, inline or with the
        samples fetched by a thread pool released on an early stop."""
        if self.num_workers <= 0:
            yield from (fetch(start, map) for start in starts)
            return
        executor = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            yield from (fetch(start, executor.map) for start in starts)
        finally:
            # cancel_futures: without it, workers keep fetching into an
            # abandoned epoch after the consumer stops early
            executor.shutdown(wait=False, cancel_futures=True)

    def _iter_padded(self) -> tp.Iterator[tp.Tuple[tp.Any, np.ndarray]]:
        own = list(range(self._shard_index, len(self.dataset),
                         self._num_shards))
        valid = len(own)
        total = len(self) * self.batch_size
        pad_src = own or [0]  # an empty shard: any sample, fully masked
        padded = own + [pad_src[i % len(pad_src)]
                        for i in range(total - valid)]
        tracer = _data_tracer()

        def fetch(start, sample_map):
            with _span(tracer, "data/fetch"):
                idxs = padded[start:start + self.batch_size]
                samples = list(sample_map(self.dataset.__getitem__, idxs))
                mask = np.arange(start, start + self.batch_size) < valid
                return self.collate_fn(samples), mask

        yield from self._run(range(0, total, self.batch_size), fetch)

    def __iter__(self) -> tp.Iterator[tp.Any]:
        if self.pad_to_even:
            yield from self._iter_padded()
            return
        indices = list(self._indices())
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        tracer = _data_tracer()

        def fetch(batch_indices, sample_map):
            with _span(tracer, "data/fetch"):
                samples = list(sample_map(self.dataset.__getitem__,
                                          batch_indices))
                return self.collate_fn(samples)

        yield from self._run(batches, fetch)


def masked_mean(per_sample: tp.Dict[str, tp.Any], mask: np.ndarray
                ) -> tp.Tuple[tp.Dict[str, float], float]:
    """Mean of per-sample metrics over the valid rows of a padded batch.

    `per_sample` maps names to [batch_size] arrays (or tensors); `mask`
    is the bool validity mask of a `pad_to_even` loader. Returns `(means,
    weight)`, `weight` the number of valid samples: feed both to
    `utils.averager()` and the final count to `distrib.average_metrics`
    for the unsharded eval's metrics. A fully padded batch returns zero
    means with zero weight.
    """
    mask = np.asarray(mask)
    weight = float(mask.sum())
    denom = max(weight, 1.0)

    def host(value):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().double().numpy()
        return np.asarray(value, dtype=np.float64)

    means = {key: float((host(value) * mask).sum() / denom)
             for key, value in per_sample.items()}
    return means, weight


def _leaves(tree: tp.Any) -> tp.Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _map(tree: tp.Any, fn: tp.Callable) -> tp.Any:
    """`fn` on every array leaf (numpy, tensor) of dicts, lists and
    tuples; other leaves pass through."""
    if isinstance(tree, dict):
        return type(tree)((key, _map(value, fn))
                          for key, value in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(value, fn) for value in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return fn(tree)
    return tree


def prefetch_to_device(iterator: tp.Iterable[tp.Any], size: int = 2,
                       mesh=None,
                       batch_axes: tp.Sequence[str] = ("data", "fsdp"),
                       device: tp.Any = None) -> tp.Iterator[tp.Any]:
    """Keep `size` host batches in flight to this process's device.

    Each batch (a tree of numpy arrays or tensors) is copied into pinned
    host memory and uploaded with `non_blocking` copies on a side stream,
    so while the step crunches batch N, batch N+1's transfer is already
    running and the step never waits on a blocking upload (which would
    wait for the card's whole queue). Before a batch is yielded, the
    consumer's stream waits on the upload's event and every tensor is
    `record_stream`ed there, so the allocator never hands its memory out
    early. Yields trees of tensors on the device: this process's local
    batch, as `parallel.shard_batch` places it. The device is `device`,
    else the mesh's, else `cuda`; on the CPU (device='cpu') the batches
    become CPU tensors, with no stream.

    A consumer that stops early (break, exception, the generator's GC)
    closes the source first, then rewinds a checkpointable source (a
    datapipe stage, `state_dict`/`load_state_dict`) past the batches
    still buffered here, so an abandoned iteration never skips them.
    """
    from ..parallel.data_parallel import _batch_device, _to_device
    device = _batch_device(mesh, device)
    unknown = set(batch_axes) - {"data", "fsdp"}
    if unknown:
        raise ValueError(f"batch axes {sorted(unknown)} do not shard a batch")
    queue: collections.deque = collections.deque()
    iterator = iter(iterator)
    tracer = _data_tracer()
    checkpointable = (hasattr(iterator, "state_dict")
                      and hasattr(iterator, "load_state_dict"))
    last_state = iterator.state_dict() if checkpointable else None
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def pinned(leaf):
        host = leaf if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(leaf))
        return host.pin_memory()

    def upload(batch):
        if stream is None:
            return _to_device(batch, device), None
        host = _map(batch, pinned)
        with torch.cuda.stream(stream):
            placed = _map(host, lambda t: t.to(device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return placed, (event, host)

    def enqueue(batch):
        state = iterator.state_dict() if checkpointable else None
        with _span(tracer, "data/host_to_device"):
            queue.append(upload(batch) + (state,))

    def deliver():
        nonlocal last_state
        batch, pending, state = queue.popleft()
        if pending is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(pending[0])
            for tensor in _leaves(batch):
                tensor.record_stream(current)
        last_state = state
        return batch

    try:
        try:
            while True:
                while len(queue) < size:
                    enqueue(next(iterator))
                yield deliver()
        except StopIteration:
            while queue:
                yield deliver()
    finally:
        # close() first (a datapipe prefetch rewinds to its own consumed
        # cursor there), then replay the undelivered batches by rewinding
        # past them
        close = getattr(iterator, "close", None)
        if close is not None:
            close()
        if checkpointable and queue:
            iterator.load_state_dict(last_state)
