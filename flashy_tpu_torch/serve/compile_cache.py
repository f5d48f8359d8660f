"""Prompt-length bucketing and the serving CompileCache (port of
flashy_tpu/serve/compile_cache.py).

The JAX package pins one compiled executable per shape bucket, so that
steady-state traffic never traces. PyTorch runs eagerly; the counterpart
of a pinned executable is a captured CUDA graph. On CUDA an entry of
`CompileCache` is a `torch.cuda.CUDAGraph` captured over the static
tensors of its first call: that call runs the step once eagerly, on the
stream the capture then uses (so kernel builds, a wrapper's first-call
checks and any lazy library set-up happen there, never inside the
capture), and captures it; every later call replays the graph. On the
CPU an entry is the eager callable. The bookkeeping is the same on both:
hits, misses, entries, and `recompiles()`, the entries made ready
(captured on CUDA, built on the CPU) after `seal()`. `DecodeEngine.
warmup()` warms every key live traffic can touch and then seals.

A replay reads and writes the tensors it was captured over: a call whose
tensor arguments are not those tensors (the same storage, shape and
dtype) raises, and nothing is ever captured again. A replay's outputs
are the graph's static tensors, overwritten by the next replay.

The kernel wrappers count their launches in Python, which a replay does
not run: the cache records each graph's launch-count deltas at capture
(taking them back out, since the capture launched nothing) and adds them
on every replay, so the counts stay exact.

Python's garbage collector is off while a graph is captured. A step and
its cache hold each other, so a dropped engine's graphs are freed by a
collection, and a collection that runs inside another engine's capture
frees them there: releasing a graph's memory pool calls `cudaFree`,
which invalidates the capture (`cudaErrorStreamCaptureInvalidated`).
"""
import gc
import typing as tp

import torch

from ..utils import resolve_device

Key = tp.Tuple[tp.Any, ...]

TODO_OBSERVABILITY = ("ROADMAP.md queue A item 9 (observability: the "
                      "recompile watchdog, the tracer and the roofline "
                      "profiler)")


def bucket_length(n: int, *, minimum: int = 4,
                  maximum: tp.Optional[int] = None) -> int:
    """Round `n` up to the next power of two (>= `minimum`), capped at
    `maximum`; `n` beyond `maximum` raises (the request cannot fit)."""
    if n < 1:
        raise ValueError(f"cannot bucket a length < 1, got {n}")
    bucket = minimum
    while bucket < n:
        bucket *= 2
    if maximum is not None:
        if n > maximum:
            raise ValueError(f"length {n} exceeds the bucket cap {maximum}")
        bucket = min(bucket, maximum)
    return bucket


def launch_counters() -> tp.Tuple[tp.Dict[str, int], ...]:
    """Every kernel wrapper's launch-count dict."""
    from ..ops import attention, grouped_matmul, paged_decode, ssd_scan
    from ..parallel import ring_fused
    return (attention.launch_counts, grouped_matmul.launch_counts,
            paged_decode.launch_counts, ssd_scan.launch_counts,
            ring_fused.launch_counts)


def _signature(args: tp.Sequence[tp.Any]) -> tp.Tuple:
    """What a replay must find again: each tensor's storage, shape, dtype
    and device, each other argument's value."""
    return tuple((a.data_ptr(), tuple(a.shape), a.dtype, a.device)
                 if torch.is_tensor(a) else a for a in args)


class CudaGraphStep:
    """One step as a CUDA graph over the static tensors of its first call
    (`CompileCache` on CUDA). The first call runs `fn` eagerly on a side
    stream and captures it there; later calls replay."""

    def __init__(self, fn: tp.Callable, cache: "CompileCache", name: str):
        self.fn, self.cache, self.name = fn, cache, name
        self.graph: tp.Optional[torch.cuda.CUDAGraph] = None
        self.outputs: tp.Any = None
        self.signature: tp.Optional[tp.Tuple] = None
        self.launches: tp.List[tp.Dict[str, int]] = []

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, *args: tp.Any) -> tp.Any:
        if self.graph is None:
            return self._capture(args)
        signature = _signature(args)
        if signature != self.signature:
            raise ValueError(
                f"compile cache entry {self.name}: a replay's arguments "
                f"{signature} are not the tensors it was captured over "
                f"{self.signature}; a graph replays its captured buffers "
                f"only (fill them in place)")
        self.graph.replay()
        for counts, delta in zip(launch_counters(), self.launches):
            for name, n in delta.items():
                counts[name] += n
        return self.outputs

    def _capture(self, args: tp.Sequence[tp.Any]) -> tp.Any:
        device = self.cache.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            result = self.fn(*args)  # builds, first-call checks, set-up
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        for generator in self.cache.generators:
            graph.register_generator_state(generator)
        counters = launch_counters()
        before = [dict(c) for c in counters]
        collecting = gc.isenabled()
        gc.disable()   # see the module docstring
        try:
            with torch.cuda.graph(graph, stream=stream):
                self.outputs = self.fn(*args)
        finally:
            if collecting:
                gc.enable()
        # the capture launched nothing: its counts come back on replay
        self.launches = []
        for counts, old in zip(counters, before):
            delta = {name: counts[name] - old[name] for name in counts
                     if counts[name] != old[name]}
            for name, n in delta.items():
                counts[name] -= n
            self.launches.append(delta)
        self.signature = _signature(args)
        self.graph = graph
        self.cache._ready()
        return result


class CompileCache:
    """Keyed registry of serving steps with hit/miss and recompile stats.

    `get(key, build)` returns the entry under `key`, built from the eager
    callable `build()` returns on first use: on CUDA (`cuda_graphs=True`)
    a `CudaGraphStep`, captured at its first call; else the callable
    itself. `warm(key, build, *args)` registers the key and runs it once.
    `seal()` ends the warm-up: every entry made ready after it (captured
    on CUDA, built elsewhere) is a recompile, which `recompiles()`
    counts. Generators that a step samples from must be registered
    (`register_generator`) so that each replay advances them.

    Args:
        watchdog, tracer, roofline: the reference's observability hooks;
            not ported (passing one raises NotImplementedError).
        device: where the steps run; `cuda` by default, the CPU only when
            asked for.
        cuda_graphs: capture CUDA graphs on a CUDA device (the default);
            False runs every entry eagerly, for measurements that hold
            replay against eager.
    """

    def __init__(self, watchdog: tp.Any = None, tracer: tp.Any = None,
                 roofline: tp.Any = None, *, device: tp.Any = None,
                 cuda_graphs: bool = True):
        for name, value in (("watchdog", watchdog), ("tracer", tracer),
                            ("roofline", roofline)):
            if value is not None:
                raise NotImplementedError(
                    f"CompileCache({name}=...): {TODO_OBSERVABILITY}")
        self.device = resolve_device(device)
        self.graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.generators: tp.List[torch.Generator] = []
        self.hits = 0
        self.misses = 0
        self.sealed = False
        self._late = 0
        self._fns: tp.Dict[Key, tp.Callable] = {}

    def __contains__(self, key: Key) -> bool:
        return key in self._fns

    def __len__(self) -> int:
        return len(self._fns)

    @staticmethod
    def _name(key: Key) -> str:
        return "/".join(str(part) for part in key)

    def register_generator(self, generator: torch.Generator) -> None:
        """Register a generator the steps sample from with every graph
        captured from now on (CUDA generators only; the CPU runs eagerly).
        Register before the first capture."""
        if generator.device.type == "cuda" and not any(
                generator is g for g in self.generators):
            if any(isinstance(fn, CudaGraphStep) and fn.captured
                   for fn in self._fns.values()):
                raise ValueError("register generators before the first "
                                 "capture")
            self.generators.append(generator)

    def _ready(self) -> None:
        if self.sealed:
            self._late += 1

    def get(self, key: Key, build: tp.Callable[[], tp.Callable]
            ) -> tp.Callable:
        """The entry under `key`; built from `build()` on first use."""
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        self.misses += 1
        raw = build()
        if self.graphs:
            fn = CudaGraphStep(raw, self, self._name(key))
        else:
            fn = raw
            self._ready()
        self._fns[key] = fn
        return fn

    def warm(self, key: Key, build: tp.Callable[[], tp.Callable],
             *args: tp.Any) -> tp.Any:
        """Register `key` and run it once on `args` (on CUDA: the eager
        run and the capture)."""
        return self.get(key, build)(*args)

    def seal(self) -> None:
        """End the warm-up: entries made ready from now on count as
        recompiles."""
        self.sealed = True

    def executables(self) -> tp.Dict[str, tp.Callable]:
        """{name: entry}: every step this cache manages."""
        return {self._name(key): fn for key, fn in self._fns.items()}

    def recompiles(self) -> int:
        """Entries made ready after `seal()`: captures on CUDA, builds
        elsewhere. The serving acceptance signal: 0 for the whole run once
        `warmup()` has warmed every key."""
        return self._late

    def stats(self) -> tp.Dict[str, int]:
        """{hits, misses, entries, recompiles} snapshot."""
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._fns), "recompiles": self.recompiles()}
