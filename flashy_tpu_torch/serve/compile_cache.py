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

An entry therefore belongs to the object that built it: on CUDA a graph
over that engine's buffers, on the CPU a closure over its cache and
generator. Where an XLA executable is a pure function of its arguments
and may serve any engine, an entry here may not: `get` and `warm` take
the caller as `owner`, and an existing key built for another owner
raises (on the CPU too, where a silent hit would read the first engine's
pool). Engines that share a cache need scopes of their own, and a
rebuilt engine needs a fresh cache or fresh scopes.

The kernel wrappers count their launches in Python, which a replay does
not run: the cache records each graph's launch-count deltas at capture
(taking them back out, since the capture launched nothing) and adds them
on every replay, so the counts stay exact.

Every entry made ready (a build on the CPU, a capture on CUDA) is
reported to a `RecompileWatchdog` through `note_compile(name)`, a private
one unless telemetry or the caller gives one; after `seal()` the
warm-up budget is 0, so `recompiles()` and the watchdog's `summary()`
count the same thing. With a Tracer each miss is an instant plus a
`compile_cache` journal record, and `warm` runs inside a span; with an
enabled RooflineProfiler each step built after the attach has its aten
FLOPs counted on its first, eager run (on CUDA the run that precedes the
capture) and every later call timed to completion. Every hook is
host-side Python outside the capture.

Python's garbage collector is off while a graph is captured. A step and
its cache hold each other, so a dropped engine's graphs are freed by a
collection, and a collection that runs inside another engine's capture
frees them there: releasing a graph's memory pool calls `cudaFree`,
which invalidates the capture (`cudaErrorStreamCaptureInvalidated`).
"""
import gc
import logging
import time
import typing as tp
import weakref

import torch

from ..observability import RecompileWatchdog
from ..observability.watchdog import describe_abstract
from ..utils import resolve_device

logger = logging.getLogger(__name__)

Key = tp.Tuple[tp.Any, ...]


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
    stream (through `eager`, which calls `fn`, when given) and captures
    `fn` there; later calls replay."""

    def __init__(self, fn: tp.Callable, cache: "CompileCache", name: str,
                 eager: tp.Optional[tp.Callable] = None):
        self.fn, self.cache, self.name = fn, cache, name
        self.eager = eager or fn
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
            result = self.eager(*args)  # builds, first-call checks, set-up
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
        self.cache._ready(self.name, args)
        return result


class _Profiled:
    """A cache entry under an enabled RooflineProfiler. Its first call
    registers the step (the aten FLOPs counted on the eager run: on CUDA
    the run before the capture, never the capture or a replay); every
    later call is timed to completion (one synchronize of the cache's
    device) and observed. Attributes of the entry (`captured`, `graph`,
    ...) read through."""

    def __init__(self, fn: tp.Callable, cache: "CompileCache", name: str):
        self.cache, self.name = cache, name
        profiler = cache.roofline

        def register(*args: tp.Any) -> tp.Any:
            return profiler.register_fn(name, fn, args)

        if cache.graphs:
            self.entry = CudaGraphStep(fn, cache, name, eager=register)
            self._first: tp.Optional[tp.Callable] = self.entry
        else:
            self.entry, self._first = fn, register

    def __getattr__(self, attr: str) -> tp.Any:
        return getattr(self.entry, attr)

    def __call__(self, *args: tp.Any) -> tp.Any:
        if self._first is not None:
            first, self._first = self._first, None
            return first(*args)
        start = time.perf_counter()
        out = self.entry(*args)
        if self.cache.device.type == "cuda":
            torch.cuda.synchronize(self.cache.device)
        self.cache.roofline.observe(self.name, time.perf_counter() - start)
        return out


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
        watchdog: the RecompileWatchdog every build and capture is
            reported to; a private one when not given, so the accounting
            always works.
        tracer: an `observability.Tracer`: each miss lands as an instant
            and a `compile_cache` journal record, each `warm` in a span.
        roofline: an enabled `observability.RooflineProfiler` (or
            `attach_roofline()`): every step built after the attach is
            registered and timed per call. Attach before
            `DecodeEngine.warmup()`.
        device: where the steps run; `cuda` by default, the CPU only when
            asked for.
        cuda_graphs: capture CUDA graphs on a CUDA device (the default);
            False runs every entry eagerly, for measurements that hold
            replay against eager.
    """

    def __init__(self, watchdog: tp.Optional[RecompileWatchdog] = None,
                 tracer: tp.Any = None, roofline: tp.Any = None, *,
                 device: tp.Any = None, cuda_graphs: bool = True):
        self.watchdog = watchdog or RecompileWatchdog(warmup=1)
        self.tracer = tracer
        self.roofline = roofline
        self.device = resolve_device(device)
        self.graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.generators: tp.List[torch.Generator] = []
        self.hits = 0
        self.misses = 0
        self.sealed = False
        self._fns: tp.Dict[Key, tp.Callable] = {}
        self._owners: tp.Dict[Key, tp.Any] = {}  # key -> weakref of owner

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
            if any(getattr(fn, "captured", False)
                   for fn in self._fns.values()):
                raise ValueError("register generators before the first "
                                 "capture")
            self.generators.append(generator)

    def _ready(self, name: str, args: tp.Sequence[tp.Any] = ()) -> None:
        """An entry was made ready: report it to the watchdog, with no
        warm-up budget once the cache is sealed."""
        self.watchdog.note_compile(name, describe_abstract(args, {}),
                                   warmup=0 if self.sealed else None)

    def get(self, key: Key, build: tp.Callable[[], tp.Callable],
            owner: tp.Any = None) -> tp.Callable:
        """The entry under `key`; built from `build()` on first use. With
        an `owner` (the engine whose buffers the step reads) the entry is
        bound to it: a later `get` of the key by another owner raises
        ValueError instead of returning a step over someone else's
        buffers."""
        fn = self._fns.get(key)
        if fn is not None:
            if owner is not None:
                ref = self._owners.get(key)
                if ref is None or ref() is not owner:
                    raise ValueError(
                        f"compile cache entry {self._name(key)} was built "
                        f"for another engine: an entry reads the buffers "
                        f"of the engine that built it; give this engine a "
                        f"cache_scope of its own or a fresh CompileCache")
            self.hits += 1
            return fn
        self.misses += 1
        name = self._name(key)
        raw = build()
        if self.roofline is not None and self.roofline.enabled:
            fn = _Profiled(raw, self, name)
        elif self.graphs:
            fn = CudaGraphStep(raw, self, name)
        else:
            fn = raw
        if not self.graphs:
            self._ready(name)
        self._fns[key] = fn
        if owner is not None:
            self._owners[key] = weakref.ref(owner)
        logger.debug("compile cache miss: built %s", name)
        if self.tracer is not None:
            self.tracer.instant(f"compile_cache/miss/{name}",
                                category="serve")
            self.tracer.record({"type": "compile_cache", "event": "miss",
                                "key": name})
        return fn

    def warm(self, key: Key, build: tp.Callable[[], tp.Callable],
             *args: tp.Any, owner: tp.Any = None) -> tp.Any:
        """Register `key` and run it once on `args` (on CUDA: the eager
        run and the capture); `owner` as in `get`."""
        fn = self.get(key, build, owner=owner)
        if self.tracer is not None:
            with self.tracer.span(f"compile_cache/warm/{self._name(key)}",
                                  category="serve"):
                return fn(*args)
        return fn(*args)

    def attach_roofline(self, roofline: tp.Any) -> None:
        """Attach a RooflineProfiler: steps built from now on are
        registered and timed (existing entries are not rewrapped:
        attach before the engine's `warmup()`)."""
        self.roofline = roofline

    def seal(self) -> None:
        """End the warm-up: entries made ready from now on count as
        recompiles."""
        self.sealed = True

    def executables(self) -> tp.Dict[str, tp.Callable]:
        """{name: entry}: every step this cache manages."""
        return {self._name(key): fn for key, fn in self._fns.items()}

    def recompiles(self) -> int:
        """Rebuilds the watchdog counted under this cache's names: every
        entry made ready after `seal()` (a capture on CUDA, a build
        elsewhere), and a name made ready twice before it (two unscoped
        engines on one watchdog). The serving acceptance signal: 0 for
        the whole run once `warmup()` has warmed every key."""
        return sum(self.watchdog.counts.get(self._name(key), {})
                   .get("recompiles", 0) for key in self._fns)

    def stats(self) -> tp.Dict[str, int]:
        """{hits, misses, entries, recompiles} snapshot."""
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._fns), "recompiles": self.recompiles()}
