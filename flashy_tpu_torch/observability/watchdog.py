"""RecompileWatchdog: WARN when a step is rebuilt after warm-up (the port
of flashy_tpu/observability/watchdog.py).

Under jit a shape change silently compiles a fresh executable; in the
port the counterpart is a serving step captured as a CUDA graph after
the warm-up (or, on the CPU, a step built after it): a stall of every
live request that raises nothing. The watchdog counts builds per name
and, once a name is built past its warm-up budget, logs a WARNING naming
it and the arguments that triggered the build.
"""
import functools
import logging
import typing as tp

from .tracer import Tracer

logger = logging.getLogger(__name__)

_MAX_LEAVES_SHOWN = 16


def _leaves(tree: tp.Any) -> tp.List[tp.Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree, key=str)
                for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def describe_abstract(args: tp.Any, kwargs: tp.Any) -> str:
    """Compact shape/dtype description of a call's arguments: two calls
    with different descriptions explain a rebuild."""
    leaves = _leaves((args, kwargs))
    parts = []
    for leaf in leaves[:_MAX_LEAVES_SHOWN]:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            dtype_name = str(dtype).replace("torch.", "")
            parts.append(f"{dtype_name}[{','.join(str(d) for d in shape)}]")
        else:
            parts.append(f"{type(leaf).__name__}({leaf!r})")
    if len(leaves) > _MAX_LEAVES_SHOWN:
        parts.append(f"... +{len(leaves) - _MAX_LEAVES_SHOWN} more leaves")
    return ", ".join(parts)


class RecompileWatchdog:
    """Counts builds per name and flags rebuilds past warm-up.

    Two report paths feed one accounting:

    * `watch(fn)` wraps a callable that exposes a `_cache_size()` hook
      (a compile cache it can poll around every call). The port has no
      jit cache, so no callable of its own has one: `watch` refuses a
      callable without it, as the reference refuses a plain function.
    * `note_compile(name, description)` / `note_call(name)` are the
      direct-report API for caches the watchdog cannot wrap: the serving
      `CompileCache` reports every build and every CUDA-graph capture
      through it.

    `warmup` builds per name are expected. Any build past that logs a
    WARNING with the arguments, fires a tracer instant and journal
    record, and is tallied in `counts`; `summary()` gives the rebuilds
    past warm-up per name (nonzero only).
    """

    def __init__(self, warmup: int = 1, tracer: tp.Optional[Tracer] = None,
                 log: tp.Optional[logging.Logger] = None):
        self.warmup = warmup
        self.tracer = tracer
        self._logger = log or logger
        self.counts: tp.Dict[str, tp.Dict[str, int]] = {}

    def watch(self, fn: tp.Callable, name: tp.Optional[str] = None,
              warmup: tp.Optional[int] = None) -> tp.Callable:
        """Return `fn` wrapped with rebuild detection; `fn` must expose a
        `_cache_size()` hook, else this raises TypeError at once rather
        than never warning."""
        cache_size = getattr(fn, "_cache_size", None)
        if cache_size is None:
            raise TypeError(
                f"RecompileWatchdog.watch expects a callable with a "
                f"compile cache (a `_cache_size()` hook; got {fn!r} with "
                f"none). PyTorch runs eagerly: report builds and captures "
                f"with note_compile() instead (CompileCache does).")
        fn_name = name or getattr(fn, "__name__", None) or repr(fn)
        allowed = self.warmup if warmup is None else warmup
        entry = self._entry(fn_name)

        @functools.wraps(fn)
        def wrapped(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            before = cache_size()
            out = fn(*args, **kwargs)
            grew = cache_size() - before
            entry["calls"] += 1
            if grew > 0:
                shapes = describe_abstract(args, kwargs)
                for _ in range(grew):
                    self.note_compile(fn_name, shapes, warmup=allowed)
            return out

        wrapped.watchdog_name = fn_name  # type: ignore[attr-defined]
        return wrapped

    def note_call(self, name: str) -> None:
        """Tally one call of an externally managed cache under `name`."""
        self._entry(name)["calls"] += 1

    def note_compile(self, name: str, description: str = "", *,
                     warmup: tp.Optional[int] = None) -> int:
        """Record one build under `name`; past `warmup` (this call's
        budget, else the watchdog's), WARN with `description`, fire the
        tracer events and tally a rebuild. Returns the rebuilds recorded
        under `name`."""
        entry = self._entry(name)
        allowed = self.warmup if warmup is None else warmup
        entry["compiles"] += 1
        if entry["compiles"] > allowed:
            entry["recompiles"] += 1
            self._logger.warning(
                "recompile #%d of %r (after %d warm-up compiles) "
                "triggered by arguments: %s",
                entry["compiles"], name, allowed, description)
            if self.tracer is not None:
                self.tracer.instant(f"recompile/{name}",
                                    category="watchdog", shapes=description)
                self.tracer.record({"type": "recompile", "fn": name,
                                    "compiles": entry["compiles"],
                                    "shapes": description})
        return entry["recompiles"]

    def _entry(self, name: str) -> tp.Dict[str, int]:
        return self.counts.setdefault(name, {"calls": 0, "compiles": 0,
                                             "recompiles": 0})

    def summary(self) -> tp.Dict[str, int]:
        """Rebuilds past warm-up per name (nonzero only)."""
        return {name: entry["recompiles"]
                for name, entry in self.counts.items()
                if entry["recompiles"]}
