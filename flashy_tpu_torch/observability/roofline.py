"""RooflineProfiler: per-step FLOPs + measured wall time -> MFU verdicts
(the port of flashy_tpu/observability/roofline.py).

The reference reads each compiled executable's FLOPs and bytes from
XLA's `cost_analysis()`. PyTorch has no compiled executable to ask, so
the port counts a step's FLOPs itself: `register_fn` runs the step once,
eagerly, under `torch.utils.flop_counter.FlopCounterMode`, which prices
every aten operation it dispatches (matmuls, convolutions, attention
calls). What it cannot see is priced at zero:

* the hand-written kernels, launched through `ctypes`, never reach the
  dispatcher. The reference is in the same position: no `pallas_call`
  passes a `cost_estimate`, so XLA prices those custom calls at zero.
* bytes: the counter counts operations only, so `bytes_accessed` stays
  None unless `register_costs` gives it.

The count runs once per name, on the eager run that precedes a CUDA-graph
capture (or on a step's first call), never on a replay. Timing arrives
through `observe` (measured wall time), `timed` (each call waited for to
completion) or a stage's summed step wall clock (`stage_summary`).
"""
import functools
import logging
import time
import typing as tp

from ..utils import percentile

logger = logging.getLogger(__name__)

# (device name substring, peak dense bf16 FLOP/s, peak memory bytes/s):
# data-sheet figures, matched case-insensitively against
# `torch.cuda.get_device_name()`. NVIDIA H100 SXM (80GB HBM3).
DEVICE_SPECS: tp.Tuple[tp.Tuple[str, float, float], ...] = (
    ("h100", 989e12, 3.35e12),
)


def device_peaks(device_kind: tp.Optional[str] = None
                 ) -> tp.Tuple[tp.Optional[float], tp.Optional[float]]:
    """(peak FLOP/s, peak memory bytes/s) for a device name, or (None,
    None). `device_kind=None` reads the name of CUDA device 0; without
    CUDA the peaks are unknown (never an error)."""
    if device_kind is None:
        import torch
        if not torch.cuda.is_available():
            return None, None
        device_kind = torch.cuda.get_device_name(0)
    kind = (device_kind or "").lower()
    for needle, flops, bandwidth in DEVICE_SPECS:
        if needle in kind:
            return flops, bandwidth
    return None, None


class ExecutableProfile:
    """Cost and timing record of one step."""

    def __init__(self, name: str, source: str = "flop_counter"):
        self.name = name
        self.source = source            # 'flop_counter' | 'analytic'
        self.flops: tp.Optional[float] = None
        self.bytes_accessed: tp.Optional[float] = None
        self.cost_error: tp.Optional[str] = None
        self.calls = 0
        self.wall: tp.List[float] = []  # per-call wall seconds (sampled)
        self.total_wall = 0.0

    @property
    def intensity(self) -> tp.Optional[float]:
        """Arithmetic intensity, FLOPs per byte of memory traffic."""
        if self.flops is None or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed


class RooflineProfiler:
    """Registry of steps with costs, timings and roofline verdicts.

    Registration paths (idempotent per name):

    * `register_fn(name, fn, args, kwargs)` runs `fn` on the call's
      arguments under `FlopCounterMode` and keeps the count; it is the
      call itself (its result is returned), so nothing runs twice.
    * `register_costs(name, flops, bytes_accessed)`: hand-derived
      numbers (`source='analytic'`).
    * `register_compiled` is the reference's path for an AOT-compiled
      executable; the port has none, so it raises.

    `report()` divides: realized FLOP/s per step, the MFU where the peak
    is known, and the compute-vs-bandwidth verdict where bytes are known.
    A disabled profiler (`enabled=False`, the Telemetry default) makes
    every method a cheap no-op, so call sites register unconditionally.
    """

    MAX_WALL_SAMPLES = 4096  # per step; total stays bounded

    def __init__(self, peak_flops: tp.Optional[float] = None,
                 peak_bytes_per_sec: tp.Optional[float] = None,
                 tracer: tp.Optional[tp.Any] = None,
                 enabled: bool = True):
        self.tracer = tracer
        self.enabled = enabled
        self.peak_flops = peak_flops
        self.peak_bytes_per_sec = peak_bytes_per_sec
        self._peaks_probed = (peak_flops is not None
                              or peak_bytes_per_sec is not None)
        self.profiles: tp.Dict[str, ExecutableProfile] = {}

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def _profile(self, name: str, source: str) -> ExecutableProfile:
        profile = self.profiles.get(name)
        if profile is None:
            profile = self.profiles[name] = ExecutableProfile(name, source)
        return profile

    def register_compiled(self, name: str, compiled: tp.Any) -> None:
        """The reference registers an AOT-compiled XLA executable here and
        reads its `cost_analysis()`. PyTorch has no compiled executable
        to read costs from: count a step's FLOPs with `register_fn`."""
        raise NotImplementedError(
            "register_compiled reads XLA's cost_analysis() of a compiled "
            "executable, which PyTorch has no counterpart of: use "
            "register_fn (FLOPs of the aten operations a run dispatches) "
            "or register_costs")

    def register_fn(self, name: str, fn: tp.Callable,
                    args: tp.Sequence[tp.Any],
                    kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None
                    ) -> tp.Any:
        """Call `fn(*args, **kwargs)` and return its result; the first
        time `name` is seen (and the profiler is enabled) the call runs
        under `FlopCounterMode` and its aten FLOPs become the step's
        cost. Kernels launched outside the dispatcher count zero."""
        if not isinstance(args, (tuple, list)):
            raise TypeError(
                f"register_fn args must be a tuple/list of call arguments, "
                f"got {type(args).__name__}: wrap a single argument as "
                f"(arg,)")
        if kwargs is not None and not isinstance(kwargs, dict):
            raise TypeError(f"register_fn kwargs must be a dict or None, "
                            f"got {type(kwargs).__name__}")
        kwargs = kwargs or {}
        if not self.enabled or name in self.profiles:
            return fn(*args, **kwargs)
        from torch.utils.flop_counter import FlopCounterMode
        profile = self._profile(name, "flop_counter")
        counter = FlopCounterMode(display=False)
        with counter:
            out = fn(*args, **kwargs)
        profile.flops = float(counter.get_total_flops())
        return out

    def register_costs(self, name: str, flops: tp.Optional[float] = None,
                       bytes_accessed: tp.Optional[float] = None,
                       source: str = "analytic") -> None:
        """Register hand-derived costs (or fill in missing fields)."""
        if not self.enabled:
            return
        profile = self._profile(name, source)
        if flops is not None:
            profile.flops = float(flops)
        if bytes_accessed is not None:
            profile.bytes_accessed = float(bytes_accessed)

    # ------------------------------------------------------------------
    # timing
    # ------------------------------------------------------------------
    def observe(self, name: str, seconds: float, calls: int = 1) -> None:
        """Record `seconds` of measured wall time over `calls` calls."""
        if not self.enabled:
            return
        profile = self._profile(name, "flop_counter")
        profile.calls += calls
        profile.total_wall += seconds
        if len(profile.wall) < self.MAX_WALL_SAMPLES and calls == 1:
            profile.wall.append(seconds)

    def note_call(self, name: str) -> None:
        """Count a call without timing it (the stage's time arrives
        through `stage_summary`)."""
        if not self.enabled:
            return
        self._profile(name, "flop_counter").calls += 1

    def timed(self, name: str, fn: tp.Callable) -> tp.Callable:
        """Wrap `fn` so each call is waited for to completion (a
        synchronize of the CUDA devices of its outputs) and fed to
        `observe`. Meant for steps whose outputs are read to the host
        right after anyway: the wait moves, it is not added."""
        if not self.enabled:
            return fn
        from .steptimer import _wait_for

        @functools.wraps(fn)
        def wrapped(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            _wait_for((out,))
            self.observe(name, time.perf_counter() - start)
            return out

        return wrapped

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def _ensure_peaks(self) -> None:
        if self._peaks_probed:
            return
        self._peaks_probed = True
        flops, bandwidth = device_peaks()
        self.peak_flops = self.peak_flops or flops
        self.peak_bytes_per_sec = self.peak_bytes_per_sec or bandwidth

    @property
    def balance(self) -> tp.Optional[float]:
        """The machine balance point (FLOPs/byte): intensity above it is
        compute-bound, below it bandwidth-bound."""
        self._ensure_peaks()
        if not self.peak_flops or not self.peak_bytes_per_sec:
            return None
        return self.peak_flops / self.peak_bytes_per_sec

    def _verdict(self, profile: ExecutableProfile) -> str:
        intensity = profile.intensity
        balance = self.balance
        if intensity is None:
            return "unknown"
        if balance is None:
            # no machine model: decode-style streaming (< 10 flops/byte)
            # is bandwidth-bound on every accelerator
            return "bandwidth-bound" if intensity < 10.0 else "unknown"
        return "compute-bound" if intensity >= balance else "bandwidth-bound"

    def summarize(self, name: str) -> tp.Optional[tp.Dict[str, tp.Any]]:
        """The roofline record of one step, or None if unknown."""
        profile = self.profiles.get(name)
        if profile is None:
            return None
        entry: tp.Dict[str, tp.Any] = {
            "name": name, "source": profile.source,
            "flops_per_call": profile.flops,
            "bytes_per_call": profile.bytes_accessed,
            "intensity": profile.intensity,
            "calls": profile.calls,
            "verdict": self._verdict(profile),
        }
        if profile.cost_error:
            entry["cost_error"] = profile.cost_error
        if profile.calls and profile.total_wall > 0:
            per_call = profile.total_wall / profile.calls
            entry["wall_ms_per_call"] = per_call * 1e3
            if profile.wall:
                entry["wall_ms_p50"] = percentile(profile.wall, 50) * 1e3
            if profile.flops is not None:
                realized = profile.flops / per_call
                entry["realized_flops_per_sec"] = realized
                if self.peak_flops:
                    entry["mfu"] = realized / self.peak_flops
            if profile.bytes_accessed is not None:
                gbps = profile.bytes_accessed / per_call / 1e9
                entry["realized_hbm_gb_per_sec"] = gbps
                if self.peak_bytes_per_sec:
                    entry["hbm_frac"] = gbps * 1e9 / self.peak_bytes_per_sec
        return entry

    def report(self) -> tp.Dict[str, tp.Any]:
        """Full roofline report: the machine model and every step."""
        self._ensure_peaks()
        executables = {}
        for name in sorted(self.profiles):
            entry = self.summarize(name)
            if entry is not None:
                executables[name] = entry
        return {"peak_flops": self.peak_flops,
                "peak_hbm_gb_per_sec": (self.peak_bytes_per_sec / 1e9
                                        if self.peak_bytes_per_sec else None),
                "balance_flops_per_byte": self.balance,
                "executables": executables}

    def stage_summary(self, seconds: float,
                      since: tp.Optional[tp.Dict[str, int]] = None
                      ) -> tp.Dict[str, float]:
        """Stage-level realized TFLOP/s and MFU from measured time.

        `seconds` is the stage's summed step wall clock (the StepTimer's
        totals; the reference divides by the device share, which the
        port's op-by-op launches shrink to the backlog at the step's
        end, see `steptimer`); the FLOPs are summed over every registered
        step's calls (minus the `since` snapshot from `mark()`, so
        back-to-back stages do not double count). Flat numeric keys for
        the stage metrics."""
        if not self.enabled or seconds <= 0:
            return {}
        self._ensure_peaks()
        total_flops = 0.0
        total_bytes = 0.0
        priced_calls = 0
        for name, profile in self.profiles.items():
            calls = profile.calls - (since or {}).get(name, 0)
            if calls <= 0:
                continue
            if profile.flops is not None:
                total_flops += profile.flops * calls
                priced_calls += calls
            if profile.bytes_accessed is not None:
                total_bytes += profile.bytes_accessed * calls
        if not priced_calls:
            return {}
        out: tp.Dict[str, float] = {}
        if total_flops:
            realized = total_flops / seconds
            out["roofline_tflops_per_sec"] = realized / 1e12
            if self.peak_flops:
                out["roofline_mfu"] = realized / self.peak_flops
        if total_bytes:
            out["roofline_hbm_gb_per_sec"] = (total_bytes / seconds
                                              / 1e9)
        return out

    def mark(self) -> tp.Dict[str, int]:
        """Per-step call-count snapshot (for `stage_summary`)."""
        return {name: p.calls for name, p in self.profiles.items()}

    def record(self, tracer: tp.Optional[tp.Any] = None
               ) -> tp.Dict[str, tp.Any]:
        """Journal the report (`{"type": "roofline"}` record)."""
        report = self.report()
        tracer = tracer or self.tracer
        if tracer is not None:
            tracer.record({"type": "roofline", **report})
        return report
