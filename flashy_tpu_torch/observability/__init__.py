"""Runtime telemetry of the PyTorch port (the port of
flashy_tpu.observability): host-side tracing, step timing, rebuild and
straggler watch, SLO burn rates and roofline attribution.

  * Tracer            host-side spans -> Perfetto trace + telemetry.jsonl
  * StepTimer         data-wait / host / device split per training step
  * RecompileWatchdog WARN when a step is rebuilt after warm-up
  * Heartbeat         per-rank liveness files + straggler report
  * SLOEngine         declarative latency budgets + burn-rate alerting
  * RooflineProfiler  per-step aten FLOPs + time -> MFU

`enable_telemetry()` (or `solver.enable_telemetry()`) turns everything
on; the solver's stage loop, LogProgressBar and the serving engine then
feed it. It complements `solver.enable_profiling` (the device timeline
of `torch.profiler`): profiling answers "what is the card doing",
telemetry "why is the step slower than the card's time".

Importing this package touches no CUDA device.
"""

from .tracer import JsonlJournal, Tracer  # noqa
from .steptimer import StepTimer  # noqa
from .watchdog import RecompileWatchdog  # noqa
from .heartbeat import (  # noqa
    Heartbeat, device_memory_stats, read_heartbeats, straggler_report,
    format_straggler_report,
)
from .slo import (  # noqa
    COUNTER_SLO_BURN, DEFAULT_SLO_BUDGETS, SLOBudget, SLOEngine,
    engine_budget_sets, format_slo_report,
)
from .roofline import RooflineProfiler, device_peaks  # noqa
from .telemetry import (  # noqa
    Telemetry, enable_telemetry, disable_telemetry, get_telemetry,
    TELEMETRY_NAME, TRACE_NAME, HEARTBEAT_DIR_NAME,
)

__all__ = [
    "Tracer", "JsonlJournal", "StepTimer", "RecompileWatchdog",
    "Heartbeat", "Telemetry",
    "enable_telemetry", "disable_telemetry", "get_telemetry",
    "device_memory_stats", "read_heartbeats", "straggler_report",
    "format_straggler_report",
    "SLOBudget", "SLOEngine", "DEFAULT_SLO_BUDGETS", "format_slo_report",
    "engine_budget_sets", "COUNTER_SLO_BURN",
    "RooflineProfiler", "device_peaks",
    "TELEMETRY_NAME", "TRACE_NAME", "HEARTBEAT_DIR_NAME",
]
