"""Fault tolerance of the PyTorch port (the port of
flashy_tpu.resilience): so far the deterministic fault injector the
serving path's chaos drills run under (`chaos`). The preemption guard,
checkpoint integrity, retry, the hang watchdog and the chaos campaign
come with ROADMAP.md queue A item 9's resilience half.

Importing this package touches no CUDA device.
"""

from .chaos import (  # noqa
    FaultInjector, InjectedFault, UnfiredFaultRules, corrupt_active_slot,
    corrupt_file, fault_point, get_injector, install, stall_heartbeat,
    uninstall,
)

__all__ = [
    "FaultInjector", "InjectedFault", "UnfiredFaultRules", "install",
    "uninstall", "get_injector",
    "fault_point", "corrupt_file", "corrupt_active_slot", "stall_heartbeat",
]
