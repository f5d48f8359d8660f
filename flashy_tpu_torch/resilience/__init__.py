"""Fault tolerance of the PyTorch port (the port of
flashy_tpu.resilience): the pieces that make "a preempted run resumes
exactly at the last committed epoch" hold when the failure is not
polite.

  * PreemptionGuard  SIGTERM/SIGINT -> a cooperative stop at a stage or
                     commit boundary; the requeue exit code 75
  * integrity        sha256 manifests per slot and a sidecar per file;
                     restore verifies before unpickling and falls back
                     to the sibling A/B slot
  * retry            exponential backoff with jitter for transient IO
                     (checkpoint writes, history.json; metric backends
                     degrade to warnings)
  * FaultInjector    deterministic site-keyed fault injection: every
                     recovery path above is tested through it
  * HangWatchdog     WARNs, then optionally aborts (exit code 70) with a
                     straggler report, when a rank's heartbeat stalls

`python -m flashy_tpu_torch.resilience` is the chaos drill: it trains
under an injected mid-stage SIGTERM, a transient IO fault and a
corrupted active checkpoint slot, and checks the resumed run's history
and state against an uninterrupted run. With `--campaign` it runs the
chaos campaign (`resilience.campaign`: every registry site under every
fault kind its scenario declares, failures shrunk to a JSON reproducer)
over the ported `train` and `datapipe` scenarios; the serve, fleet,
pipeline, tensor and elastic scenarios wait for ROADMAP.md queue A
items 5, 8 and 10.

Importing this package touches no CUDA device.
"""

from .preemption import (  # noqa
    EXIT_PREEMPTED, PreemptionGuard, PreemptionInterrupt,
    enable_preemption_guard, disable_preemption_guard, get_preemption_guard,
)
from .integrity import (  # noqa
    MANIFEST_NAME, CheckpointCorrupted, CheckpointError, file_digest,
    verify_checkpoint, verify_file, verify_slot, write_manifest,
    write_sidecar,
)
from .retry import backoff_delay, call_with_retry, retry  # noqa
from .chaos import (  # noqa
    FaultInjector, InjectedFault, UnfiredFaultRules, corrupt_active_slot,
    corrupt_file, fault_point, get_injector, install, stall_heartbeat,
    uninstall,
)
from .hang import EXIT_HUNG, HangWatchdog  # noqa
from .campaign import (  # noqa  (imports `chaos` above: keep this last)
    CampaignFailure, FaultSpec, Schedule, builtin_scenarios, ddmin,
    replay_artifact, run_campaign, static_coverage,
)

__all__ = [
    "EXIT_PREEMPTED", "EXIT_HUNG", "PreemptionGuard", "PreemptionInterrupt",
    "enable_preemption_guard", "disable_preemption_guard",
    "get_preemption_guard",
    "MANIFEST_NAME", "CheckpointError", "CheckpointCorrupted", "file_digest",
    "write_manifest", "write_sidecar", "verify_slot", "verify_file",
    "verify_checkpoint",
    "retry", "call_with_retry", "backoff_delay",
    "FaultInjector", "InjectedFault", "UnfiredFaultRules", "install",
    "uninstall", "get_injector",
    "fault_point", "corrupt_file", "corrupt_active_slot", "stall_heartbeat",
    "HangWatchdog",
    "CampaignFailure", "FaultSpec", "Schedule", "builtin_scenarios",
    "ddmin", "static_coverage", "run_campaign", "replay_artifact",
]
