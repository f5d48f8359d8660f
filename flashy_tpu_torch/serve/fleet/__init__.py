"""The serving fleet of the PyTorch port (port of
flashy_tpu/serve/fleet/): N engines behind one deterministic
prefix-sticky router, prefill/decode disaggregation with a block-list
handoff over one shared pool, per-tenant quotas and priority preemption,
per-engine SLO-burn redirects, engine-death re-routing that re-serves
in-flight requests token-exactly, and a request write-ahead log that
makes admission durable across a killed process. It composes the
engine, scheduler and paged pool; every paged read of its engines goes
through the Hopper paged-decode kernel on the card.

`python -m flashy_tpu_torch.serve.fleet` runs the acceptance demo.
"""

from .fleet import (  # noqa
    ENGINE_FAULT_SITE, STATUS_FAULT_SITE, FleetMember, ServingFleet,
)
from .handoff import DisaggregatedPair, HandoffPacket, hand_off  # noqa
from .quota import QuotaManager, TenantQuota  # noqa
from .router import FleetRouter, RouteDecision, fnv1a  # noqa
from .wal import (  # noqa
    APPEND_FAULT_SITE, REPLAY_FAULT_SITE, RequestWAL, WALEntry,
)

__all__ = [
    "ServingFleet", "FleetMember", "ENGINE_FAULT_SITE",
    "STATUS_FAULT_SITE",
    "DisaggregatedPair", "HandoffPacket", "hand_off",
    "QuotaManager", "TenantQuota",
    "FleetRouter", "RouteDecision", "fnv1a",
    "RequestWAL", "WALEntry", "APPEND_FAULT_SITE", "REPLAY_FAULT_SITE",
]
