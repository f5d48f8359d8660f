"""TenantQuota and QuotaManager: per-tenant in-flight admission caps
(port of flashy_tpu/serve/fleet/quota.py).

A fleet door without quotas lets one tenant's burst fill every queue.
The quota is a cap on a tenant's IN-FLIGHT requests fleet-wide (queued
and running), the one resource the door controls at submit time; blocks
and slots are priced downstream by each engine's own admission. An
over-quota submit sheds with the same QueueFull a full queue raises.
"""
import dataclasses
import typing as tp


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract: `max_inflight` concurrent
    requests fleet-wide, and the `priority` class stamped on its requests
    (higher admits first and may preempt strictly-lower running ones)."""
    max_inflight: int = 8
    priority: int = 0

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {self.max_inflight}")


class QuotaManager:
    """Per-tenant in-flight counts against their quotas: `try_acquire`
    counts a request or refuses it at the cap (the caller sheds with
    QueueFull), `release` returns the credit when it finishes. Unknown
    tenants get `default`."""

    def __init__(self, quotas: tp.Optional[
                     tp.Mapping[str, TenantQuota]] = None,
                 default: TenantQuota = TenantQuota()):
        self.quotas: tp.Dict[str, TenantQuota] = dict(quotas or {})
        self.default = default
        self._inflight: tp.Dict[str, int] = {}
        self.shed: tp.Dict[str, int] = {}  # tenant -> over-quota refusals

    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default)

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def try_acquire(self, tenant: str) -> bool:
        """Count one request against `tenant`, or refuse at its cap."""
        if self.inflight(tenant) >= self.quota_for(tenant).max_inflight:
            self.shed[tenant] = self.shed.get(tenant, 0) + 1
            return False
        self._inflight[tenant] = self.inflight(tenant) + 1
        return True

    def release(self, tenant: str) -> None:
        count = self.inflight(tenant)
        if count <= 0:
            raise ValueError(f"release without acquire for tenant "
                             f"{tenant!r}")
        self._inflight[tenant] = count - 1

    def summary(self) -> tp.Dict[str, tp.Dict[str, int]]:
        """Per-tenant {inflight, max_inflight, shed}."""
        tenants = (set(self._inflight) | set(self.shed)
                   | set(self.quotas))
        return {t: {"inflight": self.inflight(t),
                    "max_inflight": self.quota_for(t).max_inflight,
                    "shed": self.shed.get(t, 0)}
                for t in sorted(tenants)}
