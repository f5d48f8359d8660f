"""FleetRouter: deterministic prefix-sticky request routing (port of
flashy_tpu/serve/fleet/router.py; numpy only).

Every engine of a fleet keeps its OWN prefix index, so two requests that
share a system prompt share K/V only if the router lands them on the
same engine. The routing key is the prefix cache's own chain key: the
token content of the prompt's first full block, the root link of the
chain `PrefixIndex.match` walks, hashed with a fixed FNV-1a (Python's
`hash()` is salted per process), so the same key and fleet route alike
in every process and rerun. The engine-death drill re-serves a dead
engine's requests, and replaying where each went is how it is debugged.
"""
import dataclasses
import typing as tp

import numpy as np

# FNV-1a 64-bit offset basis and prime
_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_FNV_MOD = 1 << 64

POLICIES = ("sticky", "round_robin")


def fnv1a(data: bytes, seed: int = 0) -> int:
    """64-bit FNV-1a of `data`, optionally perturbed by `seed`:
    deterministic across processes, platforms and reruns."""
    h = _FNV_OFFSET
    if seed:
        for b in seed.to_bytes(8, "little"):
            h = ((h ^ b) * _FNV_PRIME) % _FNV_MOD
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) % _FNV_MOD
    return h


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one request goes and why.

    `engine` is the chosen member; `reason` is 'sticky' (chain-key hash),
    'round_robin' (uid modulo) or 'slo_redirect' (the target was burning
    its SLO budgets and the request moved to the next healthy engine on
    the probe ring that is not). `key_hash` is the FNV-1a of the routing
    key, stable across reruns.
    """
    engine: str
    reason: str
    key_hash: int


class FleetRouter:
    """Prefix-cache-aware sticky routing over a named engine set.

    The chain key of a prompt is the bytes of its first full block
    (`prompt[:block_size]` as int32), so requests sharing a header of at
    least one block hash to the same engine and hit its prefix cache; a
    prompt shorter than a block routes on all its bytes.
    `policy='round_robin'` (uid modulo fleet size) is the prefix-blind
    baseline.

    Args:
        engines: ordered member names; the order is part of the routing
            contract (the hash indexes the HEALTHY subsequence in order).
        block_size: the paged block size defining "first full block".
        policy: 'sticky' (default) or 'round_robin'.
        seed: perturbs the sticky hash (another deterministic placement).
    """

    def __init__(self, engines: tp.Sequence[str], block_size: int,
                 policy: str = "sticky", seed: int = 0):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one engine name")
        if len(set(engines)) != len(engines):
            raise ValueError(f"duplicate engine names in {engines}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.engines = engines
        self.block_size = int(block_size)
        self.policy = policy
        self.seed = int(seed)

    def chain_key(self, prompt: np.ndarray) -> bytes:
        """The routing key: the bytes of the prompt's first full block,
        or of the whole prompt when it is shorter than one block."""
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        if prompt.size >= self.block_size:
            return prompt[:self.block_size].tobytes()
        return prompt.tobytes()

    def route(self, uid: int, prompt: np.ndarray,
              healthy: tp.Optional[tp.Collection[str]] = None,
              alerting: tp.Collection[str] = ()) -> RouteDecision:
        """Pick the engine for one request.

        `healthy` restricts the candidates (None: all). A target in
        `alerting` redirects to the next candidate on the probe ring that
        is not alerting; when every candidate alerts, the target stays
        (the fleet's door decides whether to shed; the router only
        places). Deterministic in (uid, chain key, candidates).
        """
        candidates = [e for e in self.engines
                      if healthy is None or e in healthy]
        if not candidates:
            raise RuntimeError("no healthy engines to route to")
        key_hash = fnv1a(self.chain_key(prompt), seed=self.seed)
        if self.policy == "sticky":
            start, reason = key_hash % len(candidates), "sticky"
        else:
            start, reason = uid % len(candidates), "round_robin"
        choice = candidates[start]
        if choice in alerting:
            for step in range(1, len(candidates)):
                probe = candidates[(start + step) % len(candidates)]
                if probe not in alerting:
                    return RouteDecision(engine=probe,
                                         reason="slo_redirect",
                                         key_hash=key_hash)
        return RouteDecision(engine=choice, reason=reason,
                             key_hash=key_hash)
