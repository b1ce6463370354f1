"""Per-tenant serving policy: default params, caps, token-bucket admission.

The registry is the *admission* half of the serving loop. Every request is
checked host-side before it can queue: unknown tenants, cap-violating
parameter overrides and tenants that have exhausted their token budget are
shed with a typed ``Rejected`` reason instead of queueing unboundedly —
under overload the loop keeps serving admitted traffic at its provisioned
rate while the shed fraction is observable per tenant in ``ServerStats``.

Token buckets are deterministic given an explicit clock: ``admit(tenant,
now)`` refills from the elapsed time since the previous call, so the
synchronous loop (``serve_loop`` with a scripted trace) reproduces
admission decisions exactly, and the threaded front-end passes wall time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.api import SearchParams
from repro_torch.serve import request as request_mod
from repro_torch.serve.request import Request

__all__ = ["TenantPolicy", "TenantRegistry", "TokenBucket"]


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant serving contract.

    ``params`` are the tenant's default ``SearchParams`` (every request
    without an explicit override serves with these, so one tenant's whole
    stream coalesces onto one plan signature). ``max_k``/``max_pool`` cap
    per-request overrides; ``rate``/``burst`` parameterize the token bucket
    (requests/second sustained, and the burst capacity — ``math.inf`` rate
    disables rate limiting). ``write_rate``/``write_burst`` are the same
    contract for the write path (a *separate* bucket, so a write burst
    cannot starve the tenant's reads or vice versa).
    """

    params: SearchParams = SearchParams()
    max_k: int = 128
    max_pool: int = 1024
    rate: float = math.inf  # sustained admitted requests/second
    burst: float = 32.0  # token-bucket capacity (peak burst size)
    write_rate: float = math.inf  # sustained admitted writes/second
    write_burst: float = 32.0  # write token-bucket capacity

    def __post_init__(self):
        if self.max_k <= 0 or self.max_pool <= 0:
            raise ValueError("caps must be positive")
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError("rate and burst must be positive")
        if self.write_rate <= 0 or self.write_burst <= 0:
            raise ValueError("write_rate and write_burst must be positive")
        if self.params.k > self.max_k:
            raise ValueError("default params.k exceeds max_k")
        if self.params.effective_pool > self.max_pool:
            raise ValueError("default params pool exceeds max_pool")


@dataclasses.dataclass
class TokenBucket:
    """Deterministic token bucket: refills ``rate`` tokens/second up to
    ``burst``, one token per admitted request. Time never flows backwards
    (a stale ``now`` is clamped), so replaying a trace is reproducible."""

    rate: float
    burst: float
    tokens: float = dataclasses.field(default=0.0)
    _last: float = dataclasses.field(default=0.0)
    _started: bool = dataclasses.field(default=False)

    def try_take(self, now: float) -> bool:
        if math.isinf(self.rate):  # rate limiting disabled — burst included
            return True
        if not self._started:  # first sighting: full burst available
            self.tokens, self._last, self._started = self.burst, now, True
        elif now > self._last:
            self.tokens = min(
                self.burst, self.tokens + (now - self._last) * self.rate
            )
            self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class TenantRegistry:
    """Tenant → policy mapping plus live token-bucket state.

    ``default_policy`` (when given) auto-registers unseen tenants on first
    contact; without it, requests from unknown tenants are rejected.
    """

    def __init__(self, default_policy: Optional[TenantPolicy] = None):
        self._policies: Dict[str, TenantPolicy] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._write_buckets: Dict[str, TokenBucket] = {}
        self.default_policy = default_policy

    def register(self, tenant: str, policy: TenantPolicy) -> None:
        self._policies[tenant] = policy
        self._buckets[tenant] = TokenBucket(policy.rate, policy.burst)
        self._write_buckets[tenant] = TokenBucket(
            policy.write_rate, policy.write_burst
        )

    def policy(self, tenant: str) -> Optional[TenantPolicy]:
        got = self._policies.get(tenant)
        if got is None and self.default_policy is not None:
            self.register(tenant, self.default_policy)
            got = self.default_policy
        return got

    @property
    def tenants(self) -> tuple:
        return tuple(self._policies)

    def resolve_params(self, req: Request) -> SearchParams:
        """The request's effective ``SearchParams`` (tenant default unless
        overridden). Assumes ``admit`` already validated caps."""
        pol = self.policy(req.tenant)
        assert pol is not None
        return req.params if req.params is not None else pol.params

    def admit(self, req: Request, now: float) -> Optional[str]:
        """Admission check at time ``now``: returns None to admit, or the
        typed rejection reason. Order: tenant existence → per-request caps
        (cap checks are free; a capped request must not burn a token) →
        token bucket."""
        pol = self.policy(req.tenant)
        if pol is None:
            return request_mod.REJECT_UNKNOWN
        if req.params is not None:
            if req.params.k > pol.max_k:
                return request_mod.REJECT_K_CAP
            if req.params.effective_pool > pol.max_pool:
                return request_mod.REJECT_POOL_CAP
        if not self._buckets[req.tenant].try_take(now):
            return request_mod.REJECT_RATE
        return None

    def admit_write(self, write, now: float) -> Optional[str]:
        """Admission for the write path (``Upsert``/``Delete``): tenant
        existence, then the tenant's *write* token bucket. Reads and
        writes draw from independent budgets."""
        pol = self.policy(write.tenant)
        if pol is None:
            return request_mod.REJECT_UNKNOWN
        if not self._write_buckets[write.tenant].try_take(now):
            return request_mod.REJECT_WRITE_RATE
        return None
