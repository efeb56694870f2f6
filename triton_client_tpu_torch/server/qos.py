"""Multi-tenant QoS: priority tiers, per-tenant token buckets, and the
tiered queue behind the dynamic batcher.

The port's copy of ``triton_client_tpu/server/qos.py``, with the same
policy, numbers and texts:

* **Priority tiers.** The v2 request ``priority`` (0 = highest) maps onto
  ``tiers`` classes, ``tier = min(priority, tiers - 1)``; the last tier is
  the preemptible best-effort lane.
* **Per-tenant token buckets.** The tenant comes from the
  ``triton-tenant`` header (gRPC metadata), else the basic-auth username,
  else ``"anonymous"``.  A configured rate (requests/s, with a burst)
  sheds a tenant's excess with 429 and pushback before it can take queue
  slots.
* **Tier-aware admission.** Tier 0 may fill a model's ``max_queue_size``,
  the best-effort lane ``best_effort_fraction`` of it, the tiers between
  on the line between.
* **Preemption.** A higher-tier arrival at a full queue evicts the newest
  queued request of the lowest lane strictly below it.
* **Depth-proportional pushback.** ``Retry-After`` scales with the shed
  tier's queue depth.

The one difference is :class:`TieredQueue`.  The reference's is an asyncio
queue whose getters park on futures; the port's batcher is a thread that
calls ``get(timeout=...)``, so here it is a thread-safe queue on a
``threading.Condition``.  It pops in the reference's order (strict
priority, FIFO within a tier, or weighted-fair with ``weights``): the same
puts give the same sequence of items.
"""

from __future__ import annotations

import base64
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["TokenBucket", "TieredQueue", "QosManager", "DEFAULT_TENANT",
           "parse_tenant_limit", "tenant_from_headers"]

DEFAULT_TENANT = "anonymous"


class TokenBucket:
    """Token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``acquire()`` returns ``None`` when a token was taken, else the seconds
    until one is available (the pushback horizon).  Thread-safe."""

    __slots__ = ("rate", "burst", "_tokens", "_stamp", "_lock")

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        # acquire() needs a whole token: a burst under one would deny every
        # request, so it floors at one
        self.burst = max(1.0, float(burst)) if burst is not None else max(
            1.0, self.rate)
        self._tokens = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            if now is None:
                now = time.monotonic()
            elapsed = max(0.0, now - self._stamp)
            self._stamp = now
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return None
            return (1.0 - self._tokens) / self.rate


class TieredQueue:
    """Multi-lane thread-safe queue with strict-priority or weighted-fair
    dequeue, and preemption of queued lower-tier items.

    ``put_nowait(item, tier)`` never blocks (admission bounds the depth
    before anything reaches it); ``get(timeout)`` waits for an item and
    raises ``queue.Empty`` at the timeout; ``preempt_lower(tier)`` takes
    the newest item of the lowest nonempty lane below ``tier``."""

    def __init__(self, tiers: int, weights: Optional[List[int]] = None):
        self._tiers = max(1, int(tiers))
        self._lanes: List[deque] = [deque() for _ in range(self._tiers)]
        if weights is not None:
            if len(weights) != self._tiers:
                raise ValueError(
                    f"need {self._tiers} weights, got {len(weights)}")
            if any(w <= 0 for w in weights):
                raise ValueError("tier weights must be positive")
        self._weights = list(weights) if weights is not None else None
        # weighted-fair state: the lane holding the floor and the pops it
        # has left before the floor rotates
        self._wf_lane = 0
        self._wf_credit = self._weights[0] if self._weights else 0
        self._cond = threading.Condition()

    # -- queue surface -----------------------------------------------------
    def empty(self) -> bool:
        with self._cond:
            return self._empty_locked()

    def _empty_locked(self) -> bool:
        return all(not lane for lane in self._lanes)

    def qsize(self) -> int:
        with self._cond:
            return sum(len(lane) for lane in self._lanes)

    def depth(self, tier: int) -> int:
        """Queued items in one tier's lane."""
        with self._cond:
            return len(self._lanes[self._clamp(tier)])

    def depths(self) -> List[int]:
        with self._cond:
            return [len(lane) for lane in self._lanes]

    def _clamp(self, tier: int) -> int:
        return min(max(int(tier), 0), self._tiers - 1)

    def put_nowait(self, item, tier: int = 0) -> None:
        with self._cond:
            self._lanes[self._clamp(tier)].append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None):
        """The next item by the dequeue policy; waits while empty, up to
        ``timeout`` seconds (None: for ever), then raises ``queue.Empty``."""
        with self._cond:
            if timeout is None:
                while self._empty_locked():
                    self._cond.wait()
            else:
                end = time.monotonic() + timeout
                while self._empty_locked():
                    left = end - time.monotonic()
                    if left <= 0:
                        raise queue.Empty
                    self._cond.wait(left)
            return self._pop()

    def _pop(self):
        if self._weights is None:
            for lane in self._lanes:
                if lane:
                    return lane.popleft()
            raise queue.Empty
        # deficit-style weighted fair: the floor-holding lane pops up to
        # its weight in a row while nonempty, then the floor rotates.
        # tiers + 1 turns: the only nonempty lane may hold the floor with
        # its credit spent, and gets it back after a full ring.
        for _ in range(self._tiers + 1):
            lane = self._lanes[self._wf_lane]
            if lane and self._wf_credit > 0:
                self._wf_credit -= 1
                return lane.popleft()
            self._wf_lane = (self._wf_lane + 1) % self._tiers
            self._wf_credit = self._weights[self._wf_lane]
        raise queue.Empty  # pragma: no cover - emptiness guarded

    def drain(self) -> list:
        """Every queued item, lane by lane, leaving the queue empty."""
        with self._cond:
            items = [item for lane in self._lanes for item in lane]
            for lane in self._lanes:
                lane.clear()
            return items

    # -- preemption --------------------------------------------------------
    def preempt_lower(self, tier: int):
        """Evict the newest queued item of the lowest nonempty lane strictly
        below ``tier``, for an arrival at ``tier``; None when nothing
        outranked is queued.  Best effort drains first, and the request
        that waited least loses least."""
        floor = self._clamp(tier)
        with self._cond:
            for lane_idx in range(self._tiers - 1, floor, -1):
                lane = self._lanes[lane_idx]
                if lane:
                    return lane.pop()
        return None


class QosManager:
    """Per-core QoS policy and counters.

    The defaults are inert: no tenant rate means no tenant is limited, and
    with every request at priority 0 one lane is used and tier 0's bound
    is ``max_queue_size``.

    Counters, read by ``/metrics``: ``tenant_requests[(tenant, tier)]``
    (``nv_qos_tenant_requests_total``, every request admitted or not) and
    ``rejected[(model, tenant, tier)]`` (``nv_inference_rejected_total``:
    tenant-bucket, tier-bound and preemption sheds).  At most
    ``MAX_TRACKED_TENANTS`` tenants are tracked; beyond that, new ones fold
    into ``~overflow`` for counters and buckets alike."""

    MAX_TRACKED_TENANTS = 1024
    OVERFLOW_TENANT = "~overflow"

    def __init__(
        self,
        tiers: int = 4,
        tenant_rate: float = 0.0,
        tenant_burst: Optional[float] = None,
        tenant_rates: Optional[Dict[str, Tuple[float, Optional[float]]]] = None,
        best_effort_fraction: float = 0.5,
        weights: Optional[List[int]] = None,
    ):
        if tiers < 1:
            raise ValueError("need at least one QoS tier")
        if not 0.0 < best_effort_fraction <= 1.0:
            raise ValueError(
                "best_effort_fraction must be in (0, 1], got "
                f"{best_effort_fraction}")
        self.tiers = int(tiers)
        self.tenant_rate = float(tenant_rate)      # 0 = unlimited
        self.tenant_burst = tenant_burst
        # per-tenant overrides: tenant -> (rate, burst); rate 0 = unlimited
        self.tenant_rates: Dict[str, Tuple[float, Optional[float]]] = \
            dict(tenant_rates or {})
        self.best_effort_fraction = float(best_effort_fraction)
        if weights is not None:
            # checked here, so that a bad --qos-weights fails at start-up
            if len(weights) != self.tiers:
                raise ValueError(
                    f"need {self.tiers} QoS weights, got {len(weights)}")
            if any(w <= 0 for w in weights):
                raise ValueError("QoS tier weights must be positive")
        self.weights = list(weights) if weights is not None else None
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._known_tenants: set = set()
        self.tenant_requests: Dict[Tuple[str, int], int] = {}
        self.rejected: Dict[Tuple[str, str, int], int] = {}

    def track_tenant(self, tenant: str) -> str:
        """The identity counters and buckets are keyed by: the tenant while
        the tracked set has room (configured tenants always), else
        ``~overflow``."""
        with self._lock:
            if tenant in self._known_tenants or tenant in self.tenant_rates:
                return tenant
            if len(self._known_tenants) < self.MAX_TRACKED_TENANTS:
                self._known_tenants.add(tenant)
                return tenant
            return self.OVERFLOW_TENANT

    # -- tiers -------------------------------------------------------------
    @property
    def best_effort_tier(self) -> int:
        return self.tiers - 1

    def tier_of(self, priority: int) -> int:
        """v2 priority -> tier: 0 is the highest class; anything at or
        beyond the last tier rides the best-effort lane."""
        try:
            p = int(priority)
        except (TypeError, ValueError):
            p = 0
        return min(max(p, 0), self.tiers - 1)

    def tier_limit(self, tier: int, max_queue_size: int) -> int:
        """The admission bound of ``tier`` against a model's queue bound:
        tier 0 the whole queue, best effort ``best_effort_fraction`` of it,
        the tiers between interpolated; at least 1 for a positive bound."""
        if max_queue_size <= 0:
            return 0  # unbounded model: no threshold
        if self.tiers == 1 or tier <= 0:
            return max_queue_size
        frac = 1.0 - (tier / (self.tiers - 1)) * (
            1.0 - self.best_effort_fraction)
        return max(1, int(max_queue_size * frac))

    # -- tenants -----------------------------------------------------------
    def count_request(self, tenant: str, tier: int) -> None:
        key = (self.track_tenant(tenant), tier)
        with self._lock:
            self.tenant_requests[key] = self.tenant_requests.get(key, 0) + 1

    def count_rejected(self, model: str, tenant: str, tier: int) -> None:
        key = (model, self.track_tenant(tenant), tier)
        with self._lock:
            self.rejected[key] = self.rejected.get(key, 0) + 1

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        # overflow tenants share one bucket: a rotating identity is
        # throttled as one tenant
        tenant = self.track_tenant(tenant)
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is not None:
                return bucket
            rate, burst = self.tenant_rates.get(
                tenant, (self.tenant_rate, self.tenant_burst))
            if rate <= 0:
                return None  # unlimited tenant
            bucket = TokenBucket(rate, burst)
            self._buckets[tenant] = bucket
            return bucket

    def admit_tenant(self, tenant: str) -> Optional[float]:
        """Token-bucket verdict: None = admitted, else the pushback horizon
        (seconds) for a 429."""
        bucket = self._bucket_for(tenant)
        if bucket is None:
            return None
        return bucket.acquire()

    def set_tenant_rate(self, tenant: str, rate: float,
                        burst: Optional[float] = None) -> None:
        """Override one tenant's rate at run time; the new rate applies at
        once."""
        with self._lock:
            self.tenant_rates[tenant] = (float(rate), burst)
            self._buckets.pop(tenant, None)

    # -- pushback ----------------------------------------------------------
    @staticmethod
    def pushback_s(base_s: float, depth: int, limit: int) -> float:
        """``Retry-After``: the base horizon scaled by how deep the shed
        tier's backlog is against the model's bound."""
        if base_s <= 0:
            return 0.0
        if limit <= 0:
            return base_s
        return base_s * (1.0 + max(0, depth) / float(limit))

    # -- snapshots (copies: the dicts change under live traffic) -----------
    def tenant_request_counts(self) -> Dict[Tuple[str, int], int]:
        with self._lock:
            return dict(self.tenant_requests)

    def rejected_counts(self) -> Dict[Tuple[str, str, int], int]:
        with self._lock:
            return dict(self.rejected)


def parse_tenant_limit(spec: str) -> Tuple[str, float, Optional[float]]:
    """``--qos-tenant-limit NAME=RATE[:BURST]`` -> (name, rate, burst); a
    ValueError on junk, so that a typo fails at start-up."""
    name, sep, rest = spec.partition("=")
    if not sep or not name or not rest:
        raise ValueError(
            f"invalid tenant limit '{spec}': expected NAME=RATE[:BURST]")
    rate_s, _, burst_s = rest.partition(":")
    rate = float(rate_s)
    burst = float(burst_s) if burst_s else None
    if rate < 0 or (burst is not None and burst <= 0):
        raise ValueError(
            f"invalid tenant limit '{spec}': rate must be >= 0 and "
            "burst > 0")
    return name, rate, burst


def tenant_from_headers(tenant_header: Optional[str],
                        authorization: Optional[str]) -> str:
    """One request's tenant: the ``triton-tenant`` header, else the
    basic-auth username, else ``anonymous``."""
    if tenant_header:
        return tenant_header
    if authorization and authorization.lower().startswith("basic "):
        try:
            decoded = base64.b64decode(
                authorization.split(None, 1)[1], validate=True).decode(
                "utf-8", errors="replace")
            user = decoded.partition(":")[0]
            if user:
                return user
        except (ValueError, IndexError):
            pass  # malformed auth is the auth layer's concern, not QoS's
    return DEFAULT_TENANT
