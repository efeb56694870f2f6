"""The cluster client: one client surface over a fleet of servers (the
reference's ``triton_client_tpu/cluster/``; ``cluster.aio`` is its asyncio
sibling over the port's aio clients).

* :class:`EndpointPool`: N endpoints, each with a circuit breaker
  (consecutive failures trip it, a half-open trial closes it), balanced by
  :class:`RoundRobin` or :class:`LeastOutstanding` (power of two choices),
  a sequence pinned by :func:`rendezvous_rank`;
* :class:`ClusterClient`: the ``InferenceServerClient`` surface over the
  port's ``http`` and ``grpc`` clients, with retries that prefer another
  replica, active health probes and :class:`HedgePolicy` hedging.

The client registry (``_telemetry.telemetry()``) counts it all:
``nv_client_endpoint_requests_total``, ``nv_client_endpoint_state``,
``nv_client_hedges_total`` and ``nv_client_hedge_wins_total``.
"""

from ._client import ClusterClient
from ._policy import (BalancingPolicy, HedgePolicy, LeastOutstanding,
                      RoundRobin, make_policy, rendezvous_rank)
from ._pool import CircuitBreaker, Endpoint, EndpointPool

__all__ = [
    "BalancingPolicy",
    "CircuitBreaker",
    "ClusterClient",
    "Endpoint",
    "EndpointPool",
    "HedgePolicy",
    "LeastOutstanding",
    "RoundRobin",
    "make_policy",
    "rendezvous_rank",
]
