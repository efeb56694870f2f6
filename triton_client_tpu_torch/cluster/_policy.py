"""Balancing policies of the cluster client (the reference's
``triton_client_tpu/cluster/_policy.py``).

A policy answers one question, ``choose(endpoints)`` over the endpoints
that may take a request now; health, exclusion and sequence pinning are
the pool's (``_pool.py``):

* ``round_robin``: strict rotation, blind to load;
* ``least_outstanding``: power of two choices (Mitzenmacher 2001): two
  endpoints drawn at random, the one with fewer requests in flight taken.
  Its draws come from a ``random.Random`` of an explicit seed.

A nonzero ``sequence_id`` is routed before any policy, by rendezvous
(highest random weight) hashing, :func:`rendezvous_rank`: md5 over
``"<sequence id>|<url>"``, the same order as the reference's for the same
URLs, so a sequence's replica does not depend on which package routes it.
Dropping an endpoint never moves a sequence pinned to another one.

:class:`HedgePolicy` says when a hedged request sends its backup: after
the chosen endpoint's observed latency quantile for the model, or a fixed
delay until ``min_samples`` observations exist.
"""

from __future__ import annotations

import hashlib
import random
import threading
from typing import List, Optional, Sequence

__all__ = [
    "BalancingPolicy",
    "HedgePolicy",
    "LeastOutstanding",
    "RoundRobin",
    "make_policy",
    "rendezvous_rank",
]


class HedgePolicy:
    """The delay before a hedged request's backup (Dean and Barroso, "The
    Tail at Scale", 2013): the ``quantile`` of the (model, endpoint)
    latencies this client observed, ``default_delay_s`` until there are
    ``min_samples`` of them.  A hedge runs the request twice, so the
    cluster client hedges only what may run twice (a retry policy with
    ``retry_infer``, or ``hedge=True`` on the call), never a sequence."""

    def __init__(self, quantile: float = 0.95,
                 default_delay_s: float = 0.05,
                 min_samples: int = 16) -> None:
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        self.quantile = float(quantile)
        self.default_delay_s = float(default_delay_s)
        self.min_samples = int(min_samples)

    def delay_s(self, endpoint, model: str) -> float:
        """The hedge delay of one request to ``model`` on ``endpoint``."""
        h = endpoint.latency(model)
        if h is not None and h.count >= self.min_samples:
            return h.quantile(self.quantile)
        return self.default_delay_s


class BalancingPolicy:
    """Picks one endpoint of a non-empty sequence."""

    name = "abstract"

    def choose(self, endpoints: Sequence):
        raise NotImplementedError


class RoundRobin(BalancingPolicy):
    name = "round_robin"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def choose(self, endpoints: Sequence):
        with self._lock:
            i = self._n
            self._n += 1
        return endpoints[i % len(endpoints)]


class LeastOutstanding(BalancingPolicy):
    """Power of two choices over the requests in flight."""

    name = "least_outstanding"

    def __init__(self, seed: Optional[int] = None) -> None:
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def choose(self, endpoints: Sequence):
        if len(endpoints) == 1:
            return endpoints[0]
        with self._lock:
            a, b = self._rng.sample(range(len(endpoints)), 2)
        ea, eb = endpoints[a], endpoints[b]
        return ea if ea.outstanding <= eb.outstanding else eb


def rendezvous_rank(sequence_id: int, urls: Sequence[str]) -> List[str]:
    """``urls`` by rendezvous weight for one sequence, highest first: rank
    0 is its pin, the next ranks its failover order.  md5, not ``hash()``
    (salted per process), so every process ranks alike."""
    def weight(url: str) -> int:
        return int.from_bytes(
            hashlib.md5(f"{sequence_id}|{url}".encode()).digest()[:8],
            "big")

    return sorted(urls, key=weight, reverse=True)


_POLICIES = {
    "round_robin": RoundRobin,
    "least_outstanding": LeastOutstanding,
}


def make_policy(spec) -> BalancingPolicy:
    """A policy from its name, or ``spec`` itself where it is one."""
    if isinstance(spec, BalancingPolicy):
        return spec
    try:
        return _POLICIES[spec]()
    except KeyError:
        raise ValueError(
            f"unknown balancing policy {spec!r}; "
            f"expected one of {sorted(_POLICIES)} or a BalancingPolicy")
