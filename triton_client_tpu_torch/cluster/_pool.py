"""The endpoint pool: health, circuit breakers and routing state (the
reference's ``triton_client_tpu/cluster/_pool.py``).

An :class:`Endpoint` is one replica's routing state: its requests in
flight, a latency histogram per model (the port's
``_telemetry.LatencyHistogram``; the hedge delay reads it) and a
:class:`CircuitBreaker`.  :class:`EndpointPool` holds N of them and the
balancing policy, and picks the endpoint of each attempt: a sequence's pin
first, then the policy over the endpoints its breakers admit, less the
ones a retry excludes.

The breaker's states::

    closed    --[threshold consecutive failures]--> open
    open      --[reset_timeout_s elapsed]--------> half_open (one trial)
    half_open --[trial ok]--> closed;  half_open --[trial fails]--> open

``would_allow`` lists candidates and changes nothing; ``try_admit`` is
called on the chosen endpoint only, since admitting the half-open trial
takes its one slot.  Every transition is recorded in the client registry
(``nv_client_endpoint_state``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Union

from .._telemetry import LatencyHistogram, telemetry
from ._policy import make_policy, rendezvous_rank

__all__ = ["CircuitBreaker", "Endpoint", "EndpointPool"]


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open trial.

    ``record(ok)`` settles each routed attempt and each health probe;
    ``history`` keeps the last 64 transitions."""

    def __init__(self, endpoint: str, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.endpoint = endpoint
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._trial_in_flight = False
        self.history: List[str] = ["closed"]

    @property
    def state(self) -> str:
        return self._state

    def _transition(self, state: str) -> None:
        # the caller holds the lock
        if state == self._state:
            return
        self._state = state
        self.history.append(state)
        del self.history[:-64]  # a flapping endpoint must not grow it
        telemetry().set_endpoint_state(self.endpoint, state)

    def would_allow(self, now: Optional[float] = None) -> bool:
        """Whether a request could be admitted now; changes nothing."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return now - self._opened_at >= self.reset_timeout_s
            return not self._trial_in_flight  # half_open

    def try_admit(self, now: Optional[float] = None) -> bool:
        """Admission of the chosen endpoint.  An open breaker whose cooldown
        has passed goes half-open and gives this request its one trial
        slot, which the next ``record`` frees."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if now - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition("half_open")
                self._trial_in_flight = True
                return True
            # half_open: one trial at a time, so that a herd does not
            # knock down a replica that just came back
            if self._trial_in_flight:
                return False
            self._trial_in_flight = True
            return True

    def record(self, ok: bool, now: Optional[float] = None) -> None:
        """One attempt's outcome."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trial_in_flight = False
            if ok:
                self._consecutive_failures = 0
                if self._state != "open":
                    # an open breaker closes through its trial only: a
                    # success landing now was sent before the trip
                    self._transition("closed")
                return
            self._consecutive_failures += 1
            if self._state == "half_open" \
                    or self._consecutive_failures >= self.failure_threshold:
                self._opened_at = now
                self._transition("open")


class Endpoint:
    """One replica's routing state: URL, breaker, load, latencies."""

    def __init__(self, url: str, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0) -> None:
        self.url = url
        self.breaker = CircuitBreaker(url, failure_threshold,
                                      reset_timeout_s)
        self._lock = threading.Lock()
        self._outstanding = 0
        # per model, the latencies this client saw (the hedge delay)
        self._latency: Dict[str, LatencyHistogram] = {}
        telemetry().set_endpoint_state(url, "closed")

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def acquire(self) -> None:
        with self._lock:
            self._outstanding += 1

    def release(self) -> None:
        with self._lock:
            self._outstanding -= 1

    def observe(self, model: str, latency_s: float) -> None:
        h = self._latency.get(model)
        if h is None:
            with self._lock:
                h = self._latency.setdefault(model, LatencyHistogram())
        h.observe(latency_s)

    def latency(self, model: str) -> Optional[LatencyHistogram]:
        return self._latency.get(model)

    def __repr__(self) -> str:
        return (f"Endpoint({self.url!r}, state={self.breaker.state}, "
                f"outstanding={self._outstanding})")


class EndpointPool:
    """N endpoints, a balancing policy and sticky sequence routing.

    ``probe_ok(url, ok)`` takes an active health probe's verdict (the
    client that owns the transports runs the probes): a failed probe
    counts as a failure, so a dead endpoint with no traffic is evicted
    too; a passed probe on a recovering endpoint takes the half-open
    trial, so its recovery costs no user request."""

    def __init__(
        self,
        urls: Union[str, Iterable[str]],
        policy: Union[str, object] = "least_outstanding",
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
    ) -> None:
        if isinstance(urls, str):
            urls = [u.strip() for u in urls.split(",") if u.strip()]
        urls = list(urls)
        if not urls:
            raise ValueError("EndpointPool needs at least one endpoint URL")
        if len(set(urls)) != len(urls):
            raise ValueError(f"duplicate endpoint URLs: {urls}")
        self.endpoints: List[Endpoint] = [
            Endpoint(u, failure_threshold, reset_timeout_s) for u in urls]
        self._by_url = {e.url: e for e in self.endpoints}
        self.policy = make_policy(policy)

    @property
    def urls(self) -> List[str]:
        return [e.url for e in self.endpoints]

    def endpoint(self, url: str) -> Endpoint:
        return self._by_url[url]

    def sticky_rank(self, sequence_id: int) -> List[str]:
        """The endpoints in one sequence's rendezvous order (rank 0 its
        pin, the rest its failover order)."""
        return rendezvous_rank(sequence_id, self.urls)

    def _admit_from(self, candidates: Sequence[Endpoint]
                    ) -> Optional[Endpoint]:
        """The policy's choice, admitted; where a half-open trial was lost
        to another request, a choice among the rest."""
        remaining = list(candidates)
        while remaining:
            chosen = (self.policy.choose(remaining) if len(remaining) > 1
                      else remaining[0])
            if chosen.breaker.try_admit():
                return chosen
            remaining.remove(chosen)
        return None

    def pick(self, sequence_id: int = 0,
             exclude: Sequence[str] = ()) -> Endpoint:
        """The endpoint of one attempt.

        A nonzero ``sequence_id`` goes by rendezvous rank, skipping evicted
        and excluded endpoints in rank order, so its pin moves only when
        the pinned replica is out.  Otherwise the policy chooses among the
        admitted endpoints.  An exclusion that would leave none is dropped
        (the same replica again beats failing), and with every breaker open
        the policy routes over all of them: the retry layer decides."""
        if sequence_id:
            ranked = self.sticky_rank(sequence_id)
            for pass_exclude in (exclude, ()):
                for url in ranked:
                    e = self._by_url[url]
                    if url in pass_exclude:
                        continue
                    if e.breaker.try_admit():
                        return e
                    if e.breaker.state == "half_open":
                        # its one trial is taken, but the pinned replica is
                        # back enough to be on trial: a sequence stays
                        # where its state is
                        return e
            return self._by_url[ranked[0]]
        for pass_exclude in (exclude, ()):
            candidates = [e for e in self.endpoints
                          if e.url not in pass_exclude
                          and e.breaker.would_allow()]
            chosen = self._admit_from(candidates)
            if chosen is not None:
                return chosen
        # every breaker open: route all the same
        return (self.policy.choose(self.endpoints)
                if len(self.endpoints) > 1 else self.endpoints[0])

    def record(self, endpoint: Endpoint, ok: bool) -> None:
        """One routed attempt's outcome: its breaker and its counter."""
        endpoint.breaker.record(ok)
        telemetry().record_endpoint_request(endpoint.url, ok)

    def probe_ok(self, url: str, ok: bool) -> None:
        """One health probe's verdict.  A passed probe matters only to an
        endpoint that is recovering: on a closed breaker it is dropped, or
        a replica that answers its health route and fails its requests
        would never trip.  A failed probe always counts."""
        br = self._by_url[url].breaker
        if ok:
            if br.state == "closed":
                return
            if not br.try_admit():
                # still cooling down, or a trial is in flight
                return
        br.record(ok)

    def states(self) -> Dict[str, str]:
        return {e.url: e.breaker.state for e in self.endpoints}
