"""Client-side resilience: retry policy, backoff and deadline budgets.

The port's copy of ``triton_client_tpu/_resilience.py``, shared by its HTTP
and gRPC clients:

* :class:`RetryPolicy` -- attempts, exponential backoff with full jitter,
  gated on retryable failures only: connection errors, HTTP 429/503, gRPC
  UNAVAILABLE/RESOURCE_EXHAUSTED.  The server's pushback (HTTP
  ``triton-retry-after-ms`` / ``Retry-After``, gRPC ``retry-after-ms``
  trailing metadata) overrides the computed backoff.  An oversize
  rejection (413, or RESOURCE_EXHAUSTED with the ingress cap's text) is
  never retried.  ``infer`` retries only where the caller opts in
  (``retry_infer=True``): a request that timed out may have run.
* A per-request deadline budget (``deadline_s``) caps the time across all
  attempts; what is left of it travels to the server on each attempt, as
  the ``triton-timeout-us`` header on HTTP and the v2 ``timeout``
  parameter on gRPC, so the server drops a request whose client gave up.

The error classifiers are rewritten for the port's own exception types:
the HTTP client raises ``http.client`` and socket errors for a connection
that broke (``IncompleteRead`` where a response was cut short, as a chaos
``abort`` does), and both clients raise ``InferenceServerException`` with
the HTTP status or the gRPC status spelling (``"StatusCode.UNAVAILABLE"``).
Each committed retry is counted in the client registry
(``_telemetry.telemetry()``), which ``perf_analyzer`` reads back, and
where client tracing is on it leaves a RETRY span over the failed
attempt.  A single request's retry loop (``journey=True``) runs inside a
journey (``_telemetry.begin_journey``): every attempt sends a traceparent
with the journey's one trace id and a span id of its own, so the server
records of all attempts join the client's under one trace.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

from ._telemetry import begin_journey, current_journey, end_journey, telemetry
from .utils import InferenceServerException

__all__ = [
    "RetryPolicy",
    "call_with_retry",
    "deadline_exceeded_error",
    "is_connection_error",
    "is_oversize_error",
    "is_quarantine_error",
    "min_timeout",
    "normalized_status",
    "remaining_us",
]

#: Statuses a policy retries by default.  DEADLINE_EXCEEDED is not one:
#: retrying a blown deadline only blows it further.
DEFAULT_RETRYABLE_STATUSES = frozenset(
    {"429", "503", "UNAVAILABLE", "RESOURCE_EXHAUSTED"})

#: Message markers of a wire-size rejection: RESOURCE_EXHAUSTED is also
#: the status of a retryable shed, so only the text tells them apart.
_OVERSIZE_MSG_MARKERS = (
    "larger than max",            # gRPC max_receive_message_length
    "message length",             # grpc-core variants of the same check
    "max request size",           # the servers' typed 413 text
    "max-request-bytes",          # ... and its flag spelling
    "request entity too large",   # stock HTTP 413 reason phrase
    # the memory governor's permanent verdict (a 413 that gRPC carries as
    # RESOURCE_EXHAUSTED)
    "can never be admitted",
)

#: Message marker of a device-fault quarantine refusal (503/UNAVAILABLE).
_QUARANTINE_MSG_MARKERS = ("quarantined",)

#: Exception class names (anywhere in the MRO) of a connection that failed
#: or broke: the server may never have seen the request, or its answer was
#: cut short.
_CONNECTION_EXC_NAMES = frozenset({
    "ConnectionError", "ConnectionResetError", "ConnectionRefusedError",
    "ConnectionAbortedError", "BrokenPipeError",
    # http.client: the connection closed before or inside a response
    "RemoteDisconnected", "IncompleteRead", "BadStatusLine",
})

#: Exception class names of a transport timeout.
_TIMEOUT_EXC_NAMES = frozenset({"TimeoutError"})


def normalized_status(exc: BaseException) -> Optional[str]:
    """The status a client exception carries, the same on both
    protocols: ``"429"``/``"503"`` (HTTP) or the bare gRPC code name
    (``"UNAVAILABLE"``)."""
    status = getattr(exc, "_status", None)
    if status is None:
        return None
    status = str(status)
    if status.startswith("StatusCode."):
        status = status[len("StatusCode."):]
    return status


def is_oversize_error(exc: BaseException) -> bool:
    """A wire-size rejection (HTTP 413, or RESOURCE_EXHAUSTED with the
    ingress cap's text): never retryable, the same payload bounces again."""
    status = normalized_status(exc)
    if status == "413":
        return True
    if status in ("RESOURCE_EXHAUSTED", "429"):
        msg = str(exc).lower()
        return any(marker in msg for marker in _OVERSIZE_MSG_MARKERS)
    return False


def is_quarantine_error(exc: BaseException) -> bool:
    """A quarantine refusal (503/UNAVAILABLE naming it): shed before any
    compute, so safe to retry even for ``infer``."""
    if normalized_status(exc) not in ("503", "UNAVAILABLE"):
        return False
    msg = str(exc).lower()
    return any(marker in msg for marker in _QUARANTINE_MSG_MARKERS)


def is_connection_error(exc: BaseException) -> bool:
    """A connection-level failure: it failed to connect, or broke before
    or inside the response."""
    if isinstance(exc, (ConnectionError, BrokenPipeError)):
        return True
    return any(k.__name__ in _CONNECTION_EXC_NAMES
               for k in type(exc).__mro__)


def is_timeout_error(exc: BaseException) -> bool:
    """A transport timeout (``socket.timeout`` is ``TimeoutError``)."""
    if isinstance(exc, TimeoutError):
        return True
    return any(k.__name__ in _TIMEOUT_EXC_NAMES
               for k in type(exc).__mro__)


def deadline_exceeded_error(msg: str = "deadline exceeded before the "
                            "request completed") -> InferenceServerException:
    """The typed client-side deadline failure (the gRPC spelling on both
    protocols)."""
    return InferenceServerException(
        msg=msg, status="StatusCode.DEADLINE_EXCEEDED")


class RetryPolicy:
    """Retry and backoff policy of both clients.

    ``max_attempts`` counts the first (1 = no retries).  The delay before
    attempt ``n + 1`` is drawn uniformly from ``[0, min(max_backoff_s,
    initial_backoff_s * backoff_multiplier ** (n - 1))]`` (full jitter),
    unless the server sent pushback.  ``retry_infer`` lets ``infer``
    retry; health and metadata calls always may.  ``retryable_statuses``
    gate a retry (connection failures always retry).  ``deadline_s`` is the
    default deadline of a call that passes none; ``seed`` seeds the jitter.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        initial_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        backoff_multiplier: float = 2.0,
        retry_infer: bool = False,
        retryable_statuses=DEFAULT_RETRYABLE_STATUSES,
        deadline_s: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.initial_backoff_s = float(initial_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.backoff_multiplier = float(backoff_multiplier)
        self.retry_infer = bool(retry_infer)
        self.retryable_statuses = frozenset(retryable_statuses)
        self.deadline_s = deadline_s
        self._rng = random.Random(seed)

    def should_retry(self, exc: BaseException, method: str,
                     attempt: int) -> bool:
        """Whether a failed ``attempt`` (from 1) of a ``method``-class call
        ("infer" / "health" / "metadata") may be retried."""
        if attempt >= self.max_attempts:
            return False
        if is_quarantine_error(exc):
            return True  # refused before any compute
        if method == "infer" and not self.retry_infer:
            return False
        if is_oversize_error(exc):
            return False
        if is_connection_error(exc) or is_timeout_error(exc):
            return True
        status = normalized_status(exc)
        return status is not None and status in self.retryable_statuses

    def backoff_s(self, attempt: int,
                  retry_after_s: Optional[float] = None) -> float:
        """The delay before the next attempt: the server's pushback where
        it sent one, else the jittered exponential backoff."""
        if retry_after_s is not None and retry_after_s >= 0:
            return float(retry_after_s)
        cap = min(self.max_backoff_s,
                  self.initial_backoff_s
                  * self.backoff_multiplier ** (attempt - 1))
        return self._rng.uniform(0.0, cap)


def _record_retry(model: str, protocol: str, method_name: str,
                  request_id: str, attempt_start_ns: int) -> None:
    """A committed retry: counted, and where client tracing is on, a RETRY
    span over the failed attempt (under the journey's traceparent and
    attempt number where one is open)."""
    tel = telemetry()
    tel.record_retry(model, protocol, method_name)
    if tel.tracing_enabled:
        journey = current_journey()
        tel.record_client_trace(
            request_id or (journey.request_id if journey else ""),
            model, protocol, method_name,
            spans=[("RETRY", attempt_start_ns, time.monotonic_ns())],
            ok=False)


def call_with_retry(
    policy: Optional[RetryPolicy],
    attempt_fn: Callable[[Optional[float], int], Any],
    method: str = "infer",
    deadline_s: Optional[float] = None,
    retry_meta=None,
    on_failure: Optional[Callable[[BaseException, int], None]] = None,
    journey: bool = False,
) -> Any:
    """Run ``attempt_fn(remaining_s, attempt)`` under ``policy``.

    ``remaining_s`` is what is left of the deadline (None without one): the
    call site caps its transport timeout with it and sends it to the
    server.  ``retry_meta`` is ``(model, protocol, method_name,
    request_id)`` for the retry count, or None.  With ``policy=None``: one
    attempt under the deadline.  ``on_failure(exc, attempt)`` runs for
    every failed attempt.  ``journey`` (one request's call sites, not a
    batch's) opens a journey around the attempts, where none is open."""
    if deadline_s is None and policy is not None:
        deadline_s = policy.deadline_s
    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    scope = begin_journey(retry_meta[3] if retry_meta else "") \
        if journey else None
    attempt = 0
    try:
        while True:
            attempt += 1
            if scope is not None:
                scope[0].attempt = attempt
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise deadline_exceeded_error()
            t0_ns = time.monotonic_ns()
            try:
                return attempt_fn(remaining, attempt)
            except BaseException as e:
                if on_failure is not None:
                    on_failure(e, attempt)
                if deadline is not None and is_timeout_error(e) \
                        and time.monotonic() >= deadline - 1e-3:
                    # the budget, not a shorter per-attempt timeout, ran
                    # out: the typed deadline failure
                    raise deadline_exceeded_error() from e
                if policy is None \
                        or not policy.should_retry(e, method, attempt):
                    raise
                delay = policy.backoff_s(
                    attempt,
                    retry_after_s=getattr(e, "retry_after_s", None))
                if deadline is not None \
                        and time.monotonic() + delay >= deadline:
                    raise  # the budget cannot cover another attempt
                # counted once the retry is committed
                if retry_meta is not None:
                    _record_retry(*retry_meta, t0_ns)
                time.sleep(delay)
    finally:
        if scope is not None:
            end_journey(scope)


async def call_with_retry_async(
    policy: Optional[RetryPolicy],
    attempt_fn,
    method: str = "infer",
    deadline_s: Optional[float] = None,
    retry_meta=None,
    on_failure: Optional[Callable[[BaseException, int], None]] = None,
    journey: bool = False,
) -> Any:
    """:func:`call_with_retry` of the aio clients: ``attempt_fn`` is a
    coroutine function and the backoff is awaited.  ``on_failure`` is a
    plain callback; the journey is held in a context variable, so the
    tasks' journeys stay apart."""
    import asyncio

    if deadline_s is None and policy is not None:
        deadline_s = policy.deadline_s
    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    scope = begin_journey(retry_meta[3] if retry_meta else "") \
        if journey else None
    attempt = 0
    try:
        while True:
            attempt += 1
            if scope is not None:
                scope[0].attempt = attempt
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise deadline_exceeded_error()
            t0_ns = time.monotonic_ns()
            try:
                return await attempt_fn(remaining, attempt)
            except Exception as e:
                if on_failure is not None:
                    on_failure(e, attempt)
                if deadline is not None and is_timeout_error(e) \
                        and time.monotonic() >= deadline - 1e-3:
                    raise deadline_exceeded_error() from e
                if policy is None \
                        or not policy.should_retry(e, method, attempt):
                    raise
                delay = policy.backoff_s(
                    attempt,
                    retry_after_s=getattr(e, "retry_after_s", None))
                if deadline is not None \
                        and time.monotonic() + delay >= deadline:
                    raise
                if retry_meta is not None:
                    _record_retry(*retry_meta, t0_ns)
                await asyncio.sleep(delay)
    finally:
        if scope is not None:
            end_journey(scope)


def min_timeout(client_timeout: Optional[float],
                remaining_s: Optional[float]) -> Optional[float]:
    """One attempt's transport timeout: the caller's timeout capped by
    what is left of the deadline."""
    if remaining_s is None:
        return client_timeout
    if client_timeout is None:
        return remaining_s
    return min(client_timeout, remaining_s)


def remaining_us(remaining_s: float) -> int:
    """The remaining deadline in the v2 wire unit (microseconds, at least
    1, so an all-but-spent budget arrives expired rather than vanishing):
    the gRPC ``timeout`` parameter and the HTTP ``triton-timeout-us``
    header alike."""
    return max(1, int(remaining_s * 1e6))
