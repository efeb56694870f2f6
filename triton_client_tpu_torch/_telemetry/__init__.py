"""The pieces of ``triton_client_tpu/_telemetry.py`` the port uses (copies):
the log-bucketed ``LatencyHistogram``, ``AppendFile``, ``escape_label`` and
the client registry's per-request ``retries`` record.

``perf_analyzer`` records every latency into one histogram, so its
percentiles come out of the same buckets as the reference tool's; the
server's flight recorder keeps one per model.  ``AppendFile`` is the cached
append handle of the request tracer and the server log, ``escape_label``
the Prometheus label escape of ``/metrics``.  :func:`new_trace_context`
gives one request's propagation headers, a W3C ``traceparent`` and a
``triton-request-id`` (``genai_perf`` stamps each request with them; the
server records both in the request's trace).  :func:`telemetry` is the
process's client registry: the retry layer (``_resilience.py``) counts each
committed retry per (model, protocol, method) there, and ``perf_analyzer``
reads the counts back around each level (the reference's
``snapshot()["requests"][i]["retries"]``).  The rest of the reference's
client telemetry (latency and byte counters, client tracing, OTLP) is not
ported yet (ROADMAP A6b).

A package rather than a ``_telemetry.py`` file: the repository's lint
(``triton-lint``'s METRICS-DECL) reads the one file of that name as the
reference's client metrics registry.
"""

from __future__ import annotations

import math
import os
import re
import threading
from typing import Dict

#: the correlation id header (the server echoes it on the response)
REQUEST_ID_HEADER = "triton-request-id"
#: the W3C Trace Context header stamped beside it
#: (00-<trace 16 bytes>-<span 8 bytes>-01)
TRACEPARENT_HEADER = "traceparent"

# a header-safe id: visible ASCII; another id stays in the body only
_HEADER_SAFE = re.compile(r"[\x20-\x7e]+\Z")


def new_trace_context(request_id: str = "") -> Dict[str, str]:
    """Fresh propagation headers for one request: ``request_id`` is the
    correlation id where it is header-safe, else a random 16-hex id is
    minted; the trace and span ids are random."""
    if not request_id or not _HEADER_SAFE.match(request_id):
        request_id = os.urandom(8).hex()
    traceparent = f"00-{os.urandom(16).hex()}-{os.urandom(8).hex()}-01"
    return {REQUEST_ID_HEADER: request_id, TRACEPARENT_HEADER: traceparent}


class AppendFile:
    """Cached append handle, reopened when the configured path changes.  A
    failing write never raises (the request that happened to log or trace
    must not fail) and closes the handle before dropping it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._file = None
        self._path = None

    def append(self, path: str, data: str) -> None:
        with self._lock:
            try:
                if self._file is None or self._path != path:
                    self._close_locked()
                    self._file = open(path, "a")
                    self._path = path
                self._file.write(data)
                self._file.flush()
            except OSError:
                self._close_locked()

    def _close_locked(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
            self._path = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()


def escape_label(value: str) -> str:
    """A label value escaped per the Prometheus text exposition format
    (backslash, double quote, newline)."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class LatencyHistogram:
    """Log-bucketed latency histogram (seconds in, quantiles out).

    Bucket ``i >= 1`` covers ``[MIN * G**(i-1), MIN * G**i)`` with
    ``MIN = 1 µs`` and growth ``G = 1.05``; bucket 0 is the underflow
    bucket and the last bucket takes the overflow.  A quantile is the
    geometric midpoint of its bucket, so its relative error is at most
    ``sqrt(G) - 1`` (~2.5%) inside the covered range.  The exact sum is
    kept beside the buckets, so ``mean`` is not quantized.
    """

    MIN_S = 1e-6
    GROWTH = 1.05
    # covers MIN_S .. ~130 s: ceil(log(1.3e8)/log(1.05)) interior buckets
    NUM_BUCKETS = 2 + int(math.ceil(math.log(1.3e8) / math.log(1.05)))

    __slots__ = ("_counts", "_count", "_sum_s", "_lock", "_log_growth")

    def __init__(self) -> None:
        self._counts = [0] * self.NUM_BUCKETS
        self._count = 0
        self._sum_s = 0.0
        self._lock = threading.Lock()
        self._log_growth = math.log(self.GROWTH)

    def _index(self, seconds: float) -> int:
        if seconds < self.MIN_S:
            return 0
        i = 1 + int(math.log(seconds / self.MIN_S) / self._log_growth)
        return i if i < self.NUM_BUCKETS else self.NUM_BUCKETS - 1

    def observe(self, seconds: float) -> None:
        i = self._index(seconds)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum_s += seconds

    @property
    def count(self) -> int:
        return self._count

    def mean(self) -> float:
        with self._lock:
            return self._sum_s / self._count if self._count else float("nan")

    def _bucket_value(self, i: int) -> float:
        if i == 0:
            return self.MIN_S / 2.0
        # geometric midpoint of [MIN*G**(i-1), MIN*G**i)
        return self.MIN_S * self.GROWTH ** (i - 0.5)

    def quantile(self, q: float) -> float:
        """The ``q``-quantile (0..1) in seconds; NaN when empty."""
        with self._lock:
            total = self._count
            if not total:
                return float("nan")
            # nearest rank on the cumulative counts
            rank = max(1, math.ceil(q * total))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    return self._bucket_value(i)
        return self._bucket_value(self.NUM_BUCKETS - 1)

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)

    def merge(self, other: "LatencyHistogram") -> None:
        with other._lock:
            counts = list(other._counts)
            count, sum_s = other._count, other._sum_s
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum_s += sum_s


class ClientTelemetry:
    """The process's client registry, as far as the port has it: retries
    per (model, protocol, method)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._retries: dict = {}

    def record_retry(self, model: str, protocol: str, method: str) -> None:
        """Count one retried attempt (before the retry runs: a retry that
        then succeeds is counted too)."""
        key = (model, protocol, method)
        with self._lock:
            self._retries[key] = self._retries.get(key, 0) + 1

    def snapshot(self) -> dict:
        """``{"requests": [{"model", "protocol", "method", "retries"}]}``,
        the reference's rows less their latency and byte counters."""
        with self._lock:
            rows = sorted(self._retries.items())
        return {"requests": [
            {"model": m, "protocol": p, "method": meth, "retries": n}
            for (m, p, meth), n in rows]}


_TELEMETRY = ClientTelemetry()


def telemetry() -> ClientTelemetry:
    """The process-wide client registry."""
    return _TELEMETRY
